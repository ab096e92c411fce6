// The per-member element product of the ensemble step, written for Hopper
// (sm_90a).
//
// Kernel G, member_product: y[e, i, c, b] = sum_j F[j, e, i, b] * x[e, j, c, b]
//   F holds one folded element matrix a (cell, member), F_e[j, e, i, b] =
//   F_e^(b)[e, i, j] ([nloc, E, nloc, B], contiguous: ops/operators.py
//   convection_setup); x is the element view of the input, nc channels a node
//   and B members; y is written once in the [E, nloc, nc, B] slot layout that
//   kernel C (csrc/ensemble_kernels.cu slot_reduce) reads.
//   Replaces no TPU kernel: the JAX package's _emv
//   (navierstokes_project_nm4pde_tpu/ops/operators.py:390) is a plain XLA
//   product under vmap.  It takes the place of the plain version's chain of
//   nloc multiply-adds, each of which streams the whole [E, nloc, nc, B]
//   accumulator in and out of device memory (1.72 GB an apply at E 9,576,
//   nloc 10, nc 3, B 64, where the work needs a fifth of that).
//   Two input modes:
//   (a) node rows, the slot gather fused in: x[e, j] is row cells[e, j] of
//       u [n, nc, B]; kernel D and the element view it would write drop out
//       (ops/operators.py apply_F);
//   (b) an element view already gathered, with any strides (a channel slice
//       of the step's stacked gather is read in place, never copied).
//   Bound by device-memory bytes: F is read once and y written once, mode
//   (a) 245.1 + 73.5 = 318.6 MB (330.9 with the node rows, 11.5 MB, and
//   their int64 index, which stay in the 50 MB L2), mode (b) 392 MB with the
//   element view's 73.5 MB read, at E 9,576, nloc 10, nc 3, B 64 in float32:
//   0.1349 ms in mode (a) (73% of the 330.9 MB bound; kernel D and the
//   chain 0.7777, einsum 4.07) and 0.1373 ms in mode (b) (85%; the chain
//   0.7411), float64 0.2567 / 0.2674 ms (77 / 88%) (H100 80GB HBM3, 700 W).
//   Design: one thread a (cell, row i, vector of members), so that each F
//   entry is loaded by one thread only, the F rows of a cell (nloc
//   contiguous [nloc, B] slabs) coalesced across the CTA; a thread issues
//   its nloc independent 16-byte F loads before anything else, so a CTA of
//   160 threads has 25.6 KB in flight.  Meanwhile
//   the CTA stages its cells' input rows in shared memory, which every row i
//   reads; the sums of a thread's nc channels stay in registers, and y never
//   exists in device memory until its one write.  Channels beyond a group of
//   CG (3, 2 or 1, whichever divides nc) are staged and summed group by
//   group with F kept in registers, so wide payloads read F once too.
//   Members are split across CTAs in chunks of kLanes vectors (a float64
//   thread's F rows fill 80 registers), and narrow B packs several cells
//   into one CTA.  Each y entry sums j = 0 .. nloc-1 in order (the
//   first product, then fused multiply-adds), with no atomics: the result is
//   the same in every run, bit for bit.
//
// A template on the element type, as kernels C and D are: the _f32 entry
// point takes float, the _f64 one double.  The 16-byte path (float4, or
// double2) runs where B is a multiple of its width and every base and
// stride allows it; else one element a thread lane.  Each entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper (ops/onehot.py member_product)
// can raise; the wrapper checks shapes, and the gather's indices are
// validated when the plans are built (ops/onehot.py build_onehot_plans).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;       // member vectors a cell's row in one CTA
constexpr int kCtaThreads = 256;  // narrow B: cells a CTA up to this many threads

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T, int VEC>
struct Vec;
template <typename T>
struct Vec<T, 1> {
  using V = T;
  __device__ static T get(const V& v, int) { return v; }
  __device__ static void set(V& v, int, T x) { v = x; }
};
template <>
struct Vec<float, 4> {
  using V = float4;
  __device__ static float get(const V& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
  __device__ static void set(V& v, int k, float x) {
    if (k == 0) v.x = x; else if (k == 1) v.y = x; else if (k == 2) v.z = x; else v.w = x;
  }
};
template <>
struct Vec<double, 2> {
  using V = double2;
  __device__ static double get(const V& v, int k) { return k == 0 ? v.x : v.y; }
  __device__ static void set(V& v, int k, double x) {
    if (k == 0) v.x = x; else v.y = x;
  }
};

// One CTA: cpc consecutive cells x nloc rows x lanes member vectors (thread
// order: vector fastest, then row i, then cell), member chunk blockIdx.y.
// x's element (e, j, c, b) lies at e * s_e + j * s_j + c * s_c + b * s_b; with
// GATHER, at cells[e * NLOC + j] * s_j + c * s_c + b * s_b (u's node rows).
template <typename T, int VEC, int NLOC, int CG, bool GATHER>
__global__ void __launch_bounds__(kCtaThreads)
member_product_kernel(const T* __restrict__ F, const T* __restrict__ x,
                      const int64_t* __restrict__ cells, T* __restrict__ y, int E, int nc,
                      int nv, int lanes, int cpc, long long s_e, long long s_j, long long s_c,
                      long long s_b) {
  using VT = Vec<T, VEC>;
  using V = typename VT::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* xs = reinterpret_cast<V*>(smem_raw);  // [cpc][NLOC][CG][lanes]

  const int per_cell = NLOC * lanes;
  const int t = threadIdx.x;
  const int cl = t / per_cell;
  const int r = t - cl * per_cell;
  const int i = r / lanes;
  const int vl = r - i * lanes;
  const int e0 = blockIdx.x * cpc;
  const int v0 = blockIdx.y * lanes;
  const int e = e0 + cl;
  const int v = v0 + vl;
  const bool mine = cl < cpc && e < E && v < nv;

  // this thread's F rows: nloc independent 16-byte loads, issued first
  V f[NLOC];
  if (mine) {
    const V* Fv = reinterpret_cast<const V*>(F);
#pragma unroll
    for (int j = 0; j < NLOC; ++j)
      f[j] = __ldg(Fv + ((static_cast<long long>(j) * E + e) * NLOC + i) * nv + v);
  }

  const int n_stage = cpc * NLOC * CG * lanes;
  for (int g = 0; g < nc; g += CG) {
    if (g > 0) __syncthreads();  // the previous group's sums have read xs
    for (int k = t; k < n_stage; k += blockDim.x) {
      const int kl = k % lanes;
      int rest = k / lanes;
      const int cc = rest % CG;
      rest /= CG;
      const int j = rest % NLOC;
      const int ce = e0 + rest / NLOC;
      const int kv = v0 + kl;
      if (ce < E && kv < nv) {
        long long off = GATHER ? cells[static_cast<long long>(ce) * NLOC + j] * s_j
                               : ce * s_e + j * s_j;
        off += (g + cc) * s_c + static_cast<long long>(kv) * VEC * s_b;
        xs[k] = __ldg(reinterpret_cast<const V*>(x + off));
      }
    }
    __syncthreads();
    if (mine) {
      const V* xc = xs + cl * (NLOC * CG * lanes) + vl;
      T acc[CG][VEC];
#pragma unroll
      for (int j = 0; j < NLOC; ++j) {
#pragma unroll
        for (int cc = 0; cc < CG; ++cc) {
          const V xv = xc[(j * CG + cc) * lanes];
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            const T a = VT::get(f[j], q);
            const T b = VT::get(xv, q);
            acc[cc][q] = j == 0 ? a * b : fmadd(a, b, acc[cc][q]);
          }
        }
      }
      V* yv = reinterpret_cast<V*>(y);
#pragma unroll
      for (int cc = 0; cc < CG; ++cc) {
        V out;
#pragma unroll
        for (int q = 0; q < VEC; ++q) VT::set(out, q, acc[cc][q]);
        yv[((static_cast<long long>(e) * NLOC + i) * nc + g + cc) * nv + v] = out;
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, int VEC, int NLOC, int CG, bool GATHER>
int launch(const T* F, const T* x, const int64_t* cells, T* y, int E, int nc, int B,
           long long s_e, long long s_j, long long s_c, long long s_b, cudaStream_t s) {
  const int nv = B / VEC;
  const int lanes = nv < kLanes ? nv : kLanes;
  const int per_cell = NLOC * lanes;
  const int cpc = per_cell >= kCtaThreads ? 1 : kCtaThreads / per_cell;
  const dim3 grid((E + cpc - 1) / cpc, (nv + lanes - 1) / lanes);
  const size_t smem = static_cast<size_t>(cpc) * NLOC * CG * lanes * sizeof(typename Vec<T, VEC>::V);
  member_product_kernel<T, VEC, NLOC, CG, GATHER><<<grid, cpc * per_cell, smem, s>>>(
      F, x, cells, y, E, nc, nv, lanes, cpc, s_e, s_j, s_c, s_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int NLOC, bool GATHER>
int launch_groups(const T* F, const T* x, const int64_t* cells, T* y, int E, int nc, int B,
                  long long s_e, long long s_j, long long s_c, long long s_b, cudaStream_t s) {
  if (nc % 3 == 0)
    return launch<T, VEC, NLOC, 3, GATHER>(F, x, cells, y, E, nc, B, s_e, s_j, s_c, s_b, s);
  if (nc % 2 == 0)
    return launch<T, VEC, NLOC, 2, GATHER>(F, x, cells, y, E, nc, B, s_e, s_j, s_c, s_b, s);
  return launch<T, VEC, NLOC, 1, GATHER>(F, x, cells, y, E, nc, B, s_e, s_j, s_c, s_b, s);
}

template <typename T, int VEC>
int launch_cells(const T* F, const T* x, const int64_t* cells, T* y, int E, int nloc, int nc,
                 int B, long long s_e, long long s_j, long long s_c, long long s_b,
                 cudaStream_t s) {
  const bool gather = cells != nullptr;
  if (nloc == 10)
    return gather ? launch_groups<T, VEC, 10, true>(F, x, cells, y, E, nc, B, s_e, s_j, s_c, s_b, s)
                  : launch_groups<T, VEC, 10, false>(F, x, cells, y, E, nc, B, s_e, s_j, s_c, s_b, s);
  if (nloc == 6)
    return gather ? launch_groups<T, VEC, 6, true>(F, x, cells, y, E, nc, B, s_e, s_j, s_c, s_b, s)
                  : launch_groups<T, VEC, 6, false>(F, x, cells, y, E, nc, B, s_e, s_j, s_c, s_b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int member_product(const T* F, const T* x, const int64_t* cells, T* y, int E, int nloc, int nc,
                   int B, long long s_e, long long s_j, long long s_c, long long s_b,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || nc <= 0 || B <= 0) return 0;
  constexpr int L = 16 / static_cast<int>(sizeof(T));
  const bool vec = B % L == 0 && s_b == 1 && s_e % L == 0 && s_j % L == 0 && s_c % L == 0 &&
                   aligned16(F) && aligned16(x) && aligned16(y);
  return vec ? launch_cells<T, L>(F, x, cells, y, E, nloc, nc, B, s_e, s_j, s_c, s_b, s)
             : launch_cells<T, 1>(F, x, cells, y, E, nloc, nc, B, s_e, s_j, s_c, s_b, s);
}

}  // namespace

#define NS_MEMBER_ENTRY(T, SUFFIX)                                                               \
  extern "C" int ns_member_product_##SUFFIX(const T* F, const T* x, const int64_t* cells, T* y,  \
                                            int E, int nloc, int nc, int B, long long s_e,       \
                                            long long s_j, long long s_c, long long s_b,         \
                                            void* stream) {                                      \
    return member_product<T>(F, x, cells, y, E, nloc, nc, B, s_e, s_j, s_c, s_b, stream);        \
  }

NS_MEMBER_ENTRY(float, f32)
NS_MEMBER_ENTRY(double, f64)
