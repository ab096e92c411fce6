// The frozen coarse Cholesky solve of the two-level pressure
// preconditioner, written for Hopper (sm_90a).
//
// coarse_solve: z = Sc^-1 r = L^-T L^-1 r, Sc = L L^T the dense [nc, nc]
//   coarse matrix of the frozen Schur operator S1 (ops/coarse.py), r and z
//   [nc, cols] (one column a member).  Replaces no TPU kernel: the JAX
//   package solves with the factor (`cho_solve`, two triangular
//   substitutions), and so did the port (`torch.cholesky_solve`: cuBLAS
//   trsv twice, each a sweep over nc dependent rows that leaves the card
//   nearly empty, and copies into column-major layout around them: 0.219
//   ms a call at nc = 1,704, the 965k duct's).  The factor never changes
//   during a run, so set-up inverts it once, W = L^-1, in float64 on the
//   host, and packs it into one [nc, ld] matrix M (ops/coarse.py
//   frozen_cho_w): W in the lower triangle, diagonal included, W^T's
//   strict upper part above it.
//   The solve is then two triangular products in which every row is
//   independent:
//       y[k] = sum_{j <= k} M[k, j] r[j]    (y = W r)
//       z[j] = sum_{k >= j} M[j, k] y[k]    (z = W^T y)
//   one launch each, the second reading the first's y from a scratch the
//   wrapper allocates.  Each launch reads one triangle of M once, row by
//   row: bound by device-memory bytes, nc (nc + 1) / 2 entries a launch
//   (5.81 MB in float32 at nc = 1,704; the two triangles are distinct
//   bytes, so the second launch finds nothing of the first's in L2), while
//   the coarse vectors (nc x cols entries) stay in L2.
//
// Design: one warp per (row, group of G columns), its lanes across the
//   row's range in 16-byte vectors of M (ld % 4 == 0 keeps every row's
//   vectors aligned; entries of the vectors at either end that lie outside
//   the range are masked), kBatch vectors in flight a lane: 16 for one
//   column, 8 for a group, whose accumulators take the registers.  Each CTA
//   stages its G columns of the input in shared memory, [G][ld], zero past
//   nc, so that a lane reads the input in 16-byte vectors too, kStage loads
//   in flight a thread; the first batch of M is loaded before the staging,
//   to hide its latency.  Rows are dealt round-robin (warp w of CTA b takes
//   row w * gridDim.x + b), so that every CTA holds long and short rows of
//   the triangle alike.  Each
//   lane sums its vectors in order and the warp's lanes meet by shuffles in
//   a fixed order, with no atomics: a replay repeats the result bit for bit.
//   The partition follows the shape: one column (the single run) takes
//   G = 1, one warp a row; an ensemble's columns split into groups of up to
//   8 (G = 1, 2, 4 or 8, the narrowest that holds cols), a grid dimension.
//   Measured (profiler, each launch after a 250 MB read empties L2; H100
//   80GB HBM3, 700 W): 4.95 + 4.75 us at nc 1,704 and one column (16
//   vectors in flight: 5.58 + 5.28 with 8; the input read from global
//   memory and not staged: 9.51 + 5.75), 2.55 + 2.70 us at nc 90 and 64
//   columns (3.58 + 3.19 with 16 vectors); at the small size a launch's
//   latency, not its bytes, is the time.
//
// The _f32 entry point takes float operands, the _f64 one double (the
// float64 runs; a 16-byte vector holds 2 entries there).  It launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take) so that the Python
// wrapper can raise.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows of a CTA, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 8;  // entries of the input in flight a thread while a CTA stages it
constexpr int kMaxG = 8;   // widest column group
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using V = float4;
  static constexpr int N = 4;
  __device__ static void unpack(V v, float* a) {
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  }
};
template <>
struct Vec16<double> {
  using V = double2;
  static constexpr int N = 2;
  __device__ static void unpack(V v, double* a) {
    a[0] = v.x;
    a[1] = v.y;
  }
};

// out[row, c0 + g] = sum over the row's range of M[row, j] x[j, c0 + g]:
// the range is [0, row] (kUpper false: y = W x) or [row, nc) (kUpper
// true: z = W^T x)
template <typename T, int G, bool kUpper>
__global__ void __launch_bounds__(kThreads)
coarse_trimv_kernel(const T* __restrict__ M, const T* __restrict__ x, T* __restrict__ out,
                    int nc, int ld, int cols) {
  using V = typename Vec16<T>::V;
  constexpr int N = Vec16<T>::N;
  constexpr int kBatch = G == 1 ? 16 : 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [G][ld]

  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const bool live = row < nc;
  const int lo = kUpper ? row : 0;
  const int hi = kUpper ? nc - 1 : row;  // inclusive
  const int q0 = lo / N + lane;          // this lane's first vector
  const int q1 = hi / N;                 // the row's last vector
  const V* Mr = reinterpret_cast<const V*>(M + static_cast<long long>(live ? row : 0) * ld);

  V v[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int q = q0 + 32 * u;
    if (live && q <= q1) v[u] = __ldg(Mr + q);
  }

  // kStage loads of the input in flight a thread, then their stores: one
  // round trip to L2 for nc * G <= kThreads * kStage
  const int c0 = blockIdx.y * G;
  const int gc = min(G, cols - c0);
  const int n_stage = ld * G;
  for (int t0 = threadIdx.x; t0 < n_stage; t0 += kThreads * kStage) {
    T xv[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int t = t0 + u * kThreads;
      const int j = t / G;
      const int g = t - j * G;
      xv[u] = (j < nc && g < gc) ? x[static_cast<long long>(j) * cols + c0 + g] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int t = t0 + u * kThreads;
      const int j = t / G;
      if (t < n_stage) xs[(t - j * G) * ld + j] = xv[u];
    }
  }
  __syncthreads();
  if (!live) return;  // whole warps leave together, after the CTA's last barrier

  T acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = T(0);
  for (int qb = q0; qb <= q1; qb += 32 * kBatch) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = qb + 32 * u;
      if (q <= q1) {
        T m[N];
        Vec16<T>::unpack(v[u], m);
#pragma unroll
        for (int t = 0; t < N; ++t) {
          const int j = q * N + t;
          if (j < lo || j > hi) m[t] = T(0);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          T xv[N];
          Vec16<T>::unpack(reinterpret_cast<const V*>(xs + g * ld)[q], xv);
#pragma unroll
          for (int t = 0; t < N; ++t) acc[g] += m[t] * xv[t];
        }
      }
    }
    // the next batch
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = qb + 32 * (kBatch + u);
      if (q <= q1) v[u] = __ldg(Mr + q);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], off);
  }
  T* o = out + static_cast<long long>(row) * cols + c0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == g && g < gc) o[g] = acc[g];
  }
}

template <typename T, int G, bool kUpper>
int launch_trimv(const T* M, const T* x, T* out, int nc, int ld, int cols, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(ld) * G * sizeof(T);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(coarse_trimv_kernel<T, G, kUpper>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((nc + kWarps - 1) / kWarps, (cols + G - 1) / G);
  coarse_trimv_kernel<T, G, kUpper><<<grid, kThreads, smem, s>>>(M, x, out, nc, ld, cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int solve_g(const T* M, const T* r, T* y, T* z, int nc, int ld, int cols, cudaStream_t s) {
  const int rc = launch_trimv<T, G, false>(M, r, y, nc, ld, cols, s);
  if (rc != 0) return rc;
  return launch_trimv<T, G, true>(M, y, z, nc, ld, cols, s);
}

template <typename T>
int coarse_solve(const T* M, const T* r, T* y, T* z, int nc, int ld, int cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc <= 0 || cols <= 0) return 0;
  if (ld < nc || ld % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  // the narrowest group that holds cols, narrowed further until the staged
  // input fits the default shared memory; one column past it opts in to more
  int G = 1;
  while (G < kMaxG && G < cols) G *= 2;
  while (G > 1 && static_cast<size_t>(ld) * G * sizeof(T) > kDefaultSmem) G /= 2;
  if (static_cast<size_t>(ld) * G * sizeof(T) > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  switch (G) {
    case 1:
      return solve_g<T, 1>(M, r, y, z, nc, ld, cols, s);
    case 2:
      return solve_g<T, 2>(M, r, y, z, nc, ld, cols, s);
    case 4:
      return solve_g<T, 4>(M, r, y, z, nc, ld, cols, s);
    default:
      return solve_g<T, 8>(M, r, y, z, nc, ld, cols, s);
  }
}

}  // namespace

#define NS_COARSE_ENTRIES(T, SUFFIX)                                                          \
  extern "C" int ns_coarse_solve_##SUFFIX(const T* M, const T* r, T* y, T* z, int nc, int ld, \
                                          int cols, void* stream) {                           \
    return coarse_solve<T>(M, r, y, z, nc, ld, cols, stream);                                 \
  }

NS_COARSE_ENTRIES(float, f32)
NS_COARSE_ENTRIES(double, f64)
