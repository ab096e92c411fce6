// Element-slot data movement of the vmapped ensemble step and of the
// single run's element passes, written for Hopper (sm_90a).
//
// The ensemble packs its B members into the channels of one payload:
// a velocity-space array is [n_rows, C] with C = dim * B (component-major,
// member-minor), and its element-slot view is [n_slots, C] with one slot
// per (cell, local node), n_slots = E * n_loc.  Every element pass of the
// step moves data between the two with these kernels.
//
// Kernel C, slot_reduce: out[r, :] = sum_{k in [off[r], off[r+1])} y[perm[k], :]
//   Replaces the Pallas kernel _reduce_kernel (navierstokes_project_nm4pde_tpu/
//   ops/onehot.py:342, via onehot_reduce), which summed each node block's
//   contiguous slot window by one-hot MXU products.  Bound by device-memory
//   bytes: every slot row (C * 4 bytes) is read once and every node row
//   written once (73.5 MB read at C = 192 on the 64-member 46,928-DoF
//   ensemble).  Design: one warp per output row, lanes across the channels
//   with 16-byte loads where C % 4 == 0; the row's slot ids come from a CSR
//   order sorted by target row (ops/scatter.py build_segment_plan), loaded
//   32 at a time by the lanes and broadcast with shuffles.  Each channel
//   sums its slots one after another in that fixed order: no atomics, so
//   the result is the same in every run, and no permuted copy of y is
//   written first (the plain version's index_select + segment_reduce).
//   Narrow payloads (C <= kNarrowC: the single run's element passes at 3,
//   6 or 9 channels) would leave 29 of a warp's 32 lanes idle, so there one
//   thread sums one (row, channel) over the row's slots, in the same order
//   (the same result, bit for bit); C is a compile-time constant there, so
//   splitting the thread index costs a multiply.  At IMEX's fine subset
//   (C = 3, 1.98 M slots): 0.0254 ms, 54% of its bound, against the
//   warp-a-row design's 0.1102 and index_add_'s 0.0529 (H100 80GB HBM3,
//   700 W).
//
// Kernel D, slot_gather: y[s, :] = x[idx[s], :]
//   Replaces the Pallas kernel _gather_kernel (navierstokes_project_nm4pde_tpu/
//   ops/onehot.py:247, via onehot_gather), which read two DMA'd node windows
//   per cell block and placed rows by one-hot MXU products.  Bound by
//   device-memory bytes written (n_slots * C * 4: 73.5 MB at C = 192);
//   the source (11.5 MB at C = 192) stays in the 50 MB L2.  Design: one
//   thread per (slot, 4-channel vector), a coalesced row copy.  Exact.
//   Narrow payloads (C <= kNarrowC) take kGatherPer (slot, channel)
//   elements a thread, C a compile-time constant: with one element a
//   thread and the index split by a run-time C (a 64-bit division), each
//   thread kept one index-then-row chain of loads in flight (C = 3 at
//   IMEX's fine subset: 0.0320 ms, 40% of bound, against index_select's
//   0.0262; now 0.0193, 67%; H100 80GB HBM3, 700 W).
//
// Both kernels are templates on the element type: the _f32 entry points
// take float payloads, the _f64 ones double (the float64 runs).  In double
// the wide designs' 16-byte vectors hold 2 channels (double2, where
// C % 2 == 0 and the bases are aligned); the narrow kernels are the same
// code.  C still sums each (row, channel) in the CSR order, so it stays
// deterministic, and D stays an exact copy.  Both stay bound by bytes,
// which double doubles.
//
// Every entry point launches on the caller's stream, allocate nothing, and
// return cudaGetLastError() so the Python wrapper can raise.  Indices are
// validated when the plans are built (ops/onehot.py build_onehot_plans).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kReduceWarps = 8;  // output rows per CTA, one warp each
constexpr int kGatherThreads = 256;
constexpr int kNarrowC = 16;  // widest payload of the narrow kernels
constexpr int kNarrowThreads = 256;
constexpr int kGatherPer = 4;  // elements a thread of the narrow gather

// VEC channels of element type T moved as one load: 1, or 16 bytes
template <typename T, int VEC>
struct Vec;
template <typename T>
struct Vec<T, 1> {
  using V = T;
  __device__ static void add(T* acc, V v) { acc[0] += v; }
  __device__ static V pack(const T* acc) { return acc[0]; }
};
template <>
struct Vec<float, 4> {
  using V = float4;
  __device__ static void add(float* acc, V v) {
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  __device__ static V pack(const float* acc) {
    return make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};
template <>
struct Vec<double, 2> {
  using V = double2;
  __device__ static void add(double* acc, V v) {
    acc[0] += v.x;
    acc[1] += v.y;
  }
  __device__ static V pack(const double* acc) { return make_double2(acc[0], acc[1]); }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kReduceWarps * 32)
slot_reduce_kernel(const T* __restrict__ y, const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ off, T* __restrict__ out,
                   int n_rows, int C) {
  using V = typename Vec<T, VEC>::V;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kReduceWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps leave together
  const int nv = C / VEC;     // vectors per row
  const V* yv = reinterpret_cast<const V*>(y);
  V* ov = reinterpret_cast<V*>(out);
  const long long k0 = off[row];
  const long long k1 = off[row + 1];
  for (int v0 = 0; v0 < nv; v0 += 32) {
    const int v = v0 + lane;
    T acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = T(0);
    for (long long kb = k0; kb < k1; kb += 32) {
      const int cnt = static_cast<int>(min(32LL, k1 - kb));
      const long long mine = lane < cnt ? static_cast<long long>(perm[kb + lane]) : 0LL;
      for (int t = 0; t < cnt; ++t) {
        const long long s = __shfl_sync(0xffffffffu, mine, t);
        if (v < nv) Vec<T, VEC>::add(acc, yv[s * nv + v]);
      }
    }
    if (v < nv) ov[static_cast<long long>(row) * nv + v] = Vec<T, VEC>::pack(acc);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kGatherThreads)
slot_gather_kernel(const T* __restrict__ x, const int64_t* __restrict__ idx,
                   T* __restrict__ y, long long n_slots, int nv) {
  using V = typename Vec<T, VEC>::V;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_slots * nv) return;
  const long long s = t / nv;
  const int v = static_cast<int>(t - s * nv);
  const long long r = idx[s];
  reinterpret_cast<V*>(y)[t] = reinterpret_cast<const V*>(x)[r * nv + v];
}

// one thread a (row, channel): its row's slots in CSR order, as above
template <typename T, int C>
__global__ void __launch_bounds__(kNarrowThreads)
slot_reduce_narrow_kernel(const T* __restrict__ y, const int64_t* __restrict__ perm,
                          const int64_t* __restrict__ off, T* __restrict__ out,
                          int total) {
  const int t = blockIdx.x * kNarrowThreads + threadIdx.x;
  if (t >= total) return;
  const int row = t / C;
  const int c = t - row * C;
  const long long k1 = off[row + 1];
  T acc = T(0);
#pragma unroll 4
  for (long long k = off[row]; k < k1; ++k) acc += y[perm[k] * C + c];
  out[t] = acc;
}

// kGatherPer (slot, channel) elements a thread, kNarrowThreads apart so
// that each store is coalesced; their loads are independent, so a thread
// keeps kGatherPer index-then-row chains in flight
template <typename T, int C>
__global__ void __launch_bounds__(kNarrowThreads)
slot_gather_narrow_kernel(const T* __restrict__ x, const int64_t* __restrict__ idx,
                          T* __restrict__ y, int total) {
  const int base = blockIdx.x * (kNarrowThreads * kGatherPer) + threadIdx.x;
  T v[kGatherPer];
#pragma unroll
  for (int i = 0; i < kGatherPer; ++i) {
    const int t = base + i * kNarrowThreads;
    if (t < total) {
      const int s = t / C;
      v[i] = x[idx[s] * C + (t - s * C)];
    }
  }
#pragma unroll
  for (int i = 0; i < kGatherPer; ++i) {
    const int t = base + i * kNarrowThreads;
    if (t < total) y[t] = v[i];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// channels of T in one 16-byte vector
template <typename T>
constexpr int kVec16 = 16 / static_cast<int>(sizeof(T));

template <typename T>
int reduce_wide(const T* y, const int64_t* perm, const int64_t* off, T* out,
                int n_rows, int C, cudaStream_t s) {
  constexpr int L = kVec16<T>;
  const int blocks = (n_rows + kReduceWarps - 1) / kReduceWarps;
  if (C % L == 0 && aligned16(y) && aligned16(out)) {
    slot_reduce_kernel<T, L><<<blocks, kReduceWarps * 32, 0, s>>>(y, perm, off, out, n_rows, C);
  } else {
    slot_reduce_kernel<T, 1><<<blocks, kReduceWarps * 32, 0, s>>>(y, perm, off, out, n_rows, C);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gather_wide(const T* x, const int64_t* idx, T* y, long long n_slots, int C,
                cudaStream_t s) {
  constexpr int L = kVec16<T>;
  const bool vec = C % L == 0 && aligned16(x) && aligned16(y);
  const int nv = vec ? C / L : C;
  const long long total = n_slots * nv;
  const unsigned blocks = static_cast<unsigned>((total + kGatherThreads - 1) / kGatherThreads);
  if (vec) {
    slot_gather_kernel<T, L><<<blocks, kGatherThreads, 0, s>>>(x, idx, y, n_slots, nv);
  } else {
    slot_gather_kernel<T, 1><<<blocks, kGatherThreads, 0, s>>>(x, idx, y, n_slots, nv);
  }
  return static_cast<int>(cudaGetLastError());
}

// the narrow kernel at C = 1 .. kNarrowC over `total` = rows (slots) x C
// elements, `per` a thread; false if C is wider
template <typename T, template <typename, int> class Launch, typename... Args>
bool launch_narrow(int C, long long total, int per, cudaStream_t s, Args... args) {
  if (C < 1 || C > kNarrowC || total >= (1LL << 31) - kNarrowThreads * per) return false;
  const long long chunk = static_cast<long long>(kNarrowThreads) * per;
  const unsigned blocks = static_cast<unsigned>((total + chunk - 1) / chunk);
  switch (C) {
#define NS_NARROW_CASE(c) \
  case c:                 \
    Launch<T, c>::run(blocks, s, args..., static_cast<int>(total)); \
    break;
    NS_NARROW_CASE(1) NS_NARROW_CASE(2) NS_NARROW_CASE(3) NS_NARROW_CASE(4)
    NS_NARROW_CASE(5) NS_NARROW_CASE(6) NS_NARROW_CASE(7) NS_NARROW_CASE(8)
    NS_NARROW_CASE(9) NS_NARROW_CASE(10) NS_NARROW_CASE(11) NS_NARROW_CASE(12)
    NS_NARROW_CASE(13) NS_NARROW_CASE(14) NS_NARROW_CASE(15) NS_NARROW_CASE(16)
#undef NS_NARROW_CASE
  }
  return true;
}

template <typename T, int C>
struct ReduceNarrow {
  static void run(unsigned blocks, cudaStream_t s, const T* y, const int64_t* perm,
                  const int64_t* off, T* out, int total) {
    slot_reduce_narrow_kernel<T, C><<<blocks, kNarrowThreads, 0, s>>>(y, perm, off, out, total);
  }
};

template <typename T, int C>
struct GatherNarrow {
  static void run(unsigned blocks, cudaStream_t s, const T* x, const int64_t* idx, T* y,
                  int total) {
    slot_gather_narrow_kernel<T, C><<<blocks, kNarrowThreads, 0, s>>>(x, idx, y, total);
  }
};

template <typename T>
int slot_reduce(const T* y, const int64_t* perm, const int64_t* off, T* out, int n_rows, int C,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || C <= 0) return 0;
  static_assert(kNarrowC == 16, "launch_narrow's cases take C = 1 .. kNarrowC");
  if (launch_narrow<T, ReduceNarrow>(C, static_cast<long long>(n_rows) * C, 1, s, y, perm, off,
                                     out))
    return static_cast<int>(cudaGetLastError());
  return reduce_wide(y, perm, off, out, n_rows, C, s);
}

template <typename T>
int slot_gather(const T* x, const int64_t* idx, T* y, long long n_slots, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_slots <= 0 || C <= 0) return 0;
  if (launch_narrow<T, GatherNarrow>(C, n_slots * C, kGatherPer, s, x, idx, y))
    return static_cast<int>(cudaGetLastError());
  return gather_wide(x, idx, y, n_slots, C, s);
}

}  // namespace

#define NS_SLOT_ENTRIES(T, SUFFIX)                                                               \
  extern "C" int ns_slot_reduce_##SUFFIX(const T* y, const int64_t* perm, const int64_t* off,   \
                                         T* out, int n_rows, int C, void* stream) {             \
    return slot_reduce<T>(y, perm, off, out, n_rows, C, stream);                                 \
  }                                                                                              \
  extern "C" int ns_slot_gather_##SUFFIX(const T* x, const int64_t* idx, T* y,                   \
                                         long long n_slots, int C, void* stream) {               \
    return slot_gather<T>(x, idx, y, n_slots, C, stream);                                        \
  }

NS_SLOT_ENTRIES(float, f32)
NS_SLOT_ENTRIES(double, f64)
