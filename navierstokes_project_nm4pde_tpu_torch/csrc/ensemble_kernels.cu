// Element-slot data movement of the vmapped ensemble step, written for
// Hopper (sm_90a).
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
//
// Kernel D, slot_gather: y[s, :] = x[idx[s], :]
//   Replaces the Pallas kernel _gather_kernel (navierstokes_project_nm4pde_tpu/
//   ops/onehot.py:247, via onehot_gather), which read two DMA'd node windows
//   per cell block and placed rows by one-hot MXU products.  Bound by
//   device-memory bytes written (n_slots * C * 4: 73.5 MB at C = 192);
//   the source (11.5 MB at C = 192) stays in the 50 MB L2.  Design: one
//   thread per (slot, 4-channel vector), a coalesced row copy.  Exact.
//
// Both entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() so the Python wrapper can raise.  Indices are
// validated when the plans are built (ops/onehot.py build_onehot_plans).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kReduceWarps = 8;  // output rows per CTA, one warp each
constexpr int kGatherThreads = 256;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static void add(float* acc, T v) { acc[0] += v; }
  __device__ static T pack(const float* acc) { return acc[0]; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static void add(float* acc, T v) {
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  __device__ static T pack(const float* acc) {
    return make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <int VEC>
__global__ void __launch_bounds__(kReduceWarps * 32)
slot_reduce_kernel(const float* __restrict__ y, const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ off, float* __restrict__ out,
                   int n_rows, int C) {
  using V = typename Vec<VEC>::T;
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
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (long long kb = k0; kb < k1; kb += 32) {
      const int cnt = static_cast<int>(min(32LL, k1 - kb));
      const long long mine = lane < cnt ? static_cast<long long>(perm[kb + lane]) : 0LL;
      for (int t = 0; t < cnt; ++t) {
        const long long s = __shfl_sync(0xffffffffu, mine, t);
        if (v < nv) Vec<VEC>::add(acc, yv[s * nv + v]);
      }
    }
    if (v < nv) ov[static_cast<long long>(row) * nv + v] = Vec<VEC>::pack(acc);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kGatherThreads)
slot_gather_kernel(const float* __restrict__ x, const int64_t* __restrict__ idx,
                   float* __restrict__ y, long long n_slots, int nv) {
  using V = typename Vec<VEC>::T;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_slots * nv) return;
  const long long s = t / nv;
  const int v = static_cast<int>(t - s * nv);
  const long long r = idx[s];
  reinterpret_cast<V*>(y)[t] = reinterpret_cast<const V*>(x)[r * nv + v];
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" int ns_slot_reduce_f32(const float* y, const int64_t* perm, const int64_t* off,
                                  float* out, int n_rows, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || C <= 0) return 0;
  const int blocks = (n_rows + kReduceWarps - 1) / kReduceWarps;
  if (C % 4 == 0 && aligned16(y) && aligned16(out)) {
    slot_reduce_kernel<4><<<blocks, kReduceWarps * 32, 0, s>>>(y, perm, off, out, n_rows, C);
  } else {
    slot_reduce_kernel<1><<<blocks, kReduceWarps * 32, 0, s>>>(y, perm, off, out, n_rows, C);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_slot_gather_f32(const float* x, const int64_t* idx, float* y,
                                  long long n_slots, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_slots <= 0 || C <= 0) return 0;
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(y);
  const int nv = vec ? C / 4 : C;
  const long long total = n_slots * nv;
  const unsigned blocks = static_cast<unsigned>((total + kGatherThreads - 1) / kGatherThreads);
  if (vec) {
    slot_gather_kernel<4><<<blocks, kGatherThreads, 0, s>>>(x, idx, y, n_slots, nv);
  } else {
    slot_gather_kernel<1><<<blocks, kGatherThreads, 0, s>>>(x, idx, y, n_slots, nv);
  }
  return static_cast<int>(cudaGetLastError());
}
