// Macro-element block-dense velocity operator: the two per-step kernels of
// the projection stepper's F path, written for Hopper (sm_90a).
//
// The velocity operator F = M/dt + nu A + C(w) is held as B dense [U, U]
// blocks, one per macro block of c_blk consecutive (RCM-ordered) cells
// whose unique P2 nodes fit in U slots.  Values are stored TRANSPOSED,
// FtT[b, v, u] = Ft[b, u, v] (the reference's "vu" layout), so that in
// both kernels neighbouring threads touch neighbouring addresses.
//
// Kernel A, macro_matvec: y[b, u, c] = sum_v FtT[b, v, u] * x[b, v, c]
//   Replaces the Pallas kernel _mv_kernel (navierstokes_project_nm4pde_tpu/
//   ops/macroblock.py:265, via macro_matvec_vpu).  Bound by device-memory
//   bytes: the value stream (B*U*U*4 bytes, 712 MB at the 965k-DoF bench
//   mesh) is read once per apply and each value is used C times.  Design:
//   one CTA per block, one thread per output row u, f32 accumulators in
//   registers, the block's [U, C] input panel staged in shared memory and
//   broadcast to all threads; thread u reads column u of row v, so a warp
//   reads 128 contiguous bytes per step (coalesced).  All C channels ride
//   one pass over the values.
//
// Kernel B, macro_build: FtT[b, lidx[c, j], lidx[c, i]] += F_e[c, i, j]
//   Replaces the Pallas prototypes _kern_cells / _kern_bd / _kern_cells16 /
//   _kern_bd16 (scripts/prof_macro_build_kernel.py, via run_fused), i.e. the
//   function of build_macro_values (ops/macroblock.py:153).  Bound by
//   device-memory bytes: it writes the whole value array (712 MB at 965k)
//   and reads F_e (87 MB).  Design: one CTA per block accumulates its
//   [U, U] f32 tile in 64 KB of dynamic shared memory with shared-memory
//   atomics (no one-hot placement and no bf16 splitting: those were answers
//   to the TPU's matrix unit), then streams the tile out coalesced.  Cells
//   past E (the last block's padding) carry F_e = 0 and are skipped.
//   Atomics make the f32 summation order vary from run to run.
//
// Both entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 8;
constexpr int kMatvecThreads = 128;
constexpr int kBuildThreads = 256;

template <int C>
__global__ void __launch_bounds__(kMatvecThreads)
macro_matvec_kernel(const float* __restrict__ FtT, const float* __restrict__ xb,
                    float* __restrict__ yb, int U) {
  extern __shared__ float panel[];  // [U, C] input slots of this block
  const int b = blockIdx.x;
  const float* xblk = xb + static_cast<size_t>(b) * U * C;
  for (int i = threadIdx.x; i < U * C; i += blockDim.x) panel[i] = xblk[i];
  __syncthreads();

  const float* F = FtT + static_cast<size_t>(b) * U * U;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll 8
    for (int v = 0; v < U; ++v) {
      const float f = __ldg(F + static_cast<size_t>(v) * U + u);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(f, panel[v * C + c], acc[c]);
    }
    float* y = yb + (static_cast<size_t>(b) * U + u) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] = acc[c];
  }
}

__global__ void __launch_bounds__(kBuildThreads)
macro_build_kernel(const float* __restrict__ Fe, const int32_t* __restrict__ lidx,
                   float* __restrict__ FtT, int E, int c_blk, int nloc, int U) {
  extern __shared__ float tile[];  // tile[v * U + u] = Ft[b, u, v]
  const int b = blockIdx.x;
  const int UU = U * U;
  for (int i = threadIdx.x; i < UU; i += blockDim.x) tile[i] = 0.f;
  __syncthreads();

  const int nn = nloc * nloc;
  const int cell0 = b * c_blk;
  const int ncell = min(c_blk, E - cell0);
  const int32_t* lb = lidx + static_cast<size_t>(b) * c_blk * nloc;
  const float* Fb = Fe + static_cast<size_t>(cell0) * nn;
  for (int t = threadIdx.x; t < ncell * nn; t += blockDim.x) {
    const int c = t / nn;
    const int r = t - c * nn;
    const int i = r / nloc;
    const int j = r - i * nloc;
    const int u = lb[c * nloc + i];
    const int v = lb[c * nloc + j];
    atomicAdd(&tile[v * U + u], Fb[t]);
  }
  __syncthreads();

  float* out = FtT + static_cast<size_t>(b) * UU;
  for (int i = threadIdx.x; i < UU; i += blockDim.x) out[i] = tile[i];
}

template <int C>
void launch_matvec(const float* FtT, const float* xb, float* yb, int B, int U,
                   cudaStream_t s) {
  const size_t smem = static_cast<size_t>(U) * C * sizeof(float);
  macro_matvec_kernel<C><<<B, kMatvecThreads, smem, s>>>(FtT, xb, yb, U);
}

}  // namespace

extern "C" int ns_macro_matvec_f32(const float* FtT, const float* xb, float* yb,
                                   int B, int U, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  switch (C) {
    case 1: launch_matvec<1>(FtT, xb, yb, B, U, s); break;
    case 2: launch_matvec<2>(FtT, xb, yb, B, U, s); break;
    case 3: launch_matvec<3>(FtT, xb, yb, B, U, s); break;
    case 4: launch_matvec<4>(FtT, xb, yb, B, U, s); break;
    case 5: launch_matvec<5>(FtT, xb, yb, B, U, s); break;
    case 6: launch_matvec<6>(FtT, xb, yb, B, U, s); break;
    case 7: launch_matvec<7>(FtT, xb, yb, B, U, s); break;
    case kMaxC: launch_matvec<kMaxC>(FtT, xb, yb, B, U, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_macro_build_f32(const float* Fe, const int32_t* lidx, float* FtT,
                                  int E, int B, int c_blk, int nloc, int U,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const size_t smem = static_cast<size_t>(U) * U * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      macro_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  macro_build_kernel<<<B, kBuildThreads, smem, s>>>(Fe, lidx, FtT, E, c_blk, nloc, U);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_macro_max_channels() { return kMaxC; }
