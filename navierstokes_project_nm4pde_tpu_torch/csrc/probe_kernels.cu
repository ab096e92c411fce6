// Two measurement probes of the TPU era, written again for Hopper (sm_90a).
//
// Probe E, sgemm_probe: C[m, n] = sum_k A[k, m] B[k, n]   (C = A^T B)
//   Replaces the Pallas kernel `kern` of probe_mxu_rate
//   (scripts/prof_macro_build_kernel.py:74), one f32 [2048, 2048] product
//   contracted over the leading axis of both operands (its DN), which
//   measured the TPU matrix unit's f32 rate.  Here it measures what a plain
//   f32 FMA GEMM reaches on the CUDA cores: no tensor cores, because the
//   port's precision rule keeps TF32 off.  Bound by FMA throughput.
//   Design: 128 x 128 output tile per CTA, 256 threads with 8 x 8 outputs
//   each (rows ty + 16 i, columns tx + 16 j, so that a warp reads shared
//   memory without bank conflicts), k-slices of 8 staged in shared memory;
//   A^T needs no transpose on load because A is read along m.  Edges are
//   guarded, so any shape works.
//
// Probe F, column_gather: out[i, j] = src[idx[i, j], j]
//   Replaces the Pallas kernel gather_kernel (scripts/prof_pallas_gather.py:49),
//   the same-shape take_along_axis that tested row access inside a VMEM
//   window.  Bound by device-memory bytes (or L2, for a source that fits
//   it).  Design: one thread per output element; neighbouring threads
//   write neighbouring addresses.  Exact.  Indices are checked by the
//   wrapper.
//
// Both entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;  // BM = BN
constexpr int kBK = 8;
constexpr int kMicro = 8;   // outputs per thread along each axis
constexpr int kSide = kTile / kMicro;  // 16 x 16 threads
constexpr int kGemmThreads = kSide * kSide;
constexpr int kGatherThreads = 256;

__global__ void __launch_bounds__(kGemmThreads)
sgemm_tn_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[kBK][kTile];
  __shared__ float Bs[kBK][kTile];
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = threadIdx.x; e < kBK * kTile; e += kGemmThreads) {
      const int k = e / kTile;
      const int c = e - k * kTile;
      const int gk = k0 + k;
      As[k][c] = (gk < K && m0 + c < M) ? A[static_cast<size_t>(gk) * M + m0 + c] : 0.f;
      Bs[k][c] = (gk < K && n0 + c < N) ? B[static_cast<size_t>(gk) * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = As[k][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = Bs[k][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int m = m0 + ty + kSide * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int n = n0 + tx + kSide * j;
      if (n < N) C[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

// Index type I: 32-bit arithmetic where the element count allows it (the
// column index is a modulo, which costs several times more in 64 bits).
template <typename I>
__global__ void __launch_bounds__(kGatherThreads)
column_gather_kernel(const float* __restrict__ src, const int32_t* __restrict__ idx,
                     float* __restrict__ out, I total, int width) {
  const I t = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const I j = t % width;
  out[t] = src[static_cast<long long>(idx[t]) * width + j];
}

}  // namespace

extern "C" int ns_sgemm_tn_f32(const float* A, const float* B, float* C, int M, int N,
                               int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  sgemm_tn_kernel<<<grid, kGemmThreads, 0, s>>>(A, B, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_column_gather_f32(const float* src, const int32_t* idx, float* out,
                                    int n_rows, int width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(n_rows) * width;
  if (total <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + kGatherThreads - 1) / kGatherThreads);
  if (total + kGatherThreads <= INT32_MAX) {
    column_gather_kernel<int><<<blocks, kGatherThreads, 0, s>>>(
        src, idx, out, static_cast<int>(total), width);
  } else {
    column_gather_kernel<long long><<<blocks, kGatherThreads, 0, s>>>(src, idx, out, total, width);
  }
  return static_cast<int>(cudaGetLastError());
}
