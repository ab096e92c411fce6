// Two measurement probes of the TPU era, written again for Hopper (sm_90a).
//
// Probe E, sgemm_probe: C[m, n] = sum_k A[k, m] B[k, n]   (C = A^T B)
//   Replaces the Pallas kernel `kern` of probe_mxu_rate
//   (scripts/prof_macro_build_kernel.py:74), one f32 [2048, 2048] product
//   contracted over the leading axis of both operands (its DN), which
//   measured the TPU matrix unit's f32 rate.  Here it measures what an
//   exact f32 FMA GEMM reaches on the CUDA cores: no tensor cores, because
//   no tensor-core input type holds an f32 operand exactly and the port's
//   precision rule keeps TF32 off.  Bound by FMA issue, so the design keeps
//   everything else off the FMA pipe's way:
//   - a 128 x 128 output tile per CTA, so [2048]^3 is 256 CTAs: one wave
//     at 2 CTAs an SM (264 slots; 128 x 256 would leave 4 of 132 SMs idle
//     and need 128 accumulators a thread);
//   - k-tiles of 32 in a 3-stage ring of dynamic shared memory (96 KB a
//     CTA, 192 KB for the two on an SM), filled by cp.async without
//     passing through registers, so the loads of tiles k+1 and k+2 are in
//     flight while tile k is multiplied; one barrier a k-tile.  Both
//     operands are k-major (A is [K, M], B [K, N]), so both tiles copy
//     along their contiguous axis with no transpose;
//   - 8 warps as 4 x 2 warp tiles of 32 x 64, lanes as 4 x 8; each thread
//     owns 8 x 8 outputs as 2 x 2 sub-blocks of 4 x 4 (rows r0 + {0..3} and
//     r0 + 16 + {0..3}, columns c0 + {0..3} and c0 + 32 + {0..3}), read from
//     shared memory as four float4 loads (LDS.128) for every 64 FMAs, the
//     next k-step's loads issued before this one's FMAs.  A warp's A reads
//     are 64 contiguous bytes and its B reads 128, so no bank conflicts;
//   - 16-byte copies when M and N are multiples of 4 and the bases are
//     16-byte aligned, else the same kernel with 4-byte copies (template
//     VEC); edges and the K tail are zero-filled by the copies themselves.
//
// Probe F, column_gather: out[i, j] = src[idx[i, j], j]
//   Replaces the Pallas kernel gather_kernel (scripts/prof_pallas_gather.py:49),
//   the same-shape take_along_axis that tested row access inside a VMEM
//   window.  Bound by memory transactions: every output costs one random
//   4-byte read of the source (a 32-byte sector, from L2 for a source that
//   fits it) beside the streamed index and output.  Design: one thread
//   handles 4 consecutive columns of one row (one 16-byte index load, four
//   source loads, one 16-byte store) in a 2D grid of rows by column groups,
//   so no thread divides by the width; a scalar instantiation (VEC = 1)
//   takes any other width.  Exact.  Indices are checked by the wrapper.
//
// Both entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;  // BM = BN
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kGemmThreads = 256;  // 8 warps, 8 x 8 outputs a thread
constexpr int kStageFloats = kBK * 2 * kTile;  // A tile, then B tile
constexpr int kGemmSmem = kStages * kStageFloats * static_cast<int>(sizeof(float));
constexpr int kGatherThreads = 256;

// Copy BYTES (16 or 4) from global to shared memory asynchronously; write
// zeros instead when `in` is false (`src` must still be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of k-tile [k0, k0 + kBK) into ring slot `buf`: A's
// [kBK][kTile] then B's, rows past K and columns past M or N zero-filled.
template <int VEC>
__device__ __forceinline__ void load_tile(float* buf, const float* A, const float* B, int M,
                                          int N, int K, int m0, int n0, int k0) {
  constexpr int kPerRow = kTile / VEC;
  constexpr int kRounds = kBK * kPerRow / kGemmThreads;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int e = threadIdx.x + r * kGemmThreads;
    const int k = e / kPerRow;
    const int c = (e % kPerRow) * VEC;
    const int gk = k0 + k;
    const bool a_in = gk < K && m0 + c < M;
    const bool b_in = gk < K && n0 + c < N;
    cp_async<4 * VEC>(buf + k * kTile + c, a_in ? A + static_cast<size_t>(gk) * M + m0 + c : A,
                      a_in);
    cp_async<4 * VEC>(buf + (kBK + k) * kTile + c,
                      b_in ? B + static_cast<size_t>(gk) * N + n0 + c : B, b_in);
  }
}

// A thread's k-step operands: rows r0 + {0..3}, r0 + 16 + {0..3} of A^T
// and columns c0 + {0..3}, c0 + 32 + {0..3} of B, as four float4 loads.
__device__ __forceinline__ void load_frags(const float* As, const float* Bs, int r0, int c0,
                                           float (&a)[8], float (&b)[8]) {
  const float4 a0 = *reinterpret_cast<const float4*>(As + r0);
  const float4 a1 = *reinterpret_cast<const float4*>(As + r0 + 16);
  const float4 b0 = *reinterpret_cast<const float4*>(Bs + c0);
  const float4 b1 = *reinterpret_cast<const float4*>(Bs + c0 + 32);
  a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
  a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
  b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
  b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
}

// Two CTAs an SM cap a thread at 128 registers; the 4-byte copies' 16
// address rounds a k-tile do not fit beside the 64 accumulators there, so
// that instantiation runs one CTA an SM instead of spilling.
template <int VEC>
__global__ void __launch_bounds__(kGemmThreads, VEC == 4 ? 2 : 1)
sgemm_tn_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, int M, int N, int K) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = (warp / 2) * 32 + (lane / 8) * 4;
  const int c0 = (warp % 2) * 64 + (lane % 8) * 4;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int n_tiles = (K + kBK - 1) / kBK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // Prologue: tiles 0 .. kStages-2 in flight (a group each, empty past K).
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile<VEC>(smem + s * kStageFloats, A, B, M, N, K, m0, n0, s * kBK);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t have landed
    __syncthreads();               // everyone's have, and tile t-1 is consumed
    const int next = t + kStages - 1;
    if (next < n_tiles)
      load_tile<VEC>(smem + (next % kStages) * kStageFloats, A, B, M, N, K, m0, n0, next * kBK);
    cp_async_commit();
    const float* As = smem + (t % kStages) * kStageFloats;
    const float* Bs = As + kBK * kTile;
    float a[2][8], b[2][8];
    load_frags(As, Bs, r0, c0, a[0], b[0]);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      if (k + 1 < kBK)
        load_frags(As + (k + 1) * kTile, Bs + (k + 1) * kTile, r0, c0, a[(k + 1) % 2], b[(k + 1) % 2]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[k % 2][i], b[k % 2][j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + r0 + (i / 4) * 16 + i % 4;
    if (m >= M) continue;
    float* row = C + static_cast<size_t>(m) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + c0 + h * 32;
      if constexpr (VEC == 4) {
        if (n < N)
          *reinterpret_cast<float4*>(row + n) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) row[n + j] = acc[i][4 * h + j];
      }
    }
  }
}

template <int VEC>
int launch_sgemm(const float* A, const float* B, float* C, int M, int N, int K,
                 cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      sgemm_tn_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  sgemm_tn_kernel<VEC><<<grid, kGemmThreads, kGemmSmem, s>>>(A, B, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// Thread (x, y) of a block gathers columns [VEC g, VEC g + VEC) of row i,
// g and i from the 2D grid (rows on x, which has no 65,535 limit).
template <int VEC>
__global__ void __launch_bounds__(kGatherThreads)
column_gather_kernel(const float* __restrict__ src, const int32_t* __restrict__ idx,
                     float* __restrict__ out, int n_rows, int width) {
  const int i = blockIdx.x * blockDim.y + threadIdx.y;
  const int j = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (i >= n_rows || j >= width) return;
  const size_t o = static_cast<size_t>(i) * width + j;
  if constexpr (VEC == 4) {
    const int4 r = __ldg(reinterpret_cast<const int4*>(idx + o));
    const float4 v = make_float4(__ldg(src + static_cast<size_t>(r.x) * width + j),
                                 __ldg(src + static_cast<size_t>(r.y) * width + j + 1),
                                 __ldg(src + static_cast<size_t>(r.z) * width + j + 2),
                                 __ldg(src + static_cast<size_t>(r.w) * width + j + 3));
    *reinterpret_cast<float4*>(out + o) = v;
  } else {
    out[o] = __ldg(src + static_cast<size_t>(__ldg(idx + o)) * width + j);
  }
}

template <int VEC>
int launch_gather(const float* src, const int32_t* idx, float* out, int n_rows, int width,
                  cudaStream_t s) {
  const int groups = width / VEC;
  const int bx = groups < 32 ? groups : 32;
  const dim3 block(bx, kGatherThreads / bx);
  const dim3 grid((n_rows + block.y - 1) / block.y, (groups + bx - 1) / bx);
  column_gather_kernel<VEC><<<grid, block, 0, s>>>(src, idx, out, n_rows, width);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int ns_sgemm_tn_f32(const float* A, const float* B, float* C, int M, int N,
                               int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (M % 4 == 0 && N % 4 == 0 && aligned16(A) && aligned16(B) && aligned16(C))
    return launch_sgemm<4>(A, B, C, M, N, K, s);
  return launch_sgemm<1>(A, B, C, M, N, K, s);
}

extern "C" int ns_column_gather_f32(const float* src, const int32_t* idx, float* out,
                                    int n_rows, int width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || width <= 0) return 0;
  if (width % 4 == 0 && aligned16(idx) && aligned16(out))
    return launch_gather<4>(src, idx, out, n_rows, width, s);
  return launch_gather<1>(src, idx, out, n_rows, width, s);
}
