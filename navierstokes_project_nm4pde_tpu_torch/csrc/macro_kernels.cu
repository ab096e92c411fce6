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
//   and reads F_e (87 MB) and lidx (9 MB); 88% of the bytes are the tile
//   write-out.  Each block's [U, U] f32 tile is summed in shared memory
//   with shared-memory atomics (no one-hot placement and no bf16 splitting:
//   those were answers to the TPU's matrix unit).  Cells past E (the last
//   block's padding) carry F_e = 0 and are skipped.  Atomics make the f32
//   summation order vary from run to run.
//
//   The design keeps tile writes in flight at all times.  Persistent CTAs
//   (as many as fit on the SMs at once; one an SM at U = 128) walk the
//   blocks b = blockIdx.x, += gridDim.x with two tiles in dynamic shared
//   memory: while the Tensor Memory Accelerator writes block k's tile out
//   (one cp.async.bulk store of U*U*4 bytes, issued by one thread, so the
//   threads spend no instructions on the 712 MB stream), the CTA zeroes
//   the other tile with 16-byte stores and sums block k+1 into it.  A
//   tile is zeroed again only after cp.async.bulk.wait_group.read says its
//   store has read it.  Block k+1's F_e (c_blk x nloc^2 floats) and lidx
//   (c_blk x nloc ints) come into a second pair of stage buffers by
//   cp.async.bulk on an mbarrier, issued one block ahead, so the sum reads
//   shared memory only.  The sum is bound by the latency of shared-memory
//   f32 atomics (compare-and-swap loops on Hopper), so 1024 threads each
//   take two adds of a (c, i) row: u = lidx[c, i] once, then
//   tile[v * U + u] += F_e[c, i, j] for its two j.
//   Where the inputs' sizes or bases are not 16-byte multiples (an odd
//   c_blk), the sum reads F_e and lidx from global memory instead.
//   macro_build_v1 is the earlier design (one CTA a block, zero / sum /
//   copy out in sequence, one tile), kept to time the two in turns.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxC = 8;
constexpr int kMatvecThreads = 128;
constexpr int kBuildV1Threads = 256;
// Kernel B: one CTA of 1024 threads an SM; each thread adds kBuildAdds
// values of a (c, i) row.  Hopper has no shared-memory f32 add: atomicAdd
// there is a compare-and-swap loop (ATOMS.CAST.SPIN), so what bounds the
// sum is the latency of those loops, and short chains over many threads
// hide it (at the 965k-DoF shape, zero + sum without the write-out: rows
// of 10 adds over 256 threads 0.32 ms, pairs over 1024 threads 0.16 ms,
// by prof/macro_build_parts.py on an H100 80GB HBM3 at 700 W).
constexpr int kBuildThreads = 1024;
constexpr int kBuildAdds = 2;

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

__global__ void __launch_bounds__(kBuildV1Threads)
macro_build_v1_kernel(const float* __restrict__ Fe, const int32_t* __restrict__ lidx,
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

// ---- kernel B: PTX helpers for the bulk copies and mbarriers ----------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, tracked by this thread's bulk async-groups; the lines
// are marked first to leave L2 (nothing reads them again in this kernel)
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::
                   "l"(dst),
               "r"(smem_addr(src)), "r"(bytes), "l"(policy)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Shared memory of kernel B: two [U, U] tiles, then two F_e stages and two
// lidx stages (each rounded to 16 bytes), then two mbarriers.
size_t build_smem_bytes(int c_blk, int nloc, int U) {
  return sizeof(float) * (2 * static_cast<size_t>(U) * U + 2 * round4(c_blk * nloc * nloc) +
                          2 * round4(c_blk * nloc)) +
         2 * sizeof(uint64_t);
}

__global__ void __launch_bounds__(kBuildThreads)
macro_build_kernel(const float* __restrict__ Fe, const int32_t* __restrict__ lidx,
                   float* __restrict__ FtT, int E, int B, int c_blk, int nloc, int U,
                   int bulk_in) {
  extern __shared__ __align__(128) float smem[];
  const int UU = U * U, nn = nloc * nloc;
  const int fe_stage = round4(c_blk * nn), li_stage = round4(c_blk * nloc);
  float* tiles = smem;                 // tiles[s * UU + v * U + u] = Ft[b, u, v]
  float* fe = tiles + 2 * UU;          // F_e of a block, stage s at s * fe_stage
  int32_t* li = reinterpret_cast<int32_t*>(fe + 2 * fe_stage);
  uint64_t* bar = reinterpret_cast<uint64_t*>(li + 2 * li_stage);
  const int tid = threadIdx.x;

  // one thread: stage block b's F_e and lidx into buffer s
  auto stage_in = [&](int b, int s) {
    const int ncell = min(c_blk, E - b * c_blk);
    const uint32_t fe_bytes = ncell * nn * sizeof(float);
    const uint32_t li_bytes = c_blk * nloc * sizeof(int32_t);
    mbar_expect_tx(bar + s, fe_bytes + li_bytes);
    bulk_load(fe + s * fe_stage, Fe + static_cast<size_t>(b) * c_blk * nn, fe_bytes, bar + s);
    bulk_load(li + s * li_stage, lidx + static_cast<size_t>(b) * c_blk * nloc, li_bytes,
              bar + s);
  };

  if (bulk_in && tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (bulk_in && tid == 0 && blockIdx.x < B) stage_in(blockIdx.x, 0);

  int it = 0;
  for (int b = blockIdx.x; b < B; b += gridDim.x, ++it) {
    const int s = it & 1;
    float* tile = tiles + s * UU;
    if (tid == 0) {
      if (bulk_in && b + static_cast<int>(gridDim.x) < B) stage_in(b + gridDim.x, s ^ 1);
      // tile s was last written out two blocks ago: wait until that store
      // has read it (the previous block's store may still be in flight)
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    }
    __syncthreads();
    float4* t4 = reinterpret_cast<float4*>(tile);
    for (int i = tid; i < UU / 4; i += kBuildThreads) t4[i] = make_float4(0.f, 0.f, 0.f, 0.f);

    const int ncell = min(c_blk, E - b * c_blk);
    const float* fb = Fe + static_cast<size_t>(b) * c_blk * nn;
    const int32_t* lb = lidx + static_cast<size_t>(b) * c_blk * nloc;
    if (bulk_in) {
      mbar_wait(bar + s, (it >> 1) & 1);
      fb = fe + s * fe_stage;
      lb = li + s * li_stage;
    }
    __syncthreads();  // the tile is zero before any thread adds to it

    // item t: adds j in [j0, j0 + kBuildAdds) of row r = (c, i); the lanes
    // of a warp take consecutive rows, so their u (and banks) differ
    const int nrows = ncell * nloc;
    const int pieces = (nloc + kBuildAdds - 1) / kBuildAdds;
    for (int t = tid; t < nrows * pieces; t += kBuildThreads) {
      const int p = t / nrows, r = t - p * nrows;
      const int u = lb[r];
      const int j0 = p * kBuildAdds, c0 = r / nloc * nloc;
      int v[kBuildAdds];
      float x[kBuildAdds];
#pragma unroll
      for (int k = 0; k < kBuildAdds; ++k) {
        const bool in = j0 + k < nloc;
        v[k] = in ? lb[c0 + j0 + k] : -1;
        x[k] = in ? fb[r * nloc + j0 + k] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBuildAdds; ++k)
        if (v[k] >= 0) atomicAdd(&tile[v[k] * U + u], x[k]);
    }
    // make the generic-proxy adds visible to the bulk store, then issue it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) bulk_store(FtT + static_cast<size_t>(b) * UU, tile, UU * sizeof(float));
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // the tile store needs 16-byte sizes and bases: U even, FtT aligned
  if (U % 2 != 0 || !aligned(FtT)) return static_cast<int>(cudaErrorInvalidValue);
  const int bulk_in = (nloc * nloc) % 4 == 0 && (c_blk * nloc) % 4 == 0 && aligned(Fe) &&
                      aligned(lidx);
  const size_t smem = build_smem_bytes(c_blk, nloc, U);
  cudaError_t err = cudaFuncSetAttribute(
      macro_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, macro_build_kernel,
                                                           kBuildThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int grid = std::min(B, std::max(1, sms * per_sm));
  macro_build_kernel<<<grid, kBuildThreads, smem, s>>>(Fe, lidx, FtT, E, B, c_blk, nloc, U,
                                                        bulk_in);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_macro_build_v1_f32(const float* Fe, const int32_t* lidx, float* FtT,
                                     int E, int B, int c_blk, int nloc, int U,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const size_t smem = static_cast<size_t>(U) * U * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      macro_build_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  macro_build_v1_kernel<<<B, kBuildV1Threads, smem, s>>>(Fe, lidx, FtT, E, c_blk, nloc, U);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ns_macro_build_smem_bytes(int c_blk, int nloc, int U) {
  return static_cast<int>(build_smem_bytes(c_blk, nloc, U));
}

extern "C" int ns_macro_max_channels() { return kMaxC; }
