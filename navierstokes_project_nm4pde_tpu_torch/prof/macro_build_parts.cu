// Variants of kernel B (csrc/macro_kernels.cu macro_build_kernel) that run
// only some of its parts, to measure what bounds it: see
// prof/macro_build_parts.py.  Not linked into the package's kernel library.
//
// Fixed to the main path's shape class: nloc = 10, U = 128, F_e and lidx
// staged by bulk copies (c_blk even).  Template knobs:
//   THREADS  threads of the one CTA an SM;
//   ADDS     adds an item (10: a whole (c, i) row, 2: the committed pairs);
//   TILES    tiles in shared memory (2 committed, 3 tried);
//   PARTS    bits: 1 sum, 2 bulk store, 4 zero the tile;
//   HINT     1: the store marks its lines L2 evict_first (committed).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {
constexpr int NLOC = 10, NN = NLOC * NLOC, U = 128, UU = U * U;

__device__ __forceinline__ uint32_t sa(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int THREADS, int ADDS, int TILES, int PARTS, int HINT>
__global__ void __launch_bounds__(THREADS)
part_kernel(const float* __restrict__ Fe, const int32_t* __restrict__ lidx,
            float* __restrict__ FtT, int E, int B, int c_blk) {
  extern __shared__ __align__(128) float smem[];
  const int fe_stage = c_blk * NN, li_stage = c_blk * NLOC;
  float* tiles = smem;
  float* fe = tiles + TILES * UU;
  int32_t* li = reinterpret_cast<int32_t*>(fe + 2 * fe_stage);
  uint64_t* bar = reinterpret_cast<uint64_t*>(li + 2 * li_stage);
  const int tid = threadIdx.x;
  auto stage_in = [&](int b, int s) {
    const int ncell = min(c_blk, E - b * c_blk);
    const uint32_t fb = ncell * NN * 4, lbytes = c_blk * NLOC * 4;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(sa(bar + s)),
                 "r"(fb + lbytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
                     "r"(sa(fe + s * fe_stage)), "l"(Fe + static_cast<size_t>(b) * c_blk * NN), "r"(fb),
                 "r"(sa(bar + s)) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
                     "r"(sa(li + s * li_stage)), "l"(lidx + static_cast<size_t>(b) * c_blk * NLOC),
                 "r"(lbytes), "r"(sa(bar + s)) : "memory");
  };
  if (tid == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sa(bar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && blockIdx.x < B) stage_in(blockIdx.x, 0);
  int it = 0;
  for (int b = blockIdx.x; b < B; b += gridDim.x, ++it) {
    const int s = it & 1;
    float* tile = tiles + (it % TILES) * UU;
    if (tid == 0) {
      if (b + static_cast<int>(gridDim.x) < B) stage_in(b + gridDim.x, s ^ 1);
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(TILES - 1) : "memory");
    }
    __syncthreads();
    if (PARTS & 4) {
      float4* t4 = reinterpret_cast<float4*>(tile);
      for (int i = tid; i < UU / 4; i += THREADS) t4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int nrows = min(c_blk, E - b * c_blk) * NLOC;
    for (uint32_t done = 0; !done;)
      asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                   "selp.u32 %0, 1, 0, p;\n}\n"
                   : "=r"(done) : "r"(sa(bar + s)), "r"((it >> 1) & 1) : "memory");
    const float* fb = fe + s * fe_stage;
    const int32_t* lb = li + s * li_stage;
    __syncthreads();
    if (PARTS & 1) {
      constexpr int PIECES = NLOC / ADDS;
      for (int t = tid; t < nrows * PIECES; t += THREADS) {
        const int p = t / nrows, r = t - p * nrows;
        const int u = lb[r];
        const int32_t* lc = lb + r / NLOC * NLOC + p * ADDS;
        const float* f = fb + r * NLOC + p * ADDS;
        int v[ADDS];
        float x[ADDS];
#pragma unroll
        for (int k = 0; k < ADDS; ++k) v[k] = lc[k], x[k] = f[k];
#pragma unroll
        for (int k = 0; k < ADDS; ++k) atomicAdd(&tile[v[k] * U + u], x[k]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if ((PARTS & 2) && tid == 0) {
      float* dst = FtT + static_cast<size_t>(b) * UU;
      if (HINT) {
        uint64_t pol;
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(dst),
                     "r"(sa(tile)), "r"(UU * 4), "l"(pol) : "memory");
      } else {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                     "r"(sa(tile)), "r"(UU * 4) : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

using Fn = void (*)(const float*, const int32_t*, float*, int, int, int);
struct Variant {
  Fn fn;
  int threads, tiles;
};
#define V(T, A, NT, P, H) Variant{part_kernel<T, A, NT, P, H>, T, NT}
// Keep in step with VARIANTS in macro_build_parts.py.
const Variant kVariants[] = {
    V(1024, 2, 2, 7, 1),  // 0 the committed design, all parts
    V(1024, 2, 2, 6, 1),  // 1 zero + store: the write-out alone
    V(1024, 2, 2, 5, 1),  // 2 zero + sum, pairs over 1024 threads
    V(256, 10, 2, 5, 1),  // 3 zero + sum, rows over 256 threads
    V(256, 10, 2, 7, 1),  // 4 rows over 256 threads, all parts
    V(1024, 2, 3, 7, 1),  // 5 three tiles
    V(1024, 2, 2, 7, 0),  // 6 no L2 hint on the store
};
}  // namespace

extern "C" int prof_build_variants() { return sizeof(kVariants) / sizeof(kVariants[0]); }

extern "C" int prof_build_run(int var, const float* Fe, const int32_t* lidx, float* FtT, int E,
                              int B, int c_blk, void* stream) {
  const Variant& v = kVariants[var];
  const size_t smem = 4 * (static_cast<size_t>(v.tiles) * UU + 2 * c_blk * NN + 2 * c_blk * NLOC) + 16;
  cudaError_t err = cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v.fn, v.threads, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int grid = std::min(B, std::max(1, sms * per_sm));
  v.fn<<<grid, v.threads, smem, static_cast<cudaStream_t>(stream)>>>(Fe, lidx, FtT, E, B, c_blk);
  return static_cast<int>(cudaGetLastError());
}
