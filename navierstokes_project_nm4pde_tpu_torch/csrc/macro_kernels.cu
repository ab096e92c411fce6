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
//   registers, the block's [U, C] input panel staged in shared memory (rows
//   padded to 16-byte vectors) and broadcast to all threads, four channels
//   a load.  The block's values stream through a ring of 4 shared-memory
//   stages of 16 rows (8 KB at U = 128), filled by 16-byte cp.async three
//   stages ahead, so the bytes in flight do not depend on the registers
//   the accumulators take: read straight from global memory, each thread
//   kept 8 loads in flight, and the wider C's registers cut the threads
//   an SM holds (C = 15: 0.3953 ms, C = 24: 0.5474, against bounds of
//   0.2623 and 0.2922; 16-byte panel loads alone did not help: 0.4078 /
//   0.5642; H100 80GB HBM3, 700 W).  Thread u reads column u of a staged
//   row, so a warp reads 128 contiguous bytes (no bank conflict).  The
//   block's output is staged in shared memory and stored coalesced.  All C
//   channels ride one pass over the values, for any C up to kMaxC = 24:
//   the recycled-block GCR's wide round takes 3 (k + 1) channels at
//   f_recycle = k, the warm-start rhs pass 3 + 3k at f_warmstart = k.  A
//   launch reads and writes a channel slice of wider rows (row strides
//   ldx, ldy), so the wrapper splits a payload past 24 channels into
//   launches of at most 24 that write their slices of one output; each
//   launch reads the values once more.  Past U = 256 output columns (one
//   thread each) the block's columns u are split into bands of at most 256
//   (a multiple of 32, balanced: 192 at U = 384, 256 at U = 512), a CTA a
//   (block, band), the band's CTAs neighbours: each stages the whole [U, C]
//   panel and reads its band's column segment of every FtT row (row
//   stride U), so FtT is still read once (U = 384 on the 965k-DoF mesh:
//   0.8772 ms, 92.3% of its bound; H100 80GB HBM3, 700 W).  The panel
//   and the ring share the CTA's shared memory.  Up to U = 2,336 narrower
//   bands make room for a wider panel (down to 32 columns: 24 float
//   channels at U = 2,336).  Past that, where the whole panel does not fit
//   beside bands of 256 columns (U past 10,432 at 3 float channels, 3,168
//   at 3 double ones), the panel is staged in chunks of P rows as the FtT
//   row chunks reach them, the accumulators staying in registers across
//   chunks (P leaves room for two CTAs an SM, so that one streams FtT while
//   the other stages).
//   Narrower channel slices would fit too, but each reads FtT once more.
//   (Two blocks at U = 14,464, C = 3: 0.8559 ms, 58.4% of the bound, in
//   double 81.7%; at U = 2,560, C = 24 the 20 CTAs of two blocks leave most
//   SMs idle: 4.6%; H100 80GB HBM3, 700 W.)
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
//   The earlier design, one tile (launch_build_v1: one CTA a block, zero /
//   sum / copy out in sequence; its sum in the same row pairs), is kernel
//   B's float64 form and float32's past two tiles.
//
//   Wide blocks (the JAX package's numerics.macro_u runs any lane multiple
//   of 128; its profile measured U = 192 and 256): two [U, U] f32 tiles
//   and the stages fit one CTA's shared memory up to U = 162 at c_blk 20,
//   so past that each block's tile is split into bands of R rows v (the
//   most that fit, balanced over ceil(U / R) bands; 96 at U = 192, c_blk
//   34; 86 at U = 256, c_blk 48).  A work item is a (block, band): its CTA
//   zeroes an [R, U] tile, adds the block's F_e entries whose row v falls
//   in the band, and writes the band out with one bulk store (the band's
//   rows are contiguous in FtT).  Each band stages the block's F_e and
//   lidx again (19 KB at c_blk 48, against a 256 KB output block); items
//   are numbered band-fastest, so a block's bands run on neighbouring
//   CTAs at the same time and the re-reads come from L2.  The one-tile
//   design (float64, v1) bands the same way with a CTA an item.  Where not
//   even one band of two tiles fits (at c_blk 20, past U = 13,427 where U
//   is not a multiple of 4, past 26,854 where it is), float32 takes the one-tile
//   design, whose single tile holds twice the rows, and past one tile row
//   (U = 29,056 in float64) that design bands the columns too: a work item
//   is an [R, W] sub-tile, which still scans its block's F_e and writes its
//   R row segments of W values (one float32 block at U = 29,058: 69.7% of
//   the bound; float64 at 29,184: 97.8%; H100 80GB HBM3, 700 W).  A block
//   whose tiles fit keeps the unbanded kernel (a template instance), and
//   the row bands theirs.  On
//   the 965k-DoF mesh the bands hold the unbanded share of the bound: U =
//   192 0.3880 ms, 256 0.4885 ms, 384 1.0188 ms (78-81%; U = 128 0.2959,
//   81.5%), in float64 0.8103 / 0.9408 / 1.9244 ms (76-86%; H100 80GB
//   HBM3, 700 W).
//
// Float64 (the _f64 entry points; the float64 runs): kernel A is the same
// template in double, its panel in 16-byte double2 vectors of 2 channels,
// its ring of FtT stages twice as wide in bytes (64 KB at U = 128), and up
// to kMaxC64 channels a launch, since each thread holds C double
// accumulators (twice the registers of float's).  Kernel B in double cannot
// hold two [U, U] tiles (2 x 128 KB at U = 128, past the 227 KB a block may
// have), so ns_macro_build_f64 runs the one-tile design in double (one
// template for both types): a CTA a block, zero, sum with shared-memory
// atomicAdd on doubles (a native instruction on sm_90, not a
// compare-and-swap loop), then copy out with 16-byte stores.  Both stay
// bound by device-memory bytes, which double doubles (FtT 1.42 GB at the
// 965k-DoF bench mesh).
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxC = 24;    // kernel A's widest float payload a launch
constexpr int kMaxC64 = 12;  // and double's
// Shared memory a block may use on Hopper (227 KB, opt-in past 48 KB).
constexpr size_t kMaxSmem = 232448;
// Kernel A: up to kMatvecMaxW output columns a CTA (a thread each; a wider
// block's columns in bands), FtT streamed through a ring of kMatvecStages
// shared-memory stages of kMatvecRows rows.
constexpr int kMatvecMaxW = 256;
constexpr int kMatvecRows = 16;
constexpr int kMatvecStages = 4;
// Kernel B: one CTA of 1024 threads an SM; each thread adds kBuildAdds
// values of a (c, i) row.  Hopper has no shared-memory f32 add: atomicAdd
// there is a compare-and-swap loop (ATOMS.CAST.SPIN), so what bounds the
// sum is the latency of those loops, and short chains over many threads
// hide it (at the 965k-DoF shape, zero + sum without the write-out: rows
// of 10 adds over 256 threads 0.32 ms, pairs over 1024 threads 0.16 ms,
// by prof/macro_build_parts.py on an H100 80GB HBM3 at 700 W).
constexpr int kBuildThreads = 1024;
constexpr int kBuildAdds = 2;
// Kernel B's one-tile design (its float64 build, and float's earlier
// design): 1024 threads a block.
constexpr int kBuildV1Threads = 1024;

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

// Shared memory of kernel B besides its two tiles: two F_e stages and two
// lidx stages (each rounded to 16 bytes), then two mbarriers.
size_t build_stage_bytes(int c_blk, int nloc) {
  return sizeof(float) * (2 * round4(c_blk * nloc * nloc) + 2 * round4(c_blk * nloc)) +
         2 * sizeof(uint64_t);
}

// The rows R of a band of a block's [U, U] tile (kernel B, both designs):
// U where `fixed` bytes and U rows of `row_bytes` fit one CTA's shared
// memory; else the most rows that fit, balanced over ceil(U / R) bands and
// even where U is not a multiple of 4 (so every band is a whole number of
// 16-byte vectors at a 16-byte aligned row); 0 if not even that fits.
int band_rows(int U, size_t row_bytes, size_t fixed) {
  if (fixed + U * row_bytes <= kMaxSmem) return U;
  const int g = U % 4 == 0 ? 1 : 2;
  const int rmax = fixed >= kMaxSmem ? 0 : static_cast<int>((kMaxSmem - fixed) / row_bytes) / g * g;
  if (rmax <= 0) return 0;
  const int nb = (U + rmax - 1) / rmax;
  return ((U + nb - 1) / nb + g - 1) / g * g;
}

// BANDED: a work item is a band of R rows v of a block's tile (R < U);
// else a whole block (R = U), the design as it was before bands.
template <bool BANDED>
__global__ void __launch_bounds__(kBuildThreads)
macro_build_kernel(const float* __restrict__ Fe, const int32_t* __restrict__ lidx,
                   float* __restrict__ FtT, int E, int B, int c_blk, int nloc, int U,
                   int R, int bulk_in) {
  extern __shared__ __align__(128) float smem[];
  const int UU = U * U, nn = nloc * nloc;
  const int RU = BANDED ? R * U : UU;             // a tile
  const int nb = BANDED ? (U + R - 1) / R : 1;    // bands a block
  const int items = B * nb;                       // item w: block w / nb, band w % nb
  const int fe_stage = round4(c_blk * nn), li_stage = round4(c_blk * nloc);
  float* tiles = smem;                 // tiles[s * RU + (v - v0) * U + u] = Ft[b, u, v]
  float* fe = tiles + 2 * RU;          // F_e of a block, stage s at s * fe_stage
  int32_t* li = reinterpret_cast<int32_t*>(fe + 2 * fe_stage);
  uint64_t* bar = reinterpret_cast<uint64_t*>(li + 2 * li_stage);
  const int tid = threadIdx.x;

  // one thread: stage item w's block's F_e and lidx into buffer s
  auto stage_in = [&](int w, int s) {
    const int b = BANDED ? w / nb : w;
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
  if (bulk_in && tid == 0 && blockIdx.x < items) stage_in(blockIdx.x, 0);

  int it = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x, ++it) {
    const int b = BANDED ? w / nb : w;
    const int v0 = BANDED ? (w - b * nb) * R : 0;       // the band's first row
    const int rows = BANDED ? min(R, U - v0) : U;
    const int s = it & 1;
    float* tile = tiles + s * RU;
    if (tid == 0) {
      if (bulk_in && w + static_cast<int>(gridDim.x) < items) stage_in(w + gridDim.x, s ^ 1);
      // tile s was last written out two items ago: wait until that store
      // has read it (the previous item's store may still be in flight)
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    }
    __syncthreads();
    float4* t4 = reinterpret_cast<float4*>(tile);
    for (int i = tid; i < rows * U / 4; i += kBuildThreads) t4[i] = make_float4(0.f, 0.f, 0.f, 0.f);

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
    // of a warp take consecutive rows, so their u (and banks) differ; a
    // band keeps the adds of its rows v only
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
        v[k] = in ? lb[c0 + j0 + k] - v0 : -1;
        x[k] = in ? fb[r * nloc + j0 + k] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBuildAdds; ++k)
        if (BANDED ? static_cast<unsigned>(v[k]) < static_cast<unsigned>(rows) : v[k] >= 0)
          atomicAdd(&tile[v[k] * U + u], x[k]);
    }
    // make the generic-proxy adds visible to the bulk store, then issue it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0)
      bulk_store(FtT + static_cast<size_t>(b) * UU + static_cast<size_t>(v0) * U, tile,
                 rows * U * sizeof(float));
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- kernel A ------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Kernel A's element types: a 16-byte vector of L channels, an FMA of a
// value into its L accumulators, a one-element asynchronous copy.
template <typename T>
struct MvType;
template <>
struct MvType<float> {
  using V = float4;
  static constexpr int L = 4;
  __device__ static void fma_vec(float f, float4 x, float* acc) {
    acc[0] = fmaf(f, x.x, acc[0]);
    acc[1] = fmaf(f, x.y, acc[1]);
    acc[2] = fmaf(f, x.z, acc[2]);
    acc[3] = fmaf(f, x.w, acc[3]);
  }
  __device__ static void copy1(void* dst, const void* src) { cp_async4(dst, src); }
};
template <>
struct MvType<double> {
  using V = double2;
  static constexpr int L = 2;
  __device__ static void fma_vec(double f, double2 x, double* acc) {
    acc[0] = fma(f, x.x, acc[0]);
    acc[1] = fma(f, x.y, acc[1]);
  }
  __device__ static void copy1(void* dst, const void* src) { cp_async8(dst, src); }
};

// ---- kernel B, one tile a CTA: float64's build, float32's earlier design
// One CTA a block: zero the [U, U] tile, sum the block's cells into it two
// adds of a (c, i) row a thread, as kernel B does (the lanes of a warp take
// consecutive rows, so their u and banks differ; one add an item in (c, i,
// j) order put a row's adds on one bank, and took 0.8788 ms in float64
// against 0.6020 at the 965k-DoF shape, H100 80GB HBM3, 700 W), with
// shared-memory atomicAdd (on doubles a native instruction on sm_90), then
// copy it out.  Zero and copy go in 16-byte vectors where the tile is a
// whole number of them and the output's base is aligned.  BANDED: a CTA
// a band of R rows v of a block's tile (the bands of a block on
// neighbouring CTAs), its sum keeping the adds of its rows only.  COLS
// (with BANDED; where not even one band of whole rows fits): a CTA an
// [R, W] sub-tile, rows [v0, v0 + R) by columns [u0, u0 + W), numbered
// column-band fastest; its sum keeps the adds that fall in it, and its rows
// go out one segment of W values each, strided by U.
template <typename T, bool BANDED, bool COLS>
__global__ void __launch_bounds__(kBuildV1Threads)
macro_build_v1_kernel(const T* __restrict__ Fe, const int32_t* __restrict__ lidx,
                      T* __restrict__ FtT, int E, int c_blk, int nloc, int U, int R, int W) {
  using V = typename MvType<T>::V;
  constexpr int L = MvType<T>::L;
  extern __shared__ __align__(16) unsigned char v1_smem[];
  T* tile = reinterpret_cast<T*>(v1_smem);  // tile[(v - v0) * TW + u - u0] = Ft[b, u, v]
  const int tid = threadIdx.x;
  const int nbu = COLS ? (U + W - 1) / W : 1;
  const int nb = (BANDED ? (U + R - 1) / R : 1) * nbu;  // items a block
  const int b = blockIdx.x / nb, item = blockIdx.x - b * nb;
  const int v0 = BANDED ? item / nbu * R : 0;
  const int u0 = COLS ? (item - item / nbu * nbu) * W : 0;
  const int rows = BANDED ? min(R, U - v0) : U;
  const int TW = COLS ? W : U;            // the tile's row stride
  const int cols = COLS ? min(W, U - u0) : U;
  const int n = rows * TW;  // the values of the tile
  T* out = FtT + static_cast<size_t>(b) * U * U + static_cast<size_t>(v0) * U + u0;
  // COLS: every row segment is 16-byte aligned when its stride U is
  const bool vec = COLS ? (U * sizeof(T)) % 16 == 0 && cols % L == 0 &&
                              reinterpret_cast<uintptr_t>(out) % 16 == 0
                        : n % L == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec || COLS) {  // COLS: TW (a multiple of 32) rows of whole vectors
    V* t = reinterpret_cast<V*>(tile);
    for (int i = tid; i < n / L; i += kBuildV1Threads) t[i] = V{};
  } else {
    for (int i = tid; i < n; i += kBuildV1Threads) tile[i] = T(0);
  }
  __syncthreads();

  const int ncell = min(c_blk, E - b * c_blk);
  const T* fb = Fe + static_cast<size_t>(b) * c_blk * nloc * nloc;
  const int32_t* lb = lidx + static_cast<size_t>(b) * c_blk * nloc;
  const int nrows = ncell * nloc;
  const int pieces = (nloc + kBuildAdds - 1) / kBuildAdds;
  for (int t = tid; t < nrows * pieces; t += kBuildV1Threads) {
    const int p = t / nrows, r = t - p * nrows;
    const int u = lb[r] - u0;
    if (COLS && static_cast<unsigned>(u) >= static_cast<unsigned>(cols)) continue;
    const int j0 = p * kBuildAdds, c0 = r / nloc * nloc;
#pragma unroll
    for (int k = 0; k < kBuildAdds; ++k) {
      if (j0 + k < nloc) {
        const int v = lb[c0 + j0 + k] - v0;
        if (!BANDED || static_cast<unsigned>(v) < static_cast<unsigned>(rows))
          atomicAdd(&tile[v * TW + u], fb[r * nloc + j0 + k]);
      }
    }
  }
  __syncthreads();

  if (COLS) {
    if (vec) {
      const V* t = reinterpret_cast<const V*>(tile);
      const int nv = cols / L, tv = TW / L;
      for (int i = tid; i < rows * nv; i += kBuildV1Threads) {
        const int r = i / nv, c = i - r * nv;
        reinterpret_cast<V*>(out + static_cast<size_t>(r) * U)[c] = t[r * tv + c];
      }
    } else {
      for (int i = tid; i < rows * cols; i += kBuildV1Threads) {
        const int r = i / cols, c = i - r * cols;
        out[static_cast<size_t>(r) * U + c] = tile[r * TW + c];
      }
    }
  } else if (vec) {
    const V* t = reinterpret_cast<const V*>(tile);
    V* o = reinterpret_cast<V*>(out);
    for (int i = tid; i < n / L; i += kBuildV1Threads) o[i] = t[i];
  } else {
    for (int i = tid; i < n; i += kBuildV1Threads) out[i] = tile[i];
  }
}

// The one-tile design's tile: R rows (band_rows: U where the whole [U, U]
// tile fits) by W = U columns; where not even a band of rows fits (double
// past U = 29,056, float past 58,112; half that where U is not a multiple
// of 4), column bands of W, a multiple of 32 near kBuildColBytes of a row
// (balanced over the bands), and as many rows R as fit (balanced).
constexpr size_t kBuildColBytes = 16384;

struct BuildTile {
  int R, W;
};

BuildTile v1_tile(int U, size_t elem) {
  const int R = band_rows(U, U * elem, 0);
  if (R > 0) return {R, U};
  const int wmax = static_cast<int>(kBuildColBytes / elem);
  const int nbu = (U + wmax - 1) / wmax;
  const int W = ((U + nbu - 1) / nbu + 31) / 32 * 32;
  const int rmax = static_cast<int>(kMaxSmem / (W * elem));
  const int nbv = (U + rmax - 1) / rmax;
  return {(U + nbv - 1) / nbv, W};
}

template <typename T>
int launch_build_v1(const T* Fe, const int32_t* lidx, T* FtT, int E, int B, int c_blk,
                    int nloc, int U, cudaStream_t s) {
  if (B <= 0) return 0;
  const BuildTile tl = v1_tile(U, sizeof(T));
  const size_t smem = static_cast<size_t>(tl.R) * tl.W * sizeof(T);
  auto kernel = tl.W < U   ? macro_build_v1_kernel<T, true, true>
                : tl.R < U ? macro_build_v1_kernel<T, true, false>
                           : macro_build_v1_kernel<T, false, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = ((U + tl.R - 1) / tl.R) * ((U + tl.W - 1) / tl.W);
  kernel<<<B * items, kBuildV1Threads, smem, s>>>(Fe, lidx, FtT, E, c_blk, nloc, U, tl.R,
                                                  tl.W);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of kernel A at W output columns a CTA and P staged panel
// rows: the [P, CV] panel of 16-byte vectors, then the ring of W-wide FtT
// stages, which at the end holds the [W, C | 1] output.
template <typename T>
size_t matvec_smem_bytes(int C, int P, int W) {
  constexpr int L = MvType<T>::L;
  const size_t ring = std::max(kMatvecStages * kMatvecRows, C | 1) * static_cast<size_t>(W);
  return static_cast<size_t>(P) * ((C + L - 1) / L) * 16 + ring * sizeof(T);
}

// Kernel A's shape at C channels: W output columns a CTA and P panel rows
// staged at a time.  W = U up to kMatvecMaxW, else bands of kMatvecMaxW
// balanced over the block; the whole [U, C] panel is staged at once (P = U)
// where it fits beside them.  Up to kMatvecNarrowMaxU (the widest block
// that design took at every channel count: 24 float channels) the bands
// narrow, to a multiple of 32, until it does (the design before panel
// chunks, unchanged).  Otherwise the panel is staged in chunks of P rows, a
// multiple of kMatvecRows: as many as leave room for two CTAs an SM (one
// stages its chunk while the other streams FtT), or, where the ring alone
// takes half (double's), as many as fit beside it.
constexpr int kMatvecNarrowMaxU = 2336;

struct MvShape {
  int W, P;
};

template <typename T>
MvShape matvec_shape(int C, int U) {
  if (U <= kMatvecMaxW && matvec_smem_bytes<T>(C, U, U) <= kMaxSmem) return {U, U};
  int w = kMatvecMaxW;
  if (U <= kMatvecNarrowMaxU) {
    while (w >= 32 && matvec_smem_bytes<T>(C, U, w) > kMaxSmem) w -= 32;
    if (w < 32) w = kMatvecMaxW;
  }
  const int nb = (U + w - 1) / w;
  const int W = ((U + nb - 1) / nb + 31) / 32 * 32;
  if (matvec_smem_bytes<T>(C, U, W) <= kMaxSmem) return {W, U};
  const size_t ring = matvec_smem_bytes<T>(C, 0, W), row = matvec_smem_bytes<T>(C, 1, 0);
  const size_t half = kMaxSmem / 2 > ring ? (kMaxSmem / 2 - ring) / row / kMatvecRows : 0;
  const size_t rows = half > 0 ? half : (kMaxSmem - ring) / row / kMatvecRows;
  return {W, static_cast<int>(rows) * kMatvecRows};
}

// VEC: 16-byte copies of FtT (U a multiple of 16 bytes and an aligned
// base), else one element a copy.  A CTA computes the W output columns
// [u0, u0 + W) of block b (W = U: the whole block).  CHUNKED: the panel is
// staged P rows at a time (P a multiple of kMatvecRows), each chunk when
// the FtT row chunks reach it, the accumulators staying in registers; else
// the whole panel at once (P = U).
template <typename T, int C, bool VEC, bool CHUNKED>
__global__ void __launch_bounds__(kMatvecMaxW)
macro_matvec_kernel(const T* __restrict__ FtT, const T* __restrict__ xb,
                    T* __restrict__ yb, int U, int W, int ldx, int ldy, int P) {
  using V = typename MvType<T>::V;
  constexpr int L = MvType<T>::L;
  constexpr int CV = (C + L - 1) / L;  // vectors of a panel row
  constexpr int CS = C | 1;  // odd row stride of the staged output: no bank conflicts
  extern __shared__ __align__(16) unsigned char mv_smem[];
  V* panel = reinterpret_cast<V*>(mv_smem);  // [P, CV]: rows padded with zero channels
  T* ring = reinterpret_cast<T*>(panel + (CHUNKED ? P : U) * CV);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nb = (U + W - 1) / W;  // column bands a block, on neighbouring CTAs
  const int b = blockIdx.x / nb, u0 = (blockIdx.x - b * nb) * W;
  const int wb = min(W, U - u0);  // this CTA's output columns
  const T* F = FtT + static_cast<size_t>(b) * U * U + u0;
  const int stage = kMatvecRows * W;
  const int nchunk = (U + kMatvecRows - 1) / kMatvecRows;

  // every thread copies its share of rows [t * kMatvecRows, ...) into the
  // stage t % kMatvecStages; one commit group a chunk (empty past the end)
  auto load_chunk = [&](int t) {
    if (t < nchunk) {
      const int v0 = t * kMatvecRows;
      const int nr = min(kMatvecRows, U - v0);
      T* dst = ring + (t % kMatvecStages) * stage;
      const T* src = F + static_cast<size_t>(v0) * U;
      if (wb == U) {  // the whole block: its rows are contiguous
        const int n = nr * U;
        if (VEC) {
          for (int i = L * tid; i < n; i += L * nthr) cp_async16(dst + i, src + i);
        } else {
          for (int i = tid; i < n; i += nthr) MvType<T>::copy1(dst + i, src + i);
        }
      } else if (VEC) {  // a band: nr segments of wb values at a stride of U
        const int nv = wb / L;
        for (int i = tid; i < nr * nv; i += nthr) {
          const int r = i / nv, c = (i - r * nv) * L;
          cp_async16(dst + r * W + c, src + static_cast<size_t>(r) * U + c);
        }
      } else {
        for (int i = tid; i < nr * wb; i += nthr) {
          const int r = i / wb, c = i - r * wb;
          MvType<T>::copy1(dst + r * W + c, src + static_cast<size_t>(r) * U + c);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kMatvecStages - 1; ++t) load_chunk(t);

  T* pf = reinterpret_cast<T*>(panel);
  const T* xblk = xb + static_cast<size_t>(b) * U * ldx;  // the whole block's panel
  // rows [p0, p0 + P) of the panel (all U rows unless CHUNKED)
  auto load_panel = [&](int p0) {
    const int nr = CHUNKED ? min(P, U - p0) : U;
    for (int i = tid; i < nr * L * CV; i += nthr) {
      const int v = i / (L * CV), c = i - v * (L * CV);
      pf[i] = c < C ? xblk[(p0 + v) * ldx + c] : T(0);
    }
  };
  load_panel(0);

  const int u = tid;
  T acc[L * CV];
#pragma unroll
  for (int c = 0; c < L * CV; ++c) acc[c] = T(0);
  for (int t = 0; t < nchunk; ++t) {
    cp_async_wait<kMatvecStages - 2>();  // this thread's copies of chunk t have landed
    __syncthreads();                     // everyone's, and chunk t - 1 is consumed
    load_chunk(t + kMatvecStages - 1);   // into chunk t - 1's stage
    const int v0 = t * kMatvecRows;
    const int p0 = CHUNKED ? v0 / P * P : 0;  // the staged panel's first row
    if (CHUNKED && t > 0 && v0 == p0) {  // chunk t starts the next panel chunk
      load_panel(p0);                    // (every thread is past the last one's rows)
      __syncthreads();
    }
    if (u < wb) {
      const T* Fs = ring + (t % kMatvecStages) * stage;
      const int nv = min(kMatvecRows, U - v0);
#pragma unroll 4
      for (int k = 0; k < nv; ++k) {
        const T f = Fs[k * W + u];
        const V* xr = panel + (v0 - p0 + k) * CV;
#pragma unroll
        for (int q = 0; q < CV; ++q) MvType<T>::fma_vec(f, xr[q], acc + L * q);
      }
    }
  }
  // The CTA's [wb, C] output (rows at a stride of ldy): staged in the
  // ring, it goes out in coalesced stores (each thread's own row, C values
  // at a stride of C, touched a sector a store per thread: at C = 24 the
  // stores, not the bytes, bounded the kernel).
  __syncthreads();  // the ring's last stage is consumed
  if (u < wb) {
#pragma unroll
    for (int c = 0; c < C; ++c) ring[u * CS + c] = acc[c];
  }
  __syncthreads();
  T* yblk = yb + (static_cast<size_t>(b) * U + u0) * ldy;
  for (int i = tid; i < wb * C; i += nthr) {
    const int r = i / C, c = i - r * C;
    yblk[r * ldy + c] = ring[r * CS + c];
  }
}

template <typename T, int C>
int launch_matvec(const T* FtT, const T* xb, T* yb, int B, int U, int ldx, int ldy,
                  cudaStream_t s) {
  const MvShape sh = matvec_shape<T>(C, U);
  const bool chunked = sh.P < U;
  const size_t smem = matvec_smem_bytes<T>(C, sh.P, sh.W);
  const int threads = (sh.W + 31) / 32 * 32;
  const bool vec = U % MvType<T>::L == 0 && reinterpret_cast<uintptr_t>(FtT) % 16 == 0;
  auto kernel = chunked ? (vec ? macro_matvec_kernel<T, C, true, true>
                               : macro_matvec_kernel<T, C, false, true>)
                        : (vec ? macro_matvec_kernel<T, C, true, false>
                               : macro_matvec_kernel<T, C, false, false>);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B * ((U + sh.W - 1) / sh.W), threads, smem, s>>>(FtT, xb, yb, U, sh.W, ldx, ldy,
                                                             sh.P);
  return 0;
}

}  // namespace

// y[b, u, c] (row stride ldy) = sum_v FtT[b, v, u] x[b, v, c] (row stride
// ldx) for c < C: xb and yb point at the first channel of the slice.
extern "C" int ns_macro_matvec_f32(const float* FtT, const float* xb, float* yb,
                                   int B, int U, int C, int ldx, int ldy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (U < 1 || ldx < C || ldy < C) return static_cast<int>(cudaErrorInvalidValue);
  static_assert(kMaxC == 24, "the cases below take C = 1 .. kMaxC");
  int rc = 0;
  switch (C) {
#define NS_MATVEC_CASE(c) \
  case c:                 \
    rc = launch_matvec<float, c>(FtT, xb, yb, B, U, ldx, ldy, s); \
    break;
    NS_MATVEC_CASE(1) NS_MATVEC_CASE(2) NS_MATVEC_CASE(3) NS_MATVEC_CASE(4)
    NS_MATVEC_CASE(5) NS_MATVEC_CASE(6) NS_MATVEC_CASE(7) NS_MATVEC_CASE(8)
    NS_MATVEC_CASE(9) NS_MATVEC_CASE(10) NS_MATVEC_CASE(11) NS_MATVEC_CASE(12)
    NS_MATVEC_CASE(13) NS_MATVEC_CASE(14) NS_MATVEC_CASE(15) NS_MATVEC_CASE(16)
    NS_MATVEC_CASE(17) NS_MATVEC_CASE(18) NS_MATVEC_CASE(19) NS_MATVEC_CASE(20)
    NS_MATVEC_CASE(21) NS_MATVEC_CASE(22) NS_MATVEC_CASE(23) NS_MATVEC_CASE(24)
#undef NS_MATVEC_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

// The same in double, up to kMaxC64 channels a launch.
extern "C" int ns_macro_matvec_f64(const double* FtT, const double* xb, double* yb,
                                   int B, int U, int C, int ldx, int ldy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (U < 1 || ldx < C || ldy < C) return static_cast<int>(cudaErrorInvalidValue);
  static_assert(kMaxC64 == 12, "the cases below take C = 1 .. kMaxC64");
  int rc = 0;
  switch (C) {
#define NS_MATVEC_CASE(c) \
  case c:                 \
    rc = launch_matvec<double, c>(FtT, xb, yb, B, U, ldx, ldy, s); \
    break;
    NS_MATVEC_CASE(1) NS_MATVEC_CASE(2) NS_MATVEC_CASE(3) NS_MATVEC_CASE(4)
    NS_MATVEC_CASE(5) NS_MATVEC_CASE(6) NS_MATVEC_CASE(7) NS_MATVEC_CASE(8)
    NS_MATVEC_CASE(9) NS_MATVEC_CASE(10) NS_MATVEC_CASE(11) NS_MATVEC_CASE(12)
#undef NS_MATVEC_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
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
  const size_t fixed = build_stage_bytes(c_blk, nloc);
  const int R = band_rows(U, 2 * U * sizeof(float), fixed);  // two tiles of R rows
  // past two tiles of one row band: the one-tile design in bands of rows,
  // then of columns
  if (R <= 0) return launch_build_v1<float>(Fe, lidx, FtT, E, B, c_blk, nloc, U, s);
  const size_t smem = fixed + 2 * static_cast<size_t>(R) * U * sizeof(float);
  auto kernel = R < U ? macro_build_kernel<true> : macro_build_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBuildThreads,
                                                           smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int items = B * ((U + R - 1) / R);
  const int grid = std::min(items, std::max(1, sms * per_sm));
  kernel<<<grid, kBuildThreads, smem, s>>>(Fe, lidx, FtT, E, B, c_blk, nloc, U, R, bulk_in);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B in double: the one-tile design (two double tiles do not fit;
// past U = 170 one does not either, and the tile is banded; past 29,056
// not even a row does, and the tile is banded in columns too).
extern "C" int ns_macro_build_f64(const double* Fe, const int32_t* lidx, double* FtT,
                                  int E, int B, int c_blk, int nloc, int U,
                                  void* stream) {
  return launch_build_v1<double>(Fe, lidx, FtT, E, B, c_blk, nloc, U,
                                 static_cast<cudaStream_t>(stream));
}

// Kernel B's work item in float32 (elem_bytes 4: two tiles and the
// stages, else the one-tile design) or float64 (8: one tile): R rows by W
// columns of a block's [U, U] tile (U and U when a block's tiles fit one
// CTA).
static BuildTile build_tile(int c_blk, int nloc, int U, int elem_bytes) {
  if (elem_bytes == 4) {
    const int R = band_rows(U, 2 * U * sizeof(float), build_stage_bytes(c_blk, nloc));
    if (R > 0) return {R, U};
  }
  return v1_tile(U, elem_bytes);
}

extern "C" int ns_macro_build_band_rows(int c_blk, int nloc, int U, int elem_bytes) {
  return build_tile(c_blk, nloc, U, elem_bytes).R;
}

extern "C" int ns_macro_build_band_cols(int c_blk, int nloc, int U, int elem_bytes) {
  return build_tile(c_blk, nloc, U, elem_bytes).W;
}

// Kernel A's output columns a CTA at C channels (U: one CTA a block).
extern "C" int ns_macro_matvec_band_cols(int C, int U, int elem_bytes) {
  return (elem_bytes == 8 ? matvec_shape<double>(C, U) : matvec_shape<float>(C, U)).W;
}

// Kernel A's panel rows staged at a time at C channels (U: the whole panel).
extern "C" int ns_macro_matvec_panel_rows(int C, int U, int elem_bytes) {
  return (elem_bytes == 8 ? matvec_shape<double>(C, U) : matvec_shape<float>(C, U)).P;
}

extern "C" int ns_macro_max_channels() { return kMaxC; }

extern "C" int ns_macro_max_channels_f64() { return kMaxC64; }

