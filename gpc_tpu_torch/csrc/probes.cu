// K8a: the three overlap probes of tools/tpu_overlap_probe.py on the H100,
// built from the main path's pieces: chol_tiles.cuh's leaf128 and mm128
// (K2, K3's leaf, K5, K6) for every leaf, and wgmma.cuh's TMA boxes and
// wgmma m64n128k16 (K8b, K8c) for every bf16 product.
//
// Each answers a question the redesign of K3's leaf chain and of K5 needs;
// each has a plain PyTorch version in probes/overlap.py that computes the
// same returned values (the (8, 128) corner the TPU probes return, with
// every accumulator zero on entry).  Shapes as the TPU probe's (RC = KC =
// 2048, B = 512), any multiples of 128 (KC of 64; of 256 for the stream).
//
// overlap_kernel replaces make_probe (:47-123, the call at :109): n_dots
//   Schur GEMMs acc[tgt] -= bf16(slab[i % 2]) bf16(vrow)^T, (RC, KC) x (B,
//   KC)^T with f32 accumulation (acc[tgt] = product + 1e-30 i under
//   `overwrite`; tgt alternates between two accumulators under `indep`), and
//   n_leaves leaves (L, L^-1) of aleaf + 1e-3 l I, K5's routine at n = B, in
//   ONE cooperative kernel.  A TPU core issues from one stream, so it
//   interleaved the two in program order.  On the H100 the leaves are a
//   serial chain on block 0, as in a factorization; the GEMMs are 128 x 128
//   tiles of acc, each tile's dots in order on one block (the dependency the
//   TPU probe's accumulator carries; `indep` doubles the tiles), the running
//   tile in registers across its dots and written once.  When twice the
//   tiles fit the blocks that run them, each tile's K is split over two
//   blocks and the halves summed in a fixed order after a grid barrier
//   (probes/overlap.py::overlap_plan).  `seq` runs the tiles on every
//   block, a grid barrier, then the leaf chain; `inter` runs the leaf chain
//   on block 0 while blocks 1 .. G-1 run the tiles.  t(inter) near max(t(dots),
//   t(leaves)) means the chain hides under the GEMMs; near their sum, it
//   does not.
// dma_kernel replaces make_dma_probe (:126-171, the call at :158): n_iters
//   (RC, KC) bf16 slabs, slab i from buffer i % n_bufs, streamed from device
//   memory into shared memory by TMA: with the dot, acc -= slab vrow^T (a
//   128 x 128 tile of acc and a K part per block, its rows of every slab,
//   the overlap's pipeline and split); without it, one 128-row x 256-column
//   box of each slab per block through three 64 KB stages, the (8, 128)
//   corner summed as the TPU probe sums it.
// parts_kernel replaces make_leaf_parts_probe (:174-247, the call at :237):
//   n repetitions on one block of one part of a leaf: sweep128 / fsweep128
//   (leaf128 on a128 + 1e-3 i, keeping (L, L^-1) / L^-1 alone), gemm512 (a
//   dependent 512^3 bf16 GEMM, f32 accumulation, on wgmma), gemm128 (a
//   dependent 128^3 f32 GEMM on mm128), fdiag (K5 at n = 512: L and L^-1)
//   and ffdiag (K2 at b = 512: L^-1 and the logdet).
//
// What bounds them (PERF.md counts the card's bound): the dots by the
// tensor cores, 2 RC KC B bf16 operations a dot (4.34 us at 989 TFLOP/s);
// the stream by device memory, 2 RC KC bytes a slab (2.50 us at 3.35
// TB/s); a leaf and a one-block part by one SM's share of the card, since
// they run on one block: (L, L^-1) of n counts 2 n^3 / 3 f32 operations
// (176 us at n = 512, 2.75 us at 128, at 67/132 TFLOP/s), gemm128 2 * 128^3
// f32 (8.3 us), gemm512 2 * 512^3 bf16 (35.8 us at 989/132 TFLOP/s).
//
// Design.  Every kernel runs 256 threads, leaf128's shape: two warpgroups
// that both multiply (64 rows of a 128 x 128 tile each on wgmma m64n128k16)
// and thread 0 issuing the TMA loads into a ring of six 32 KB stages (a 64 k
// chunk of A and of B) with full / empty mbarriers, four chunks ahead, so a
// tile's next chunks (and the next dot's) load while this one multiplies.
// Every thread runs the producer's waits and thread 0 alone issues, through
// predicates: a divergent branch in the wgmma loop made ptxas serialize the
// wgmmas.  A dot's wgmma accumulator starts fresh and is subtracted from the
// running tile when it drains, as in K8b.  64 dependent tiles leave half of
// the 132 SMs idle, so each tile's K is split over two blocks when the tiles
// fit (the overlap's parts summed after a grid barrier, the stream's corner
// parts added into out).  The in-block (L, L^-1) of a B x B block
// (chol_inv_inblock) runs on one block the sequence K5's launch plan spreads
// over launches (chol_panel.cu's leaf, solve, update and inverse kernels):
// per 128-panel p leaf128 on the diagonal block, the panel solve L_ip =
// S_ip M_pp^T and the trailing update S_ij -= L_ip L_jp^T on mm128, then the
// block inverse by diagonals; L and M live in device memory, as between
// K5's launches, with a block barrier between a step's stores and the next
// step's reads.  Each leaf128 and tile step is a function of its own, as
// each is a kernel of its own on the main path.  gemm512 writes bf16(acc)
// with ordinary stores and reads it back by TMA in the same kernel, so each
// thread fences the generic proxy against the async proxy before the
// barrier that precedes the loads.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "chol_tiles.cuh"
#include "grid_sync.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = TILE_THREADS;      // leaf128's and mm128's block: two warpgroups
constexpr int CK = 64;                     // k chunk: one 128-byte swizzle row of bf16
constexpr int CHUNK = LEAF * CK * 2;       // 16 KB: 128 rows (or columns) x 64 k
constexpr int HALF = CHUNK / 2;            // 64 rows of a chunk: a warpgroup's A, one MN box
constexpr int STAGE_BYTES = 2 * CHUNK;     // A's chunk, then B's
constexpr int STAGES = 6;
constexpr int LAG = 2;                     // a stage is refilled two chunks after its use
constexpr int SEG = 256;                   // stream without the dot: columns of a box
constexpr int SEG_BYTES = LEAF * SEG * 2;  // 64 KB
constexpr int SEG_STAGES = 3;
constexpr int RING = STAGES * STAGE_BYTES > SEG_STAGES * SEG_BYTES ? STAGES * STAGE_BYTES
                                                                   : SEG_STAGES * SEG_BYTES;
constexpr size_t SMEM = (size_t)RING + 1024;   // + slack to align the ring to 1024 bytes
static_assert(SMEM >= LEAF_SMEM && SMEM >= MM_SMEM, "the leaf and mm128 reuse the ring");
constexpr int PN = 512;                    // the leaf-parts probe's wide block

// ---------------------------------------------------------------------------
// The tile products on wgmma
// ---------------------------------------------------------------------------

// The block's TMA ring: `next` counts the chunks it has loaded and used so
// far, which gives each stage's mbarrier phase.
struct Ring {
  uint32_t base;        // shared address of stage 0 (1024-byte aligned)
  unsigned char* ptr;   // the same, generic
  uint64_t* full;
  uint64_t* empty;
  int next;
};

__device__ __forceinline__ Ring ring_init(unsigned char* dsm, uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], THREADS / 32);   // lane 0 of every warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  const uint32_t raw = wg::smem_u32(dsm);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  return Ring{raw + pad, dsm + pad, full, empty, 0};
}

// One 128 x 128 output tile: ndots products, each nch chunks of 64 k of A
// (128 rows, K-major) times B (128 columns; MN-major if BMN, else K-major,
// B^T's rows).  Chunk (d, c)'s boxes are issued by load(d, c, a, b, bar,
// on) into the stage at shared addresses a (A) and b (B), STAGES - LAG
// chunks ahead, by thread 0 (on) alone; every thread runs the producer's
// steps, waiting until all eight warps released the stage, so no branch
// diverges inside the loop.
// Warpgroup w multiplies rows 64 w .. 64 w + 63.  When product d has
// drained, every thread calls done(d, acc) with its 64 accumulators
// (register 4 n + 2 h + e: row 16 warp + lane / 4 + 8 h of the warpgroup's
// 64, column 8 n + 2 (lane % 4) + e).
template <bool BMN, class Load, class Done>
__device__ __forceinline__ void tile_products(Ring& rg, int ndots, int nch, Load load,
                                              Done done) {
  const int total = ndots * nch;
  const int lane = threadIdx.x % 32;
  const int wgi = threadIdx.x / 128;
  const bool lead = threadIdx.x == 0;
  auto issue = [&](int l) {
    const int g = rg.next + l;
    const int st = g % STAGES;
    if (g >= STAGES) wg::mbar_wait_timed(&rg.empty[st], (g / STAGES - 1) & 1);
    wg::mbar_expect_tx_if(lead, &rg.full[st], STAGE_BYTES);
    const uint32_t a = rg.base + st * STAGE_BYTES;
    load(l / nch, l % nch, a, a + CHUNK, &rg.full[st], lead);
  };
  for (int l = 0; l < STAGES - LAG && l < total; ++l) issue(l);
  float acc[64];
  int l = 0;   // chunks of this call used so far
#pragma unroll 1
  for (int d = 0; d < ndots; ++d) {
#pragma unroll 1
    for (int c = 0; c < nch; ++c, ++l) {
      const int g = rg.next + l;
      const int st = g % STAGES;
      wg::mbar_wait_timed(&rg.full[st], (g / STAGES) & 1);
      const uint32_t a = rg.base + st * STAGE_BYTES + wgi * HALF;
      const uint32_t b = rg.base + st * STAGE_BYTES + CHUNK;
      wg::fence_operands(acc);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        const uint64_t da = wg::desc_kmajor(wg::k16_step<false>(a, kk));
        const uint64_t db = BMN ? wg::desc_mnmajor(wg::k16_step<true>(b, kk), HALF)
                                : wg::desc_kmajor(wg::k16_step<false>(b, kk));
        wg::mma_64x128<false, BMN>(acc, da, db, c > 0 || kk > 0);
      }
      wg::mma_commit();
      wg::mma_wait<1>();   // the chunk before this one is read: release its stage
      wg::mbar_arrive_if(l > 0 && lane == 0, &rg.empty[(g + STAGES - 1) % STAGES]);
      if (l + STAGES - LAG < total) issue(l + STAGES - LAG);
    }
    wg::mma_wait<0>();
    wg::fence_operands(acc);
    done(d, acc);
  }
  wg::mbar_arrive_if(total > 0 && lane == 0,
                     &rg.empty[(rg.next + total + STAGES - 1) % STAGES]);
  rg.next += total;
}

// C = alpha v + beta for this thread's accumulator entries of a 128 x 128
// tile (ldc a multiple of 2).
__device__ __forceinline__ void store_tile(const float (&v)[64], float* C, int ldc,
                                           float alpha = 1.0f, float beta = 0.0f) {
  const int wgi = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  float* o = C + (size_t)(wgi * 64 + warp * 16 + lane / 4) * ldc + 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < LEAF / 8; ++n) {
    *reinterpret_cast<float2*>(o + 8 * n) =
        make_float2(fmaf(alpha, v[4 * n], beta), fmaf(alpha, v[4 * n + 1], beta));
    *reinterpret_cast<float2*>(o + (size_t)8 * ldc + 8 * n) =
        make_float2(fmaf(alpha, v[4 * n + 2], beta), fmaf(alpha, v[4 * n + 3], beta));
  }
}

__device__ __forceinline__ void zero_run(float (&v)[64]) {
#pragma unroll
  for (int q = 0; q < 64; ++q) v[q] = 0.0f;
}

// ---------------------------------------------------------------------------
// The in-block (L, L^-1): K5's launch plan on one block
// ---------------------------------------------------------------------------

__device__ __forceinline__ void zero_tile(float* X, int ld) {
  for (int e = threadIdx.x; e < LEAF * LEAF / 4; e += THREADS)
    *reinterpret_cast<float4*>(X + (size_t)(e / (LEAF / 4)) * ld + 4 * (e % (LEAF / 4))) =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The steps below are functions of their own: leaf128 and mm128 take
// nearly all of a thread's 255 registers (chol_panel.cu's leaf and inverse
// kernels: 254-255), and inlined beside a chain's loop state they spilled
// (1.4 KB a thread, and ptxas serialized the dots' wgmmas around the
// spills).  A call saves the few live values of its caller instead.
__device__ __noinline__ double leaf_step(const float* A, int ld, float noise, float* L, float* M,
                                         float* sm) {
  return leaf128(A, ld, noise, L, ld, M, ld, sm);
}

// C = (Cin ? Cin : 0) + alpha sum_{q < count} A_q op(B_q) for 128 x 128
// tiles of row stride ld: A_q = A + 128 q (the next column block), B_q = B +
// 128 q ld (the next row block); BT: op(B) = B^T, else B.  C may be B when
// count = 1 (mm128 ends past its last read).
template <bool BT>
__device__ __noinline__ void tile_op(const float* A, const float* B, int count, int ld, float* C,
                                     const float* Cin, float alpha, float* sm) {
  float acc[8][8];
  acc_zero(acc);
  for (int q = 0; q < count; ++q)
    mm128<BT>(acc, A + q * LEAF, ld, B + (size_t)q * LEAF * ld, ld, sm);
  acc_store(acc, C, ld, Cin, alpha);
}

// (L, M = L^-1, log|src + noise I|) of one PD n x n block, n = 128 nb, on
// this block alone.  src (ld n) is read; the trailing updates go to W (ld
// n; may be src); L and M (ld n) receive the lower triangles and zeros
// above.  Without KEEP_L, L is workspace (K2's (M, logdet)): its diagonal
// blocks and the blocks above are not written (nothing reads them).  sm:
// SMEM bytes.  The logdet is returned by thread 0 (2 sum log L_cc in
// double); the routine ends in a block barrier.
template <bool KEEP_L>
__device__ double chol_inv_inblock(const float* src, int n, float noise, float* W, float* L,
                                   float* M, float* sm) {
  const int nb = n / LEAF;
  auto blk = [n](float* X, int i, int j) { return X + (size_t)i * LEAF * n + j * LEAF; };
  double ld = 0.0;
  for (int p = 0; p < nb; ++p) {
    float* S = p == 0 ? const_cast<float*>(src) : W;
    ld += leaf_step(blk(S, p, p), n, noise, KEEP_L ? blk(L, p, p) : nullptr, blk(M, p, p), sm);
    for (int i = p + 1; i < nb; ++i) {   // panel solve (chol_solve_kernel)
      tile_op<true>(blk(S, i, p), blk(M, p, p), 1, n, blk(L, i, p), nullptr, 1.0f, sm);
      zero_tile(blk(M, p, i), n);
      if (KEEP_L) zero_tile(blk(L, p, i), n);
    }
    __syncthreads();
    for (int i = p + 1; i < nb; ++i)     // trailing update (chol_update_kernel)
      for (int j = p + 1; j <= i; ++j)
        tile_op<true>(blk(L, i, p), blk(L, j, p), 1, n, blk(W, i, j), blk(S, i, j), -1.0f, sm);
    __syncthreads();
  }
  for (int d = 1; d < nb; ++d)           // block inverse by diagonals (chol_inv_kernel)
    for (int j = 0; j + d < nb; ++j) {
      const int i = j + d;
      tile_op<false>(blk(L, i, j), blk(M, j, j), d, n, blk(M, i, j), nullptr, 1.0f, sm);
      __syncthreads();                   // S complete in M_ij for every thread
      tile_op<false>(blk(M, i, i), blk(M, i, j), 1, n, blk(M, i, j), nullptr, -1.0f, sm);
      __syncthreads();
    }
  return ld;
}

// ---------------------------------------------------------------------------
// make_probe: dots and leaves in one kernel
// ---------------------------------------------------------------------------

struct OverlapArgs {
  const float* aleaf;  // (b, b)
  float* acc;          // (2, rc, b), zero on entry
  float* part;         // (ksplit, 2, rc, b) the K parts' sums; acc when ksplit = 1
  float* lw;           // (3, b, b) the leaf's workspace: W, L, M
  unsigned* bar;       // (2) the grid barrier
  float* out;          // (8, 128)
  int rc, kc, b, n_dots, n_leaves, interleave, indep, overwrite, ksplit;
};

// Unit u of this block's share (u = blockIdx.x - first, + workers ...):
// K part s, target tgt, tile (rt, cc), as overlap_plan decodes it.
__device__ __forceinline__ void overlap_dots(const CUtensorMap* smap, const CUtensorMap* vmap,
                                             const OverlapArgs& a, int first, int workers,
                                             Ring& rg) {
  const int ntgt = a.indep ? 2 : 1;
  const int cts = a.b / LEAF;
  const int tiles = (a.rc / LEAF) * cts;
  const int ks = a.kc / a.ksplit;
  const size_t plane = (size_t)a.rc * a.b;
  for (int u = (int)blockIdx.x - first; u < a.ksplit * ntgt * tiles; u += workers) {
    const int s = u / (ntgt * tiles);
    const int tgt = u / tiles % ntgt;
    const int rt = u % tiles / cts;
    const int cc = u % tiles % cts;
    const int ndots = (a.n_dots - tgt + ntgt - 1) / ntgt;   // dots tgt, tgt + ntgt, ...
    float run[64];
    zero_run(run);
    tile_products<false>(
        rg, ndots, ks / CK,
        [&](int d, int c, uint32_t da, uint32_t db, uint64_t* bar, bool on) {
          const int i = tgt + d * ntgt;
          const int k = s * ks + c * CK;
          wg::tma_load_2d_if(on, da, smap, bar, k, (i % 2) * a.rc + rt * LEAF);
          wg::tma_load_2d_if(on, db, vmap, bar, k, cc * LEAF);
        },
        [&](int d, const float(&p)[64]) {
          const float e = s == 0 ? 1e-30f * (float)(tgt + d * ntgt) : 0.0f;
#pragma unroll
          for (int q = 0; q < 64; ++q) run[q] = a.overwrite ? p[q] + e : run[q] - p[q];
        });
    store_tile(run, a.part + ((size_t)s * 2 + tgt) * plane + (size_t)rt * LEAF * a.b + cc * LEAF,
               a.b);
  }
}

// The leaf chain on this block: sum of 2 sum log diag L_l + M_l[0, 0] 1e-30
// (thread 0's value).
__device__ __noinline__ double overlap_leaves(const OverlapArgs& a, float* sm) {
  const size_t bb = (size_t)a.b * a.b;
  float* M = a.lw + 2 * bb;
  double ld = 0.0;
  for (int l = 0; l < a.n_leaves; ++l) {
    const double v =
        chol_inv_inblock<true>(a.aleaf, a.b, 1e-3f * (float)l, a.lw, a.lw + bb, M, sm);
    if (threadIdx.x == 0) ld += v + (double)(M[0] * 1e-30f);
    __syncthreads();
  }
  return ld;
}

__global__ void __launch_bounds__(THREADS, 1)
    overlap_kernel(const __grid_constant__ CUtensorMap smap,
                   const __grid_constant__ CUtensorMap vmap, OverlapArgs a) {
  extern __shared__ __align__(1024) unsigned char dsm[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ double ld0;
  Ring rg = ring_init(dsm, full, empty);
  float* sm = reinterpret_cast<float*>(rg.ptr);
  const int G = gridDim.x;
  const bool inter = a.interleave && a.n_leaves > 0;
  double ld = 0.0;
  if (inter && blockIdx.x == 0) ld = overlap_leaves(a, sm);
  else if (a.n_dots > 0) overlap_dots(&smap, &vmap, a, inter ? 1 : 0, inter ? G - 1 : G, rg);
  if (!inter) {
    if (a.n_dots > 0 && a.n_leaves > 0) gsync::grid_sync(a.bar, G);
    if (blockIdx.x == 0) ld = overlap_leaves(a, sm);
  }
  gsync::grid_sync(a.bar, G);
  if (a.ksplit > 1 && a.n_dots > 0) {   // acc = the K parts summed in order
    const size_t n = (size_t)(a.indep ? 2 : 1) * a.rc * a.b;
    const size_t stride = (size_t)2 * a.rc * a.b;
    for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n;
         e += (size_t)G * THREADS) {
      float s = 0.0f;
      for (int q = 0; q < a.ksplit; ++q) s += __ldcg(a.part + q * stride + e);
      a.acc[e] = s;
    }
    gsync::grid_sync(a.bar, G);
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) ld0 = ld;
    __syncthreads();
    for (int e = threadIdx.x; e < 8 * LEAF; e += THREADS)
      a.out[e] = __ldcg(a.acc + (size_t)(e / LEAF) * a.b + e % LEAF) + (float)ld0;
  }
}

// ---------------------------------------------------------------------------
// make_dma_probe: the slab stream
// ---------------------------------------------------------------------------

struct DmaArgs {
  float* out;   // (8, 128), zero on entry
  int rc, kc, b, n_iters, n_bufs, with_dots, ksplit;
};

// Without the dot: unit u streams rows 128 rt .. + 128, columns 256 sg ..
// + 256 of every slab through SEG_STAGES boxes of 64 KB, a stage refilled
// as soon as every warp has read it; unit 0 sums the corner (thread t:
// entries t + 256 q).
__device__ void stream_pieces(const CUtensorMap* pmap, const DmaArgs& a, Ring& rg) {
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int segs = a.kc / SEG;
  for (int u = blockIdx.x; u < (a.rc / LEAF) * segs; u += gridDim.x) {
    const int rt = u / segs;
    const int sg = u % segs;
    auto issue = [&](int l) {
      const int g = rg.next + l;
      const int st = g % SEG_STAGES;
      if (g >= SEG_STAGES) wg::mbar_wait_timed(&rg.empty[st], (g / SEG_STAGES - 1) & 1);
      wg::mbar_expect_tx(&rg.full[st], SEG_BYTES);
      wg::tma_load_2d(rg.base + st * SEG_BYTES, pmap, &rg.full[st], sg * SEG,
                      (l % a.n_bufs) * a.rc + rt * LEAF);
    };
    if (t == 0)
      for (int l = 0; l < SEG_STAGES && l < a.n_iters; ++l) issue(l);
    __syncwarp();
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int l = 0; l < a.n_iters; ++l) {
      const int g = rg.next + l;
      const int st = g % SEG_STAGES;
      wg::mbar_wait_timed(&rg.full[st], (g / SEG_STAGES) & 1);
      if (u == 0) {
        const bf16* p = reinterpret_cast<const bf16*>(rg.ptr + st * SEG_BYTES);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = t + THREADS * q;
          s[q] += __bfloat162float(p[(e / LEAF) * SEG + e % LEAF]);
        }
      }
      __syncwarp();   // the warp's reads of this stage precede its release
      if (lane == 0) wg::mbar_arrive(&rg.empty[st]);
      if (t == 0 && l + SEG_STAGES < a.n_iters) issue(l + SEG_STAGES);
      __syncwarp();
    }
    rg.next += a.n_iters;
    if (u == 0)
      for (int q = 0; q < 4; ++q) a.out[t + THREADS * q] = s[q];
  }
}

// With the dot: unit u = tile + tiles s runs K part s of a tile's every
// slab (overlap_plan's split, at most two parts); tile 0's parts add their
// corner of -sum slab vrow^T into out atomically: 0 + p0 + p1 is the same
// float in either order.
__device__ __forceinline__ void stream_dots(const CUtensorMap* hmap, const CUtensorMap* vmap,
                                            const DmaArgs& a, Ring& rg) {
  const int cts = a.b / LEAF;
  const int tiles = (a.rc / LEAF) * cts;
  const int ks = a.kc / a.ksplit;
  for (int u = blockIdx.x; u < a.ksplit * tiles; u += gridDim.x) {
    const int s = u / tiles;
    const int rt = u % tiles / cts;
    const int cc = u % tiles % cts;
    float run[64];
    zero_run(run);
    tile_products<false>(
        rg, a.n_iters, ks / CK,
        [&](int d, int c, uint32_t da, uint32_t db, uint64_t* bar, bool on) {
          const int k = s * ks + c * CK;
          wg::tma_load_2d_if(on, da, hmap, bar, k, (d % a.n_bufs) * a.rc + rt * LEAF);
          wg::tma_load_2d_if(on, db, vmap, bar, k, cc * LEAF);
        },
        [&](int, const float(&p)[64]) {
#pragma unroll
          for (int q = 0; q < 64; ++q) run[q] -= p[q];
        });
    if (u % tiles == 0 && threadIdx.x < 32) {   // rows 0-7: warpgroup 0, warp 0, h = 0
      const int lane = threadIdx.x;
      float* o = a.out + (lane / 4) * LEAF + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < LEAF / 8; ++n) {
        atomicAdd(o + 8 * n, run[4 * n]);
        atomicAdd(o + 8 * n + 1, run[4 * n + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    dma_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap pmap, DmaArgs a) {
  extern __shared__ __align__(1024) unsigned char dsm[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  Ring rg = ring_init(dsm, full, empty);
  if (a.with_dots) stream_dots(&hmap, &vmap, a, rg);
  else stream_pieces(&pmap, a, rg);
}

// ---------------------------------------------------------------------------
// make_leaf_parts_probe: where a leaf's time goes
// ---------------------------------------------------------------------------

enum PartKind { PART_SWEEP128 = 0, PART_FSWEEP128 = 1, PART_GEMM512 = 2, PART_GEMM128 = 3,
                PART_FDIAG = 4, PART_FFDIAG = 5 };

struct PartsArgs {
  const float* a512;  // (512, 512)
  const float* a128;  // (128, 128)
  float* acc;         // (512, 512), zero on entry
  bf16* accb;         // (512, 512) bf16(acc), gemm512's A
  float* w;           // (3, 512, 512) the leaves' workspace: W, L, M
  float* out;         // (8, 128)
  int kind, n;
};

constexpr int BATCH = 8;   // float4 loads a thread keeps in flight in a block-wide pass

// X = Y + add for n floats (n a multiple of 4), all threads, each thread's
// loads issued in batches before its stores (one block alone: a load at a
// time would pay device memory's latency for every 4 floats).
__device__ __forceinline__ void copy_add(float* X, const float* Y, int n, float add) {
  const float4* y = reinterpret_cast<const float4*>(Y);
  float4* x = reinterpret_cast<float4*>(X);
  for (int e0 = threadIdx.x; e0 < n / 4; e0 += BATCH * THREADS) {
    float4 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (e0 + u * THREADS < n / 4) v[u] = y[e0 + u * THREADS];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (e0 + u * THREADS < n / 4)
        x[e0 + u * THREADS] = make_float4(v[u].x + add, v[u].y + add, v[u].z + add, v[u].w + add);
  }
}

// acc[0][c] += add + sum_r M[r][c] (+ L[r][c]) for c < 128 over n rows (ld
// n): thread t sums column t % 128 over half of the rows.
__device__ void col_sums(const PartsArgs& a, const float* M, const float* L, int n, float add,
                         float* sm) {
  const int c = threadIdx.x % LEAF;
  const int h = threadIdx.x / LEAF;
  float s = 0.0f;
#pragma unroll 8
  for (int r = h * (n / 2); r < (h + 1) * (n / 2); ++r) {
    s += M[(size_t)r * n + c];
    if (L != nullptr) s += L[(size_t)r * n + c];
  }
  if (h == 1) sm[c] = s;
  __syncthreads();
  if (h == 0) a.acc[c] += add + (s + sm[c]);
  __syncthreads();
}

// sweep128 / fsweep128: leaf128 of a128 + 1e-3 i (every entry), the column
// sums of (L and) L^-1 into acc's row 0.
__device__ __noinline__ void parts_sweep(const PartsArgs& a, float fi, float* sm) {
  float* W = a.w;
  float* L = W + LEAF * LEAF;
  float* M = L + LEAF * LEAF;
  const bool keep_l = a.kind == PART_SWEEP128;
  copy_add(W, a.a128, LEAF * LEAF, fi * 1e-3f);
  __syncthreads();
  leaf_step(W, LEAF, 0.0f, keep_l ? L : nullptr, M, sm);
  col_sums(a, M, keep_l ? L : nullptr, LEAF, 0.0f, sm);
}

// gemm512: acc = bf16(acc) bf16(a512) 1e-6 + 1e-9 i, the 16 tiles as one
// stream of products through the ring.
__device__ __forceinline__ void parts_gemm512(const CUtensorMap* amap, const CUtensorMap* bmap,
                                              const PartsArgs& a, float fi, Ring& rg) {
  const float4* x = reinterpret_cast<const float4*>(a.acc);
  __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(a.accb);
  for (int e0 = threadIdx.x; e0 < PN * PN / 4; e0 += BATCH * THREADS) {   // as copy_add
    float4 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) v[u] = x[e0 + u * THREADS];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      y[2 * (e0 + u * THREADS)] = __floats2bfloat162_rn(v[u].x, v[u].y);
      y[2 * (e0 + u * THREADS) + 1] = __floats2bfloat162_rn(v[u].z, v[u].w);
    }
  }
  asm volatile("fence.proxy.async.global;" ::: "memory");   // the stores, before TMA reads
  __syncthreads();
  constexpr int nt = PN / LEAF;
  tile_products<true>(
      rg, nt * nt, PN / CK,
      [&](int d, int c, uint32_t da, uint32_t db, uint64_t* bar, bool on) {
        wg::tma_load_2d_if(on, da, amap, bar, c * CK, d / nt * LEAF);
        wg::tma_load_2d_if(on, db, bmap, bar, d % nt * LEAF, c * CK);
        wg::tma_load_2d_if(on, db + HALF, bmap, bar, d % nt * LEAF + 64, c * CK);
      },
      [&](int d, const float(&p)[64]) {
        store_tile(p, a.acc + (size_t)(d / nt) * LEAF * PN + d % nt * LEAF, PN, 1e-6f,
                   fi * 1e-9f);
      });
  __syncthreads();
}

// gemm128: acc[:128, :128] = acc[:128, :128] a128 1e-6 + 1e-9 i on mm128.
__device__ __noinline__ void parts_gemm128(const PartsArgs& a, float fi, float* sm) {
  float acc[8][8];
  acc_zero(acc);
  mm128<false>(acc, a.acc, PN, a.a128, LEAF, sm);   // ends past its last read of acc
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      a.acc[(size_t)(ty + 16 * i) * PN + tx + 16 * j] = fmaf(acc[i][j], 1e-6f, fi * 1e-9f);
  __syncthreads();
}

// fdiag / ffdiag: (L, L^-1) of a512 + 1e-3 i (every entry) on one block; the
// column sums of L + L^-1 (fdiag) or of L^-1 plus the logdet (ffdiag).
__device__ __noinline__ void parts_fdiag(const PartsArgs& a, float fi, float* sm) {
  const size_t nn = (size_t)PN * PN;
  float* W = a.w;
  float* L = W + nn;
  float* M = W + 2 * nn;
  const bool keep_l = a.kind == PART_FDIAG;
  copy_add(W, a.a512, PN * PN, fi * 1e-3f);
  __syncthreads();
  const double ld = keep_l ? chol_inv_inblock<true>(W, PN, 0.0f, W, L, M, sm)
                           : chol_inv_inblock<false>(W, PN, 0.0f, W, L, M, sm);
  if (threadIdx.x == 0) sm[LEAF] = (float)ld;
  __syncthreads();
  const float ld2 = sm[LEAF];
  col_sums(a, M, keep_l ? L : nullptr, PN, keep_l ? 0.0f : ld2, sm);
}

__global__ void __launch_bounds__(THREADS, 1)
    parts_kernel(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap bmap, PartsArgs a) {
  extern __shared__ __align__(1024) unsigned char dsm[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  Ring rg = ring_init(dsm, full, empty);
  float* sm = reinterpret_cast<float*>(rg.ptr);
  for (int i = 0; i < a.n; ++i) {
    const float fi = (float)i;
    switch (a.kind) {
      case PART_SWEEP128:
      case PART_FSWEEP128:
        parts_sweep(a, fi, sm);
        break;
      case PART_GEMM512:
        parts_gemm512(&amap, &bmap, a, fi, rg);
        break;
      case PART_GEMM128:
        parts_gemm128(a, fi, sm);
        break;
      default:
        parts_fdiag(a, fi, sm);
    }
  }
  for (int e = threadIdx.x; e < 8 * LEAF; e += THREADS)
    a.out[e] = a.acc[(e / LEAF) * PN + e % LEAF];
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A K-major bf16 operand (rows, k) with k contiguous: boxes of 64 k x 128 rows.
cudaError_t k_map(CUtensorMap* m, const void* p, int k, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t str[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {CK, LEAF};
  return wg::bf16_map(m, p, 2, dims, str, box);
}

// An MN-major bf16 operand (k, n) with n contiguous: boxes of 64 n x 64 k.
cudaError_t mn_map(CUtensorMap* m, const void* p, int n, int k) {
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t str[1] = {(cuuint64_t)n * 2};
  const cuuint32_t box[2] = {64, 64};
  return wg::bf16_map(m, p, 2, dims, str, box);
}

// The stream's boxes: 256 columns x 128 rows of (rows, kc), unswizzled.
cudaError_t seg_map(CUtensorMap* m, const void* p, int kc, int rows) {
  const wg::EncodeTiled enc = wg::encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)kc, (cuuint64_t)rows};
  const cuuint64_t str[1] = {(cuuint64_t)kc * 2};
  const cuuint32_t box[2] = {SEG, LEAF};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, str,
                         box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
}

}  // namespace

// The co-resident grid of overlap_kernel: blocks per SM times SMs.
extern "C" int gpc_probe_grid() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  allow_smem(overlap_kernel);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, overlap_kernel, THREADS, SMEM);
  return per_sm * sms;
}

extern "C" int gpc_overlap_probe(const void* slab, const void* vrow, const float* aleaf,
                                 float* acc, float* part, float* lw, unsigned* bar, float* out,
                                 int RC, int KC, int B, int n_dots, int n_leaves, int interleave,
                                 int indep, int overwrite, int ksplit, int grid, void* stream) {
  if (ksplit < 1 || RC % LEAF || B % LEAF || KC % (CK * ksplit) || grid < 2)
    return (int)cudaErrorInvalidValue;
  CUtensorMap smap, vmap;
  cudaError_t e = k_map(&smap, slab, KC, 2 * RC);
  if (e == cudaSuccess) e = k_map(&vmap, vrow, KC, B);
  if (e == cudaSuccess) e = allow_smem(overlap_kernel);
  if (e != cudaSuccess) return (int)e;
  OverlapArgs a{aleaf, acc, part, lw, bar, out, RC, KC, B, n_dots, n_leaves, interleave, indep,
                overwrite, ksplit};
  void* args[] = {&smap, &vmap, &a};
  cudaLaunchCooperativeKernel((const void*)overlap_kernel, dim3(grid), dim3(THREADS), args, SMEM,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int gpc_dma_probe(const void* hbm, const void* vrow, float* out, int RC, int KC,
                             int B, int n_iters, int n_bufs, int with_dots, int ksplit, int grid,
                             void* stream) {
  if (RC % LEAF || B % LEAF || KC % SEG || n_iters < 1 || n_bufs < 1 || ksplit < 1 ||
      ksplit > 2 || KC % (CK * ksplit))
    return (int)cudaErrorInvalidValue;
  CUtensorMap hmap, vmap, pmap;
  cudaError_t e = k_map(&hmap, hbm, KC, n_bufs * RC);
  if (e == cudaSuccess) e = k_map(&vmap, vrow, KC, B);
  if (e == cudaSuccess) e = seg_map(&pmap, hbm, KC, n_bufs * RC);
  if (e == cudaSuccess) e = allow_smem(dma_kernel);
  if (e != cudaSuccess) return (int)e;
  const DmaArgs a{out, RC, KC, B, n_iters, n_bufs, with_dots, ksplit};
  dma_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(hmap, vmap, pmap, a);
  return (int)cudaGetLastError();
}

extern "C" int gpc_leaf_parts(const float* a512, const float* a128, const void* a512b,
                              float* acc, void* accb, float* w, float* out, int kind, int n,
                              void* stream) {
  CUtensorMap amap, bmap;
  cudaError_t e = k_map(&amap, accb, PN, PN);
  if (e == cudaSuccess) e = mn_map(&bmap, a512b, PN, PN);
  if (e == cudaSuccess) e = allow_smem(parts_kernel);
  if (e != cudaSuccess) return (int)e;
  const PartsArgs a{a512, a128, acc, static_cast<bf16*>(accb), w, out, kind, n};
  parts_kernel<<<1, THREADS, SMEM, (cudaStream_t)stream>>>(amap, bmap, a);
  return (int)cudaGetLastError();
}
