// K7: the whole rbf evidence in ONE launch, a Hopper probe.
//
// Replaces tools/chol_mega_v2.py::evidence_mega_rbf (_mega_kernel, the call
// at :218): (logdet K, sum_d m_d^T K^-1 m_d) for K = rbf-Gram(X) + noise I,
// N = nb b, with gpc_tpu's bf16 policy: the Schur corrections from packed
// bf16 L^T slots (slot tri(i, j) = i (i + 1) / 2 + j holds L_ij^T, b x b)
// with f32 sums, L_ij^T = bf16(M_jj) bf16(A_ij)^T with M_jj = L_jj^-1 the
// leaf inverse, and the forward solve v = L^-1 m carried along: v_j = M_jj
// w_j in f32, w_i -= L_ij bf16(v_j).  No model path reaches it (neither
// gpc_tpu's nor the port's): it answers whether one persistent launch beats
// K3's host loop of launches for the same work.
//
// What bounds it.  The same work as K3: N^3 / 3 bf16 Schur operations,
// 1.572 ms of the card at N = 16384 (PERF.md counts K3's bound).  A
// left-looking schedule that keeps no T on chip re-streams T[jb:N, :jb] for
// every column, 11.45 GB at N = 16384, 3.42 ms at 3.35 TB/s (K3's byte
// floor, chol_panel.cu).  And the chain of nb leaves, each of which needs
// the column before it: 128 leaves of ~39 us alone at N = 16384, ~5.0 ms,
// plus one tile epilogue a column between them.  The chain is the longest
// of the three, so the design keeps everything else off it.  (Measured on
// the H100, PERF.md PR 16: beside the row blocks' traffic a leaf128 takes
// ~64 us, against ~39 us alone, so the chain, ~9.0 ms of an ~11.1 ms call,
// still bounds it.)
//
// Design.  A persistent cooperative grid of 256-thread blocks, one an SM
// (co-residency makes the waits below safe), with one grid barrier, after
// the set-up (D_i = rbf(X_i, X_i) + noise I, w = m).  After it:
//
//   block 0      the leaf chain: for each column j, wait for tile (j, j-1)'s
//                update of D_j, chol_tiles.cuh's leaf128 on D_j -> M_jj and
//                logdet_j, bf16(M_jj) into its own slot of Mb (every column
//                keeps its own), v_j = M_jj w_j (f32) once w_j is updated;
//                then, after the last leaf, the final sums (it wrote every
//                v_j and logdet_j itself).
//   blocks 1..   walk probes/chol_mega.mega_plan's list of row items in
//                order, each taking the next with an atomic ticket.  Item
//                (i, j, k0, k1) is the correction of tile (i, j) over the
//                columns [k0, k1): sum_{k0 <= k < k1} L_ik L_jk^T, one wgmma
//                product over K = (k1 - k0) b of row i's and row j's slots
//                (both MN-major), waiting first for tiles (i, k1 - 1) and
//                (j, k1 - 1).  Ranges of a tile add into its float32 running
//                sum in order (range [k0, k1) waits for the sum up to k0),
//                so no value is summed by atomics and two calls give the
//                same bits.  The last range (k1 = j) runs the tile's
//                epilogue: A_ij = rbf - the sum, bf16 into the block's
//                scratch; then, once leaf j is done, L_ij^T = bf16(M_jj)
//                bf16(A_ij)^T into slot tri(i, j) and D_i -= L_ij L_ij^T
//                (both operands the slot just written), which leaf i waits
//                for, and only then w_i -= L_ij bf16(v_j).
//
// Each tile (i, j) has a flag: the columns its running sum holds, then j +
// 1 once its slot and D_i are written, j + 2 once w_i is; each leaf a
// flag.  Flags are written with release after a block barrier and read
// with acquire by thread 0 before one (the spins trap after
// gsync::TIMEOUT_NS).  Every store that another
// block reads by TMA (the slots, Mb) is followed by fence.proxy.async.global
// before the release, and the reader fences again before it issues.
// Partial sums, D_i and w_i are read through L2 (__ldcg).  mega_plan puts
// every item after what it waits for, tile (j+1, j) first in its column, so
// any co-resident grid of two or more blocks finishes.  Lookahead: tile
// (j+1, j)'s correction runs during leaf j, so leaf j+1 starts as soon as
// that tile's epilogue lands, beside the rest of column j, and column
// j+1's corrections start before leaf j+1 ends.  Each correction of a late
// tile (K up to 16256 at N = 16384) is split into ranges of 16 columns,
// ready as soon as the columns they cover are, so little of it is left for
// its tile's turn.
//
// Every bf16 product is wgmma m64n128k16 fed by TMA from 128-byte-swizzled
// shared memory (wgmma.cuh): 256 threads, two warpgroups each multiplying
// 64 rows, thread 0 issuing through predicates into a ring of five 32 KB
// stages, three chunks ahead; a product's wgmma accumulator restarts every
// 256 k and joins a float32 register sum (the tensor cores' own sums
// truncate).  The leaf and the ring share the dynamic shared memory by
// role: block 0 never runs the ring.  A row block's epilogue keeps L_ij^T
// (bf16) and a chunk of v_j past the ring for the w update.
//
// Modes, for slice timing (tools/chol_mega_v2.py:216):
//   full    the evidence
//   noleaf  the diagonal stand-in of chol_mega_v2.py:110-118: M_jj =
//           diag(1 / (max_c |D_j[r, c]| + 1)), no factorization
//   nodot   the corrections skipped: both operands still stream through
//           shared memory, no product is formed
//   nodma   the corrections read from row j's own slots (L2-hot) instead
//           of row i's
//   nogram  the exp map skipped: var * d2 (the evidence is then not finite)
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

enum MegaMode { MEGA_FULL = 0, MEGA_NOLEAF = 1, MEGA_NODOT = 2, MEGA_NODMA = 3,
                MEGA_NOGRAM = 4 };

constexpr int THREADS = TILE_THREADS;      // leaf128's block: two warpgroups
constexpr int CK = 64;                     // k chunk: one 128-byte swizzle row of bf16
constexpr int CHUNK = LEAF * CK * 2;       // 16 KB: 128 rows (or columns) x 64 k
constexpr int HALF = CHUNK / 2;            // 64 rows of a chunk: a warpgroup's A, one MN box
constexpr int STAGE_BYTES = 2 * CHUNK;     // A's chunk, then B's
constexpr int STAGES = 5;
constexpr int LAG = 2;                     // a stage is refilled two chunks after its use
constexpr int FLUSH = 4;                   // chunks (256 k) of a wgmma accumulator
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int VCOLS = 16;                  // right-hand sides a row block stages at a time
// past the ring: the epilogue's L^T tile (bf16, as stored) and a chunk of v_j
constexpr int LT_BYTES = LEAF * LEAF * 2;
constexpr int VB_BYTES = LEAF * VCOLS * 4;
constexpr size_t SMEM = (size_t)RING_BYTES + LT_BYTES + VB_BYTES + 1024;   // + alignment slack
// the leaf block: right-hand sides of w_j staged at a time past the leaf's storage
constexpr int WCOLS = (int)((SMEM - 1024 - LEAF_SMEM) / (LEAF * sizeof(float)));
static_assert(WCOLS >= 1, "the leaf and a column of w_j");

struct MegaArgs {
  const float* Xs;     // (N, q) inputs scaled by sqrt(gamma / 2)
  const float* n2;     // (N) their squared norms
  const float* m;      // (N, D) right-hand sides
  float var, noise;
  int N, q, D, nb, mode, n_items;
  const int4* items;   // the row blocks' list: (i, j, k0, k1)
  bf16* T;             // (nb (nb + 1) / 2, b, b) packed L^T slots
  float* part;         // (nb (nb + 1) / 2, b, b) each tile's running correction sum
  float* Dbuf;         // (nb, b, b) the diagonal blocks, corrected as tiles land
  float* w;            // (N, D) the forward solve: w, then v
  bf16* Mb;            // (nb, b, b) bf16(M_jj) of every column
  float* Mf;           // (b, b) leaf128's float32 M (not read)
  bf16* scratch;       // (G, b, b) each block's bf16(A_ij)
  unsigned* bar;       // (2) the grid barrier
  unsigned* ticket;    // (1) the next item of the list
  unsigned* leaf_flag; // (nb) leaf j done
  unsigned* tile_flag; // (nb (nb + 1) / 2) columns summed into tile (i, j); j + 1: done
  float* out;          // (2) logdet, quad
  unsigned long long* trace;   // null, or (n_items + nb, 4) %globaltimer stamps
};

// Thread 0 stamps event e of record r when a trace was asked for.
__device__ __forceinline__ void stamp(const MegaArgs& a, int r, int e) {
  if (a.trace != nullptr && threadIdx.x == 0) a.trace[4 * (size_t)r + e] = gsync::now_ns();
}

__host__ __device__ __forceinline__ size_t tri0(int i) { return (size_t)i * (i + 1) / 2; }

// ---------------------------------------------------------------------------
// Flags
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Thread 0: spin until *p >= v, trapping after gsync::TIMEOUT_NS.
__device__ __forceinline__ void spin_until(const unsigned* p, unsigned v) {
  if (ld_acquire(p) >= v) return;
  const unsigned long long t0 = gsync::now_ns();
  while (ld_acquire(p) < v) {
    __nanosleep(32);
    if (gsync::now_ns() - t0 > gsync::TIMEOUT_NS) __trap();
  }
}

// The block waits until *p >= u and *q >= v (q may be null); what their
// writers stored before releasing them is then visible to every thread,
// and to the TMA loads thread 0 issues next.
__device__ __forceinline__ void wait_flags(const unsigned* p, unsigned u, const unsigned* q,
                                           unsigned v) {
  if (threadIdx.x == 0) {
    spin_until(p, u);
    if (q != nullptr) spin_until(q, v);
    __threadfence();
    fence_async_global();
  }
  __syncthreads();
}

// After every thread's stores: *p = v for the other blocks.
__device__ __forceinline__ void release_flag(unsigned* p, unsigned v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(p, v);
  }
}

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

// sum += A B for one 128 x 128 tile over nch chunks of 64 k: A's 128 rows
// (K-major, or MN-major if AMN) at a stage's start, B's 128 columns
// (K-major, or MN-major if BMN) `boff` bytes on (0: B is A's boxes).  Chunk
// c's boxes are issued by load(c, a, b, bar, on), `bytes` in all, STAGES -
// LAG chunks ahead, by thread 0 (on) alone; every thread runs the
// producer's steps, waiting until all eight warps released the stage, so
// no branch diverges inside the loop.  Warpgroup w multiplies rows 64 w ..
// 64 w + 63; its accumulator restarts every FLUSH chunks and is added to
// sum when it drains.  Register 4 n + 2 h + e of sum holds row 16 warp +
// lane / 4 + 8 h of the warpgroup's 64, column 8 n + 2 (lane % 4) + e.
// Without FORM the chunks stream and no product is formed.
template <bool AMN, bool BMN, bool FORM, class Load>
__device__ __forceinline__ void ring_tile(Ring& rg, int nch, unsigned bytes, uint32_t boff,
                                          Load load, float (&sum)[64]) {
  const int lane = threadIdx.x % 32;
  const int wgi = threadIdx.x / 128;
  const bool lead = threadIdx.x == 0;
  auto issue = [&](int l) {
    const int g = rg.next + l;
    const int st = g % STAGES;
    if (g >= STAGES) wg::mbar_wait_timed(&rg.empty[st], (g / STAGES - 1) & 1);
    wg::mbar_expect_tx_if(lead, &rg.full[st], bytes);
    const uint32_t a = rg.base + st * STAGE_BYTES;
    load(l, a, a + CHUNK, &rg.full[st], lead);
  };
  for (int l = 0; l < STAGES - LAG && l < nch; ++l) issue(l);
  float acc[64];
  int l = 0;   // chunks used so far
#pragma unroll 1
  for (int f0 = 0; f0 < nch; f0 += FLUSH) {
    const int f1 = min(f0 + FLUSH, nch);
#pragma unroll 1
    for (; l < f1; ++l) {
      const int g = rg.next + l;
      const int st = g % STAGES;
      wg::mbar_wait_timed(&rg.full[st], (g / STAGES) & 1);
      if constexpr (FORM) {
        const uint32_t a = rg.base + st * STAGE_BYTES + wgi * HALF;
        const uint32_t b = rg.base + st * STAGE_BYTES + boff;
        wg::fence_operands(acc);
        wg::mma_fence();
#pragma unroll
        for (int kk = 0; kk < CK / 16; ++kk) {
          const uint64_t da = AMN ? wg::desc_mnmajor(wg::k16_step<true>(a, kk), HALF)
                                  : wg::desc_kmajor(wg::k16_step<false>(a, kk));
          const uint64_t db = BMN ? wg::desc_mnmajor(wg::k16_step<true>(b, kk), HALF)
                                  : wg::desc_kmajor(wg::k16_step<false>(b, kk));
          wg::mma_64x128<AMN, BMN>(acc, da, db, l > f0 || kk > 0);
        }
        wg::mma_commit();
        wg::mma_wait<1>();   // the chunk before this one is read: release its stage
      }
      wg::mbar_arrive_if(l > 0 && lane == 0, &rg.empty[(g + STAGES - 1) % STAGES]);
      if (l + STAGES - LAG < nch) issue(l + STAGES - LAG);
    }
    if constexpr (FORM) {
      wg::mma_wait<0>();
      wg::fence_operands(acc);
#pragma unroll
      for (int q = 0; q < 64; ++q) sum[q] += acc[q];
    }
  }
  wg::mbar_arrive_if(nch > 0 && lane == 0, &rg.empty[(rg.next + nch + STAGES - 1) % STAGES]);
  rg.next += nch;
}

// This thread's row h (0, 1) and first column of pair n in a 128 x 128 tile,
// in ring_tile's accumulator layout.
__device__ __forceinline__ int acc_row(int h) {
  return (threadIdx.x / 128) * 64 + (threadIdx.x % 128 / 32) * 16 + threadIdx.x % 32 / 4 + 8 * h;
}
__device__ __forceinline__ int acc_col(int n) { return 8 * n + 2 * (threadIdx.x % 4); }

// ---------------------------------------------------------------------------
// The rbf Gram
// ---------------------------------------------------------------------------

__device__ __forceinline__ float gram_map(const MegaArgs& a, float n2r, float n2c, float cross) {
  const float d2 = fmaxf(n2r + n2c - 2.0f * cross, 0.0f);
  return a.mode == MEGA_NOGRAM ? a.var * d2 : a.var * expf(-d2);
}

// rbf(X_{i0 + r}, X_{j0 + c}) from the pre-scaled inputs, gpc_tpu's form:
// var exp(-max(n2_r + n2_c - 2 x_r . x_c, 0)).
__device__ __forceinline__ float gram_at(const MegaArgs& a, int r, int c) {
  float cross = 0.0f;
  for (int k = 0; k < a.q; ++k)
    cross = fmaf(__ldg(a.Xs + (size_t)r * a.q + k), __ldg(a.Xs + (size_t)c * a.q + k), cross);
  return gram_map(a, __ldg(a.n2 + r), __ldg(a.n2 + c), cross);
}

// g = the rbf tile (i, j) in the accumulator layout.
__device__ __forceinline__ void gram_tile(const MegaArgs& a, int i, int j, float (&g)[64]) {
  const int r0 = i * LEAF + acc_row(0);
  const int c0 = j * LEAF + acc_col(0);
#pragma unroll
  for (int q = 0; q < 64; ++q) g[q] = 0.0f;
  for (int k = 0; k < a.q; ++k) {
    const float x0 = __ldg(a.Xs + (size_t)r0 * a.q + k);
    const float x1 = __ldg(a.Xs + (size_t)(r0 + 8) * a.q + k);
#pragma unroll
    for (int n = 0; n < LEAF / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xc = __ldg(a.Xs + (size_t)(c0 + 8 * n + e) * a.q + k);
        g[4 * n + e] = fmaf(x0, xc, g[4 * n + e]);
        g[4 * n + 2 + e] = fmaf(x1, xc, g[4 * n + 2 + e]);
      }
  }
  const float n2r0 = __ldg(a.n2 + r0), n2r1 = __ldg(a.n2 + r0 + 8);
#pragma unroll
  for (int n = 0; n < LEAF / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float n2c = __ldg(a.n2 + c0 + 8 * n + e);
      g[4 * n + e] = gram_map(a, n2r0, n2c, g[4 * n + e]);
      g[4 * n + 2 + e] = gram_map(a, n2r1, n2c, g[4 * n + 2 + e]);
    }
}

// ---------------------------------------------------------------------------
// Block 0: the leaf chain
// ---------------------------------------------------------------------------

// (M_jj in sm's M half, logdet_j at thread 0) of D_j: leaf128, or under
// noleaf the stand-in M = diag(1 / dcol), dcol_r = max_c |D_j[r, c]| + 1.
// A function of its own: leaf128 takes nearly all of a thread's registers.
__device__ __noinline__ double leaf_step(const MegaArgs& a, const float* Dj, float* sm) {
  if (a.mode != MEGA_NOLEAF) return leaf128(Dj, LEAF, 0.0f, nullptr, 0, a.Mf, LEAF, sm);
  float* Ms = sm + LEAF * LDS;
  float* dcol = Ms + LEAF * LDS;
  const int t = threadIdx.x;
  constexpr int V = LEAF * LEAF / 4 / THREADS;   // D_j into shared memory, one round trip
  float4 in[V];
#pragma unroll
  for (int u = 0; u < V; ++u) in[u] = reinterpret_cast<const float4*>(Dj)[t + u * THREADS];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int e = 4 * (t + u * THREADS);
    float* d = sm + e / LEAF * LDS + e % LEAF;
    d[0] = in[u].x;
    d[1] = in[u].y;
    d[2] = in[u].z;
    d[3] = in[u].w;
  }
  __syncthreads();
  if (t < LEAF) {
    float mx = 0.0f;
    for (int c = 0; c < LEAF; ++c) mx = fmaxf(mx, fabsf(sm[t * LDS + c]));
    dcol[t] = mx + 1.0f;
  }
  __syncthreads();
  for (int e = t; e < LEAF * LEAF; e += THREADS) {
    const int r = e / LEAF;
    const int c = e % LEAF;
    Ms[r * LDS + c] = r == c ? 1.0f / dcol[r] : 0.0f;
  }
  double ld = 0.0;
  if (t == 0)
    for (int c = 0; c < LEAF; ++c) ld += 2.0 * log((double)dcol[c]);
  __syncthreads();
  return ld;
}

// Leaf j: M_jj and logdet_j once tile (j, j-1) has folded its update into
// D_j, bf16(M_jj) into Mb[j], v_j = M_jj w_j (f32) once it has into w_j,
// then leaf j's flag.  Returns logdet_j at thread 0.
__device__ double mega_leaf(const MegaArgs& a, int j, float* sm) {
  const int t = threadIdx.x;
  unsigned* last = a.tile_flag + tri0(j) + j - 1;   // tile (j, j - 1); j > 0
  stamp(a, a.n_items + j, 0);
  if (j > 0) wait_flags(last, j, nullptr, 0);
  stamp(a, a.n_items + j, 1);
  const double ld = leaf_step(a, a.Dbuf + (size_t)j * LEAF * LEAF, sm);
  stamp(a, a.n_items + j, 2);
  const float* Ms = sm + LEAF * LDS;     // complete: leaf_step ends in a barrier
  __nv_bfloat162* Mj = reinterpret_cast<__nv_bfloat162*>(a.Mb + (size_t)j * LEAF * LEAF);
  for (int e = t; e < LEAF * LEAF / 2; e += THREADS) {
    const int r = e / (LEAF / 2);
    const int c = 2 * (e % (LEAF / 2));
    Mj[e] = __floats2bfloat162_rn(c <= r ? Ms[r * LDS + c] : 0.0f,
                                  c + 1 <= r ? Ms[r * LDS + c + 1] : 0.0f);
  }
  fence_async_global();   // Mb, before the row blocks' TMA reads
  if (j > 0) wait_flags(last, j + 1, nullptr, 0);
  // v_j = M_jj w_j in f32, WCOLS right-hand sides at a time past the leaf's storage
  float* wj = sm + LEAF_SMEM / sizeof(float);
  const size_t jb = (size_t)j * LEAF;
  for (int d0 = 0; d0 < a.D; d0 += WCOLS) {
    const int dn = min(WCOLS, a.D - d0);
    __syncthreads();
    for (int e = t; e < LEAF * dn; e += THREADS)
      wj[e] = __ldcg(a.w + (jb + e / dn) * a.D + d0 + e % dn);
    __syncthreads();
    for (int e = t; e < LEAF * dn; e += THREADS) {
      const int r = e % LEAF;
      const int d = e / LEAF;
      float s = 0.0f;
      for (int c = 0; c <= r; ++c) s = fmaf(Ms[r * LDS + c], wj[c * dn + d], s);
      a.w[(jb + r) * a.D + d0 + d] = s;
    }
  }
  release_flag(a.leaf_flag + j, 1u);
  stamp(a, a.n_items + j, 3);
  return ld;
}

// After the last leaf, every v_j and logdet_j is this block's own: out =
// (sum_j logdet_j, sum v^2), in double and in a fixed order.
__device__ void mega_final(const MegaArgs& a, double ld, float* sm) {
  double* red = reinterpret_cast<double*>(sm);
  const int t = threadIdx.x;
  __syncthreads();
  double s = 0.0;
  for (size_t e = t; e < (size_t)a.N * a.D; e += THREADS) {
    const double v = __ldcg(a.w + e);
    s += v * v;
  }
  red[t] = s;
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (t < h) red[t] += red[t + h];
    __syncthreads();
  }
  if (t == 0) {
    a.out[0] = (float)ld;
    a.out[1] = (float)red[0];
  }
}

// ---------------------------------------------------------------------------
// Blocks 1 ..: the row items
// ---------------------------------------------------------------------------

// sum += the correction of tile (i, j) over columns [k0, k1): row i's slots
// (row j's under nodma) times row j's, both MN-major (a slot row is one k,
// its 128 entries the tile's m or n).
template <bool FORM>
__device__ __forceinline__ void correction(const MegaArgs& a, const CUtensorMap* tmap, Ring& rg,
                                           int i, int j, int k0, int k1, float (&sum)[64]) {
  const int ra = (int)((tri0(a.mode == MEGA_NODMA ? j : i) + k0) * LEAF);
  const int rb = (int)((tri0(j) + k0) * LEAF);
  ring_tile<true, true, FORM>(
      rg, (k1 - k0) * (LEAF / CK), STAGE_BYTES, CHUNK,
      [&](int c, uint32_t da, uint32_t db, uint64_t* bar, bool on) {
        wg::tma_load_2d_if(on, da, tmap, bar, 0, ra + c * CK);
        wg::tma_load_2d_if(on, da + HALF, tmap, bar, 64, ra + c * CK);
        wg::tma_load_2d_if(on, db, tmap, bar, 0, rb + c * CK);
        wg::tma_load_2d_if(on, db + HALF, tmap, bar, 64, rb + c * CK);
      },
      sum);
}

// The epilogue of tile (i, j), whose correction is `sum`: L_ij^T into its
// slot, then D_i -= L_ij L_ij^T and the tile's flag at j + 1 (what leaf
// j+1 and the corrections that read the slot wait for), then w_i -= L_ij
// bf16(v_j) and the flag at j + 2 (what leaf i's v_i and tile (i, j+1)'s
// epilogue wait for), so the w update is off the leaf chain.
__device__ __forceinline__ void epilogue(const MegaArgs& a, const CUtensorMap* tmap,
                                         const CUtensorMap* mmap, const CUtensorMap* smap,
                                         Ring& rg, int x, int i, int j, float (&sum)[64]) {
  const int t = threadIdx.x;
  const size_t ib = (size_t)i * LEAF, jb = (size_t)j * LEAF;
  float* Di = a.Dbuf + ib * LEAF;
  // A_ij = rbf - correction, bf16 (the product's input rounding), into this
  // block's scratch tile, row-major; formed before leaf j is waited for
  {
    float g[64];
    gram_tile(a, i, j, g);
    bf16* S = a.scratch + (size_t)blockIdx.x * LEAF * LEAF;
#pragma unroll
    for (int n = 0; n < LEAF / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(S + acc_row(h) * LEAF + acc_col(n)) =
            __floats2bfloat162_rn(g[4 * n + 2 * h] - sum[4 * n + 2 * h],
                                  g[4 * n + 2 * h + 1] - sum[4 * n + 2 * h + 1]);
  }
  fence_async_global();
  // D_i and w_i as tile (i, j-1) left them, fetched into L2 while leaf j runs
  if (j > 0) wait_flags(a.tile_flag + tri0(i) + j - 1, j + 1, nullptr, 0);
  for (int e = t; e < LEAF * LEAF * 4 / 128; e += THREADS)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(Di + 32 * e));
  for (int e = t; e < LEAF * a.D * 4 / 128 + 1; e += THREADS)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(a.w + ib * a.D + 32 * e));
  wait_flags(a.leaf_flag + j, 1u, nullptr, 0);
  stamp(a, x, 1);
  // L_ij^T = bf16(M_jj) bf16(A_ij)^T: both K-major, K = b; into slot tri(i,
  // j) and past the ring for the w update
  float p[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) p[q] = 0.0f;
  ring_tile<false, false, true>(
      rg, LEAF / CK, STAGE_BYTES, CHUNK,
      [&](int c, uint32_t da, uint32_t db, uint64_t* bar, bool on) {
        wg::tma_load_2d_if(on, da, mmap, bar, c * CK, j * LEAF);
        wg::tma_load_2d_if(on, db, smap, bar, c * CK, blockIdx.x * LEAF);
      },
      p);
  bf16* slot = a.T + (tri0(i) + j) * LEAF * LEAF;
  bf16* Lt = reinterpret_cast<bf16*>(rg.ptr + RING_BYTES);
#pragma unroll
  for (int n = 0; n < LEAF / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = acc_row(h) * LEAF + acc_col(n);
      const __nv_bfloat162 l = __floats2bfloat162_rn(p[4 * n + 2 * h], p[4 * n + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(slot + o) = l;
      *reinterpret_cast<__nv_bfloat162*>(Lt + o) = l;
    }
  fence_async_global();   // the slot, before TMA reads it here and in other blocks
  __syncthreads();
  // D_i -= L_ij L_ij^T = slot^T slot: both MN-major, one load a chunk; D_i's
  // rows loaded all at once, then written
  const int rs = (int)((tri0(i) + j) * LEAF);
#pragma unroll
  for (int q = 0; q < 64; ++q) p[q] = 0.0f;
  ring_tile<true, true, true>(
      rg, LEAF / CK, CHUNK, 0,
      [&](int c, uint32_t da, uint32_t, uint64_t* bar, bool on) {
        wg::tma_load_2d_if(on, da, tmap, bar, 0, rs + c * CK);
        wg::tma_load_2d_if(on, da + HALF, tmap, bar, 64, rs + c * CK);
      },
      p);
#pragma unroll
  for (int n0 = 0; n0 < LEAF / 8; n0 += LEAF / 32) {   // a quarter of the rows' pairs at a time
    float2 dv[LEAF / 16];
#pragma unroll
    for (int n = 0; n < LEAF / 32; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        dv[2 * n + h] = __ldcg(
            reinterpret_cast<const float2*>(Di + acc_row(h) * LEAF + acc_col(n0 + n)));
#pragma unroll
    for (int n = 0; n < LEAF / 32; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(Di + acc_row(h) * LEAF + acc_col(n0 + n)) =
            make_float2(dv[2 * n + h].x - p[4 * (n0 + n) + 2 * h],
                        dv[2 * n + h].y - p[4 * (n0 + n) + 2 * h + 1]);
  }
  unsigned* flag = a.tile_flag + tri0(i) + j;
  release_flag(flag, (unsigned)j + 1);
  // w_i -= L_ij bf16(v_j): L_ij[r][c] = Lt[c][r]
  float* vb = reinterpret_cast<float*>(rg.ptr + RING_BYTES + LT_BYTES);
  for (int d0 = 0; d0 < a.D; d0 += VCOLS) {
    const int dn = min(VCOLS, a.D - d0);
    __syncthreads();
    for (int e = t; e < LEAF * dn; e += THREADS)
      vb[e] = bf16_round(__ldcg(a.w + (jb + e / dn) * a.D + d0 + e % dn));
    __syncthreads();
    for (int e = t; e < LEAF * dn; e += THREADS) {
      const int r = e % LEAF;
      const int d = e / LEAF;
      float s = 0.0f;
      for (int c = 0; c < LEAF; ++c)
        s = fmaf(__bfloat162float(Lt[c * LEAF + r]), vb[c * dn + d], s);
      float* wi = a.w + (ib + r) * a.D + d0 + d;
      *wi = __ldcg(wi) - s;
    }
  }
  release_flag(flag, (unsigned)j + 2);
}

// Item (i, j, k0, k1) of the list.
template <bool FORM>
__device__ __forceinline__ void row_item(const MegaArgs& a, const CUtensorMap* tmap,
                                         const CUtensorMap* mmap, const CUtensorMap* smap,
                                         Ring& rg, int x, int4 it) {
  const int i = it.x, j = it.y, k0 = it.z, k1 = it.w;
  float sum[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) sum[q] = 0.0f;
  stamp(a, x, 0);
  if (k1 > k0) {
    wait_flags(a.tile_flag + tri0(i) + k1 - 1, k1, a.tile_flag + tri0(j) + k1 - 1, k1);
    stamp(a, x, 1);
    correction<FORM>(a, tmap, rg, i, j, k0, k1, sum);
  }
  unsigned* flag = a.tile_flag + tri0(i) + j;
  float* part = a.part + (tri0(i) + j) * LEAF * LEAF;
  if (k0 > 0) {   // the running sum up to k0, in order
    wait_flags(flag, k0, nullptr, 0);
#pragma unroll
    for (int n = 0; n < LEAF / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 s =
            __ldcg(reinterpret_cast<const float2*>(part + acc_row(h) * LEAF + acc_col(n)));
        sum[4 * n + 2 * h] = s.x + sum[4 * n + 2 * h];
        sum[4 * n + 2 * h + 1] = s.y + sum[4 * n + 2 * h + 1];
      }
  }
  if (k1 < j) {
#pragma unroll
    for (int n = 0; n < LEAF / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + acc_row(h) * LEAF + acc_col(n)) =
            make_float2(sum[4 * n + 2 * h], sum[4 * n + 2 * h + 1]);
    stamp(a, x, 2);
    release_flag(flag, (unsigned)k1);
  } else {
    stamp(a, x, 2);
    epilogue(a, tmap, mmap, smap, rg, x, i, j, sum);
  }
  stamp(a, x, 3);
}

template <bool FORM>
__device__ __forceinline__ void row_blocks(const MegaArgs& a, const CUtensorMap* tmap,
                                        const CUtensorMap* mmap, const CUtensorMap* smap,
                                        Ring& rg, int* slot) {
  for (;;) {
    __syncthreads();   // every thread has read the last ticket
    if (threadIdx.x == 0) *slot = (int)atomicAdd(a.ticket, 1u);
    __syncthreads();
    const int it = *slot;
    if (it >= a.n_items) return;
    row_item<FORM>(a, tmap, mmap, smap, rg, it, __ldg(a.items + it));
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    mega_kernel(const __grid_constant__ CUtensorMap tmap,
                const __grid_constant__ CUtensorMap mmap,
                const __grid_constant__ CUtensorMap smap, MegaArgs a) {
  extern __shared__ __align__(1024) unsigned char dsm[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ int ticket;
  Ring rg = ring_init(dsm, full, empty);
  const unsigned G = gridDim.x;
  const int t = threadIdx.x;
  // set-up: the diagonal blocks and w = m
  for (int i = blockIdx.x; i < a.nb; i += G) {
    float* Di = a.Dbuf + (size_t)i * LEAF * LEAF;
    for (int e = t; e < LEAF * LEAF; e += THREADS) {
      const int r = e / LEAF;
      const int c = e % LEAF;
      Di[e] = gram_at(a, i * LEAF + r, i * LEAF + c) + (r == c ? a.noise : 0.0f);
    }
  }
  for (size_t e = (size_t)blockIdx.x * THREADS + t; e < (size_t)a.N * a.D;
       e += (size_t)G * THREADS)
    a.w[e] = a.m[e];
  gsync::grid_sync(a.bar, G);
  if (blockIdx.x == 0) {
    float* sm = reinterpret_cast<float*>(rg.ptr);
    double ld = 0.0;
    for (int j = 0; j < a.nb; ++j) ld += mega_leaf(a, j, sm);
    mega_final(a, ld, sm);
  } else if (a.mode == MEGA_NODOT) {
    row_blocks<false>(a, &tmap, &mmap, &smap, rg, &ticket);
  } else {
    row_blocks<true>(a, &tmap, &mmap, &smap, rg, &ticket);
  }
}

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

cudaError_t allow_smem() {
  return cudaFuncSetAttribute(mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM);
}

}  // namespace

// The co-resident grid: blocks per SM times SMs; 0 if fewer than two fit.
extern "C" int gpc_mega_grid() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  allow_smem();
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mega_kernel, THREADS, SMEM);
  const int g = per_sm * sms;
  return g >= 2 ? g : 0;
}

// items: n_items (i, j, k0, k1) of probes/chol_mega.mega_plan's row items;
// sync: (3 + nb + nb (nb + 1) / 2) zeros: the grid barrier, the ticket, the
// leaf flags, the tile flags.
extern "C" int gpc_evidence_mega(const float* Xs, const float* n2, const float* m, float var,
                                 float noise, int N, int q, int D, int mode, int grid,
                                 const void* items, int n_items, void* T, float* part,
                                 float* Dbuf, float* w, void* Mb, float* Mf, void* scratch,
                                 unsigned* sync, float* out, unsigned long long* trace,
                                 void* stream) {
  const int nb = N / LEAF;
  if (N % LEAF || nb < 3 || grid < 2 || D < 1 || q < 1) return (int)cudaErrorInvalidValue;
  const int slots = nb * (nb + 1) / 2;
  CUtensorMap tmap, mmap, smap;
  cudaError_t e = mn_map(&tmap, T, LEAF, slots * LEAF);
  if (e == cudaSuccess) e = k_map(&mmap, Mb, LEAF, N);
  if (e == cudaSuccess) e = k_map(&smap, scratch, LEAF, grid * LEAF);
  if (e == cudaSuccess) e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  MegaArgs a{Xs, n2, m, var, noise, N, q, D, nb, mode, n_items,
             static_cast<const int4*>(items), static_cast<bf16*>(T), part, Dbuf, w,
             static_cast<bf16*>(Mb), Mf, static_cast<bf16*>(scratch), sync, sync + 2,
             sync + 3, sync + 3 + nb, out, trace};
  void* args[] = {&tmap, &mmap, &smap, &a};
  cudaLaunchCooperativeKernel((const void*)mega_kernel, dim3(grid), dim3(THREADS), args, SMEM,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
