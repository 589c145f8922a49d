// K2 + K3: the panel Cholesky evidence for K = rbf-Gram(X) + noise * I.
//
// Replaces gpc_tpu/ops/chol_panel.py::panel_state_rbf (_panel_kernel, modes
// "full" and "full+diag") and its leaf _factor_diag_fast / _cholinv_leaf_fast.
// Mode "full+diag" adds one write per panel to the leaf: bf16(L_jj^-1) into
// T's diagonal block, 32 KB a panel (4 MB at N = 16384) against the 0.5 GB
// T the panel solves write, so it moves neither bound below.
//
// The TPU kernel was ONE program whose grid ran in order, so it carried the
// factor across columns in VMEM scratch.  Blocks on the H100 run in no
// order, so the column loop is a plan of launches (ops/chol_panel.py::
// panel_plan) that one C entry, gpc_panel_state, walks on two streams of its
// own, forked from and joined to the caller's.  Each 128-wide column panel j
// (jb = 128 j) is, with acc = rbf(X[jb:], X[jb:jb+b]) - L[jb:, :jb] L[jb:jb+b, :jb]^T:
//
//   fill (diagonal)  acc[:b]: the correction of the 128 x 128 diagonal block,
//                    K = jb split across the SMs, then the Gram map minus the
//                    split sum; it runs alone                  (chain stream)
//   leaf             K2 on acc[:b] + noise I -> (L_jj^-1, logdet_j) and the
//                    forward-solve step v_j = v[:, jb:jb+b] L_jj^-T
//                                            (chain stream, highest priority)
//   fill (below)     acc[b:], the rows below, at the same time as the leaf, on
//                    one SM fewer than the card has   (second stream, lowest)
//   solve            Lp = acc[b:] L_jj^-T -> bf16 into T, v[:, rows] -= v_j Lp^T,
//                    after both                                (chain stream)
//
// and one last launch forms G = v v^T and sums the per-panel logdets (no
// atomics: the result is deterministic).  The critical chain per panel is
// fill (diagonal) + max(leaf, fill (below)) + solve, not their sum, and
// while the leaf is the longer it holds no wait across streams.
//
// What bounds it on the H100: the Schur correction, N^3/3 bf16 FLOPs in all
// (1.466 TFLOP at N = 16384, 1.5 ms of the tensor cores) that re-stream
// T[jb:N, :jb] from HBM for every panel: 11.45 GB at N = 16384, 3.42 ms at
// 3.35 TB/s, so the correction is bound by bytes (64 FLOP a byte of A with
// b = 128).  panel_corr_kernel feeds wgmma from a ring of TMA stages (one
// producer thread, two consumer warpgroups of 64 rows x 128 columns) so the
// T stream never waits on the tensor cores, and adds the float32
// accumulators into a separate float32 register sum every 256 k.  Late
// panels have few 128-row tiles and long k loops, so it splits k (partials
// reduced in a fixed order, no atomics) and each block walks several
// (tile, split) units.  Then the serial chain of N/128 leaves (~37 us each
// alone): with the correction beside it, the chain of leaves is K3's length
// (PERF.md), and a leaf's few trips to memory queue behind the correction's
// TMA loads.  Kernels of one stream use programmatic dependent launch, so a
// kernel's launch overlaps the end of the one before it.
//
// K2, the leaf (chol_tiles.cuh::leaf128), factors one 128 x 128 PD block by
// 32-wide sub-panels in shared memory and returns (L^-1, logdet); the logdet
// is 2 sum log diag(L) in double.
//
// K2 at b > 128, K5 (chol_inv_block) and K6 (chol_block) run the blocked
// factorization gpc_chol_blocked: a plan of launches that ops/chol_pallas.py
// builds (chol_plan) and this file runs, one kernel per step on the caller's
// stream, each on as many blocks as the step has 128-tiles (and batch
// entries): per panel p the leaf, the panel solve L_ip = A_ip L_pp^-T and
// the trailing update A_ij -= L_ip L_jp^T; then, for the inverse, the
// diagonals of the block-triangular inverse.  K5 replaces
// gpc_tpu/ops/chol_pallas.py::chol_inv_block: both its branches, the fused
// blocked kernel for n a multiple of 128 (chol_inv_block_fused, :213) and
// the masked column sweep with a forward-substitution inverse for any other
// n (_chol_inv_kernel, :185): (L, L^-1) of one PD f32 block, any n up to
// 1024.  K6 replaces chol_pallas.py::chol_block (_chol_kernel, :88): L
// alone, the same plan without the inverse's diagonals.  A ragged n (n % 128
// = r != 0) is first copied into the workspace padded to the next multiple
// of 128 as [[A, 0], [0, I]] (pad_kernel; no row of the input needs to be
// aligned); its factor is [[L, 0], [0, I]], so the padding is exact, and the
// result is the n x n corner of the padded outputs, zeros above the
// diagonal.  Without padding the first panel reads the input and writes its
// trailing update into the workspace, which every later step works in.  The
// bound: 2 n^3 / 3 f32 operations (K5) at n = 1000 is 10 us of the card's
// 67 TFLOP/s, but the critical path is the chain of n / 128 leaves, each
// followed by two dependent tile GEMMs; chol_tiles.cuh notes the design.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

#include "chol_tiles.cuh"
#include "gram.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {


// ---------------------------------------------------------------------------
// K2, K5 and K6: the blocked factorization's steps
// ---------------------------------------------------------------------------

// Step kinds of a plan (ops/chol_pallas.py::chol_plan).
enum StepKind { STEP_LEAF = 0, STEP_SOLVE = 1, STEP_UPDATE = 2, STEP_INV = 3 };

// Each batch entry of A (n x n) into Aw (np x np) as [[A, 0], [0, I]],
// grid-stride.  Kept out of
// the factorization's kernels (inlined into the first design's single
// kernel, its registers stayed live and spilled: K6 ran 45 % slower).
__global__ void __launch_bounds__(TILE_THREADS)
    pad_kernel(const float* __restrict__ A, int n, int np, int batch,
               float* __restrict__ Aw) {
  const size_t block = (size_t)np * np;
  for (size_t e = (size_t)blockIdx.x * TILE_THREADS + threadIdx.x; e < batch * block;
       e += (size_t)gridDim.x * TILE_THREADS) {
    const size_t b = e / block;
    const int r = (int)(e % block / np);
    const int c = (int)(e % np);
    Aw[e] = r < n && c < n ? A[b * n * n + (size_t)r * n + c] : (r == c ? 1.0f : 0.0f);
  }
}

// The leaf of panel p, one block per batch entry (blockIdx.y): (L_pp, M_pp)
// of src's block (p, p).  With ldw: the batch entry's logdet accumulates in
// stream order over the panels (deterministic), and the last panel's leaf
// writes it to ld as float.
__global__ void __launch_bounds__(TILE_THREADS, 1)
    chol_leaf_kernel(const float* __restrict__ src, int np, int p, float* L,
                     float* M, double* ldw, float* ld, int last) {
  extern __shared__ __align__(16) float smem[];
  const size_t off = (size_t)blockIdx.y * np * np + (size_t)p * LEAF * np + p * LEAF;
  const double l = leaf128(src + off, np, 0.0f, L + off, np, M + off, np, smem);
  if (ldw != nullptr && threadIdx.x == 0) {
    const double v = (p == 0 ? 0.0 : ldw[blockIdx.y]) + l;
    ldw[blockIdx.y] = v;
    if (last) ld[blockIdx.y] = (float)v;
  }
}

// Panel solve, one block per tile (i, p) below the leaf: L_ip = src_ip
// M_pp^T; the mirrored tile (p, i) of L, and of M when zero_m, is zeroed
// (the results are lower triangular).
__global__ void __launch_bounds__(TILE_THREADS, 1)
    chol_solve_kernel(const float* __restrict__ src, int np, int p,
                      const int2* __restrict__ tiles, float* L, float* M, int zero_m) {
  extern __shared__ __align__(16) float smem[];
  const size_t base = (size_t)blockIdx.y * np * np;
  const int i = tiles[blockIdx.x].x;
  const size_t ip = base + (size_t)i * LEAF * np + p * LEAF;
  const size_t pp = base + (size_t)p * LEAF * np + p * LEAF;
  const size_t pi = base + (size_t)p * LEAF * np + i * LEAF;
  float acc[8][8];
  acc_zero(acc);
  mm128<true>(acc, src + ip, np, M + pp, np, smem);
  acc_store(acc, L + ip, np, nullptr, 1.0f);
  for (int e = threadIdx.x; e < LEAF * LEAF; e += TILE_THREADS) {
    const size_t o = pi + (size_t)(e / LEAF) * np + e % LEAF;
    L[o] = 0.0f;
    if (zero_m) M[o] = 0.0f;
  }
}

// Trailing update, one block per lower tile (i, j), p < j <= i: Aw_ij =
// src_ij - L_ip L_jp^T.
__global__ void __launch_bounds__(TILE_THREADS, 1)
    chol_update_kernel(const float* src, int np, int p,
                       const int2* __restrict__ tiles, const float* __restrict__ L,
                       float* Aw) {
  extern __shared__ __align__(16) float smem[];
  const size_t base = (size_t)blockIdx.y * np * np;
  const int2 ij = tiles[blockIdx.x];
  const size_t o = base + (size_t)ij.x * LEAF * np + ij.y * LEAF;
  float acc[8][8];
  acc_zero(acc);
  mm128<true>(acc, L + base + (size_t)ij.x * LEAF * np + p * LEAF, np,
              L + base + (size_t)ij.y * LEAF * np + p * LEAF, np, smem);
  acc_store(acc, Aw + o, np, src + o, -1.0f);
}

// Block inverse, diagonal d, one block per tile (i, j = i - d): S = sum_{j <=
// k < i} L_ik M_kj into M_ij, then M_ij = -M_ii S (the tiles M_kj it reads
// lie on earlier diagonals, written by earlier launches).
__global__ void __launch_bounds__(TILE_THREADS, 1)
    chol_inv_kernel(int np, const int2* __restrict__ tiles,
                    const float* __restrict__ L, float* M) {
  extern __shared__ __align__(16) float smem[];
  const size_t base = (size_t)blockIdx.y * np * np;
  const int2 ij = tiles[blockIdx.x];
  const int i = ij.x;
  const int j = ij.y;
  float* Mij = M + base + (size_t)i * LEAF * np + j * LEAF;
  float acc[8][8];
  acc_zero(acc);
  for (int k = j; k < i; ++k)
    mm128<false>(acc, L + base + (size_t)i * LEAF * np + k * LEAF, np,
                 M + base + (size_t)k * LEAF * np + j * LEAF, np, smem);
  acc_store(acc, Mij, np, nullptr, 1.0f);
  __syncthreads();   // S complete in M_ij for every thread of the block
  acc_zero(acc);
  mm128<false>(acc, M + base + (size_t)i * LEAF * np + i * LEAF, np, Mij, np, smem);
  acc_store(acc, Mij, np, nullptr, -1.0f);   // mm128 ended past its last read of S
}

// ---------------------------------------------------------------------------
// K3: the Schur correction on wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int CW_BM = 128;                    // rows of a unit's tile: two consumer warpgroups of 64
constexpr int CW_BK = 64;                     // k chunk: one 128-byte swizzle row of bf16
constexpr int CW_STAGES = 4;                  // shared-memory ring
constexpr int CW_TILE = CW_BM * CW_BK * 2;    // 16 KB: the A tile; the B tile (LEAF rows) is the same
constexpr int CW_STAGE = 2 * CW_TILE;
constexpr int CW_SMEM = CW_STAGES * CW_STAGE + 1024;   // + slack to align the ring to 1024 bytes
constexpr int CW_THREADS = 384;               // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int CW_FLUSH = 4;                   // chunks (256 k) between float32 register-sum flushes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Programmatic dependent launch: a K3 kernel launched with it may start
// while the kernel before it on its stream finishes (the gap between two
// dependent launches sits on K3's critical chain); pdl_wait() then holds it
// until that kernel's results are visible.  Without it both are no-ops.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_release() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One TMA box (CW_BK columns x 128 rows of T, 128-byte swizzled) into dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile under the 128-byte swizzle: 8-row
// groups 1024 bytes apart (SBO), the leading offset unused (1).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, K-major) B^T (B: 128 x 16, K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_64x128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Split-K Schur correction: for the units u = (tile t, split s) of this
// launch, part[s, t*128 + i, c] = sum over the split's k range of [0, jb)
// of T[row0 + t*128 + i, k] T[jb + c, k] (i, c < 128).  Split s covers the
// chunks [s kc / splits, (s + 1) kc / splits) of kc = jb / 64.  Each block
// walks units blockIdx.x, + gridDim.x, ...: the grid may be smaller than
// the units (K3 leaves an SM free for the leaf).  Warp 8 (one thread)
// keeps TMA loads of A = T[rows, k chunk] and B = T[jb:jb+128, k chunk] in
// flight through a ring of CW_STAGES stages; warpgroups 0 and 1 each
// multiply 64 rows of A by B with wgmma into float32 registers and add
// them to a separate float32 sum every CW_FLUSH chunks (the tensor cores'
// own accumulation truncates).  Every partial has one writer and the
// reduction (panel_gram_kernel) sums them in a fixed order: deterministic.
__global__ void __launch_bounds__(CW_THREADS, 1)
    panel_corr_kernel(__grid_constant__ const CUtensorMap tmap, int row0, int tiles, int jb,
                      int splits, float* __restrict__ part) {
  pdl_wait();
  pdl_release();
  extern __shared__ unsigned char cw_raw[];
  __shared__ __align__(8) uint64_t full[CW_STAGES];
  __shared__ __align__(8) uint64_t empty[CW_STAGES];
  const uint32_t ring = (smem_u32(cw_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x / 128;
  const int kc = jb / CW_BK;
  const int units = tiles * splits;
  if (threadIdx.x == 0) {
    for (int s = 0; s < CW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int t = u / splits;
        const int s = u % splits;
        const int k1 = (s + 1) * kc / splits;
        for (int k = s * kc / splits; k < k1; ++k, ++it) {
          const int st = it % CW_STAGES;
          mbar_wait(&empty[st], ((it / CW_STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[st], CW_STAGE);
          const uint32_t a = ring + st * CW_STAGE;
          tma_load(a, &tmap, &full[st], k * CW_BK, row0 + t * CW_BM);
          tma_load(a + CW_TILE, &tmap, &full[st], k * CW_BK, jb);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    float d[64], sum[64];
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int t = u / splits;
      const int s = u % splits;
      const int k0 = s * kc / splits;
      const int k1 = (s + 1) * kc / splits;
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
      for (int k = k0; k < k1; ++k, ++it) {
        const int st = it % CW_STAGES;
        mbar_wait(&full[st], (it / CW_STAGES) & 1);
        const uint32_t a = ring + st * CW_STAGE + wg * 64 * CW_BK * 2;
        const uint32_t b = ring + st * CW_STAGE + CW_TILE;
        const int fresh = (k - k0) % CW_FLUSH == 0;
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        wg_fence_operands(d);
#pragma unroll
        for (int kk = 0; kk < CW_BK / 16; ++kk)
          wgmma_64x128(d, wg_desc(a + 32 * kk), wg_desc(b + 32 * kk), !(fresh && kk == 0));
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        wg_fence_operands(d);
        if (lane == 0) mbar_arrive(&empty[st]);
        if ((k - k0) % CW_FLUSH == CW_FLUSH - 1 || k + 1 == k1) {
#pragma unroll
          for (int i = 0; i < 64; ++i) sum[i] += d[i];
        }
      }
      // accumulator layout of m64nNk16: register 4n + 2h + e holds row
      // 16 warp + lane / 4 + 8 h, column 8 n + 2 (lane % 4) + e
      float* out = part + ((size_t)s * tiles * CW_BM + t * CW_BM + wg * 64 + warp * 16 +
                           lane / 4) * LEAF + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < LEAF / 8; ++n) {
        *reinterpret_cast<float2*>(out + 8 * n) = make_float2(sum[4 * n], sum[4 * n + 1]);
        *reinterpret_cast<float2*>(out + 8 * LEAF + 8 * n) =
            make_float2(sum[4 * n + 2], sum[4 * n + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: the Gram map and split reduction, the leaf, the panel solve, G
// ---------------------------------------------------------------------------

// acc[r - jb, c] = rbf(x_r, x_{jb+c}) - sum_s part[s, r - row0, c] for the
// rows r in [row0, row0 + rows); rows or columns >= nv carry no kernel mass.
// splits = 0: no correction (jb = 0).  A warp takes one row, each lane four
// columns (float4 partials and stores); x_r is read by broadcast and the
// panel's columns from XT = X^T (q x N) as float4, so every load is
// coalesced.  subs (1, 2, 4 or 8) warps share a row: warp i sums the splits
// i, i + subs, ... in ascending order, their loads issued GRAM_BATCH at a
// time, and the warps' sums meet in shared memory in a fixed order
// (deterministic).  The diagonal block's fill has many splits and 128 rows,
// so it takes several warps a row.
constexpr int GRAM_THREADS = 256;
constexpr int GRAM_WARPS = GRAM_THREADS / 32;
constexpr int GRAM_BATCH = 8;

__host__ __device__ __forceinline__ int gram_subs(int splits) {
  int subs = 1;
  while (subs < GRAM_WARPS && subs * GRAM_BATCH < splits) subs *= 2;
  return subs;
}

__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__global__ void __launch_bounds__(GRAM_THREADS)
    panel_gram_kernel(const float* __restrict__ X, const float* __restrict__ XT, int q, int N,
                      int jb, int row0, int rows, int nv, float gamma, float var,
                      const float* __restrict__ part, int splits, int subs,
                      float* __restrict__ acc) {
  pdl_wait();
  pdl_release();
  __shared__ float4 red[GRAM_WARPS][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = warp % subs;
  const int rb = GRAM_WARPS / subs;   // rows a block
  const size_t n = (size_t)rows * LEAF;
  const size_t e = (size_t)(blockIdx.x * rb + warp / subs) * LEAF + 4 * lane;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  float4 corr = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s0 = sub; s0 < splits; s0 += subs * GRAM_BATCH) {
    float4 p[GRAM_BATCH];
#pragma unroll
    for (int u = 0; u < GRAM_BATCH; ++u) {
      const int sp = s0 + u * subs;
      p[u] = sp < splits ? p4[((size_t)sp * n + e) / 4] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < GRAM_BATCH; ++u)
      if (s0 + u * subs < splits) add4(corr, p[u]);
  }
  if (subs > 1) {
    red[warp][lane] = corr;
    __syncthreads();
    if (sub != 0) return;
    for (int w = 1; w < subs; ++w) add4(corr, red[warp + w][lane]);
  }
  const int r = row0 + (int)(e / LEAF);
  const int c = jb + 4 * lane;
  float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (r < nv) {
    float n1 = 0.0f;
    float n2[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < q; ++k) {
      const float a = X[(size_t)r * q + k];
      const float4 b4 = *reinterpret_cast<const float4*>(XT + (size_t)k * N + c);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
      n1 += a * a;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        n2[i] += b[i] * b[i];
        cr[i] += a * b[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < nv) g[i] = dist_map(FAM_RBF, sq_dist(n1, n2[i], cr[i]), gamma, var, 0.0f);
  }
  *reinterpret_cast<float4*>(acc + (size_t)(row0 - jb) * LEAF + e) =
      make_float4(g[0] - corr.x, g[1] - corr.y, g[2] - corr.z, g[3] - corr.w);
}

// v_j's rows pass through shared memory VJ_ROWS at a time: the leaf's and
// the solve's storage plus one chunk fits a block's 227 KB, so D is not
// bounded.  The first chunk is fetched before the kernel's own work, so that
// its latency hides under it (the leaf and the solve sit on K3's critical
// chain); a wider D fetches each further chunk after the one before it.
constexpr int VJ_ROWS = 192;
constexpr int K3_SMEM_MAX = 232448;   // the most shared memory a block may take
static_assert(LEAF_SMEM + VJ_ROWS * LEAF * sizeof(float) <= K3_SMEM_MAX, "leaf + v_j chunk");

__host__ __device__ __forceinline__ int vj_rows(int D) { return D < VJ_ROWS ? D : VJ_ROWS; }

// Rows [d0, d0 + vj_rows(D - d0)) of v[:, jb:jb+128] (rows of 128 floats,
// 16-byte aligned) into shared memory by cp.async, as one group.
__device__ __forceinline__ void prefetch_vj(float* dst, const float* v, int D, int d0, int N,
                                            int jb, int nthreads) {
  const int rows = vj_rows(D - d0);
  for (int e = threadIdx.x; e < rows * (LEAF / 4); e += nthreads)
    cpa16(dst + 4 * e, v + (size_t)(d0 + e / (LEAF / 4)) * N + jb + 4 * (e % (LEAF / 4)));
  cpa_commit();
}

// K2 (leaf128) on the diagonal block acc[:b] + noise I, then v_j =
// bf16(v[:, jb:jb+b]) bf16(M)^T written back over v[:, jb:jb+b] (the bf16
// policy of _vrow_gemm); v[:, jb:jb+b] passes through shared memory past
// leaf128's storage (LEAF_SMEM + vj_rows(D) 512 bytes in all), its first
// chunk fetched while the leaf runs.
// Mode "full+diag" (T not null): M = L_jj^-1 also goes, as bf16, into the
// lower triangle of T's diagonal block j (_panel_kernel's "diag" residual,
// which the training backward rebuilds L_jj from), zeros above it.  The leaf
// runs for every panel, the last included, so every diagonal block is
// written.
__global__ void __launch_bounds__(TILE_THREADS, 1)
    panel_leaf_kernel(float* acc, float noise, float* Md, float* v, int D,
                      int N, int jb, double* ldj, bf16* T) {
  pdl_wait();
  pdl_release();
  extern __shared__ __align__(16) float smem[];
  float* vj = smem + LEAF_SMEM / sizeof(float);
  prefetch_vj(vj, v, D, 0, N, jb, TILE_THREADS);
  const double l = leaf128(acc, LEAF, noise, nullptr, 0, Md, LEAF, smem);
  const int t = threadIdx.x;
  if (t == 0) *ldj = l;
  const float* Ms = smem + LEAF * LDS;        // M = L_jj^-1 stays in shared memory
  if (T != nullptr)   // Ms is complete: leaf128 ends in a barrier; 8 values a store
    for (int e = t; e < LEAF * LEAF / 8; e += TILE_THREADS) {
      const int r = e / (LEAF / 8);
      const int c = 8 * (e % (LEAF / 8));
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c0 = c + 2 * q;
        const __nv_bfloat162 h = __floats2bfloat162_rn(c0 <= r ? Ms[r * LDS + c0] : 0.0f,
                                                       c0 + 1 <= r ? Ms[r * LDS + c0 + 1] : 0.0f);
        w[q] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(T + (size_t)(jb + r) * N + jb + c) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  for (int d0 = 0; d0 < D; d0 += VJ_ROWS) {
    const int rows = vj_rows(D - d0);
    if (d0 > 0) {
      __syncthreads();   // the chunk before is consumed
      prefetch_vj(vj, v, D, d0, N, jb, TILE_THREADS);
    }
    cpa_wait(false);
    __syncthreads();
    for (int e = t; e < rows * LEAF; e += TILE_THREADS) vj[e] = bf16_round(vj[e]);
    __syncthreads();
    for (int e = t; e < rows * LEAF; e += TILE_THREADS) {
      const int d = e / LEAF;
      const int r = e % LEAF;
      float s = 0.0f;
      for (int k = 0; k <= r; ++k) s += vj[d * LEAF + k] * bf16_round(Ms[r * LDS + k]);
      v[(size_t)(d0 + d) * N + jb + r] = s;
    }
  }
}

// The panel solve: Lp = bf16(bf16(acc[r - jb]) bf16(M)^T) for the 64 rows
// r in [r0, r0 + 64), r0 = jb + 128 + 64 blockIdx.x, stored into
// T[r, jb:jb+128]; then v[:, r] -= bf16(v_j) Lp[r]^T.  It sits on K3's
// critical chain (after the leaf, before the next panel's fill), so a block
// issues all its loads (acc's rows and M, 96 KB as float4) before its first
// store, v_j by cp.async past the operands (SV_SMEM + vj_rows(D) 512 bytes
// in all): one round trip while D fits one chunk.  WMMA bf16 fragments, warps 2 x 4 of 32 x 32, the whole
// k = 128 in shared memory.
constexpr int SV_ROWS = 64;
constexpr int SV_THREADS = 256;
constexpr int SV_LD = LEAF + 8;        // padded bf16 row of the operands
constexpr int CS_LD = LEAF + 4;        // padded f32 row of the result
constexpr int SV_SMEM = (SV_ROWS + LEAF) * SV_LD * (int)sizeof(bf16);   // 52,224 B
static_assert(SV_ROWS * CS_LD * sizeof(float) <= SV_SMEM, "the result reuses the operands");
static_assert(SV_SMEM + VJ_ROWS * LEAF * sizeof(float) <= K3_SMEM_MAX, "solve + v_j chunk");

__device__ __forceinline__ void store_bf16x4(bf16* dst, float4 x) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  d[0] = __floats2bfloat162_rn(x.x, x.y);
  d[1] = __floats2bfloat162_rn(x.z, x.w);
}

__global__ void __launch_bounds__(SV_THREADS)
    panel_solve_kernel(const float* __restrict__ acc,
                       const float* __restrict__ Md, bf16* __restrict__ T,
                       float* __restrict__ v, int D, int N, int jb) {
  pdl_wait();
  pdl_release();
  extern __shared__ __align__(128) unsigned char sv_raw[];
  bf16* As = reinterpret_cast<bf16*>(sv_raw);
  bf16* Bs = As + SV_ROWS * SV_LD;
  float* Cs = reinterpret_cast<float*>(sv_raw);   // after the products
  float* vj = reinterpret_cast<float*>(sv_raw + SV_SMEM);
  const int r0 = jb + LEAF + blockIdx.x * SV_ROWS;
  const int tid = threadIdx.x;
  prefetch_vj(vj, v, D, 0, N, jb, SV_THREADS);
  constexpr int AV = SV_ROWS * LEAF / 4 / SV_THREADS;   // float4 a thread
  constexpr int BV = LEAF * LEAF / 4 / SV_THREADS;
  const float4* a4 = reinterpret_cast<const float4*>(acc + (size_t)(r0 - jb) * LEAF);
  const float4* b4 = reinterpret_cast<const float4*>(Md);
  float4 ra[AV], rb[BV];
#pragma unroll
  for (int u = 0; u < AV; ++u) ra[u] = a4[tid + u * SV_THREADS];
#pragma unroll
  for (int u = 0; u < BV; ++u) rb[u] = b4[tid + u * SV_THREADS];
#pragma unroll
  for (int u = 0; u < AV; ++u) {
    const int e = tid + u * SV_THREADS;
    store_bf16x4(As + (e / (LEAF / 4)) * SV_LD + 4 * (e % (LEAF / 4)), ra[u]);
  }
#pragma unroll
  for (int u = 0; u < BV; ++u) {
    const int e = tid + u * SV_THREADS;
    store_bf16x4(Bs + (e / (LEAF / 4)) * SV_LD + 4 * (e % (LEAF / 4)), rb[u]);
  }
  __syncthreads();

  const int warp = tid / 32;
  const int wr = warp / 4;
  const int wc = warp % 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[2][2];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y) wmma::fill_fragment(f[x][y], 0.0f);
#pragma unroll
  for (int kk = 0; kk < LEAF; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
    for (int x = 0; x < 2; ++x)
      wmma::load_matrix_sync(af[x], As + (wr * 32 + x * 16) * SV_LD + kk, SV_LD);
#pragma unroll
    for (int y = 0; y < 2; ++y)
      wmma::load_matrix_sync(bfr[y], Bs + (wc * 32 + y * 16) * SV_LD + kk, SV_LD);
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y) wmma::mma_sync(f[x][y], af[x], bfr[y], f[x][y]);
  }
  __syncthreads();   // the operands are dead: Cs takes their place
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y)
      wmma::store_matrix_sync(Cs + (wr * 32 + x * 16) * CS_LD + wc * 32 + y * 16, f[x][y],
                              CS_LD, wmma::mem_row_major);
  __syncthreads();

  // Lp as bf16 into T, 8 values (16 bytes) a store; Cs keeps the rounded values
  for (int e = tid; e < SV_ROWS * LEAF / 8; e += SV_THREADS) {
    const int i = e / (LEAF / 8);
    const int c = 8 * (e % (LEAF / 8));
    float* cs = Cs + i * CS_LD + c;
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(cs[2 * q], cs[2 * q + 1]);
      cs[2 * q] = __low2float(h);
      cs[2 * q + 1] = __high2float(h);
      w[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(T + (size_t)(r0 + i) * N + jb + c) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int d0 = 0; d0 < D; d0 += VJ_ROWS) {
    if (d0 > 0) {
      __syncthreads();   // the chunk before is consumed
      prefetch_vj(vj, v, D, d0, N, jb, SV_THREADS);
    }
    cpa_wait(false);
    __syncthreads();
    for (int e = tid; e < SV_ROWS * vj_rows(D - d0); e += SV_THREADS) {
      const int i = e % SV_ROWS;
      const int d = e / SV_ROWS;
      float s = 0.0f;
#pragma unroll 8
      for (int c = 0; c < LEAF; ++c) s += bf16_round(vj[d * LEAF + c]) * Cs[i * CS_LD + c];
      v[(size_t)(d0 + d) * N + r0 + i] -= s;
    }
  }
}

// G[d1, d2] = sum_r v[d1, r] v[d2, r] (one block per entry, a fixed-order
// tree: deterministic); block 0 also sums the per-panel logdets.
constexpr int FIN_THREADS = 256;

__global__ void __launch_bounds__(FIN_THREADS)
    panel_finish_kernel(const float* __restrict__ v, int D, int N,
                        const double* __restrict__ ldj, int nb, float* G,
                        float* ld) {
  pdl_wait();
  pdl_release();
  __shared__ double red[FIN_THREADS];
  const int d1 = blockIdx.x / D;
  const int d2 = blockIdx.x % D;
  double s = 0.0;
  for (int r = threadIdx.x; r < N; r += FIN_THREADS)
    s += (double)v[(size_t)d1 * N + r] * (double)v[(size_t)d2 * N + r];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = FIN_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    G[blockIdx.x] = (float)red[0];
    if (blockIdx.x == 0) {
      double t = 0.0;
      for (int j = 0; j < nb; ++j) t += ldj[j];
      *ld = (float)t;
    }
  }
}

}  // namespace

// K2 (batch entries of b x b, inverse = 1), K5 (inverse = 1) and K6
// (inverse = 0: M, np x np, is then only the workspace of the leaves'
// inverses).  steps: nsteps host rows (kind, p or d, first tile, tiles);
// tiles: device int2 (i, j) pairs.  The first panel reads A (read only) and
// every later step the workspace Aw; Aw may be null when the plan has
// one panel and A is read in place.  copy: A is first copied into Aw,
// padded as [[A, 0], [0, I]] (a ragged n, or an A whose rows are not 16-byte
// aligned).  ldw (batch doubles) and ld (batch floats) may be null: then no
// logdet is formed.
extern "C" int gpc_chol_blocked(const float* A, int n, int copy, int np, int batch,
                                float* Aw, float* L, float* M, double* ldw,
                                float* ld, const int* steps, int nsteps,
                                const int* tiles, int inverse, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(chol_leaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)LEAF_SMEM);
    cudaFuncSetAttribute(chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)MM_SMEM);
    cudaFuncSetAttribute(chol_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)MM_SMEM);
    cudaFuncSetAttribute(chol_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)MM_SMEM);
    configured = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* src = A;
  if (copy) {
    pad_kernel<<<(batch * np * np + 4 * TILE_THREADS - 1) / (4 * TILE_THREADS),
                 TILE_THREADS, 0, s>>>(A, n, np, batch, Aw);
    src = Aw;
  }
  const int nbl = np / LEAF;
  const int2* tl = reinterpret_cast<const int2*>(tiles);
  for (int q = 0; q < nsteps; ++q) {
    const int kind = steps[4 * q];
    const int p = steps[4 * q + 1];
    const int2* t = tl + steps[4 * q + 2];
    const dim3 grid(steps[4 * q + 3], batch);
    const float* sp = p == 0 ? src : Aw;
    switch (kind) {
      case STEP_LEAF:
        chol_leaf_kernel<<<dim3(1, batch), TILE_THREADS, LEAF_SMEM, s>>>(
            sp, np, p, L, M, ldw, ld, p == nbl - 1);
        break;
      case STEP_SOLVE:
        chol_solve_kernel<<<grid, TILE_THREADS, MM_SMEM, s>>>(sp, np, p, t, L, M, inverse);
        break;
      case STEP_UPDATE:
        chol_update_kernel<<<grid, TILE_THREADS, MM_SMEM, s>>>(sp, np, p, t, L, Aw);
        break;
      case STEP_INV:
        chol_inv_kernel<<<grid, TILE_THREADS, MM_SMEM, s>>>(np, t, L, M);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3's host side: the tensor map over T, the streams, the plan walker
// ---------------------------------------------------------------------------

namespace {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of the (N, N) bf16 T: boxes of CW_BK columns x 128 rows, 128-byte
// swizzle (wgmma's K-major layout).  T is allocated per call, so the map is
// encoded per call.
cudaError_t t_map(const void* T, int N, CUtensorMap* map) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)N * sizeof(bf16)};
  const cuuint32_t box[2] = {CW_BK, CW_BM};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(T), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int MAX_DEVICES = 16;
constexpr int PANEL_EVENTS = 4;

// Per device, once: the kernels' shared-memory limits and the two streams
// (the leaf chain's at the highest priority, the fills below at the
// lowest), shared by every K3 call on the device.  Each call records and
// waits on events of its own (gpc_panel_state), so calls from several host
// threads interleave on the shared streams without crossing each other's
// waits.
struct PanelCtx {
  bool ready = false;
  cudaStream_t chain = nullptr, below = nullptr;
};

cudaError_t panel_ctx(PanelCtx** out) {
  static PanelCtx ctx[MAX_DEVICES];
  static std::mutex init;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  PanelCtx& c = ctx[dev];
  const std::lock_guard<std::mutex> hold(init);
  if (!c.ready) {
    int least = 0, greatest = 0;
    if ((e = cudaFuncSetAttribute(panel_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  CW_SMEM)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(panel_leaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  K3_SMEM_MAX)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(panel_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  K3_SMEM_MAX)) != cudaSuccess ||
        (e = cudaDeviceGetStreamPriorityRange(&least, &greatest)) != cudaSuccess ||
        (e = cudaStreamCreateWithPriority(&c.chain, cudaStreamNonBlocking, greatest)) !=
            cudaSuccess ||
        (e = cudaStreamCreateWithPriority(&c.below, cudaStreamNonBlocking, least)) != cudaSuccess)
      return e;
    c.ready = true;
  }
  *out = &c;
  return cudaSuccess;
}

// One launch on stream s, with programmatic dependent launch when pdl (the
// stream's last operation was a kernel of K3: no event wait between).
template <typename... K, typename... A>
cudaError_t launch_k3(bool pdl, void (*kernel)(K...), unsigned grid, unsigned block,
                      size_t smem, cudaStream_t s, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

cudaError_t launch_corr(bool pdl, const CUtensorMap& map, int row0, int rows, int jb,
                        int splits, int grid, float* part, cudaStream_t s) {
  return launch_k3(pdl, panel_corr_kernel, grid, CW_THREADS, CW_SMEM, s, map, row0,
                   rows / CW_BM, jb, splits, part);
}

// Step kinds and fields of a plan row (ops/chol_panel.py::panel_plan).
enum PanelStepKind {
  PSTEP_FILL = 0, PSTEP_LEAF = 1, PSTEP_SOLVE = 2, PSTEP_FINISH = 3, PSTEP_FORK = 4, PSTEP_JOIN = 5
};
// kind, stream, j, row0, row1, splits, grid, buf, wait, record
constexpr int PSTEP_FIELDS = 10;
constexpr int PANEL_STREAMS = 3;  // the caller's, the chain, the fills below
// The launches gpc_panel_state counts, by kernel (ops/chol_panel.py::K3_COUNTS).
enum PanelCount {
  PCOUNT_CORR = 0, PCOUNT_FILL_DIAG, PCOUNT_FILL_BELOW, PCOUNT_LEAF, PCOUNT_SOLVE, PCOUNT_FINISH,
  PANEL_COUNTS
};

// The events of one K3 call, destroyed when the call returns (a pending
// record or wait keeps its event alive until the device is past it).
struct PanelEvents {
  cudaEvent_t ev[PANEL_EVENTS] = {};
  cudaError_t create() {
    for (int i = 0; i < PANEL_EVENTS; ++i) {
      const cudaError_t e = cudaEventCreateWithFlags(&ev[i], cudaEventDisableTiming);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
  ~PanelEvents() {
    for (int i = 0; i < PANEL_EVENTS; ++i)
      if (ev[i] != nullptr) cudaEventDestroy(ev[i]);
  }
};

}  // namespace

// K3 alone: one launch of the correction kernel (tests and chip_smoke.py hold
// it against a float32 product of the same bf16 operands).
extern "C" int gpc_panel_corr(const void* T, int N, int row0, int row1, int jb, int splits,
                              int grid, float* part, void* stream) {
  PanelCtx* ctx = nullptr;
  cudaError_t e = panel_ctx(&ctx);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map;
  if ((e = t_map(T, N, &map)) != cudaSuccess) return (int)e;
  if ((e = launch_corr(false, map, row0, row1 - row0, jb, splits, grid, part,
                       (cudaStream_t)stream)) != cudaSuccess)
    return (int)e;
  return (int)cudaGetLastError();
}

// K3: walks the plan (nsteps rows of PSTEP_FIELDS ints) on the caller's
// stream (0) and the context's two streams, the chain (1) and the fills
// below (2), waiting on and recording the plan's events (the call's own):
// it forks from the caller's stream and ends joined to it.  Per step kind:
//   FILL   rows [row0, row1) of panel j: the correction (splits > 0) into
//          the partials buffer buf (0: part_d, 1: part_b), then the Gram
//          map minus their split sum into acc
//   LEAF   K2 on acc[:128] + noise I -> Md = L_jj^-1, ldj[j], v_j; mode
//          "full+diag" (diag = 1) also writes bf16(Md) into T's block j
//   SOLVE  rows [row0, row1): Lp -> T, v[:, rows] -= v_j Lp^T
//   FINISH G = v v^T and the logdet sum
//   FORK, JOIN  no launch: only their event record or wait
// counts (PANEL_COUNTS ints) gains one for each kernel launched, by kind.
// Returns the first CUDA error.
extern "C" int gpc_panel_state(const float* X, const float* XT, int q, float* v, int D, int N, int nv,
                               float gamma, float var, float noise, void* T, float* acc,
                               float* part_d, float* part_b, float* Md, double* ldj, float* G,
                               float* ld, int diag, const int* steps, int nsteps, void* stream,
                               int* counts) {
  PanelCtx* ctx = nullptr;
  cudaError_t e = panel_ctx(&ctx);
  if (e != cudaSuccess) return (int)e;
  PanelEvents events;
  if ((e = events.create()) != cudaSuccess) return (int)e;
  cudaEvent_t* ev = events.ev;
  CUtensorMap map;
  if ((e = t_map(T, N, &map)) != cudaSuccess) return (int)e;
  const cudaStream_t st[PANEL_STREAMS] = {(cudaStream_t)stream, ctx->chain, ctx->below};
  bool chained[PANEL_STREAMS] = {false, false, false};   // last operation a K3 kernel
  bf16* Tb = static_cast<bf16*>(T);
  for (int i = 0; i < nsteps; ++i) {
    const int* f = steps + PSTEP_FIELDS * i;
    const int kind = f[0], j = f[2], row0 = f[3], row1 = f[4], splits = f[5], grid = f[6];
    const int buf = f[7], wait = f[8], record = f[9];
    if (f[1] < 0 || f[1] >= PANEL_STREAMS || buf < 0 || buf > 1 || wait >= PANEL_EVENTS ||
        record >= PANEL_EVENTS)
      return (int)cudaErrorInvalidValue;
    const cudaStream_t s = st[f[1]];
    const int jb = j * LEAF;
    bool& pdl = chained[f[1]];
    if (wait >= 0) {
      if ((e = cudaStreamWaitEvent(s, ev[wait], 0)) != cudaSuccess) return (int)e;
      pdl = false;
    }
    const size_t vbytes = (size_t)vj_rows(D) * LEAF * sizeof(float);
    int counted = -1;
    switch (kind) {
      case PSTEP_FILL: {
        const int rows = row1 - row0;
        float* part = buf ? part_b : part_d;
        if (splits > 0) {
          if ((e = launch_corr(pdl, map, row0, rows, jb, splits, grid, part, s)) != cudaSuccess ||
              (e = cudaGetLastError()) != cudaSuccess)
            return (int)e;
          ++counts[PCOUNT_CORR];
          pdl = true;
        }
        const int subs = gram_subs(splits);
        e = launch_k3(pdl, panel_gram_kernel, (unsigned)(rows / (GRAM_WARPS / subs)), GRAM_THREADS,
                      0, s, X, XT, q, N, jb, row0, rows, nv, gamma, var, (const float*)part, splits,
                      subs, acc);
        counted = buf ? PCOUNT_FILL_BELOW : PCOUNT_FILL_DIAG;
        break;
      }
      case PSTEP_LEAF:
        e = launch_k3(pdl, panel_leaf_kernel, 1, TILE_THREADS, LEAF_SMEM + vbytes, s, acc, noise,
                      Md, v, D, N, jb, ldj + j, diag ? Tb : nullptr);
        counted = PCOUNT_LEAF;
        break;
      case PSTEP_SOLVE:
        e = launch_k3(pdl, panel_solve_kernel, (row1 - row0) / SV_ROWS, SV_THREADS,
                      SV_SMEM + vbytes, s, (const float*)acc, (const float*)Md, Tb, v, D, N, jb);
        counted = PCOUNT_SOLVE;
        break;
      case PSTEP_FINISH:
        e = launch_k3(pdl, panel_finish_kernel, D * D, FIN_THREADS, 0, s, (const float*)v, D, N,
                      (const double*)ldj, N / LEAF, G, ld);
        counted = PCOUNT_FINISH;
        break;
      case PSTEP_FORK:
      case PSTEP_JOIN:
        e = cudaSuccess;
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    if (e != cudaSuccess || (e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (counted >= 0) ++counts[counted];
    pdl = kind != PSTEP_FORK && kind != PSTEP_JOIN;
    if (record >= 0 && (e = cudaEventRecord(ev[record], s)) != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
