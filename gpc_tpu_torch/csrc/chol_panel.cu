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
// order, so the column loop moves to the host (PyTorch wrapper), and each
// 128-wide column panel j is three launches on one stream:
//
//   panel_fill   acc = rbf(X[jb:], X[jb:jb+b]) - L[jb:, :jb] L[jb:jb+b, :jb]^T
//                as two kernels: the split-K correction GEMM (bf16 inputs,
//                f32 accumulation on the tensor cores through WMMA, as
//                _dot_kk did on the MXU), then the Gram map minus the sum of
//                the split partials (pad rows >= n_valid carry no mass)
//   panel_leaf   K2 on acc[:b] + noise I -> (L_jj^-1, logdet_j) and the
//                forward-solve step v_j = v[:, jb:jb+b] L_jj^-T
//   panel_solve  Lp = acc[b:] L_jj^-T -> bf16 into T, v[:, rows] -= v_j Lp^T
//
// and one panel_finish launch forms G = v v^T and sums the per-panel
// logdets (no atomics: the result is deterministic).
//
// What bounds it on the H100: the Schur correction GEMMs, N^3/3 FLOPs in
// all (1.5 TFLOP at N = 16384), read from the bf16 L buffer; then the serial
// chain of N/128 leaves, each one block.  This first version is simple and
// right: WMMA 16x16x16 bf16 fragments with a register-prefetched k loop, no
// TMA, no wgmma.  Late columns have few 64-row tiles and long k loops, so
// the correction splits k across blocks (partials reduced in fixed order,
// no atomics) to keep every SM busy.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include "chol_tiles.cuh"
#include "gram.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int FT_M = 64;             // panel rows per block
constexpr int FT_K = 64;             // k chunk staged per step
constexpr int FT_LD = FT_K + 8;      // padded bf16 smem row
constexpr int CS_LD = LEAF + 4;      // padded f32 smem row of the result tile
constexpr int GEMM_THREADS = 256;    // 8 warps: 2 (rows) x 4 (cols) of 32x32
constexpr int STAGE_BYTES = (FT_M + LEAF) * FT_LD * (int)sizeof(bf16);
constexpr int CS_BYTES = FT_M * CS_LD * (int)sizeof(float);
constexpr int TILE_SMEM = STAGE_BYTES > CS_BYTES ? STAGE_BYTES : CS_BYTES;

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
// K3: the per-panel launches
// ---------------------------------------------------------------------------

// 64 x 128 tile of a bf16 GEMM on WMMA fragments: warps 2 x 4, each 32 x 32.
struct TileAcc {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[2][2];
};

__device__ __forceinline__ void tile_zero(TileAcc& acc) {
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y) wmma::fill_fragment(acc.f[x][y], 0.0f);
}

// acc += As (FT_M x FT_K, row-major) * Bs^T (Bs: LEAF x FT_K, row-major)
__device__ __forceinline__ void tile_mma(TileAcc& acc, const bf16* As,
                                         const bf16* Bs) {
  const int warp = threadIdx.x / 32;
  const int wr = warp / 4;
  const int wc = warp % 4;
#pragma unroll
  for (int kk = 0; kk < FT_K; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf[2];
#pragma unroll
    for (int x = 0; x < 2; ++x)
      wmma::load_matrix_sync(af[x], As + (wr * 32 + x * 16) * FT_LD + kk, FT_LD);
#pragma unroll
    for (int y = 0; y < 2; ++y)
      wmma::load_matrix_sync(bf[y], Bs + (wc * 32 + y * 16) * FT_LD + kk, FT_LD);
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
        wmma::mma_sync(acc.f[x][y], af[x], bf[y], acc.f[x][y]);
  }
}

__device__ __forceinline__ void tile_store(const TileAcc& acc, float* Cs) {
  const int warp = threadIdx.x / 32;
  const int wr = warp / 4;
  const int wc = warp % 4;
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y)
      wmma::store_matrix_sync(Cs + (wr * 32 + x * 16) * CS_LD + wc * 32 + y * 16,
                              acc.f[x][y], CS_LD, wmma::mem_row_major);
}

// Split-K Schur correction: part[s, r - jb, c] = sum over split s of the k
// range [0, jb) of T[r, k] T[jb + c, k], for the panel rows r in [jb, N).
// grid = ((N - jb) / FT_M, splits).  The next k chunk is fetched into
// registers while the tensor cores work on the current one.
constexpr int A_VECS = FT_M * FT_K / 8 / GEMM_THREADS;   // uint4 per thread
constexpr int B_VECS = LEAF * FT_K / 8 / GEMM_THREADS;
constexpr int KVECS = FT_K / 8;                          // uint4 per row chunk

__global__ void __launch_bounds__(GEMM_THREADS)
    panel_corr_kernel(const bf16* __restrict__ T, int N, int jb, int splits,
                      float* __restrict__ part) {
  __shared__ __align__(128) unsigned char raw[TILE_SMEM];
  bf16* As = reinterpret_cast<bf16*>(raw);
  bf16* Bs = As + FT_M * FT_LD;
  float* Cs = reinterpret_cast<float*>(raw);  // reused after the k loop
  const int tid = threadIdx.x;
  const int r0 = jb + blockIdx.x * FT_M;
  const int split = blockIdx.y;
  const int ksteps = jb / FT_K;
  const int k_begin = split * ksteps / splits * FT_K;
  const int k_end = (split + 1) * ksteps / splits * FT_K;

  uint4 ra[A_VECS], rb[B_VECS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int e = tid + v * GEMM_THREADS;
      ra[v] = *reinterpret_cast<const uint4*>(
          T + (size_t)(r0 + e / KVECS) * N + k0 + (e % KVECS) * 8);
    }
#pragma unroll
    for (int v = 0; v < B_VECS; ++v) {
      const int e = tid + v * GEMM_THREADS;
      rb[v] = *reinterpret_cast<const uint4*>(
          T + (size_t)(jb + e / KVECS) * N + k0 + (e % KVECS) * 8);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int e = tid + v * GEMM_THREADS;
      *reinterpret_cast<uint4*>(As + (e / KVECS) * FT_LD + (e % KVECS) * 8) = ra[v];
    }
#pragma unroll
    for (int v = 0; v < B_VECS; ++v) {
      const int e = tid + v * GEMM_THREADS;
      *reinterpret_cast<uint4*>(Bs + (e / KVECS) * FT_LD + (e % KVECS) * 8) = rb[v];
    }
  };

  TileAcc ta;
  tile_zero(ta);
  if (k_begin < k_end) {
    fetch(k_begin);
    stage();
    __syncthreads();
    for (int k0 = k_begin; k0 < k_end; k0 += FT_K) {
      const bool more = k0 + FT_K < k_end;
      if (more) fetch(k0 + FT_K);
      tile_mma(ta, As, Bs);
      __syncthreads();
      if (more) stage();
      __syncthreads();
    }
  }
  tile_store(ta, Cs);
  __syncthreads();

  const size_t nrem = (size_t)(N - jb);
  float* out = part + ((size_t)split * nrem + (r0 - jb)) * LEAF;
  for (int e = tid; e < FT_M * LEAF; e += GEMM_THREADS)
    out[e] = Cs[(e / LEAF) * CS_LD + e % LEAF];
}

// acc[r - jb, c] = rbf(x_r, x_{jb+c}) - sum_s part[s, r - jb, c] (fixed
// order: deterministic); rows or columns >= nv carry no kernel mass.
constexpr int GRAM_THREADS = 256;

__global__ void __launch_bounds__(GRAM_THREADS)
    panel_gram_kernel(const float* __restrict__ X, int q, int N, int jb,
                      int nv, float gamma, float var,
                      const float* __restrict__ part, int splits,
                      float* __restrict__ acc) {
  const size_t nrem = (size_t)(N - jb);
  const size_t e = (size_t)blockIdx.x * GRAM_THREADS + threadIdx.x;
  if (e >= nrem * LEAF) return;
  const int r = jb + (int)(e / LEAF);
  const int col = jb + (int)(e % LEAF);
  float g = 0.0f;
  if (r < nv && col < nv) {
    float n1 = 0.0f, n2 = 0.0f, cr = 0.0f;
    for (int k = 0; k < q; ++k) {
      const float a = X[(size_t)r * q + k];
      const float bv = X[(size_t)col * q + k];
      n1 += a * a;
      n2 += bv * bv;
      cr += a * bv;
    }
    g = dist_map(FAM_RBF, sq_dist(n1, n2, cr), gamma, var, 0.0f);
  }
  float corr = 0.0f;
  for (int s = 0; s < splits; ++s) corr += part[(size_t)s * nrem * LEAF + e];
  acc[e] = g - corr;
}

// K2 (leaf128) on the diagonal block acc[:b] + noise I, then v_j =
// bf16(v[:, jb:jb+b]) bf16(M)^T written back over v[:, jb:jb+b] (the bf16 policy of _vrow_gemm).
// Mode "full+diag" (T not null): M = L_jj^-1 also goes, as bf16, into the
// lower triangle of T's diagonal block j (_panel_kernel's "diag" residual,
// which the training backward rebuilds L_jj from).  The leaf runs for every
// panel, the last included, so every diagonal block is written; the upper
// triangle keeps the zeros T was allocated with.
__global__ void __launch_bounds__(TILE_THREADS, 1)
    panel_leaf_kernel(float* acc, float noise, float* Md, float* v, int D,
                      int N, int jb, double* ldj, bf16* T) {
  extern __shared__ __align__(16) float smem[];
  const double l = leaf128(acc, LEAF, noise, nullptr, 0, Md, LEAF, smem);
  const int t = threadIdx.x;
  if (t == 0) *ldj = l;
  if (T != nullptr)   // Md is complete: leaf128 ends in a barrier
    for (int e = t; e < LEAF * LEAF; e += TILE_THREADS) {
      const int r = e / LEAF;
      const int c = e % LEAF;
      if (c <= r)
        T[(size_t)(jb + r) * N + jb + c] = __float2bfloat16(Md[e]);
    }
  float* vin = smem;                          // L's storage is free again
  const float* Ms = smem + LEAF * LDS;        // M = L_jj^-1 stays in shared memory
  for (int d = 0; d < D; ++d) {
    __syncthreads();
    if (t < LEAF) vin[t] = bf16_round(v[(size_t)d * N + jb + t]);
    __syncthreads();
    if (t < LEAF) {
      float s = 0.0f;
      for (int k = 0; k <= t; ++k) s += vin[k] * bf16_round(Ms[t * LDS + k]);
      v[(size_t)d * N + jb + t] = s;
    }
  }
}

// Lp = bf16(bf16(acc[r - jb]) bf16(M)^T) for rows r in [jb + b, N): stored
// into T[r, jb:jb+b]; then v[:, r] -= bf16(v_j) Lp[r]^T.
// grid = (N - jb - b) / FT_M blocks.
__global__ void __launch_bounds__(GEMM_THREADS)
    panel_solve_kernel(const float* __restrict__ acc,
                       const float* __restrict__ Md, bf16* __restrict__ T,
                       float* __restrict__ v, int D, int N, int jb) {
  __shared__ __align__(128) unsigned char raw[TILE_SMEM];
  bf16* As = reinterpret_cast<bf16*>(raw);
  bf16* Bs = As + FT_M * FT_LD;
  float* Cs = reinterpret_cast<float*>(raw);
  const int r0 = jb + LEAF + blockIdx.x * FT_M;
  const int tid = threadIdx.x;

  TileAcc ta;
  tile_zero(ta);
  for (int k0 = 0; k0 < LEAF; k0 += FT_K) {
    for (int e = tid; e < FT_M * FT_K; e += GEMM_THREADS) {
      const int i = e / FT_K;
      const int kk = e % FT_K;
      As[i * FT_LD + kk] =
          __float2bfloat16(acc[(size_t)(r0 - jb + i) * LEAF + k0 + kk]);
    }
    for (int e = tid; e < LEAF * FT_K; e += GEMM_THREADS) {
      const int c = e / FT_K;
      const int kk = e % FT_K;
      Bs[c * FT_LD + kk] = __float2bfloat16(Md[c * LEAF + k0 + kk]);
    }
    __syncthreads();
    tile_mma(ta, As, Bs);
    __syncthreads();
  }
  tile_store(ta, Cs);
  __syncthreads();

  for (int e = tid; e < FT_M * LEAF; e += GEMM_THREADS) {
    const int i = e / LEAF;
    const int c = e % LEAF;
    const bf16 lp = __float2bfloat16(Cs[i * CS_LD + c]);
    T[(size_t)(r0 + i) * N + jb + c] = lp;
    Cs[i * CS_LD + c] = __bfloat162float(lp);
  }
  __syncthreads();

  for (int e = tid; e < FT_M * D; e += GEMM_THREADS) {
    const int i = e % FT_M;
    const int d = e / FT_M;
    const float* vj = v + (size_t)d * N + jb;
    float s = 0.0f;
    for (int c = 0; c < LEAF; ++c) s += bf16_round(vj[c]) * Cs[i * CS_LD + c];
    v[(size_t)d * N + r0 + i] -= s;
  }
}

// G[d1, d2] = sum_r v[d1, r] v[d2, r] (one block per entry, a fixed-order
// tree: deterministic); block 0 also sums the per-panel logdets.
constexpr int FIN_THREADS = 256;

__global__ void __launch_bounds__(FIN_THREADS)
    panel_finish_kernel(const float* __restrict__ v, int D, int N,
                        const double* __restrict__ ldj, int nb, float* G,
                        float* ld) {
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

// The Gram panel minus its Schur correction into acc.  The correction
// splits its k range so that the late columns, which have few row tiles
// and long k loops, still occupy about two blocks per SM; part holds
// part_rows x 128 floats of split partials.
extern "C" int gpc_panel_fill(const float* X, int q, const void* T, int N,
                              int jb, int nv, float gamma, float var,
                              float* part, int part_rows, float* acc,
                              void* stream) {
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
  }
  const int nrem = N - jb;
  const int tiles = nrem / FT_M;
  const int ksteps = jb / FT_K;
  int splits = 0;
  if (ksteps > 0) {
    splits = (2 * sm_count + tiles - 1) / tiles;
    if (splits > ksteps) splits = ksteps;
    if (splits > part_rows / nrem) splits = part_rows / nrem;
    if (splits < 1) splits = 1;
    panel_corr_kernel<<<dim3(tiles, splits), GEMM_THREADS, 0,
                        (cudaStream_t)stream>>>(static_cast<const bf16*>(T),
                                                N, jb, splits, part);
  }
  const size_t elems = (size_t)nrem * LEAF;
  panel_gram_kernel<<<(unsigned)((elems + GRAM_THREADS - 1) / GRAM_THREADS),
                      GRAM_THREADS, 0, (cudaStream_t)stream>>>(
      X, q, N, jb, nv, gamma, var, part, splits, acc);
  return (int)cudaGetLastError();
}

// T is null in mode "full" and the bf16 factor buffer in mode "full+diag".
extern "C" int gpc_panel_leaf(float* acc, float noise, float* Md, float* v,
                              int D, int N, int jb, double* ldj, void* T,
                              void* stream) {
  cudaFuncSetAttribute(panel_leaf_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)LEAF_SMEM);
  panel_leaf_kernel<<<1, TILE_THREADS, LEAF_SMEM, (cudaStream_t)stream>>>(
      acc, noise, Md, v, D, N, jb, ldj, static_cast<bf16*>(T));
  return (int)cudaGetLastError();
}

extern "C" int gpc_panel_solve(const float* acc, const float* Md, void* T,
                               float* v, int D, int N, int jb, void* stream) {
  const int rows = N - jb - LEAF;
  if (rows > 0)
    panel_solve_kernel<<<rows / FT_M, GEMM_THREADS, 0, (cudaStream_t)stream>>>(
        acc, Md, static_cast<bf16*>(T), v, D, N, jb);
  return (int)cudaGetLastError();
}

extern "C" int gpc_panel_finish(const float* v, int D, int N,
                                const double* ldj, int nb, float* G, float* ld,
                                void* stream) {
  panel_finish_kernel<<<D * D, FIN_THREADS, 0, (cudaStream_t)stream>>>(
      v, D, N, ldj, nb, G, ld);
  return (int)cudaGetLastError();
}
