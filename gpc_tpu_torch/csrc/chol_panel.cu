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
// K2, the leaf, inverts one 128 x 128 PD block by the augmented [A | I]
// Gauss-Jordan sweep in shared memory (128 x 256 f32 = 128 KB, dynamic
// shared memory above the 48 KB default).  The leaves form the serial chain
// of the factorization, so their latency is what counts: each sweep step
// updates only the 128 columns it changes, with all 1024 threads.  L is
// never stored: the logdet is -2 sum log diag(L^-1).  Blocks wider than 128
// are assembled from 128-leaves by blocked elimination and block triangular
// inversion, as _factor_diag_fast does.
//
// K5, chol_inv_block, replaces gpc_tpu/ops/chol_pallas.py::chol_inv_block
// (chol_inv_block_fused, which runs chol_panel._factor_diag): (L, L^-1) of
// one PD f32 block, n a multiple of 128 up to 1024.  It is K2's blocked
// routine with L kept: the sweep leaves l^T in the upper triangle of the A
// half and the pivot on its diagonal, so each leaf's L_pp is read out of
// shared memory, and L's off-diagonal blocks are the ones the elimination
// forms anyway.  One block of 1024 threads does it all: like K2 it is bound
// by the dependent column steps (n of them) and the in-block 128-cubed
// GEMMs between leaves, not by its 8 n^2 bytes or 2 n^3 / 3 operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include "gram.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int LEAF = 128;           // leaf width; also the panel width b
constexpr int AUGW = 2 * LEAF;      // augmented row [A | M]
constexpr int LEAF_THREADS = 1024;  // 8 row groups per active column
constexpr int LEAF_GROUPS = LEAF_THREADS / LEAF;
constexpr size_t LEAF_SMEM = (size_t)(LEAF * AUGW + 2 * LEAF) * sizeof(float);

constexpr int FT_M = 64;             // panel rows per block
constexpr int FT_K = 64;             // k chunk staged per step
constexpr int FT_LD = FT_K + 8;      // padded bf16 smem row
constexpr int CS_LD = LEAF + 4;      // padded f32 smem row of the result tile
constexpr int GEMM_THREADS = 256;    // 8 warps: 2 (rows) x 4 (cols) of 32x32
constexpr int STAGE_BYTES = (FT_M + LEAF) * FT_LD * (int)sizeof(bf16);
constexpr int CS_BYTES = FT_M * CS_LD * (int)sizeof(float);
constexpr int TILE_SMEM = STAGE_BYTES > CS_BYTES ? STAGE_BYTES : CS_BYTES;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------------------
// K2: the leaf and the blocked diagonal factor
// ---------------------------------------------------------------------------

// In-place augmented Gauss-Jordan sweep on W = [A | I] (LEAF x AUGW, shared
// memory).  Per column c the pivot row scaled by pivot^-1/2 is both the
// elimination row for the M half and l^T for the A half (row c of A equals
// column c by symmetry), so one rank-1 update per column serves both halves.
// Step c changes exactly 128 columns: the A-half columns > c (the columns
// <= c go stale and are never read again) and the M-half columns <= c (M is
// lower triangular, so its row c is zero beyond c).  Thread t takes active
// column a = t % LEAF — A-half column a when a > c, else M-half column a —
// and every LEAF_GROUPS-th row below c.  On exit the M half holds L^-1 in
// its lower triangle.
__device__ void leaf_sweep(float* W, float* lvec, float* urow) {
  const int a = threadIdx.x % LEAF;
  const int g = threadIdx.x / LEAF;
  for (int c = 0; c < LEAF; ++c) {
    const int col = a > c ? a : LEAF + a;
    const float inv_d = rsqrtf(W[c * AUGW + c]);
    if (g == 0) urow[a] = W[c * AUGW + col] * inv_d;
    else if (g == 1) lvec[a] = W[a * AUGW + c] * inv_d;   // read for a > c only
    __syncthreads();
    const float u = urow[a];
    for (int r = c + 1 + g; r < LEAF; r += LEAF_GROUPS)
      W[r * AUGW + col] -= lvec[r] * u;
    if (g == 0) W[c * AUGW + col] = u;
    __syncthreads();
  }
}

// C (+)= alpha * A op(B) for 128 x 128 x 128 tiles in device memory, all
// LEAF_THREADS threads of the block.  Both operands are staged in shared
// memory first (sm: the leaf's W, free between sweeps; B transposed into
// rows padded to BS_LD, so the transposed store and the reads are free of
// bank conflicts), so the device-memory reads are coalesced whatever op(B)
// is.  Thread t computes column t % LEAF of every LEAF_GROUPS-th row, its A
// reads broadcast across the warp.  The b > 128 leaf assembly (K2 at
// b > 128, and K5) uses it.
constexpr int BS_LD = LEAF + 1;
constexpr int GEMM_ROWS = LEAF / LEAF_GROUPS;
static_assert((LEAF * LEAF + LEAF * BS_LD) * sizeof(float) <= LEAF_SMEM,
              "blk_gemm stages both operands in the leaf's shared memory");

__device__ void blk_gemm(const float* A, int lda, const float* B, int ldb,
                         bool transB, float* C, int ldc, float alpha,
                         bool accumulate, float* sm) {
  float* As = sm;                  // As[i * LEAF + k]
  float* Bs = sm + LEAF * LEAF;    // Bs[k * BS_LD + j] = op(B)[k][j]
  for (int e = threadIdx.x; e < LEAF * LEAF; e += blockDim.x) {
    const int r = e / LEAF;
    const int c = e % LEAF;
    As[e] = A[(size_t)r * lda + c];
    Bs[transB ? c * BS_LD + r : r * BS_LD + c] = B[(size_t)r * ldb + c];
  }
  __syncthreads();
  const int j = threadIdx.x % LEAF;
  const int i0 = threadIdx.x / LEAF;
  float acc[GEMM_ROWS];
#pragma unroll
  for (int r = 0; r < GEMM_ROWS; ++r) acc[r] = 0.0f;
  for (int k = 0; k < LEAF; ++k) {
    const float bk = Bs[k * BS_LD + j];
#pragma unroll
    for (int r = 0; r < GEMM_ROWS; ++r)
      acc[r] += As[(i0 + LEAF_GROUPS * r) * LEAF + k] * bk;
  }
#pragma unroll
  for (int r = 0; r < GEMM_ROWS; ++r) {
    float* c = C + (size_t)(i0 + LEAF_GROUPS * r) * ldc + j;
    *c = accumulate ? *c + alpha * acc[r] : alpha * acc[r];
  }
  __syncthreads();
}

// (M = L^-1, logdet) of the PD b x b block A + noise I, b a multiple of
// LEAF.  A (lda) is overwritten by the trailing updates; M (ldm) receives the
// lower-triangular inverse with zeros above; Lw (b x b, ld b) is workspace
// for the off-diagonal L blocks and is not touched when b == LEAF.  With
// keep_l, Lw receives all of L instead: the diagonal blocks from the sweeps,
// zeros above the diagonal.  The logdet is returned by thread 0 (other
// threads return 0).
__device__ double factor_diag_block(float* A, int lda, int b, float noise,
                                    float* M, int ldm, float* Lw,
                                    float* smem, bool keep_l = false) {
  float* W = smem;
  float* lvec = W + LEAF * AUGW;
  float* urow = lvec + LEAF;
  const int t = threadIdx.x;
  const int nbl = b / LEAF;
  double ld = 0.0;
  for (int p = 0; p < nbl; ++p) {
    const float* App = A + (size_t)p * LEAF * lda + p * LEAF;
    for (int e = t; e < LEAF * AUGW; e += blockDim.x) {
      const int r = e / AUGW;
      const int c = e % AUGW;
      W[e] = c < LEAF ? App[(size_t)r * lda + c] + (r == c ? noise : 0.0f)
                      : (r == c - LEAF ? 1.0f : 0.0f);
    }
    __syncthreads();
    leaf_sweep(W, lvec, urow);
    float* Mpp = M + (size_t)p * LEAF * ldm + p * LEAF;
    for (int e = t; e < LEAF * LEAF; e += blockDim.x) {
      const int r = e / LEAF;
      const int c = e % LEAF;
      Mpp[(size_t)r * ldm + c] = c <= r ? W[r * AUGW + LEAF + c] : 0.0f;
    }
    if (t == 0)
      for (int c = 0; c < LEAF; ++c)
        ld -= 2.0 * log((double)W[c * AUGW + LEAF + c]);
    if (keep_l) {
      // row c of the A half holds L[a, c] at a > c and the pivot at a = c
      float* Lpp = Lw + (size_t)p * LEAF * b + p * LEAF;
      for (int e = t; e < LEAF * LEAF; e += blockDim.x) {
        const int r = e / LEAF;
        const int c = e % LEAF;
        Lpp[(size_t)r * b + c] = r > c    ? W[c * AUGW + r]
                                 : r == c ? sqrtf(W[c * AUGW + c])
                                          : 0.0f;
      }
    }
    __syncthreads();
    // L_ip = A_ip M_pp^T; A_ij -= L_ip L_jp^T on the trailing blocks
    for (int i = p + 1; i < nbl; ++i)
      blk_gemm(A + (size_t)i * LEAF * lda + p * LEAF, lda, Mpp, ldm, true,
               Lw + (size_t)i * LEAF * b + p * LEAF, b, 1.0f, false, smem);
    for (int i = p + 1; i < nbl; ++i)
      for (int j = p + 1; j <= i; ++j)
        blk_gemm(Lw + (size_t)i * LEAF * b + p * LEAF, b,
                 Lw + (size_t)j * LEAF * b + p * LEAF, b, true,
                 A + (size_t)i * LEAF * lda + j * LEAF, lda, -1.0f, true, smem);
  }
  // block triangular inverse: M_ij = -M_ii sum_{j<=k<i} L_ik M_kj, with the
  // unused upper block (j, i) of Lw as the scratch for the sum
  for (int j = 0; j < nbl; ++j) {
    for (int i = j + 1; i < nbl; ++i) {
      float* S = Lw + (size_t)j * LEAF * b + i * LEAF;
      blk_gemm(Lw + (size_t)i * LEAF * b + j * LEAF, b,
               M + (size_t)j * LEAF * ldm + j * LEAF, ldm, false, S, b, 1.0f,
               false, smem);
      for (int k = j + 1; k < i; ++k)
        blk_gemm(Lw + (size_t)i * LEAF * b + k * LEAF, b,
                 M + (size_t)k * LEAF * ldm + j * LEAF, ldm, false, S, b,
                 1.0f, true, smem);
      blk_gemm(M + (size_t)i * LEAF * ldm + i * LEAF, ldm, S, b, false,
               M + (size_t)i * LEAF * ldm + j * LEAF, ldm, -1.0f, false, smem);
      for (int e = t; e < LEAF * LEAF; e += blockDim.x) {
        M[(size_t)(j * LEAF + e / LEAF) * ldm + i * LEAF + e % LEAF] = 0.0f;
        if (keep_l) S[(size_t)(e / LEAF) * b + e % LEAF] = 0.0f;
      }
      __syncthreads();
    }
  }
  return ld;
}

// One block per batch entry: (M, logdet) of A[k] (destroyed).
__global__ void __launch_bounds__(LEAF_THREADS)
    factor_diag_kernel(float* A, int b, float* M, float* Lw, float* ld) {
  extern __shared__ float smem[];
  const size_t off = (size_t)blockIdx.x * b * b;
  const double l = factor_diag_block(A + off, b, b, 0.0f, M + off, b,
                                     Lw + off, smem);
  if (threadIdx.x == 0) ld[blockIdx.x] = (float)l;
}

// K5: (L, L^-1) of A (b x b, destroyed).  One block.
__global__ void __launch_bounds__(LEAF_THREADS)
    chol_inv_kernel(float* A, int b, float* L, float* M) {
  extern __shared__ float smem[];
  factor_diag_block(A, b, b, 0.0f, M, b, L, smem, true);
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

// K2 on the diagonal block acc[:b] + noise I, then v_j = bf16(v[:, jb:jb+b])
// bf16(M)^T written back over v[:, jb:jb+b] (the bf16 policy of _vrow_gemm).
// Mode "full+diag" (T not null): M = L_jj^-1 also goes, as bf16, into the
// lower triangle of T's diagonal block j (_panel_kernel's "diag" residual,
// which the training backward rebuilds L_jj from).  The leaf runs for every
// panel, the last included, so every diagonal block is written; the upper
// triangle keeps the zeros T was allocated with.
__global__ void __launch_bounds__(LEAF_THREADS)
    panel_leaf_kernel(float* acc, float noise, float* Md, float* v, int D,
                      int N, int jb, double* ldj, bf16* T) {
  extern __shared__ float smem[];
  const double l = factor_diag_block(acc, LEAF, LEAF, noise, Md, LEAF,
                                     nullptr, smem);
  const int t = threadIdx.x;
  if (t == 0) *ldj = l;
  if (T != nullptr)   // Md is complete: factor_diag_block ends in a barrier
    for (int e = t; e < LEAF * LEAF; e += LEAF_THREADS) {
      const int r = e / LEAF;
      const int c = e % LEAF;
      if (c <= r)
        T[(size_t)(jb + r) * N + jb + c] = __float2bfloat16(Md[e]);
    }
  float* vin = smem;  // the sweep's storage is free again
  for (int d = 0; d < D; ++d) {
    __syncthreads();
    if (t < LEAF) vin[t] = bf16_round(v[(size_t)d * N + jb + t]);
    __syncthreads();
    if (t < LEAF) {
      float s = 0.0f;
      for (int k = 0; k <= t; ++k) s += vin[k] * bf16_round(Md[t * LEAF + k]);
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

extern "C" int gpc_factor_diag(float* A, int batch, int b, float* M,
                               float* Lw, float* ld, void* stream) {
  cudaFuncSetAttribute(factor_diag_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)LEAF_SMEM);
  if (batch > 0)
    factor_diag_kernel<<<batch, LEAF_THREADS, LEAF_SMEM, (cudaStream_t)stream>>>(
        A, b, M, Lw, ld);
  return (int)cudaGetLastError();
}

extern "C" int gpc_chol_inv_block(float* A, int b, float* L, float* M,
                                  void* stream) {
  cudaFuncSetAttribute(chol_inv_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)LEAF_SMEM);
  chol_inv_kernel<<<1, LEAF_THREADS, LEAF_SMEM, (cudaStream_t)stream>>>(
      A, b, L, M);
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
  panel_leaf_kernel<<<1, LEAF_THREADS, LEAF_SMEM, (cudaStream_t)stream>>>(
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
