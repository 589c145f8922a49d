// The first design of K2's leaf routines, kept for the probes that were
// measured on it: the whole-evidence probe K7 (chol_mega.cu) and the overlap
// probes K8a (probes.cu).  K2, K3's leaf, K5 and K6 run chol_tiles.cuh's
// redesign.  Every routine here is run by one block of LEAF_THREADS threads
// and assumes that block size.
//
// leaf_sweep inverts one 128 x 128 PD block by the augmented [A | I]
// Gauss-Jordan sweep in shared memory (128 x 256 f32 = 128 KB, dynamic
// shared memory above the 48 KB default).  The leaves form the serial chain
// of a factorization, so their latency is what counts: each sweep step
// updates only the 128 columns it changes, with all 1024 threads.  Blocks
// wider than 128 are assembled from 128-leaves by blocked elimination and
// block triangular inversion (factor_diag_block), as gpc_tpu's
// _factor_diag_fast does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int LEAF = 128;           // leaf width; also the panel width b
constexpr int AUGW = 2 * LEAF;      // augmented row [A | M]
constexpr int LEAF_THREADS = 1024;  // 8 row groups per active column
constexpr int LEAF_GROUPS = LEAF_THREADS / LEAF;
constexpr size_t LEAF_SMEM = (size_t)(LEAF * AUGW + 2 * LEAF) * sizeof(float);

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// In-place augmented Gauss-Jordan sweep on W = [A | I] (LEAF x AUGW, shared
// memory).  Per column c the pivot row scaled by pivot^-1/2 is both the
// elimination row for the M half and l^T for the A half (row c of A equals
// column c by symmetry), so one rank-1 update per column serves both halves.
// Step c changes exactly 128 columns: the A-half columns > c (the columns
// <= c go stale and are never read again) and the M-half columns <= c (M is
// lower triangular, so its row c is zero beyond c).  Thread t takes active
// column a = t % LEAF — A-half column a when a > c, else M-half column a —
// and every LEAF_GROUPS-th row below c.  On exit the M half holds L^-1 in
// its lower triangle, and row c of the A half holds L[a, c] at a > c and
// the pivot L[c, c]^2 at a = c.
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
// reads broadcast across the warp.
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
// KEEP_L, Lw receives all of L instead: the diagonal blocks from the sweeps,
// zeros above the diagonal within them, L's blocks below them.  Without
// INVERSE only the diagonal blocks of M are formed (each leaf's L_pp^-1,
// which the elimination needs), and the blocks of Lw above the diagonal
// are left as they were.  The logdet is returned by thread 0 (other threads
// return 0).  The flags are template parameters, so each instance compiles
// only its own branches.
template <bool KEEP_L = false, bool INVERSE = true>
__device__ double factor_diag_block(float* A, int lda, int b, float noise,
                                    float* M, int ldm, float* Lw,
                                    float* smem) {
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
    if (KEEP_L) {
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
  if (!INVERSE) return ld;
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
        if (KEEP_L) S[(size_t)(e / LEAF) * b + e % LEAF] = 0.0f;
      }
      __syncthreads();
    }
  }
  return ld;
}

}  // namespace
