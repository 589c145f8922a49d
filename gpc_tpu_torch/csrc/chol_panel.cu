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
// K2, the leaf (leaf.cuh), inverts one 128 x 128 PD block by the augmented
// [A | I] Gauss-Jordan sweep in shared memory; L is never stored: the logdet
// is -2 sum log diag(L^-1).  Blocks wider than 128 are assembled from
// 128-leaves by blocked elimination and block triangular inversion, as
// _factor_diag_fast does.
//
// K5, chol_inv_block, replaces gpc_tpu/ops/chol_pallas.py::chol_inv_block:
// both its branches, the fused blocked kernel for n a multiple of 128
// (chol_inv_block_fused, :213) and the masked column sweep with a
// forward-substitution inverse for any other n (_chol_inv_kernel, :185):
// (L, L^-1) of one PD f32 block, any n up to 1024.  K6, chol_block, replaces
// chol_pallas.py::chol_block (_chol_kernel, :88): L alone.  Both are K2's
// blocked routine with L kept: the sweep leaves l^T in the upper triangle of
// the A half and the pivot on its diagonal, so each leaf's L_pp is read out
// of shared memory, and L's off-diagonal blocks are the ones the elimination
// forms anyway; K6 skips the block triangular inverse.  A block of n = 1024
// f32 is 4 MB, far above a block's 227 KB of shared memory, so the TPU's
// whole-block sweep is not carried over: the blocked routine is the design,
// with its workspace in device memory.  A ragged n (n % 128 = r != 0) is
// read into the workspace padded to the next multiple of 128 as
// [[A, 0], [0, I]] by masked scalar loads (no row of the input needs to be
// aligned); its factor is [[L, 0], [0, I]], so the padding is exact and the
// padded pivots stay 1, and the result is the n x n corner of the padded
// outputs, zeros above the diagonal.  One block of 1024 threads does it all: like K2
// it is bound by the dependent column steps (n rounded up to 128 of them)
// and the in-block 128-cubed GEMMs between leaves, not by its 12 n^2 bytes
// or 2 n^3 / 3 operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include "gram.cuh"
#include "leaf.cuh"

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
// K2, K5 and K6 on the leaf routines of leaf.cuh
// ---------------------------------------------------------------------------

// One block per batch entry: (M, logdet) of A[k] (destroyed).
__global__ void __launch_bounds__(LEAF_THREADS)
    factor_diag_kernel(float* A, int b, float* M, float* Lw, float* ld) {
  extern __shared__ float smem[];
  const size_t off = (size_t)blockIdx.x * b * b;
  const double l = factor_diag_block(A + off, b, b, 0.0f, M + off, b,
                                     Lw + off, smem);
  if (threadIdx.x == 0) ld[blockIdx.x] = (float)l;
}

// A (n x n) into Aw (np x np) as [[A, 0], [0, I]]: warp w takes rows w,
// w + 32, ..., its lanes the columns, eight loads in flight a thread.  Kept
// out of line: inlined, its registers stayed live into the factorization's
// loops, which spilled (K6 ran 45 % slower).
__device__ __noinline__ void pad_block(const float* __restrict__ A, int n, int np,
                                       float* __restrict__ Aw) {
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < np; r += LEAF_THREADS / 32) {
#pragma unroll 8
    for (int c = lane; c < np; c += 32)
      Aw[r * np + c] = r < n && c < n ? A[r * n + c] : (r == c ? 1.0f : 0.0f);
  }
}

// K5 (INV) and K6: L, and L^-1 under INV, of A (n x n, any n <= 1024).  A
// is read into the workspace Aw (np x np, np = n rounded up to LEAF) as
// [[A, 0], [0, I]]; L and M are np x np, their n x n corner the result.
// One block.
template <bool INV>
__global__ void __launch_bounds__(LEAF_THREADS)
    chol_any_kernel(const float* __restrict__ A, int n, int np, float* Aw,
                    float* L, float* M) {
  extern __shared__ float smem[];
  pad_block(A, n, np, Aw);
  __syncthreads();
  factor_diag_block<true, INV>(Aw, np, np, 0.0f, M, np, L, smem);
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

// K5 (inverse = 1) and K6 (inverse = 0: M, np x np, is then only the
// workspace of the leaves' inverses).  K6's L must be zero on entry:
// without the block inverse nothing writes its blocks above the diagonal.
extern "C" int gpc_chol_block(const float* A, int n, int np, float* Aw,
                              float* L, float* M, int inverse, void* stream) {
  auto kernel = inverse ? chol_any_kernel<true> : chol_any_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)LEAF_SMEM);
  kernel<<<1, LEAF_THREADS, LEAF_SMEM, (cudaStream_t)stream>>>(A, n, np, Aw,
                                                               L, M);
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
