// The Cholesky routines of K2, K3's leaf, K5 and K6 (chol_panel.cu): a
// 128-leaf without a block barrier per column, and a register-tiled f32
// 128^3 tile GEMM for the multi-block assembly of wider blocks.  Every
// routine here is run by one block of TILE_THREADS = 256 threads.  The probes
// K7 (chol_mega.cu) and K8a (probes.cu) run them too.
//
// What bounded the first design (a Gauss-Jordan leaf, since deleted) on the
// H100, and what this one does about it:
//
//  * the Gauss-Jordan sweep paid two barriers of 1024 threads per
//    column, 256 a leaf (~1.1 us a column, 0.133 ms a leaf).  leaf128 below
//    factors by 32-wide sub-panels instead: one warp factors the 32 x 32
//    diagonal block in registers (shuffles, no block barrier), one thread per
//    row below solves its row against it by forward substitution, and all
//    256 threads apply the rank-32 update to the trailing block in register
//    micro-tiles.  L^-1 then comes from the four 32-block inverses (one warp
//    each) and block-triangular inversion over the 4 x 4 grid of 32-blocks,
//    three rounds of two products.  That is 18 block barriers a leaf, not 256.
//    Everything stays in shared memory (L and L^-1, 2 x 66 KB, padded rows of
//    129 floats: a row-per-lane or column-per-lane access is free of bank
//    conflicts) and in exact f32 FMAs; the logdet is 2 sum log L_cc in double.
//
//  * blk_gemm read one shared-memory operand per FMA (~77 GFLOP/s a block,
//    15 % of an SM's f32 rate).  mm128 below gives each of 256 threads an
//    8 x 8 register tile: per four k it reads 16 float4 (8 rows of A, 8 of B)
//    for 256 FMAs.  Operands stream through two shared-memory stages of 32 k
//    each by cp.async (straight to shared memory through L2), so the next
//    chunk loads while this one is multiplied.
//
//  * one block did all of a block of up to 1024 (131 SMs idle).  The blocked
//    factorization is now a host-driven plan of launches (ops/chol_pallas.py
//    builds it, gpc_chol_blocked in chol_panel.cu runs it): per 128-panel p the
//    leaf on one block, the panel solve L_ip = A_ip L_pp^-T on one block per
//    tile below it, and the trailing update A_ij -= L_ip L_jp^T on one block
//    per lower tile (each tile owned by one block: no atomics, deterministic);
//    then, for K5, the block inverse by diagonals d, M_{j+d,j} = -M_{j+d,j+d}
//    sum_k L_{j+d,k} M_{k,j}, one block per tile, the tiles of a diagonal
//    independent of each other.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int LEAF = 128;            // leaf width; also K3's panel width b
constexpr int TILE_THREADS = 256;
constexpr int SUB = 32;              // sub-panel width: one warp's diagonal block
constexpr int LDS = LEAF + 1;        // padded shared row of the leaf (floats)
constexpr size_t LEAF_SMEM = (size_t)(2 * LEAF * LDS + LEAF) * sizeof(float);
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------------------
// The 128-leaf
// ---------------------------------------------------------------------------

// One warp: the lower Cholesky factor of the 32 x 32 block D (stride LDS) in
// place, and dinv[c] = 1 / L_cc.  Lane i holds row i in registers; step c
// broadcasts column c by shuffles.  Lanes below c hold stale values in their
// row[c] and ignore them.  The pivot's reciprocal square root (one SFU
// instruction, as the first design's sweep used) replaces an IEEE square
// root and reciprocal on the serial chain.
__device__ __forceinline__ void chol32(float* D, float* dinv, int lane) {
  float row[SUB];
#pragma unroll
  for (int j = 0; j < SUB; ++j) row[j] = D[lane * LDS + j];
#pragma unroll
  for (int c = 0; c < SUB; ++c) {
    const float piv = __shfl_sync(FULL_MASK, row[c], c);
    const float inv = rsqrtf(piv);
    row[c] = lane == c ? piv * inv : row[c] * inv;
    if (lane == 0) dinv[c] = inv;
#pragma unroll
    for (int j = c + 1; j < SUB; ++j) {
      const float ljc = __shfl_sync(FULL_MASK, row[c], j);
      if (lane >= j) row[j] = fmaf(-row[c], ljc, row[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < SUB; ++j)
    if (j <= lane) D[lane * LDS + j] = row[j];
}

// One thread: row R (32 wide) <- R D^-T for the lower factor D (stride LDS,
// dinv its diagonal's reciprocals), by forward substitution; D is read by
// broadcast.
__device__ __forceinline__ void trsm_row(const float* D, const float* dinv, float* R) {
  float x[SUB];
#pragma unroll
  for (int j = 0; j < SUB; ++j) x[j] = R[j];
#pragma unroll
  for (int j = 0; j < SUB; ++j) {
    float s0 = x[j], s1 = 0.0f;   // two chains: half the dependent FMAs
#pragma unroll
    for (int k = 0; k < j; ++k) {
      if (k % 2 == 0) s0 = fmaf(-x[k], D[j * LDS + k], s0);
      else s1 = fmaf(-x[k], D[j * LDS + k], s1);
    }
    x[j] = (s0 + s1) * dinv[j];
  }
#pragma unroll
  for (int j = 0; j < SUB; ++j) R[j] = x[j];
}

// All threads: the trailing block T (rows/cols base.. base + 16 R) of Ls
// -= P P^T on its lower triangle, P = Ls[rows, k0:k0+32].  Thread (ty, tx)
// owns rows base + ty + 16 a and columns base + tx + 16 b.
template <int R>
__device__ __forceinline__ void syrk_update(float* Ls, int k0) {
  const int base = k0 + SUB;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = 0.0f;
#pragma unroll 4
  for (int k = k0; k < k0 + SUB; ++k) {
    float pa[R], pb[R];
#pragma unroll
    for (int a = 0; a < R; ++a) pa[a] = Ls[(base + ty + 16 * a) * LDS + k];
#pragma unroll
    for (int b = 0; b < R; ++b) pb[b] = Ls[(base + tx + 16 * b) * LDS + k];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) acc[a][b] = fmaf(pa[a], pb[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int r = base + ty + 16 * a;
      const int c = base + tx + 16 * b;
      if (c <= r) Ls[r * LDS + c] -= acc[a][b];
    }
}

// One warp: X = D^-1 for the lower 32 x 32 factor D (both stride LDS; dinv
// its diagonal's reciprocals).  Lane j forms column j by forward
// substitution (zeros above the diagonal).
__device__ __forceinline__ void inv32(const float* D, const float* dinv, float* X,
                                      int lane) {
  float x[SUB];
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    float s0 = i == lane ? 1.0f : 0.0f, s1 = 0.0f;
#pragma unroll
    for (int k = 0; k < i; ++k) {
      if (k % 2 == 0) s0 = fmaf(-D[i * LDS + k], x[k], s0);
      else s1 = fmaf(-D[i * LDS + k], x[k], s1);
    }
    x[i] = (s0 + s1) * dinv[i];
  }
#pragma unroll
  for (int i = 0; i < SUB; ++i) X[i * LDS + lane] = x[i];
}

// (L, M = L^-1, log|A + noise I|) of one PD 128 x 128 block A (lda; the
// lower triangle is read, the whole block loaded).  L (ldl; may be null) and
// M (ldm) receive the lower triangles with zeros above.  A, L and M are read
// and written as float4: their rows start 16-byte aligned (lda, ldl, ldm
// multiples of 4).  sm: LEAF_SMEM bytes
// of dynamic shared memory.  The logdet is returned by thread 0 (the other
// threads return 0); the routine ends in a block barrier, so L and M are
// complete for every thread of the block on return.
__device__ double leaf128(const float* __restrict__ A, int lda, float noise,
                          float* __restrict__ L, int ldl,
                          float* __restrict__ M, int ldm, float* sm) {
  float* Ls = sm;
  float* Ms = sm + LEAF * LDS;
  float* dinv = Ms + LEAF * LDS;      // 1 / L_cc
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  // the block in 16 float4 loads a thread, all issued before the first
  // store: the loads' latency is paid once, not once per element
  constexpr int V = LEAF * LEAF / 4 / TILE_THREADS;
  float4 in[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int e = t + u * TILE_THREADS;
    in[u] = *reinterpret_cast<const float4*>(A + (size_t)(e / (LEAF / 4)) * lda +
                                             4 * (e % (LEAF / 4)));
  }
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int e = t + u * TILE_THREADS;
    const int r = e / (LEAF / 4);
    const int c = 4 * (e % (LEAF / 4));
    float* d = Ls + r * LDS + c;
    d[0] = in[u].x + (r == c ? noise : 0.0f);
    d[1] = in[u].y + (r == c + 1 ? noise : 0.0f);
    d[2] = in[u].z + (r == c + 2 ? noise : 0.0f);
    d[3] = in[u].w + (r == c + 3 ? noise : 0.0f);
  }
  __syncthreads();
  // factor: per 32-wide sub-panel, diagonal block, rows below, trailing update
#pragma unroll 1
  for (int k0 = 0; k0 < LEAF; k0 += SUB) {
    if (warp == 0) chol32(Ls + k0 * LDS + k0, dinv + k0, lane);
    __syncthreads();
    const int nr = LEAF - k0 - SUB;
    if (t < nr) trsm_row(Ls + k0 * LDS + k0, dinv + k0, Ls + (k0 + SUB + t) * LDS + k0);
    __syncthreads();
    if (nr == 96) syrk_update<6>(Ls, k0);
    else if (nr == 64) syrk_update<4>(Ls, k0);
    else if (nr == 32) syrk_update<2>(Ls, k0);
    if (nr > 0) __syncthreads();
  }
  // the four 32-block inverses, one warp each
  if (warp < LEAF / SUB)
    inv32(Ls + warp * SUB * (LDS + 1), dinv + warp * SUB, Ms + warp * SUB * (LDS + 1), lane);
  __syncthreads();
  // block-triangular inverse by diagonals d of the 4 x 4 grid of 32-blocks:
  // S = sum_{j<=k<i} L_ik M_kj into the free upper block (j, i) of Ms, then
  // M_ij = -M_ii S.  Thread (tr, tc) owns elements (tr + 16 a, tc + 16 b).
  const int tr = t / 16;
  const int tc = t % 16;
  for (int d = 1; d < LEAF / SUB; ++d) {
    for (int j = 0; j + d < LEAF / SUB; ++j) {
      const int i = j + d;
      float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
      for (int k = SUB * j; k < SUB * i; ++k) {
        const float a0 = Ls[(SUB * i + tr) * LDS + k];
        const float a1 = Ls[(SUB * i + tr + 16) * LDS + k];
        const float b0 = Ms[k * LDS + SUB * j + tc];
        const float b1 = Ms[k * LDS + SUB * j + tc + 16];
        s[0][0] = fmaf(a0, b0, s[0][0]);
        s[0][1] = fmaf(a0, b1, s[0][1]);
        s[1][0] = fmaf(a1, b0, s[1][0]);
        s[1][1] = fmaf(a1, b1, s[1][1]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          Ms[(SUB * j + tr + 16 * a) * LDS + SUB * i + tc + 16 * b] = s[a][b];
    }
    __syncthreads();
    for (int j = 0; j + d < LEAF / SUB; ++j) {
      const int i = j + d;
      float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
      for (int k = 0; k < SUB; ++k) {   // M_ii is lower: rows tr + 16 a use k <= tr + 16 a
        const float a0 = Ms[(SUB * i + tr) * LDS + SUB * i + k];
        const float a1 = Ms[(SUB * i + tr + 16) * LDS + SUB * i + k];
        const float b0 = Ms[(SUB * j + k) * LDS + SUB * i + tc];
        const float b1 = Ms[(SUB * j + k) * LDS + SUB * i + tc + 16];
        s[0][0] = fmaf(a0, b0, s[0][0]);
        s[0][1] = fmaf(a0, b1, s[0][1]);
        s[1][0] = fmaf(a1, b0, s[1][0]);
        s[1][1] = fmaf(a1, b1, s[1][1]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          Ms[(SUB * i + tr + 16 * a) * LDS + SUB * j + tc + 16 * b] = -s[a][b];
    }
    __syncthreads();
  }
#pragma unroll 4
  for (int u = 0; u < V; ++u) {
    const int e = t + u * TILE_THREADS;
    const int r = e / (LEAF / 4);
    const int c = 4 * (e % (LEAF / 4));
    const float* l = Ls + r * LDS + c;
    const float* m = Ms + r * LDS + c;
    if (L != nullptr)
      *reinterpret_cast<float4*>(L + (size_t)r * ldl + c) =
          make_float4(c <= r ? l[0] : 0.0f, c + 1 <= r ? l[1] : 0.0f,
                      c + 2 <= r ? l[2] : 0.0f, c + 3 <= r ? l[3] : 0.0f);
    *reinterpret_cast<float4*>(M + (size_t)r * ldm + c) =
        make_float4(c <= r ? m[0] : 0.0f, c + 1 <= r ? m[1] : 0.0f,
                    c + 2 <= r ? m[2] : 0.0f, c + 3 <= r ? m[3] : 0.0f);
  }
  double ld = 0.0;
  if (warp == 0) {
    for (int c = lane; c < LEAF; c += 32) ld += log((double)Ls[c * LDS + c]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) ld += __shfl_down_sync(FULL_MASK, ld, off);
  }
  __syncthreads();
  return t == 0 ? 2.0 * ld : 0.0;
}

// ---------------------------------------------------------------------------
// The 128^3 tile GEMM
// ---------------------------------------------------------------------------

constexpr int KC = 32;                       // k chunk a stage holds
constexpr int SLD = KC + 4;                  // stage row: 32 k + pad (floats)
constexpr int STAGE = 2 * LEAF * SLD;        // floats: A's rows, then B's
constexpr size_t MM_SMEM = (size_t)2 * STAGE * sizeof(float);   // 72 KB

__device__ __forceinline__ void cpa16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cpa_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cpa_wait(bool one_pending) {
  if (one_pending) asm volatile("cp.async.wait_group 1;\n" ::);
  else asm volatile("cp.async.wait_group 0;\n" ::);
}

// S[r][k] = X[r][k0 + k] for 128 rows of a row-major X (ld a multiple of 4,
// rows 16-byte aligned): four 16-byte copies a thread.
__device__ __forceinline__ void stage_rows(float* S, const float* X, int ld, int k0) {
#pragma unroll
  for (int v = 0; v < LEAF * KC / 4 / TILE_THREADS; ++v) {
    const int e = threadIdx.x + v * TILE_THREADS;
    const int r = e / (KC / 4);
    const int q = e % (KC / 4);
    cpa16(S + r * SLD + 4 * q, X + (size_t)r * ld + k0 + 4 * q);
  }
}

// S[c][k] = X[k0 + k][c] for a row-major X of 128 columns: lane k of warp w
// reads columns 4 (w + 8 v) .. +4 of row k0 + k (from L2: X may have been
// written by this block) and stores them transposed, conflict-free.
__device__ __forceinline__ void stage_cols(float* S, const float* X, int ld, int k0) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int v = 0; v < LEAF / 4 / (TILE_THREADS / 32); ++v) {
    const int c4 = warp + (TILE_THREADS / 32) * v;
    const float4 x =
        __ldcg(reinterpret_cast<const float4*>(X + (size_t)(k0 + lane) * ld + 4 * c4));
    S[(4 * c4 + 0) * SLD + lane] = x.x;
    S[(4 * c4 + 1) * SLD + lane] = x.y;
    S[(4 * c4 + 2) * SLD + lane] = x.z;
    S[(4 * c4 + 3) * SLD + lane] = x.w;
  }
}

// acc += As Bs^T over one chunk; thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j.
__device__ __forceinline__ void mma_chunk(float (&acc)[8][8], const float* As,
                                          const float* Bs) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int k4 = 0; k4 < KC / 4; ++k4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * SLD + 4 * k4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * SLD + 4 * k4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

// acc[i][j] += sum_k A[r][k] op(B)[k][c] for the 128 x 128 x 128 tile, r = ty
// + 16 i, c = tx + 16 j; A row-major (lda); BT: B row-major with B[c][k]
// (the NT form of the panel solve and the trailing update), else B[k][c]
// (the NN form of the block inverse).  sm: MM_SMEM bytes.  Starts and ends
// with every thread past a block barrier, so calls may follow each other.
template <bool BT>
__device__ void mm128(float (&acc)[8][8], const float* A, int lda, const float* B,
                      int ldb, float* sm) {
  constexpr int NCH = LEAF / KC;
  auto load = [&](int kc) {
    float* As = sm + (kc & 1) * STAGE;
    float* Bs = As + LEAF * SLD;
    stage_rows(As, A, lda, kc * KC);
    if (BT) stage_rows(Bs, B, ldb, kc * KC);
    else stage_cols(Bs, B, ldb, kc * KC);
    cpa_commit();
  };
  load(0);
  for (int kc = 0; kc < NCH; ++kc) {
    if (kc + 1 < NCH) load(kc + 1);
    cpa_wait(kc + 1 < NCH);
    __syncthreads();
    const float* As = sm + (kc & 1) * STAGE;
    mma_chunk(acc, As, As + LEAF * SLD);
    __syncthreads();
  }
}

__device__ __forceinline__ void acc_zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

// C[r][c] = (Cin ? Cin[r][c] : 0) + alpha acc, the thread's 8 x 8 elements
// (a warp writes two rows of 16 consecutive floats a step).
__device__ __forceinline__ void acc_store(const float (&acc)[8][8], float* C, int ldc,
                                          const float* Cin, float alpha) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t o = (size_t)(ty + 16 * i) * ldc + tx + 16 * j;
      C[o] = Cin != nullptr ? fmaf(alpha, acc[i][j], Cin[o]) : alpha * acc[i][j];
    }
}

}  // namespace
