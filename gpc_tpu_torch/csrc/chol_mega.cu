// K7: the whole rbf evidence in ONE launch, a Hopper probe.
//
// Replaces tools/chol_mega_v2.py::evidence_mega_rbf (_mega_kernel): (logdet K,
// sum_d m_d^T K^-1 m_d) for K = rbf-Gram(X) + noise I, N = nb b, with gpc_tpu's
// schedule and bf16 policy: the Schur corrections from packed bf16 L^T slots
// (slot tri(i, j) = i (i + 1) / 2 + j holds L_ij^T, b x b) with f32
// accumulation, L_ij^T = bf16(M_jj) bf16(A_ij)^T with M_jj = L_jj^-1 the leaf
// inverse, and the forward solve v = L^-1 m carried along, bf16 in and f32
// accumulated.  No model path reaches it (neither gpc_tpu's nor the port's):
// it answers whether one persistent launch beats K3's host loop of 512
// launches for the same work.
//
// The TPU kernel was one in-order program.  On the H100 it is a persistent
// cooperative grid (cudaLaunchCooperativeKernel, no more blocks than can be
// co-resident: one 1024-thread block per SM, held by the leaf's 132 KB of
// shared memory) with a grid-wide barrier after each phase:
//
//   set-up       D_i = rbf(X_i, X_i) + noise I for every diagonal block,
//                w = m                                        (all blocks)
//   column j, A  block 0: K2's leaf on D_j -> M_jj and logdet_j (leaf.cuh),
//                v_j = M_jj w_j (f32), bf16(M_jj) for the rows
//   column j, B  rows i > j, one 128 x 128 tile each, spread over blocks
//                1 .. G-1: A_ij = rbf(X_i, X_j) - sum_{k<j} L_ik L_jk^T
//                (one TN GEMM over the j contiguous slots of rows i and j),
//                L_ij^T into slot tri(i, j), then the right-looking updates
//                D_i -= L_ij L_ij^T and w_i -= L_ij v_j
//
// The TPU program formed D_j and w_j left-looking at the diagonal step (one
// wide dot each); here the owner of row i folds L_ij into them as soon as it
// has it, which moves that work off block 0's serial chain.  The products are
// the same bf16 products with f32 sums, in another order.  Every read of data
// another block wrote goes through L2 (cp.async.cg, __ldcg), never a stale L1.
//
// What bounds it: the same work as K3, so K3's bound (N^3/3 bf16 Schur
// operations, 1.57 ms at N = 16384); in fact the nb serial leaves and the
// 2 nb + 1 grid barriers, with the row phase at most nb - 1 tiles wide, one
// per SM.  Modes, for slice timing (tools/chol_mega_v2.py:216):
//   full    the evidence
//   noleaf  the diagonal stand-in of chol_mega_v2.py:110-118: M_jj =
//           diag(1 / (max_c |D_j[r, c]| + 1)), no sweep
//   nodot   the row correction skipped: both operands still stream through
//           shared memory, no product is formed
//   nodma   the row correction read from row j's own slots (the resident
//           column panel, L2-hot on the H100) instead of row i's
//   nogram  the exp map skipped: var * d2 (the evidence is then not finite)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "leaf.cuh"
#include "tile.cuh"

namespace {

enum MegaMode { MEGA_FULL = 0, MEGA_NOLEAF = 1, MEGA_NODOT = 2, MEGA_NODMA = 3,
                MEGA_NOGRAM = 4 };

struct MegaArgs {
  const float* Xs;   // (N, q) inputs scaled by sqrt(gamma / 2)
  const float* n2;   // (N) their squared norms
  const float* m;    // (N, D) right-hand sides
  float var, noise;
  int N, q, D, nb, mode;
  bf16* T;           // (nb (nb + 1) / 2, b, b) packed L^T slots
  float* Dbuf;       // (nb, b, b) the diagonal blocks, corrected as rows land
  float* w;          // (N, D) the forward solve: w, then v
  bf16* Mdb;         // (b, b) bf16(M_jj) of the current column
  double* ldj;       // (nb) logdet of each leaf
  bf16* scratch;     // (G, b, b) each block's bf16(A_ij)
  unsigned* bar;     // (2) the grid barrier
  float* out;        // (2) logdet, quad
};

__device__ __forceinline__ size_t tri0(int i) { return (size_t)i * (i + 1) / 2; }

// rbf(X_{i0 + r}, X_{j0 + c}) from the pre-scaled inputs, gpc_tpu's form:
// var exp(-max(n2_r + n2_c - 2 x_r . x_c, 0)).
__device__ __forceinline__ float mega_gram(const MegaArgs& a, int r, int c) {
  float cross = 0.0f;
  for (int k = 0; k < a.q; ++k)
    cross += __ldg(a.Xs + (size_t)r * a.q + k) * __ldg(a.Xs + (size_t)c * a.q + k);
  const float d2 = fmaxf(__ldg(a.n2 + r) + __ldg(a.n2 + c) - 2.0f * cross, 0.0f);
  return a.mode == MEGA_NOGRAM ? a.var * d2 : a.var * expf(-d2);
}

// Phase A on block 0: the leaf of column j.
__device__ void mega_diag(const MegaArgs& a, int j, float* smem) {
  float* W = smem;
  float* lvec = W + LEAF * AUGW;
  float* urow = lvec + LEAF;
  const int t = threadIdx.x;
  const float* Dj = a.Dbuf + (size_t)j * LEAF * LEAF;
  for (int e = t; e < LEAF * AUGW; e += LEAF_THREADS) {
    const int r = e / AUGW;
    const int c = e % AUGW;
    W[e] = c < LEAF ? __ldcg(Dj + r * LEAF + c) : (r == c - LEAF ? 1.0f : 0.0f);
  }
  __syncthreads();
  if (a.mode == MEGA_NOLEAF) {
    // M = diag(1 / dcol), dcol_r = max_c |D_j[r, c]| + 1: urow holds dcol
    if (t < LEAF) {
      float mx = 0.0f;
      for (int c = 0; c < LEAF; ++c) mx = fmaxf(mx, fabsf(W[t * AUGW + c]));
      urow[t] = mx + 1.0f;
    }
    __syncthreads();
    for (int e = t; e < LEAF * LEAF; e += LEAF_THREADS) {
      const int r = e / LEAF;
      const int c = e % LEAF;
      W[r * AUGW + LEAF + c] = r == c ? 1.0f / urow[r] : 0.0f;
    }
    __syncthreads();
  } else {
    leaf_sweep(W, lvec, urow);
  }
  if (t == 0) {
    double ld = 0.0;
    for (int c = 0; c < LEAF; ++c) ld -= 2.0 * log((double)W[c * AUGW + LEAF + c]);
    a.ldj[j] = ld;
  }
  for (int e = t; e < LEAF * LEAF; e += LEAF_THREADS) {
    const int r = e / LEAF;
    const int c = e % LEAF;
    a.Mdb[e] = __float2bfloat16(c <= r ? W[r * AUGW + LEAF + c] : 0.0f);
  }
  // v_j = M_jj w_j in f32 (_gemm32); the inputs are read before any write
  const size_t jb = (size_t)j * LEAF;
  const int r = t % LEAF;
  float* wj = lvec;   // free after the sweep: one right-hand side at a time
  for (int d = 0; d < a.D; ++d) {
    __syncthreads();
    if (t < LEAF) wj[t] = __ldcg(a.w + (jb + t) * a.D + d);
    __syncthreads();
    if (t < LEAF) {
      float s = 0.0f;
      for (int c = 0; c <= r; ++c) s += W[r * AUGW + LEAF + c] * wj[c];
      a.w[(jb + r) * a.D + d] = s;
    }
  }
}

// Phase B: row i of column j on one block.
__device__ void mega_row(const MegaArgs& a, int i, int j, bf16* sm, bf16* S) {
  float* ct = reinterpret_cast<float*>(sm);   // aliases the stages
  const int t = threadIdx.x;
  const size_t ib = (size_t)i * LEAF, jb = (size_t)j * LEAF;
  const bf16* Vi = a.T + tri0(a.mode == MEGA_NODMA ? j : i) * LEAF * LEAF;
  const bf16* Vj = a.T + tri0(j) * LEAF * LEAF;
  TileFrags acc;
  frags_zero(acc);
  // correction sum_{k<j} L_ik L_jk^T = Vi^T Vj over K = j b (k-major slots)
  auto ai = [&](int c) { return Vi + (size_t)c * TK * LEAF; };
  auto aj = [&](int c) { return Vj + (size_t)c * TK * LEAF; };
  const int nch = j * (LEAF / TK);
  if (a.mode == MEGA_NODOT)
    tile_gemm<true, true, false>(acc, ai, LEAF, aj, LEAF, nch, sm, NoSeen());
  else
    tile_gemm<true, true, true>(acc, ai, LEAF, aj, LEAF, nch, sm, NoSeen());
  frags_store(acc, ct);
  // A_ij = rbf - correction, bf16 (the dot's input rounding) into S
  for (int e = t; e < LEAF * LEAF; e += LEAF_THREADS) {
    const int r = e / LEAF;
    const int c = e % LEAF;
    S[e] = __float2bfloat16(mega_gram(a, (int)ib + r, (int)jb + c) - ct[r * CT_LD + c]);
  }
  __threadfence();
  __syncthreads();
  // L_ij^T = bf16(M_jj) bf16(A_ij)^T: row-major operands, K = b
  frags_zero(acc);
  auto am = [&](int c) { return a.Mdb + c * TK; };
  auto as = [&](int c) { return S + c * TK; };
  tile_gemm<false, false, true>(acc, am, LEAF, as, LEAF, LEAF / TK, sm, NoSeen());
  frags_store(acc, ct);
  bf16* slot = a.T + (tri0(i) + j) * LEAF * LEAF;
  for (int e = t; e < LEAF * LEAF; e += LEAF_THREADS) {
    const int c = e / LEAF;
    const int r = e % LEAF;
    const bf16 l = __float2bfloat16(ct[c * CT_LD + r]);
    slot[e] = l;
    ct[c * CT_LD + r] = __bfloat162float(l);
  }
  __syncthreads();
  // w_i -= L_ij bf16(v_j): L_ij[r][c] = ct[c][r]
  {
    const int r = t % LEAF;
    for (int d = t / LEAF; d < a.D; d += LEAF_GROUPS) {
      float s = 0.0f;
      for (int c = 0; c < LEAF; ++c)
        s += ct[c * CT_LD + r] * bf16_round(__ldcg(a.w + (jb + c) * a.D + d));
      float* wi = a.w + (ib + r) * a.D + d;
      *wi = __ldcg(wi) - s;
    }
  }
  __threadfence();
  __syncthreads();
  // D_i -= L_ij L_ij^T = slot^T slot (k-major, K = b)
  frags_zero(acc);
  auto al = [&](int c) { return slot + (size_t)c * TK * LEAF; };
  tile_gemm<true, true, true>(acc, al, LEAF, al, LEAF, LEAF / TK, sm, NoSeen());
  frags_store(acc, ct);
  float* Di = a.Dbuf + (size_t)i * LEAF * LEAF;
  for (int e = t; e < LEAF * LEAF; e += LEAF_THREADS) {
    const int r = e / LEAF;
    const int c = e % LEAF;
    Di[e] = __ldcg(Di + e) - ct[r * CT_LD + c];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(LEAF_THREADS, 1) mega_kernel(MegaArgs a) {
  extern __shared__ __align__(128) float dsm[];
  const unsigned G = gridDim.x;
  const int t = threadIdx.x;
  // set-up: the diagonal blocks and w = m
  for (int i = blockIdx.x; i < a.nb; i += G) {
    float* Di = a.Dbuf + (size_t)i * LEAF * LEAF;
    for (int e = t; e < LEAF * LEAF; e += LEAF_THREADS) {
      const int r = e / LEAF;
      const int c = e % LEAF;
      Di[e] = mega_gram(a, i * LEAF + r, i * LEAF + c) + (r == c ? a.noise : 0.0f);
    }
  }
  for (size_t e = (size_t)blockIdx.x * LEAF_THREADS + t; e < (size_t)a.N * a.D;
       e += (size_t)G * LEAF_THREADS)
    a.w[e] = a.m[e];
  grid_sync(a.bar, G);
  bf16* S = a.scratch + (size_t)blockIdx.x * LEAF * LEAF;
  for (int j = 0; j < a.nb; ++j) {
    if (blockIdx.x == 0) mega_diag(a, j, dsm);
    grid_sync(a.bar, G);
    if (blockIdx.x > 0)
      for (int i = j + blockIdx.x; i < a.nb; i += G - 1)
        mega_row(a, i, j, reinterpret_cast<bf16*>(dsm), S);
    grid_sync(a.bar, G);
  }
  // every v_j and logdet_j was written by block 0 itself
  if (blockIdx.x == 0) {
    double* red = reinterpret_cast<double*>(dsm);
    double s = 0.0;
    for (size_t e = t; e < (size_t)a.N * a.D; e += LEAF_THREADS) {
      const double v = a.w[e];
      s += v * v;
    }
    red[t] = s;
    __syncthreads();
    for (int h = LEAF_THREADS / 2; h > 0; h >>= 1) {
      if (t < h) red[t] += red[t + h];
      __syncthreads();
    }
    if (t == 0) {
      double ld = 0.0;
      for (int j = 0; j < a.nb; ++j) ld += a.ldj[j];
      a.out[0] = (float)ld;
      a.out[1] = (float)red[0];
    }
  }
}

}  // namespace

// The co-resident grid for nb columns (block 0 and at most nb - 1 row
// blocks); 0 if fewer than two blocks fit.
extern "C" int gpc_mega_grid(int nb) {
  const int g = cooperative_grid(mega_kernel, nb);
  return g >= 2 ? g : 0;
}

extern "C" int gpc_evidence_mega(const float* Xs, const float* n2, const float* m,
                                 float var, float noise, int N, int q, int D,
                                 int mode, int grid, void* T, float* Dbuf,
                                 float* w, void* Mdb, double* ldj, void* scratch,
                                 unsigned* bar, float* out, void* stream) {
  MegaArgs a{Xs, n2, m, var, noise, N, q, D, N / LEAF, mode,
             static_cast<bf16*>(T), Dbuf, w, static_cast<bf16*>(Mdb), ldj,
             static_cast<bf16*>(scratch), bar, out};
  cudaFuncSetAttribute(mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)LEAF_SMEM);
  void* args[] = {&a};
  cudaLaunchCooperativeKernel((const void*)mega_kernel, dim3(grid),
                              dim3(LEAF_THREADS), args, LEAF_SMEM,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
