// K8a: the three overlap probes of tools/tpu_overlap_probe.py on the H100.
//
// Each answers a question the redesign of K3's leaf chain and of K5 needs;
// each has a plain PyTorch version in probes/overlap.py that computes the
// same returned values (the (8, 128) corner the TPU probes return, with
// every accumulator zero on entry).  Shapes as the TPU probe's (RC = KC =
// 2048, B = 512), any multiples of 128 (KC of 256 for the slab stream).
//
// overlap_kernel (make_probe, :47-123): n_dots Schur GEMMs acc[tgt] -=
//   bf16(slab[i % 2]) bf16(vrow)^T, (RC, KC) x (B, KC)^T with f32
//   accumulation (or acc[tgt] = product + 1e-30 i under `overwrite`; tgt
//   alternates between two accumulators under `indep`), and n_leaves leaves
//   (L, L^-1) of aleaf + 1e-3 l I, K5's routine at n = B, in ONE cooperative
//   kernel.  A TPU core issues from one stream, so it interleaved the two in
//   program order.  On the H100 the leaves are a serial chain on block 0, as
//   in a factorization; the GEMMs are 128 x 128 output tiles, each tile's
//   dots in order on one block (the dependency the TPU probe's accumulator
//   carries; `indep` doubles the tiles that can run at once).  `seq` runs
//   every tile on every block, a grid barrier, then the leaf chain;
//   `inter` runs the leaf chain on block 0 while blocks 1 .. G-1 run the
//   tiles.  t(inter) near max(t(dots), t(leaves)) means the chain hides under
//   the GEMMs; near their sum, it does not.
// dma_kernel (make_dma_probe, :126-171): n_iters (RC, KC) bf16 slabs, slab i
//   from buffer i % n_bufs, streamed from device memory through shared memory
//   by cp.async, double-buffered: with the dot acc -= slab vrow^T (one
//   128 x 128 tile of acc per block, its rows of every slab), or without it,
//   128-row x 256-column pieces of each slab per block, the (8, 128) corner
//   summed as the TPU probe sums it.
// parts_kernel (make_leaf_parts_probe, :174-247): n repetitions on one block
//   of one part of a leaf: sweep128 / fsweep128 (K2's 128-wide sweep; the
//   TPU's masked and fast sweeps are one sweep here), gemm512 (a dependent
//   512^3 bf16 GEMM, f32 accumulation, on the tile GEMM), gemm128 (a
//   dependent 128^3 f32 GEMM, K5's in-block blk_gemm), fdiag (K5 at n = 512:
//   L and L^-1) and ffdiag (K2 at b = 512: L^-1 and the logdet).
//
// What bounds them: they measure, they are not on a path.  The GEMM tiles
// are bound by the tensor cores (2 RC KC B operations a dot), the stream by
// device memory (2 RC KC bytes a slab), the leaves by their serial column
// steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "leaf.cuh"
#include "tile.cuh"

namespace {

struct OverlapArgs {
  const bf16* slab;    // (2, RC, KC)
  const bf16* vrow;    // (B, KC)
  const float* aleaf;  // (B, B)
  float* acc;          // (2, RC, B), zero on entry
  float* lw;           // (3, B, B) the leaf's workspace
  unsigned* bar;       // (2) the grid barrier
  float* out;          // (8, 128)
  int RC, KC, B, n_dots, n_leaves, interleave, indep, overwrite;
};

__device__ void overlap_dots(const OverlapArgs& a, int first, int workers, bf16* sm) {
  float* ct = reinterpret_cast<float*>(sm);
  const int ntgt = a.indep ? 2 : 1;
  const int cts = a.B / LEAF;
  const int tiles = (a.RC / LEAF) * cts;
  for (int u = blockIdx.x - first; u < ntgt * tiles; u += workers) {
    const int tgt = u / tiles;
    const int rt = (u % tiles) / cts;
    const int cc = (u % tiles) % cts;
    float* C = a.acc + (size_t)tgt * a.RC * a.B + (size_t)rt * LEAF * a.B + cc * LEAF;
    for (int i = tgt; i < a.n_dots; i += ntgt) {
      const bf16* A = a.slab + (size_t)(i % 2) * a.RC * a.KC + (size_t)rt * LEAF * a.KC;
      const bf16* Bm = a.vrow + (size_t)cc * LEAF * a.KC;
      TileFrags acc;
      frags_zero(acc);
      tile_gemm<false, false, true>(
          acc, [&](int c) { return A + c * TK; }, a.KC,
          [&](int c) { return Bm + c * TK; }, a.KC, a.KC / TK, sm, NoSeen());
      frags_store(acc, ct);
      for (int e = threadIdx.x; e < LEAF * LEAF; e += LEAF_THREADS) {
        const int r = e / LEAF;
        const int c = e % LEAF;
        float* p = C + (size_t)r * a.B + c;
        *p = a.overwrite ? ct[r * CT_LD + c] + 1e-30f * (float)i : *p - ct[r * CT_LD + c];
      }
      __syncthreads();
    }
  }
}

// The leaf chain on this block: sum of 2 sum log diag L_l + M_l[0, 0] 1e-30
// (thread 0's value).
__device__ double overlap_leaves(const OverlapArgs& a, float* smem) {
  const size_t bb = (size_t)a.B * a.B;
  double ld = 0.0;
  for (int l = 0; l < a.n_leaves; ++l) {
    for (size_t e = threadIdx.x; e < bb; e += LEAF_THREADS)
      a.lw[e] = a.aleaf[e] + (e / a.B == e % a.B ? 1e-3f * (float)l : 0.0f);
    __syncthreads();
    const double l_ld = factor_diag_block<true>(a.lw, a.B, a.B, 0.0f, a.lw + 2 * bb, a.B,
                                                a.lw + bb, smem);
    if (threadIdx.x == 0) ld += l_ld + (double)(a.lw[2 * bb] * 1e-30f);
    __syncthreads();
  }
  return ld;
}

__global__ void __launch_bounds__(LEAF_THREADS, 1) overlap_kernel(OverlapArgs a) {
  extern __shared__ __align__(128) float dsm[];
  const int G = gridDim.x;
  const bool inter = a.interleave && a.n_leaves > 0;
  double ld = 0.0;
  if (inter) {
    if (blockIdx.x == 0) ld = overlap_leaves(a, dsm);
    else overlap_dots(a, 1, G - 1, reinterpret_cast<bf16*>(dsm));
  } else {
    overlap_dots(a, 0, G, reinterpret_cast<bf16*>(dsm));
    if (a.n_dots > 0 && a.n_leaves > 0) grid_sync(a.bar, G);
    if (blockIdx.x == 0) ld = overlap_leaves(a, dsm);
  }
  grid_sync(a.bar, G);
  if (blockIdx.x == 0) {   // thread t: element (t / 128, t % 128) of the corner
    double* ld0 = reinterpret_cast<double*>(dsm);
    if (threadIdx.x == 0) *ld0 = ld;
    __syncthreads();
    a.out[threadIdx.x] =
        __ldcg(a.acc + (size_t)(threadIdx.x / LEAF) * a.B + threadIdx.x % LEAF) +
        (float)*ld0;
  }
}

struct DmaArgs {
  const bf16* hbm;   // (n_bufs, RC, KC)
  const bf16* vrow;  // (B, KC)
  float* out;        // (8, 128)
  int RC, KC, B, n_iters, n_bufs, with_dots;
};

constexpr int KSEG = 256;   // slab columns a block streams per piece, no dot

__global__ void __launch_bounds__(LEAF_THREADS, 1) dma_kernel(DmaArgs a) {
  extern __shared__ __align__(128) float dsm[];
  bf16* sm = reinterpret_cast<bf16*>(dsm);
  const int t = threadIdx.x;
  const size_t slab = (size_t)a.RC * a.KC;
  TileFrags acc;
  if (a.with_dots) {
    const int cts = a.B / LEAF;
    const int cps = a.KC / TK;
    for (int u = blockIdx.x; u < (a.RC / LEAF) * cts; u += gridDim.x) {
      const bf16* A = a.hbm + (size_t)(u / cts) * LEAF * a.KC;
      const bf16* Bm = a.vrow + (size_t)(u % cts) * LEAF * a.KC;
      frags_zero(acc);
      tile_gemm<false, false, true>(
          acc, [&](int c) { return A + (size_t)((c / cps) % a.n_bufs) * slab + (c % cps) * TK; },
          a.KC, [&](int c) { return Bm + (c % cps) * TK; }, a.KC, a.n_iters * cps, sm,
          NoSeen());
      if (u == 0) {
        float* ct = reinterpret_cast<float*>(dsm);
        frags_store(acc, ct);
        a.out[t] = -ct[(t / LEAF) * CT_LD + t % LEAF];
      }
    }
  } else {
    const int segs = a.KC / KSEG;
    const int cps = KSEG / TK;
    const int col = t % LEAF;
    const int row = t / LEAF;
    for (int u = blockIdx.x; u < (a.RC / LEAF) * segs; u += gridDim.x) {
      const bf16* A = a.hbm + (size_t)(u / segs) * LEAF * a.KC + (u % segs) * KSEG;
      const bool corner = u == 0;
      float s = 0.0f;
      tile_gemm<false, false, false>(
          acc, [&](int c) { return A + (size_t)((c / cps) % a.n_bufs) * slab + (c % cps) * TK; },
          a.KC, [&](int) { return (const bf16*)nullptr; }, 0, a.n_iters * cps, sm,
          [&](int c, const bf16* As) {
            const int k0 = (c % cps) * TK;
            if (corner && col >= k0 && col < k0 + TK)
              s += __bfloat162float(As[row * RM_LD + col - k0]);
          });
      if (corner) a.out[t] = s;
    }
  }
}

enum PartKind { PART_SWEEP128 = 0, PART_FSWEEP128 = 1, PART_GEMM512 = 2, PART_GEMM128 = 3,
                PART_FDIAG = 4, PART_FFDIAG = 5 };

constexpr int PN = 512;   // the leaf-parts probe's wide block

struct PartsArgs {
  const float* a512;  // (512, 512)
  const float* a128;  // (128, 128)
  const bf16* a512b;  // bf16(a512)
  float* acc;         // (512, 512), zero on entry
  bf16* accb;         // (512, 512) bf16(acc), gemm512's input
  float* w;           // (3, 512, 512) fdiag's workspace
  float* out;         // (8, 128)
  int kind, n;
};

// Column sums of the sweep's L (sweep128) and M into acc's row 0.
__device__ void parts_sweep(const PartsArgs& a, float fi, float* smem) {
  float* W = smem;
  float* lvec = W + LEAF * AUGW;
  float* urow = lvec + LEAF;
  const int t = threadIdx.x;
  for (int e = t; e < LEAF * AUGW; e += LEAF_THREADS) {
    const int r = e / AUGW;
    const int c = e % AUGW;
    W[e] = c < LEAF ? a.a128[r * LEAF + c] + fi * 1e-3f : (r == c - LEAF ? 1.0f : 0.0f);
  }
  __syncthreads();
  leaf_sweep(W, lvec, urow);
  if (t < LEAF) {
    float s = 0.0f;
    for (int r = t; r < LEAF; ++r) s += W[r * AUGW + LEAF + t];   // M[r][t]
    if (a.kind == PART_SWEEP128) {
      s += sqrtf(W[t * AUGW + t]);                                 // L[t][t]
      for (int r = t + 1; r < LEAF; ++r) s += W[t * AUGW + r];     // L[r][t]
    }
    a.acc[t] += s;
  }
  __syncthreads();
}

__device__ void parts_gemm512(const PartsArgs& a, float fi, float* smem) {
  bf16* sm = reinterpret_cast<bf16*>(smem);
  float* ct = smem;
  for (int e = threadIdx.x; e < PN * PN; e += LEAF_THREADS)
    a.accb[e] = __float2bfloat16(a.acc[e]);
  __threadfence();
  __syncthreads();
  for (int tile = 0; tile < (PN / LEAF) * (PN / LEAF); ++tile) {
    const int rt = tile / (PN / LEAF);
    const int cc = tile % (PN / LEAF);
    const bf16* A = a.accb + (size_t)rt * LEAF * PN;   // row-major (r, k)
    const bf16* Bm = a.a512b + cc * LEAF;              // k-major: (s, k) at k PN + s
    TileFrags acc;
    frags_zero(acc);
    tile_gemm<false, true, true>(acc, [&](int c) { return A + c * TK; }, PN,
                                 [&](int c) { return Bm + (size_t)c * TK * PN; }, PN,
                                 PN / TK, sm, NoSeen());
    frags_store(acc, ct);
    for (int e = threadIdx.x; e < LEAF * LEAF; e += LEAF_THREADS) {
      const int r = e / LEAF;
      const int c = e % LEAF;
      a.acc[(size_t)(rt * LEAF + r) * PN + cc * LEAF + c] = ct[r * CT_LD + c] * 1e-6f + fi * 1e-9f;
    }
    __syncthreads();
  }
}

__device__ void parts_fdiag(const PartsArgs& a, float fi, float* smem) {
  const size_t nn = (size_t)PN * PN;
  const int t = threadIdx.x;
  for (size_t e = t; e < nn; e += LEAF_THREADS) a.w[e] = a.a512[e] + fi * 1e-3f;
  __syncthreads();
  const bool keep_l = a.kind == PART_FDIAG;
  const double ld =
      keep_l ? factor_diag_block<true>(a.w, PN, PN, 0.0f, a.w + 2 * nn, PN, a.w + nn, smem)
             : factor_diag_block(a.w, PN, PN, 0.0f, a.w + 2 * nn, PN, a.w + nn, smem);
  if (t == 0) smem[0] = (float)ld;
  __syncthreads();
  const float ld2 = smem[0];
  if (t < LEAF) {
    float s = keep_l ? 0.0f : ld2;
    for (int r = 0; r < PN; ++r) {
      s += a.w[2 * nn + (size_t)r * PN + t];           // M[r][t]
      if (keep_l) s += a.w[nn + (size_t)r * PN + t];   // L[r][t]
    }
    a.acc[t] += s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(LEAF_THREADS, 1) parts_kernel(PartsArgs a) {
  extern __shared__ __align__(128) float dsm[];
  for (int i = 0; i < a.n; ++i) {
    const float fi = (float)i;
    switch (a.kind) {
      case PART_SWEEP128:
      case PART_FSWEEP128:
        parts_sweep(a, fi, dsm);
        break;
      case PART_GEMM512:
        parts_gemm512(a, fi, dsm);
        break;
      case PART_GEMM128:
        blk_gemm(a.acc, PN, a.a128, LEAF, false, a.acc, PN, 1e-6f, false, dsm);
        for (int e = threadIdx.x; e < LEAF * LEAF; e += LEAF_THREADS)
          a.acc[(e / LEAF) * PN + e % LEAF] += fi * 1e-9f;
        __syncthreads();
        break;
      default:
        parts_fdiag(a, fi, dsm);
    }
  }
  a.out[threadIdx.x] = a.acc[(threadIdx.x / LEAF) * PN + threadIdx.x % LEAF];
}

}  // namespace

extern "C" int gpc_probe_grid() {
  return cooperative_grid(overlap_kernel, 1 << 20);
}

extern "C" int gpc_overlap_probe(const void* slab, const void* vrow, const float* aleaf,
                                 float* acc, float* lw, unsigned* bar, float* out, int RC,
                                 int KC, int B, int n_dots, int n_leaves, int interleave,
                                 int indep, int overwrite, int grid, void* stream) {
  OverlapArgs a{static_cast<const bf16*>(slab), static_cast<const bf16*>(vrow), aleaf,
                acc, lw, bar, out, RC, KC, B, n_dots, n_leaves, interleave, indep,
                overwrite};
  cudaFuncSetAttribute(overlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)LEAF_SMEM);
  void* args[] = {&a};
  cudaLaunchCooperativeKernel((const void*)overlap_kernel, dim3(grid), dim3(LEAF_THREADS),
                              args, LEAF_SMEM, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int gpc_dma_probe(const void* hbm, const void* vrow, float* out, int RC, int KC,
                             int B, int n_iters, int n_bufs, int with_dots, int grid,
                             void* stream) {
  DmaArgs a{static_cast<const bf16*>(hbm), static_cast<const bf16*>(vrow), out, RC, KC, B,
            n_iters, n_bufs, with_dots};
  cudaFuncSetAttribute(dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)LEAF_SMEM);
  dma_kernel<<<grid, LEAF_THREADS, LEAF_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int gpc_leaf_parts(const float* a512, const float* a128, const void* a512b,
                              float* acc, void* accb, float* w, float* out, int kind, int n,
                              void* stream) {
  PartsArgs a{a512, a128, static_cast<const bf16*>(a512b), acc, static_cast<bf16*>(accb),
              w, out, kind, n};
  cudaFuncSetAttribute(parts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)LEAF_SMEM);
  parts_kernel<<<1, LEAF_THREADS, LEAF_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
