// The building blocks of the persistent kernels K7 (chol_mega.cu) and K8a
// (probes.cu): a 128 x 128 bf16 tile GEMM for one block of LEAF_THREADS
// threads, fed through shared memory by cp.async, and a grid-wide barrier
// for cooperative launches.
//
// tile_gemm computes acc += op(A) op(B)^T over K = nchunks * TK: C[r][s] =
// sum_k A(r, k) B(s, k), with f32 accumulation in WMMA fragments (bf16
// 16x16x16, as the MXU's bf16 passes).  An operand is either row-major
// (element (r, k) at p[r * ld + k], the NT form of a Schur correction) or
// k-major (element (r, k) at p[k * ld + r], gpc_tpu's packed L^T slots); a
// functor maps chunk c to the address of its element (0, k0).  Chunk c + 1
// streams into the second stage while the tensor cores work on chunk c
// (cp.async.cg: straight to shared memory through L2, no registers and no
// L1, so data other blocks wrote before a grid barrier is never read stale).
// 32 warps: warp w owns rows 32 (w / 8) .. +32 and columns 16 (w % 8) .. +16
// of the tile, two 16 x 16 accumulators.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "leaf.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TK = 64;               // k chunk staged per step
constexpr int KM_LD = LEAF + 8;      // k-major stage row: 128 r + pad (bf16)
constexpr int RM_LD = TK + 8;        // row-major stage row: 64 k + pad (bf16)
constexpr int STAGE_ELEMS = LEAF * RM_LD > TK * KM_LD ? LEAF * RM_LD : TK * KM_LD;
constexpr int STAGES_BYTES = 4 * STAGE_ELEMS * (int)sizeof(bf16);  // A, B x 2
constexpr int CT_LD = LEAF + 4;      // f32 result tile row
constexpr int CT_BYTES = LEAF * CT_LD * (int)sizeof(float);
static_assert(STAGES_BYTES <= (int)LEAF_SMEM && CT_BYTES <= (int)LEAF_SMEM,
              "the tile GEMM runs in the leaf's shared memory");
static_assert(TK * LEAF / 8 == LEAF_THREADS, "one 16-byte copy per thread");

struct TileFrags {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[2];
};

__device__ __forceinline__ void frags_zero(TileFrags& acc) {
  nvcuda::wmma::fill_fragment(acc.f[0], 0.0f);
  nvcuda::wmma::fill_fragment(acc.f[1], 0.0f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait(bool one_pending) {
  if (one_pending) asm volatile("cp.async.wait_group 1;\n" ::);
  else asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage one TK-deep chunk of a 128-row operand (chunk start p, stride ld).
template <bool KMAJOR>
__device__ __forceinline__ void stage_chunk(bf16* st, const bf16* p, long long ld) {
  const int t = threadIdx.x;
  if (KMAJOR) {   // TK rows of 128 contiguous r: 16 copies a row
    const int k = t / 16, seg = t % 16;
    cp_async16(st + k * KM_LD + seg * 8, p + k * ld + seg * 8);
  } else {        // 128 rows of TK contiguous k: 8 copies a row
    const int r = t / 8, seg = t % 8;
    cp_async16(st + r * RM_LD + seg * 8, p + r * ld + seg * 8);
  }
}

template <bool AK, bool BK>
__device__ __forceinline__ void tile_mma(TileFrags& acc, const bf16* As, const bf16* Bs) {
  using namespace nvcuda;
  typedef typename std::conditional<AK, wmma::col_major, wmma::row_major>::type ALay;
  typedef typename std::conditional<BK, wmma::row_major, wmma::col_major>::type BLay;
  const int warp = threadIdx.x / 32;
  const int r0 = (warp / 8) * 32;
  const int c0 = (warp % 8) * 16;
#pragma unroll
  for (int kk = 0; kk < TK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALay> af[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLay> bfr;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r0 + 16 * x;
      wmma::load_matrix_sync(af[x], AK ? As + kk * KM_LD + r : As + r * RM_LD + kk,
                             AK ? KM_LD : RM_LD);
    }
    wmma::load_matrix_sync(bfr, BK ? Bs + kk * KM_LD + c0 : Bs + c0 * RM_LD + kk,
                           BK ? KM_LD : RM_LD);
    wmma::mma_sync(acc.f[0], af[0], bfr, acc.f[0]);
    wmma::mma_sync(acc.f[1], af[1], bfr, acc.f[1]);
  }
}

// acc += A B^T over nchunks chunks; a(c), b(c) give chunk c's start.  With
// DOT false the chunks stream through shared memory and no product is
// formed (B is not read); `seen(c, As)` is called for every chunk once it
// has landed, all threads of the block between two barriers.  smem: the
// block's dynamic shared memory (STAGES_BYTES).
template <bool AK, bool BK, bool DOT, class AF, class BF, class SEEN>
__device__ void tile_gemm(TileFrags& acc, AF a, long long lda, BF b, long long ldb,
                          int nchunks, bf16* smem, SEEN seen) {
  if (nchunks <= 0) return;
  bf16* As[2] = {smem, smem + STAGE_ELEMS};
  bf16* Bs[2] = {smem + 2 * STAGE_ELEMS, smem + 3 * STAGE_ELEMS};
  stage_chunk<AK>(As[0], a(0), lda);
  if (DOT) stage_chunk<BK>(Bs[0], b(0), ldb);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const bool more = c + 1 < nchunks;
    if (more) {
      stage_chunk<AK>(As[(c + 1) & 1], a(c + 1), lda);
      if (DOT) stage_chunk<BK>(Bs[(c + 1) & 1], b(c + 1), ldb);
      cp_async_commit();
    }
    cp_async_wait(more);
    __syncthreads();
    if (DOT) tile_mma<AK, BK>(acc, As[c & 1], Bs[c & 1]);
    seen(c, As[c & 1]);
    __syncthreads();
  }
}

struct NoSeen {
  __device__ void operator()(int, const bf16*) const {}
};

// The fragments into a 128 x CT_LD f32 tile in shared memory (ct), then a
// barrier.  ct may alias the stages: the last tile_gemm step ends in one.
__device__ __forceinline__ void frags_store(const TileFrags& acc, float* ct) {
  const int warp = threadIdx.x / 32;
  const int r0 = (warp / 8) * 32;
  const int c0 = (warp % 8) * 16;
  nvcuda::wmma::store_matrix_sync(ct + r0 * CT_LD + c0, acc.f[0], CT_LD,
                                  nvcuda::wmma::mem_row_major);
  nvcuda::wmma::store_matrix_sync(ct + (r0 + 16) * CT_LD + c0, acc.f[1], CT_LD,
                                  nvcuda::wmma::mem_row_major);
  __syncthreads();
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr unsigned long long BARRIER_TIMEOUT_NS = 20ull * 1000 * 1000 * 1000;

// Grid-wide barrier of a cooperative launch (every block co-resident): bar[0]
// counts arrivals, bar[1] is the generation.  The generation is read before
// arriving, so the last block's increment cannot be missed; the fences
// publish each block's writes (ordered before thread 0's by the first
// __syncthreads) before the arrival, and order the reads after it.  A wait
// longer than 20 s (a block that skipped a barrier) traps, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const unsigned long long t0 = global_ns();
      while (*gen == g) {
        __nanosleep(64);
        if (global_ns() - t0 > BARRIER_TIMEOUT_NS) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The co-resident grid of a 1024-thread kernel with the leaf's shared
// memory: blocks per SM times SMs, at most `cap`.
template <class K>
int cooperative_grid(K kernel, int cap) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)LEAF_SMEM);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LEAF_THREADS,
                                                LEAF_SMEM);
  const int g = per_sm * sms;
  return g < cap ? g : cap;
}

}  // namespace
