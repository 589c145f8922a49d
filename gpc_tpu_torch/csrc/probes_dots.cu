// K8b and K8c: the chained bf16 dots of tools/tpu_dotform_probe.py (:44-65,
// the call at :88) and tools/tpu_refread_probe.py (:51-85, the call at :111)
// on the H100, on wgmma fed by TMA.
//
// Both sum REPS products of the same bf16 operands in float32: out (B, B) =
// sum over REPS of op(A) op(B), contraction width K (8192 x 512 at REPS =
// 1024 in the TPU probes).  K8b asks which operand layout the tensor cores
// take at full rate, in three forms:
//   c0    A^T B, A and B (K, B)   (K3's and K7's V_i^T V_j)
//   std   A B,   A (B, K), B (K, B)
//   dotT  A B^T, A and B (B, K)   (both row-major)
// In wgmma's terms an operand whose output index (m of A, n of B) is the
// contiguous one is MN-major, one whose k is contiguous is K-major: c0 has
// both operands MN-major, std A K-major and B MN-major, dotT both K-major.
// wgmma takes either through its transpose bits (wgmma.cuh), so every form
// runs the same kernel from swizzled shared memory.
// K8c asks what re-reading the operand before each dot costs, in form c0:
//   hoisted       each block loads its K-slices of A and B into shared memory
//                 once and runs all REPS dots from there (the TPU probe read
//                 A into a value before its loop; K8b's forms all do this);
//   read_each     B's slice stays resident (the TPU kernels read b_ref
//                 before the loop) and every dot streams A's slice again
//                 from device memory (L2) through a ring of TMA stages;
//   reshape_each  the same, A addressed as (K / B, B, B) through a rank-3
//                 tensor map: the same bytes, a 3-D index;
//   dynslot       A alternates between two copies (2, K / B, B, B), slot =
//                 rep mod 2, on a rank-3 map whose outer index folds the
//                 slot: a 24 MB working set against the 50 MB L2.
//
// What bounds it: the tensor cores, 2 K B^2 REPS operations, 4.447 ms at
// 989 TFLOP/s for the TPU probes' shapes, 4.343 us a product; the operands
// are 16-24 MB, read once from device memory and then from L2 or shared
// memory.
//
// Design.  The (B, B) output is only (B / 128)^2 tiles of 128 x 128, too few
// for 132 SMs, so the contraction is split into slices of ks = 256
// (probes/dotform.py::dot_plan) across blocks: (B / 128)^2 * K / ks
// blocks, 512 at the TPU probes' shapes, one 384-thread block an SM.  Warp 8
// (one thread) issues the TMA loads: for hoisted both slices once, else B's
// slice once and A's 64-k chunks of every dot through STAGES stages with
// full / empty mbarriers, so the loads run ahead of the products.
// Warpgroups 0 and 1 each multiply 64 rows of the tile by its 128 columns
// with wgmma m64n128k16, four a chunk.  Every dot's wgmmas issue (asm
// volatile; nothing is multiplied by REPS): a dot starts its accumulator
// fresh (scale-d = 0 on its first k-step) and, once its wgmmas complete,
// is added to a float32 sum in registers, as the TPU kernel adds each dot
// to its accumulator (the tensor cores' own f32 accumulation truncates; a
// dot's 256 k stay inside it).  Each dot drains (wgmma.wait_group 0)
// before it joins the sum, and the two warpgroups' dots cover each other's
// drains: a second accumulator, to add one dot while the next ran, made
// ptxas serialize the wgmmas (C7514, an accumulator read inside the
// pipeline) and ran 14-25 % slower on the H100.  The block writes its
// partial sum once and a second kernel sums the K / ks partials in a fixed
// order.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int TILE = 128;              // output tile: TILE x TILE, two warpgroups of 64 rows
constexpr int CK = 64;                 // k chunk: one 128-byte swizzle row of bf16
constexpr int CHUNK = TILE * CK * 2;   // 16 KB: one operand's chunk
constexpr int HALF = CHUNK / 2;        // 8 KB: 64 rows of a chunk (one MN-major box)
constexpr int STAGES = 6;              // A's ring in the streamed patterns
constexpr int THREADS = 384;           // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int SMEM_LIMIT = 232448 - 1024;   // less the static barriers' room

enum Form { FORM_C0 = 0, FORM_STD = 1, FORM_DOTT = 2 };
enum Pattern { PAT_HOISTED = 0, PAT_READ_EACH = 1, PAT_RESHAPE_EACH = 2, PAT_DYNSLOT = 3 };

struct DotArgs {
  float* part;   // (K / ks, B, B) the slices' partial sums
  int K, B, reps, ks;
};

__host__ __device__ constexpr int smem_bytes(int pattern, int nch) {
  return (nch + (pattern == PAT_HOISTED ? nch : STAGES)) * CHUNK + 1024;
}

// Block (tile, slice): output rows r0 .. r0 + 128, columns s0 .. s0 + 128,
// contraction k0 .. k0 + ks.  AMN / BMN: the operand is MN-major (c0's A,
// element (r, k) at a[k * B + r]; c0's and std's B) rather than K-major
// (element (r, k) at a[r * K + k]).  The maps: an MN-major operand in boxes
// of 64 rows x 64 k (two a chunk), a K-major one in boxes of 64 k x 128
// rows; reshape_each and dynslot read A on a rank-3 map (r, k mod B, slot
// * K / B + k / B).
template <bool AMN, bool BMN, int PAT>
__global__ void __launch_bounds__(THREADS, 1)
    dots_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap, DotArgs d) {
  extern __shared__ unsigned char dsm[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ __align__(8) uint64_t once;
  constexpr bool HOIST = PAT == PAT_HOISTED;
  const uint32_t base = (wg::smem_u32(dsm) + 1023u) & ~1023u;
  const int nt = d.B / TILE;
  const int tile = blockIdx.x % (nt * nt);
  const int slice = blockIdx.x / (nt * nt);
  const int r0 = (tile / nt) * TILE;
  const int s0 = (tile % nt) * TILE;
  const int nch = d.ks / CK;
  const int k0 = slice * d.ks;
  const uint32_t bres = base;                 // B's nch chunks, resident
  const uint32_t ares = base + nch * CHUNK;   // hoisted: A's nch chunks; else the ring
  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    wg::mbar_init(&once, 1);
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256 && d.reps > 0) {
      // chunk at k of A (dot rep) and of B into dst
      auto load_a = [&](uint32_t dst, uint64_t* bar, int rep, int k) {
        if constexpr (!AMN) {
          wg::tma_load_2d(dst, &amap, bar, k, r0);
        } else if constexpr (PAT == PAT_HOISTED || PAT == PAT_READ_EACH) {
          wg::tma_load_2d(dst, &amap, bar, r0, k);
          wg::tma_load_2d(dst + HALF, &amap, bar, r0 + 64, k);
        } else {
          const int z = (PAT == PAT_DYNSLOT ? (rep % 2) * (d.K / d.B) : 0) + k / d.B;
          wg::tma_load_3d(dst, &amap, bar, r0, k % d.B, z);
          wg::tma_load_3d(dst + HALF, &amap, bar, r0 + 64, k % d.B, z);
        }
      };
      wg::mbar_expect_tx(&once, (HOIST ? 2 : 1) * nch * CHUNK);
      for (int c = 0; c < nch; ++c) {
        const int k = k0 + c * CK;
        if constexpr (BMN) {
          wg::tma_load_2d(bres + c * CHUNK, &bmap, &once, s0, k);
          wg::tma_load_2d(bres + c * CHUNK + HALF, &bmap, &once, s0 + 64, k);
        } else {
          wg::tma_load_2d(bres + c * CHUNK, &bmap, &once, k, s0);
        }
        if constexpr (HOIST) load_a(ares + c * CHUNK, &once, 0, k);
      }
      if constexpr (!HOIST) {
        int it = 0;
        for (int rep = 0; rep < d.reps; ++rep)
          for (int c = 0; c < nch; ++c, ++it) {
            const int st = it % STAGES;
            wg::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
            wg::mbar_expect_tx(&full[st], CHUNK);
            load_a(ares + st * CHUNK, &full[st], rep, k0 + c * CK);
          }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    float acc[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
    if (d.reps > 0) wg::mbar_wait(&once, 0);
    int it = 0;
    for (int rep = 0; rep < d.reps; ++rep) {
      int held = -1;   // the ring stage the last committed chunk reads
#pragma unroll 1
      for (int c = 0; c < nch; ++c, ++it) {
        uint32_t a = ares + c * CHUNK;
        int st = 0;
        if constexpr (!HOIST) {
          st = it % STAGES;
          wg::mbar_wait(&full[st], (it / STAGES) & 1);
          a = ares + st * CHUNK;
        }
        a += wgi * HALF;   // this warpgroup's 64 rows
        const uint32_t b = bres + c * CHUNK;
        wg::fence_operands(acc);
        wg::mma_fence();
#pragma unroll
        for (int kk = 0; kk < CK / 16; ++kk) {
          const uint64_t da = AMN ? wg::desc_mnmajor(wg::k16_step<true>(a, kk), HALF)
                                  : wg::desc_kmajor(wg::k16_step<false>(a, kk));
          const uint64_t db = BMN ? wg::desc_mnmajor(wg::k16_step<true>(b, kk), HALF)
                                  : wg::desc_kmajor(wg::k16_step<false>(b, kk));
          wg::mma_64x128<AMN, BMN>(acc, da, db, c > 0 || kk > 0);
        }
        wg::mma_commit();
        if constexpr (!HOIST) {   // the chunk before this one is read: free its stage
          wg::mma_wait<1>();
          if (held >= 0 && lane == 0) wg::mbar_arrive(&empty[held]);
          held = st;
        }
      }
      wg::mma_wait<0>();
      wg::fence_operands(acc);
      if constexpr (!HOIST)
        if (lane == 0) wg::mbar_arrive(&empty[held]);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
    // accumulator layout of m64nNk16: register 4n + 2h + e holds row
    // 16 warp + lane / 4 + 8 h, column 8 n + 2 (lane % 4) + e
    float* out = d.part + ((size_t)slice * d.B + r0 + wgi * 64 + warp * 16 + lane / 4) * d.B +
                 s0 + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(sum[4 * n], sum[4 * n + 1]);
      *reinterpret_cast<float2*>(out + (size_t)8 * d.B + 8 * n) =
          make_float2(sum[4 * n + 2], sum[4 * n + 3]);
    }
  }
}

__global__ void sum_slices(const float* part, float* out, int n, int slices) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int q = 0; q < slices; ++q) s += part[(size_t)q * n + e];
  out[e] = s;
}

// The maps of an MN-major operand stored as `outer` rows of B (boxes of 64
// x 64) and of a K-major one, (B, K) (boxes of 64 k x 128 rows).
cudaError_t mn_map(CUtensorMap* m, const void* p, int B, int outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)B, (cuuint64_t)outer};
  const cuuint64_t rows[1] = {(cuuint64_t)B * 2};
  const cuuint32_t box[2] = {64, 64};
  return wg::bf16_map(m, p, 2, dims, rows, box);
}

cudaError_t k_map(CUtensorMap* m, const void* p, int K, int B) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)B};
  const cuuint64_t rows[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {64, TILE};
  return wg::bf16_map(m, p, 2, dims, rows, box);
}

// (copies * K / B, B, B) as a rank-3 map: (r, k mod B, block), boxes 64 x 64 x 1.
cudaError_t blocks_map(CUtensorMap* m, const void* p, int K, int B, int copies) {
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)B, (cuuint64_t)copies * (K / B)};
  const cuuint64_t rows[2] = {(cuuint64_t)B * 2, (cuuint64_t)B * B * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return wg::bf16_map(m, p, 3, dims, rows, box);
}

template <bool AMN, bool BMN, int PAT>
int launch_dots(const CUtensorMap& am, const CUtensorMap& bm, const DotArgs& d,
                cudaStream_t stream) {
  const int smem = smem_bytes(PAT, d.ks / CK);
  cudaError_t e = cudaFuncSetAttribute(dots_kernel<AMN, BMN, PAT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nt = d.B / TILE;
  dots_kernel<AMN, BMN, PAT><<<nt * nt * (d.K / d.ks), THREADS, smem, stream>>>(am, bm, d);
  return (int)cudaGetLastError();
}

}  // namespace

// out (B, B) = sum over reps of op(a) op(b) (form, pattern as above); part:
// (K / ks, B, B) float32 scratch.  ks a multiple of 64 that divides K, B a
// multiple of 128, both slices (hoisted) or B's slice and the ring within
// shared memory; the patterns other than hoisted take form c0 only, and
// reshape_each and dynslot a K that B divides.
extern "C" int gpc_dot_probe(const void* a, const void* b, float* part, float* out, int form,
                             int pattern, int K, int B, int reps, int ks, void* stream) {
  if (ks <= 0 || ks % CK || K % ks || B % TILE || reps < 0 ||
      smem_bytes(pattern, ks / CK) > SMEM_LIMIT || (pattern != PAT_HOISTED && form != FORM_C0) ||
      ((pattern == PAT_RESHAPE_EACH || pattern == PAT_DYNSLOT) && K % B))
    return (int)cudaErrorInvalidValue;
  const DotArgs d{part, K, B, reps, ks};
  cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap am, bm;
  cudaError_t e = form == FORM_DOTT ? k_map(&bm, b, K, B) : mn_map(&bm, b, B, K);
  if (e == cudaSuccess)
    e = form != FORM_C0                   ? k_map(&am, a, K, B)
        : pattern == PAT_RESHAPE_EACH     ? blocks_map(&am, a, K, B, 1)
        : pattern == PAT_DYNSLOT          ? blocks_map(&am, a, K, B, 2)
                                          : mn_map(&am, a, B, K);
  if (e != cudaSuccess) return (int)e;
  int code;
  if (pattern == PAT_HOISTED) {
    code = form == FORM_C0    ? launch_dots<true, true, PAT_HOISTED>(am, bm, d, s)
           : form == FORM_STD ? launch_dots<false, true, PAT_HOISTED>(am, bm, d, s)
                              : launch_dots<false, false, PAT_HOISTED>(am, bm, d, s);
  } else {
    code = pattern == PAT_READ_EACH      ? launch_dots<true, true, PAT_READ_EACH>(am, bm, d, s)
           : pattern == PAT_RESHAPE_EACH ? launch_dots<true, true, PAT_RESHAPE_EACH>(am, bm, d, s)
                                         : launch_dots<true, true, PAT_DYNSLOT>(am, bm, d, s);
  }
  if (code != 0) return code;
  const int n = B * B;
  sum_slices<<<(n + 255) / 256, 256, 0, s>>>(part, out, n, K / ks);
  return (int)cudaGetLastError();
}
