// K8b and K8c: the chained bf16 dots of tools/tpu_dotform_probe.py (:44-65,
// the call at :88) and tools/tpu_refread_probe.py (:51-85, the call at :111)
// on the H100.
//
// Both sum REPS products of the same bf16 operands in float32: out (B, B) =
// sum over REPS of op(A) op(B), contraction width K (8192 x 512 at REPS =
// 1024 in the TPU probes).  K8b asks which operand layout the tensor cores
// take at full rate, in three forms:
//   c0    A^T B, A and B (K, B)   (K3's and K7's V_i^T V_j: both k-major)
//   std   A B,   A (B, K), B (K, B)
//   dotT  A B^T, A and B (B, K)   (both row-major)
// K8c asks what re-reading the operand before each dot costs, in form c0:
//   hoisted       each block stages its K-slices of A and B in shared memory
//                 once and runs all REPS dots from there (the TPU probe read
//                 A into a value before its loop; K8b's forms all do this);
//   read_each     every dot re-streams the slices from device memory (L2)
//                 through tile.cuh's cp.async double buffer;
//   reshape_each  the same, A addressed as (K / B, B, B): the same bytes, a
//                 3-D index;
//   dynslot       A alternates between two copies (2, K / B, B, B), slot =
//                 rep mod 2: a 24 MB working set against the 50 MB L2.
//
// Design.  The (B, B) output is only (B / 128)^2 tiles of 128 x 128, too few
// for 132 SMs, so K is split into slices of KS = 256 across blocks: (B /
// 128)^2 * K / KS blocks (512 at the TPU probes' shapes, one 1024-thread
// block per SM).  A block forms each dot's slice product in WMMA fragments
// (tile.cuh: bf16 16x16x16, f32 accumulation; every dot's MMAs run) and adds
// it to a float32 sum in registers, as the TPU kernel adds each dot to its
// accumulator: the tensor cores' own f32 accumulation does not round to
// nearest, and 1024 dots summed in one fragment drift 3e-4 toward zero.
// The block writes its partial sum once, and a second kernel sums the K / KS
// partials in a fixed order.  In `hoisted` a compiler barrier starts every
// dot and its chunk loop is not unrolled, so each chunk's fragments are
// loaded from shared memory as the MMAs need them: loading all of a dot's
// 48 fragments ahead (the unrolled loop) spilled and ran 3-9x slower.
//
// What bounds it: the tensor cores, 2 K B^2 REPS operations (4.45 ms at
// 989 TFLOP/s for the TPU probes' shapes); the operands are 16-24 MB, read
// once from device memory and then from L2 or shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

#include "leaf.cuh"
#include "tile.cuh"

namespace {

constexpr int KS = 256;          // K-slice of one block
constexpr int CPS = KS / TK;     // TK-deep chunks of a slice
constexpr int HOIST_BYTES = 2 * CPS * STAGE_ELEMS * (int)sizeof(bf16);
static_assert(HOIST_BYTES <= 232448, "both hoisted slices fit in shared memory");

enum Form { FORM_C0 = 0, FORM_STD = 1, FORM_DOTT = 2 };
enum Pattern { PAT_HOISTED = 0, PAT_READ_EACH = 1, PAT_RESHAPE_EACH = 2, PAT_DYNSLOT = 3 };

struct DotArgs {
  const bf16* a;  // c0: (K, B) [(K / B, B, B) reshape_each; (2, K / B, B, B) dynslot]; else (B, K)
  const bf16* b;  // c0, std: (K, B); dotT: (B, K)
  float* part;    // (K / KS, B, B) the slices' partial sums
  int K, B, reps;
};

__device__ __forceinline__ void frags_add(TileFrags& sum, const TileFrags& p) {
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int i = 0; i < sum.f[f].num_elements; ++i) sum.f[f].x[i] += p.f[f].x[i];
}

__device__ __forceinline__ void frags_to_global(const TileFrags& acc, float* C, int ldc) {
  const int warp = threadIdx.x / 32;
  const int r0 = (warp / 8) * 32;
  const int c0 = (warp % 8) * 16;
  nvcuda::wmma::store_matrix_sync(C + (size_t)r0 * ldc + c0, acc.f[0], ldc,
                                  nvcuda::wmma::mem_row_major);
  nvcuda::wmma::store_matrix_sync(C + (size_t)(r0 + 16) * ldc + c0, acc.f[1], ldc,
                                  nvcuda::wmma::mem_row_major);
}

// Block (tile, slice): output rows r0 .. r0 + 128, columns s0 .. s0 + 128,
// contraction k0 .. k0 + KS.  AK / BK: the operand is k-major (element (r,
// k) at p[k * B + r]) rather than row-major (at p[r * K + k]).
template <bool AK, bool BK, int PAT>
__global__ void __launch_bounds__(LEAF_THREADS, 1) dots_kernel(DotArgs d) {
  extern __shared__ __align__(128) float dsm[];
  bf16* sm = reinterpret_cast<bf16*>(dsm);
  const int nt = d.B / LEAF;
  const int tile = blockIdx.x % (nt * nt);
  const int slice = blockIdx.x / (nt * nt);
  const int r0 = (tile / nt) * LEAF;
  const int s0 = (tile % nt) * LEAF;
  const int k0 = slice * KS;
  const long long lda = AK ? d.B : d.K;
  const long long ldb = BK ? d.B : d.K;
  // chunk c (TK deep) of the slice: its element (0, 0) in A and in B
  auto a_at = [&](int rep, int c) -> const bf16* {
    const int k = k0 + c * TK;
    if (!AK) return d.a + (long long)r0 * d.K + k;
    if (PAT == PAT_HOISTED || PAT == PAT_READ_EACH) return d.a + (long long)k * d.B + r0;
    const long long slot = PAT == PAT_DYNSLOT ? rep % 2 : 0;   // (slot, k / B, k % B, r)
    const long long nblk = d.K / d.B;
    return d.a + ((slot * nblk + k / d.B) * d.B + k % d.B) * d.B + r0;
  };
  auto b_at = [&](int c) -> const bf16* {
    const int k = k0 + c * TK;
    return BK ? d.b + (long long)k * d.B + s0 : d.b + (long long)s0 * d.K + k;
  };
  TileFrags sum, acc;   // the dots' float32 sum; one dot's slice product
  frags_zero(sum);
  if constexpr (PAT == PAT_HOISTED) {
    bf16* As = sm;
    bf16* Bs = sm + CPS * STAGE_ELEMS;
#pragma unroll
    for (int c = 0; c < CPS; ++c) {
      stage_chunk<AK>(As + c * STAGE_ELEMS, a_at(0, c), lda);
      stage_chunk<BK>(Bs + c * STAGE_ELEMS, b_at(c), ldb);
    }
    cp_async_commit();
    cp_async_wait(false);
    __syncthreads();
    for (int rep = 0; rep < d.reps; ++rep) {
      asm volatile("" ::: "memory");   // each dot reads its operands from shared memory
      frags_zero(acc);
#pragma unroll 1
      for (int c = 0; c < CPS; ++c)   // unrolled, its fragment loads spill
        tile_mma<AK, BK>(acc, As + c * STAGE_ELEMS, Bs + c * STAGE_ELEMS);
      frags_add(sum, acc);
    }
  } else {
    // one stream of REPS * CPS chunks, so the double buffer runs across dots
    frags_zero(acc);
    tile_gemm<AK, BK, true>(
        acc, [&](int c) { return a_at(c / CPS, c % CPS); }, lda,
        [&](int c) { return b_at(c % CPS); }, ldb, d.reps * CPS, sm,
        [&](int c, const bf16*) {
          if (c % CPS == CPS - 1) {   // a dot is complete
            frags_add(sum, acc);
            frags_zero(acc);
          }
        });
  }
  frags_to_global(sum, d.part + (size_t)slice * d.B * d.B + (size_t)r0 * d.B + s0, d.B);
}

__global__ void sum_slices(const float* part, float* out, int n, int slices) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int q = 0; q < slices; ++q) s += part[(size_t)q * n + e];
  out[e] = s;
}

template <bool AK, bool BK, int PAT>
int launch_dots(const DotArgs& d, cudaStream_t stream) {
  const int smem = PAT == PAT_HOISTED ? HOIST_BYTES : STAGES_BYTES;
  cudaFuncSetAttribute(dots_kernel<AK, BK, PAT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const int nt = d.B / LEAF;
  dots_kernel<AK, BK, PAT><<<nt * nt * (d.K / KS), LEAF_THREADS, smem, stream>>>(d);
  return (int)cudaGetLastError();
}

}  // namespace

// out (B, B) = sum over reps of op(a) op(b) (form, pattern as above); part:
// (K / KS, B, B) float32 scratch.  K a multiple of KS, B of 128; the
// patterns other than hoisted take form c0 only.
extern "C" int gpc_dot_probe(const void* a, const void* b, float* part, float* out, int form,
                             int pattern, int K, int B, int reps, void* stream) {
  const DotArgs d{static_cast<const bf16*>(a), static_cast<const bf16*>(b), part, K, B, reps};
  cudaStream_t s = (cudaStream_t)stream;
  int code;
  if (pattern == PAT_HOISTED) {
    code = form == FORM_C0    ? launch_dots<true, true, PAT_HOISTED>(d, s)
           : form == FORM_STD ? launch_dots<false, true, PAT_HOISTED>(d, s)
                              : launch_dots<false, false, PAT_HOISTED>(d, s);
  } else if (form != FORM_C0) {
    return (int)cudaErrorInvalidValue;
  } else {
    code = pattern == PAT_READ_EACH      ? launch_dots<true, true, PAT_READ_EACH>(d, s)
           : pattern == PAT_RESHAPE_EACH ? launch_dots<true, true, PAT_RESHAPE_EACH>(d, s)
                                         : launch_dots<true, true, PAT_DYNSLOT>(d, s);
  }
  if (code != 0) return code;
  const int n = B * B;
  sum_slices<<<(n + 255) / 256, 256, 0, s>>>(part, out, n, K / KS);
  return (int)cudaGetLastError();
}
