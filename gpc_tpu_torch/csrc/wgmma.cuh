// Hopper tile pieces: mbarriers, TMA boxes of rank 2 and 3 under the 128-byte
// swizzle, wgmma descriptors of K-major and MN-major bf16 tiles, and the
// m64n128k16 product with its transpose bits.  Taken from K3's correction
// (chol_panel.cu, which keeps its own copies) and extended with the
// MN-major descriptor, the rank-3 box, the host-side tensor maps, an
// mbarrier wait that times out and the predicated issue of a TMA box, an
// expect_tx and an arrive (K8a's ring, csrc/probes.cu).
//
// Layouts.  A wgmma operand tile is K-major when k is its contiguous index
// (a row of 64 bf16 k is one 128-byte swizzle row, 8-row groups 1024 bytes
// apart) and MN-major when m (or n) is: a TMA box of 64 m x 64 k puts 64 m
// in each 128-byte row, one row a k, so 8 k are a 1024-byte swizzle atom
// and the next 64 m sit in the next box.  In the descriptor (CUTLASS's
// canonical GMMA layouts, in 16-byte units) the MN-major B128 tile is
// ((8, n), (8, k)) : ((1, LBO), (8, SBO)): LBO steps to the next 64 m or n,
// SBO to the next 8 k.  A k16 step advances a K-major descriptor by 32
// bytes inside the swizzle row and an MN-major one by 16 rows, 2048 bytes.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
      "selp.u32 %0, 1, 0, p; }"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// mbar_wait that traps after gsync::TIMEOUT_NS: a load that never lands
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait_timed(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = gsync::now_ns();
  while (!mbar_try_wait(bar, parity))
    if (gsync::now_ns() - t0 > gsync::TIMEOUT_NS) __trap();
}

// mbar_expect_tx, mbar_arrive and tma_load_2d issued only where `on` holds,
// through a predicate and not a branch: a thread-divergent branch inside a
// wgmma loop (a producer's issue on one thread) makes ptxas serialize the
// wgmmas (C7518).
__device__ __forceinline__ void mbar_expect_tx_if(bool on, uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0;\n"
      "@q mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1; }" ::"r"(smem_u32(bar)),
      "r"(bytes), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_if(bool on, uint64_t* bar) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %1, 0;\n"
      "@q mbarrier.arrive.shared::cta.b64 _, [%0]; }" ::"r"(smem_u32(bar)), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d_if(bool on, uint32_t dst, const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %5, 0;\n"
      "@q cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4]; }" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar)),
      "r"((int)on)
      : "memory");
}

// One TMA box of a rank-2 map at (c0, c1), innermost first, into dst.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// One TMA box of a rank-3 map at (c0, c1, c2) into dst.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Descriptor of a 128-byte-swizzled tile at shared address addr (1024-byte
// aligned swizzle atoms): LBO and SBO in bytes.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major: 8-row groups 1024 bytes apart, the leading offset unused (16).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_b128(addr, 16, 1024);
}

// MN-major: the next 64 m (n) `next64` bytes on, the next 8 k 1024 bytes on.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t next64) {
  return desc_b128(addr, next64, 1024);
}

// The shared-memory address of k16 step kk of a chunk of 64 k.
template <bool MN>
__device__ __forceinline__ uint32_t k16_step(uint32_t addr, int kk) {
  return addr + (MN ? 2048u : 32u) * kk;
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (+)= A (64 x 16) B (16 x 128) from shared memory; TA / TB: the operand
// is MN-major (wgmma's transpose bit), else K-major.  scale_d = 0
// overwrites d.
template <bool TA, bool TB>
__device__ __forceinline__ void mma_64x128(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"((int)TA), "n"((int)TB));
}

// ---------------------------------------------------------------------------
// Host side: tensor maps through the runtime's driver entry point (no -lcuda)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 map of rank 2 or 3 (dims and box innermost first; rows: the byte
// strides of dimensions 1 and 2) under the 128-byte swizzle.
inline cudaError_t bf16_map(CUtensorMap* map, const void* p, int rank, const cuuint64_t* dims,
                            const cuuint64_t* rows, const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p), dims,
                         rows, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
