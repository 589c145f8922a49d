// K8d: the epilogue-side probes of tools/tpu_vpu_probe.py on the H100 (the
// calls at :114, :121, :128 and :134): the rates the whole-evidence kernel
// (K7) and the panel kernel (K3) depend on besides their GEMMs.  Each has a
// plain PyTorch version in probes/vpu.py that computes the same values.
//
// exp_kernel (kern_exp :37-42): acc <- 0.5 acc + exp(-(A + 1e-9 acc)), REPS
//   times over a (B, B) f32 tile.  Each element's chain is independent: one
//   thread per element.  Bound by the special-function units (one exp an
//   element a rep; expf, as K1 pays, not __expf).
// gram_kernel (kern_gramtile :45-54): acc <- exp(-max(n2_i + n2_j - 2 x_i.x_j
//   + 1e-9 acc[0, 0], 0)), REPS times, X (B, 8) f32.  The only coupling
//   between elements is acc[0, 0], whose chain depends on X row 0 and n2[0]
//   alone, so every thread carries that scalar chain itself: no barrier and
//   no other block's result per rep.  The TPU probe formed the whole tile
//   every rep; so does this kernel: X and n2 are re-read from shared memory
//   behind a compiler barrier each rep, so the 8-deep dots cannot be hoisted
//   out of the loop.  A warp takes 32 columns (a lane each) and 8 rows.
// matvec_kernel (kern_matvec :57-65): v <- (A^T v) / (1 + |(A^T v)_0|), A
//   (B, B) f32, REPS times: a serial chain in which each rep needs the whole
//   previous vector.  One block of 1024 threads; A (1 MB at B = 512) is
//   re-read from L2 every rep (it does not fit one SM's shared memory), 1024
//   / B threads a column, coalesced along the row.  Bound by one SM's L2 read
//   rate and three block barriers a rep; a cluster holding A in distributed
//   shared memory is the faster design.
// store_kernel (kern_store_dma :68-87): n times, stage bf16(A + 1e-9 it) and
//   write it to big[it mod 64], big (64, B, B) bf16; o (B, B) = n.  A block
//   owns a band of ST_ROWS rows (A's band in registers) and a double buffer
//   of it in shared memory.  `bulk`: threads write the stage, fence the
//   async proxy, and one thread copies it out with cp.async.bulk (the TMA's
//   1-D form), waiting (wait_group.read 1) until the copy that read a slot
//   two iterations ago has read it before the slot is written again.
//   `direct`: the threads store the bf16 values straight to big.  Bound by
//   device memory for the bytes that must land (big and o once, A once); the
//   n * B * B * 2 bytes written are what a run moves.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__global__ void exp_kernel(const float* __restrict__ a, float* __restrict__ out, int n,
                           int reps) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float x = a[e];
  float acc = 0.0f;
  for (int it = 0; it < reps; ++it) acc = acc * 0.5f + expf(-(x + acc * 1e-9f));
  out[e] = acc;
}

constexpr int GD = 8;              // the Gram tile's input width (X is (B, 8))
constexpr int G_ROWS = 8;          // rows of a warp (a lane takes one column)
constexpr int G_WARPS = 8;         // warps of a block: 64 rows x 32 columns

__device__ __forceinline__ float dot8(const float4* xi, const float4* xj) {
  const float4 a0 = xi[0], a1 = xi[1], b0 = xj[0], b1 = xj[1];
  float g = a0.x * b0.x;
  g = fmaf(a0.y, b0.y, g);
  g = fmaf(a0.z, b0.z, g);
  g = fmaf(a0.w, b0.w, g);
  g = fmaf(a1.x, b1.x, g);
  g = fmaf(a1.y, b1.y, g);
  g = fmaf(a1.z, b1.z, g);
  return fmaf(a1.w, b1.w, g);
}

// One element's step: exp(-max(n2_i + n2_j - 2 g + 1e-9 c, 0)), after acc * 0.
__device__ __forceinline__ float gram_step(float acc, float n2i, float n2j, float g, float c) {
  const float d2 = fmaxf(n2i + n2j - 2.0f * g + c * 1e-9f, 0.0f);
  return acc * 0.0f + expf(-d2);
}

__global__ void __launch_bounds__(32 * G_WARPS) gram_kernel(const float* __restrict__ X,
                                                            const float* __restrict__ n2,
                                                            float* __restrict__ out, int B,
                                                            int reps) {
  extern __shared__ __align__(16) float gsm[];
  float4* Xs = reinterpret_cast<float4*>(gsm);   // (B, 8) as (B, 2) float4
  float* n2s = gsm + B * GD;
  for (int e = threadIdx.x; e < B * GD; e += blockDim.x) gsm[e] = X[e];
  for (int e = threadIdx.x; e < B; e += blockDim.x) n2s[e] = n2[e];
  __syncthreads();
  const int j = blockIdx.x * 32 + threadIdx.x % 32;
  const int i0 = blockIdx.y * (G_ROWS * G_WARPS) + (threadIdx.x / 32) * G_ROWS;
  float acc[G_ROWS];
#pragma unroll
  for (int r = 0; r < G_ROWS; ++r) acc[r] = 0.0f;
  float c = 0.0f;   // acc[0, 0], the chain every element reads
  for (int it = 0; it < reps; ++it) {
    asm volatile("" ::: "memory");   // X and n2 are read anew: the dots run every rep
    const float n2j = n2s[j];
    const float c_next = gram_step(c, n2s[0], n2s[0], dot8(Xs, Xs), c);
#pragma unroll
    for (int r = 0; r < G_ROWS; ++r)
      acc[r] = gram_step(acc[r], n2s[i0 + r], n2j, dot8(Xs + 2 * (i0 + r), Xs + 2 * j), c);
    c = c_next;
  }
#pragma unroll
  for (int r = 0; r < G_ROWS; ++r) out[(size_t)(i0 + r) * B + j] = acc[r];
}

constexpr int MV_THREADS = 1024;

// A load through L2 that the compiler may neither hoist out of the rep loop
// nor merge with another rep's.
__device__ __forceinline__ float ld_l2(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__global__ void __launch_bounds__(MV_THREADS, 1) matvec_kernel(const float* A,
                                                               const float* __restrict__ v0,
                                                               float* __restrict__ out, int B,
                                                               int reps) {
  extern __shared__ float msm[];
  float* v = msm;        // (B) the chain's vector
  float* red = msm + B;  // (1024 / B, B) partial sums of A^T v
  const int t = threadIdx.x;
  const int tpc = MV_THREADS / B;
  const int j = t % B;
  const int h = t / B;
  for (int i = t; i < B; i += MV_THREADS) v[i] = v0[i];
  __syncthreads();
  for (int rep = 0; rep < reps; ++rep) {
    float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // rows h, h + tpc, ... in four chains
    for (int i = h; i < B; i += 4 * tpc) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = i + u * tpc;
        p[u] = fmaf(ld_l2(A + (size_t)r * B + j), v[r], p[u]);
      }
    }
    red[h * B + j] = (p[0] + p[1]) + (p[2] + p[3]);
    __syncthreads();
    if (t < B) {
      float s = 0.0f;
      for (int q = 0; q < tpc; ++q) s += red[q * B + t];
      red[t] = s;   // column t is read and written by thread t alone
    }
    __syncthreads();
    if (t < B) v[t] = red[t] * (1.0f / (1.0f + fabsf(red[0])));
    __syncthreads();
  }
  for (int i = t; i < B; i += MV_THREADS) out[i] = v[i];
}

constexpr int ST_ROWS = 4;        // rows of A a block owns
constexpr int ST_THREADS = 256;
constexpr int ST_SLOTS = 64;      // big's slots
constexpr int ST_MAXQ = 8;        // pairs a thread holds: ST_ROWS * B / 2 / ST_THREADS, B <= 1024

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__global__ void __launch_bounds__(ST_THREADS) store_kernel(const float* __restrict__ A,
                                                           bf16* __restrict__ big,
                                                           float* __restrict__ o, int B, int n,
                                                           int bulk) {
  extern __shared__ __align__(128) unsigned char ssm[];
  const int t = threadIdx.x;
  const int npairs = ST_ROWS * B / 2;          // a band, in bf16 pairs
  const int nq = npairs / ST_THREADS;
  const size_t row0 = (size_t)blockIdx.x * ST_ROWS;
  bf162* stage = reinterpret_cast<bf162*>(ssm);   // (2, npairs)
  const float2* Ab = reinterpret_cast<const float2*>(A + row0 * B);
  float2 a[ST_MAXQ];
#pragma unroll
  for (int q = 0; q < ST_MAXQ; ++q)
    if (q < nq) a[q] = Ab[t + q * ST_THREADS];
  float acc = 0.0f;
  for (int it = 0; it < n; ++it) {
    const float s = __fmul_rn(acc, 1e-9f);   // unfused, as the reference rounds it
    bf162* dst = reinterpret_cast<bf162*>(big + (size_t)(it % ST_SLOTS) * B * B + row0 * B);
    if (bulk) {
      const int slot = it & 1;
      if (it >= 2) {   // the copy started two iterations ago has read this slot
        if (t == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        __syncthreads();
      }
      bf162* st = stage + slot * npairs;
#pragma unroll
      for (int q = 0; q < ST_MAXQ; ++q)
        if (q < nq)
          st[t + q * ST_THREADS] = __floats2bfloat162_rn(__fadd_rn(a[q].x, s),
                                                         __fadd_rn(a[q].y, s));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (t == 0) {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                     "r"(smem_addr(st)), "r"(npairs * 4)
                     : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else {
#pragma unroll
      for (int q = 0; q < ST_MAXQ; ++q)
        if (q < nq)
          dst[t + q * ST_THREADS] = __floats2bfloat162_rn(__fadd_rn(a[q].x, s),
                                                          __fadd_rn(a[q].y, s));
    }
    acc += 1.0f;
  }
  if (bulk && t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  for (int e = t; e < ST_ROWS * B; e += ST_THREADS) o[row0 * B + e] = acc;
}

}  // namespace

extern "C" int gpc_vpu_exp(const float* a, float* out, int n, int reps, void* stream) {
  exp_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, out, n, reps);
  return (int)cudaGetLastError();
}

// X (B, 8), n2 (B) = row sums of X * X, out (B, B); B a multiple of 64.
extern "C" int gpc_vpu_gram(const float* X, const float* n2, float* out, int B, int reps,
                            void* stream) {
  const int smem = B * (GD + 1) * (int)sizeof(float);
  cudaFuncSetAttribute(gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gram_kernel<<<dim3(B / 32, B / (G_ROWS * G_WARPS)), 32 * G_WARPS, smem,
                (cudaStream_t)stream>>>(X, n2, out, B, reps);
  return (int)cudaGetLastError();
}

// A (B, B), v and out (B); B a power of two, 64 <= B <= 1024.
extern "C" int gpc_vpu_matvec(const float* A, const float* v, float* out, int B, int reps,
                              void* stream) {
  const int smem = (B + MV_THREADS) * (int)sizeof(float);
  matvec_kernel<<<1, MV_THREADS, smem, (cudaStream_t)stream>>>(A, v, out, B, reps);
  return (int)cudaGetLastError();
}

// A (B, B) f32, big (64, B, B) bf16, o (B, B) f32; B a multiple of 128, <= 1024.
extern "C" int gpc_vpu_store(const float* A, void* big, float* o, int B, int n, int bulk,
                             void* stream) {
  const int smem = 2 * ST_ROWS * B * (int)sizeof(bf16);
  store_kernel<<<B / ST_ROWS, ST_THREADS, smem, (cudaStream_t)stream>>>(
      A, static_cast<bf16*>(big), o, B, n, bulk);
  return (int)cudaGetLastError();
}
