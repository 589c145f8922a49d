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
//   previous vector.  One launch of ONE thread-block cluster of CS blocks
//   (8, or 16 where the card allows the non-portable size; matvec_cluster
//   picks the larger), each on its own SM.  Block c owns the columns [c W,
//   (c + 1) W), W = B / CS, and keeps them on chip for the whole chain: in
//   shared memory while they fit (B <= 512: 128 KB a block at CS = 8, 64 KB
//   at 16), else (B = 1024, 4 MB) streamed from L2 each rep by all CS SMs
//   at once.  A rep: every block forms its W entries of p = A^T v from its
//   own copy of v (each column summed by neighbouring lanes of one warp over
//   its rows, the lanes meeting by shuffles: no block barrier), writes them
//   into every block's copy of the next v through distributed shared memory,
//   and the cluster meets at one barrier (arrive.release / wait.acquire); the
//   scale 1 / (1 + |p_0|) is applied as the next rep reads v.  v is
//   double-buffered, so a block never writes the copy a peer is reading, and
//   the rep's barrier is the last access to a peer's memory before any block
//   exits.  What bounds a rep now: latency, not bytes: the block's share of
//   the product (B W FMAs from shared memory, B / lanes dependent on a lane),
//   one round of CS remote stores and one cluster barrier.
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
#include <cooperative_groups.h>
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

constexpr int MV_THREADS = 512;
constexpr int MV_REG_ROWS = 32;         // A's rows a thread keeps in registers, at most
constexpr int MV_SMEM_A = 160 * 1024;   // else A's columns stay in shared memory up to this

// A's columns a block owns, W = B / cs, each summed by `lanes` neighbouring
// lanes of one warp (min(MV_THREADS / W, 32, B)) over B / lanes rows each.
struct MvShape {
  int W, lanes, rows;
};

__host__ __device__ __forceinline__ MvShape mv_shape(int B, int cs) {
  const int W = B / cs;
  int lanes = MV_THREADS / W;
  if (lanes > 32) lanes = 32;
  if (lanes > B) lanes = B;
  return MvShape{W, lanes, B / lanes};
}

// A column in shared memory is padded by `lanes` floats, so that the
// columns a warp reads sit in different banks.
__host__ __device__ __forceinline__ int mv_ld(int B, int cs) {
  return B + mv_shape(B, cs).lanes;
}

// Where a block keeps its columns of A: 0 registers, 1 shared memory, 2 L2.
__host__ __device__ __forceinline__ int mv_home(int B, int cs) {
  if (mv_shape(B, cs).rows <= MV_REG_ROWS) return 0;
  return (size_t)(B / cs) * mv_ld(B, cs) * sizeof(float) <= (size_t)MV_SMEM_A ? 1 : 2;
}

// A load that the compiler may neither hoist out of the rep loop nor merge
// with another rep's.
__device__ __forceinline__ float ld_nc(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One cluster of cs blocks (launched with that cluster size).  Thread t sums
// column t / lanes over rows t % lanes, t % lanes + lanes, ... (neighbouring
// lanes read neighbouring rows); the column's lanes meet by shuffles, and
// its first lane writes it to every block.  ROWS > 0: the thread's ROWS
// entries of A in registers; ROWS = 0: A's W columns in shared memory (one
// padded row each, mv_ld) or, past MV_SMEM_A, read from L2 every rep.
// Shared memory: v's two copies (2 B), then A's columns where they live
// there.
template <int ROWS>
__global__ void __launch_bounds__(MV_THREADS, 1) matvec_kernel(const float* __restrict__ A,
                                                               const float* __restrict__ v0,
                                                               float* __restrict__ out, int B,
                                                               int reps) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float msm[];
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const MvShape sh = mv_shape(B, cs);
  const bool shared = ROWS == 0 && mv_home(B, cs) == 1;
  float* vbuf = msm;       // (2, B) v's copies: this rep's, the next
  float* As = msm + 2 * B; // (W, ld) A's columns, when in shared memory
  const int ld = mv_ld(B, cs);
  const int t = threadIdx.x;
  const int c0 = rank * sh.W;
  const int j = t / sh.lanes;
  const int r = t % sh.lanes;
  const bool active = j < sh.W;   // whole warps: W lanes is a multiple of 32
  for (int i = t; i < B; i += MV_THREADS) vbuf[i] = v0[i];
  float a[ROWS > 0 ? ROWS : 1];
  if constexpr (ROWS > 0) {
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
      a[u] = active ? A[(size_t)(r + sh.lanes * u) * B + c0 + j] : 0.0f;
  }
  if (shared)
    for (int e = t; e < B * sh.W; e += MV_THREADS)
      As[(e % sh.W) * ld + e / sh.W] = A[(size_t)(e / sh.W) * B + c0 + e % sh.W];
  cluster_barrier();   // every block runs before any writes to a peer
  for (int rep = 0; rep < reps; ++rep) {
    const float* cur = vbuf + (rep & 1) * B;
    const int nxt = ((rep + 1) & 1) * B;
    const float s = rep == 0 ? 1.0f : 1.0f / (1.0f + fabsf(cur[0]));
    if (active) {
      float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // four chains over the rows
      if constexpr (ROWS > 0) {
#pragma unroll
        for (int u = 0; u < ROWS; ++u) p[u % 4] = fmaf(a[u], cur[r + sh.lanes * u] * s, p[u % 4]);
      } else if (shared) {
#pragma unroll 4
        for (int u = 0; u < sh.rows; u += 4)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = r + sh.lanes * (u + q);
            p[q] = fmaf(As[j * ld + i], cur[i] * s, p[q]);
          }
      } else {
#pragma unroll 4
        for (int u = 0; u < sh.rows; u += 4)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = r + sh.lanes * (u + q);
            p[q] = fmaf(ld_nc(A + (size_t)i * B + c0 + j), cur[i] * s, p[q]);
          }
      }
      float pj = (p[0] + p[1]) + (p[2] + p[3]);
      for (int o = sh.lanes / 2; o > 0; o /= 2) pj += __shfl_xor_sync(0xffffffffu, pj, o);
      if (r == 0)
        for (int q = 0; q < cs; ++q) *cluster.map_shared_rank(vbuf + nxt + c0 + j, q) = pj;
    }
    cluster_barrier();
  }
  const float* last = vbuf + (reps & 1) * B;
  const float s = reps == 0 ? 1.0f : 1.0f / (1.0f + fabsf(last[0]));
  for (int e = t; e < sh.W; e += MV_THREADS) out[c0 + e] = last[c0 + e] * s;
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

namespace {

// The kernel for (B, cs) and its shared memory: rows <= MV_REG_ROWS (a
// power of two, B / lanes >= 2) keep A in registers.
typedef void (*MvKernel)(const float*, const float*, float*, int, int);

MvKernel mv_kernel(int B, int cs, size_t* smem) {
  const int home = mv_home(B, cs);
  *smem = (2 * (size_t)B + (home == 1 ? (size_t)(B / cs) * mv_ld(B, cs) : 0)) * sizeof(float);
  if (home != 0) return matvec_kernel<0>;
  switch (mv_shape(B, cs).rows) {
    case 2: return matvec_kernel<2>;
    case 4: return matvec_kernel<4>;
    case 8: return matvec_kernel<8>;
    case 16: return matvec_kernel<16>;
    default: return matvec_kernel<32>;
  }
}

// The launch configuration of one cluster of cs blocks, the kernel's
// attributes set.
cudaLaunchConfig_t mv_config(MvKernel k, int cs, size_t smem, cudaLaunchAttribute* attr,
                             cudaStream_t stream) {
  cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(MV_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The matvec's cluster size at width B: 16 where the card runs a cluster of
// 16 such blocks (the non-portable size), else 8; 0 if neither fits.
extern "C" int gpc_vpu_matvec_cluster(int B) {
  for (int cs = 16; cs >= 8; cs /= 2) {
    size_t smem = 0;
    const MvKernel k = mv_kernel(B, cs, &smem);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = mv_config(k, cs, smem, attr, nullptr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, k, &cfg) == cudaSuccess && clusters > 0)
      return cs;
    cudaGetLastError();
  }
  return 0;
}

// Where the matvec keeps A at (B, cs): 0 registers, 1 shared memory, 2 L2.
extern "C" int gpc_vpu_matvec_home(int B, int cs) { return mv_home(B, cs); }

// A (B, B), v and out (B); B a power of two, 64 <= B <= 1024; cs 8 or 16.
extern "C" int gpc_vpu_matvec(const float* A, const float* v, float* out, int B, int reps,
                              int cs, void* stream) {
  if (B < 64 || B > 1024 || (B & (B - 1)) || (cs != 8 && cs != 16))
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const MvKernel k = mv_kernel(B, cs, &smem);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = mv_config(k, cs, smem, attr, (cudaStream_t)stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, k, A, v, out, B, reps);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// A (B, B) f32, big (64, B, B) bf16, o (B, B) f32; B a multiple of 128, <= 1024.
extern "C" int gpc_vpu_store(const float* A, void* big, float* o, int B, int n, int bulk,
                             void* stream) {
  const int smem = 2 * ST_ROWS * B * (int)sizeof(bf16);
  store_kernel<<<B / ST_ROWS, ST_THREADS, smem, (cudaStream_t)stream>>>(
      A, static_cast<bf16*>(big), o, B, n, bulk);
  return (int)cudaGetLastError();
}
