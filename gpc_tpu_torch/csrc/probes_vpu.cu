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
//   every rep (at Precision.HIGHEST, bf16 passes on its MXU); so does this
//   kernel, on the tensor cores: X is split once, at load, into tf32 halves
//   (hi = rna(x), lo = rna(x - hi)), and every rep re-reads them from shared
//   memory behind a compiler barrier and runs XX^T = lo.lo + lo.hi + hi.lo +
//   hi.hi as four mma.sync m16n8k8 passes (K = 8 is one k-step).  Without
//   lo.lo (G_PASSES = 3), whose products are all positive on the diagonal,
//   d2 = 2 n2_i - 2 g_ii sits up to 9.4e-6 off float64 there at B = 1024
//   (tests/test_torch_probes_k8.py's model of this rounding), at the edge
//   of the 1e-5 budget; with it, under 6e-6, at the cost PERF.md gives.  The
//   exp is one ex2.approx on an argument prescaled by log2(e) (folded into
//   n2 at load and into the -2 factor), clamped at 0, and acc * 0 + is one
//   FMA: four float32 operations and one special-function op an element.
//   The SFUs (16 results a clock an SM) bound the work; on the card the
//   sub-partitions' issue does, the mmas adding to the exps rather than
//   hiding behind them (a wgmma m64n16k8 form was serialized by ptxas,
//   C7514, and ran slower).  A warp owns 16 x 16 elements (8 a lane); at
//   B = 512 the 256 blocks of 4 warps put two warps on each SM
//   sub-partition, whose in-order issue then always has one warp ready:
//   with 16 elements a lane and one warp a sub-partition the tensor cores'
//   and the SFU's latencies stalled the warp and a rep took several times as
//   long.  The acc[0, 0] chain costs one exp in 9.  The rep loop is
//   software-pipelined: rep it reads rep it + 1's operands, forms rep it +
//   2's dots, steps the chain for rep it + 2 and runs its own exps, so no
//   wait falls inside a rep; a plain loop (read, passes, exps in each rep)
//   took 1.56 times as long (probes/vpu_turns.py).
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
//   write it to big[it mod 64], big (64, B, B) bf16; o (B, B) = n.  Every
//   iteration writes its whole tile.  The tile is cut into 8 KiB chunks, and
//   a warp owns one chunk (A's 4096 floats in its registers) for the
//   iterations of one residue class mod `classes` (probes/vpu.py's
//   store_plan: at B = 512, 64 chunks x 8 classes, 128 blocks of 4 warps);
//   classes divides 64, so each slot's chunk has one writer, which writes it
//   in order of it.  `bulk`: a warp stages its chunk in a ring of 4 stages
//   of its own, fences the async proxy, and its lane 0 copies the 8 KiB out
//   with cp.async.bulk (the TMA's 1-D form), waiting (wait_group.read 3)
//   only until the copy that read a stage 4 copies ago has read it; warps
//   meet only at __syncwarp, never at a block barrier, and each has up to 4
//   copies in flight.  Before a copy lane 0 also waits until its copies 8
//   back have landed (wait_group 7): a slot's earlier copy lies at least 8
//   back, so a slot's copies land in order.  `direct`: the lanes store the
//   bf16 values straight to big, 16 bytes a lane.  The table's bound counts
//   the bytes that must land (big and o once, A once); the n * B * B * 2
//   bytes written pass through L2, which absorbs part of them (big is 32
//   MiB at B = 512), and lie outside that bound.
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
constexpr int G_B = 32;            // a block's rows and columns: 2 x 2 warps of 16 x 16
constexpr int G_PASSES = 4;        // the last G_PASSES of lo.lo, lo.hi, hi.lo, hi.hi
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a b over k = 8: a the 16 x 8 row fragment, b the 8 x 8 column
// fragment, tf32 in, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint2 a01, uint2 a23, uint2 b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a01.x), "r"(a01.y), "r"(a23.x), "r"(a23.y), "r"(b.x), "r"(b.y));
}

// An element's step with the exp prescaled to base 2: arg = 2 L g - (L n2_i
// + L 1e-9 c) - L n2_j = -L d2, clamped at 0 (d2 >= 0), then acc * 0 + 2^arg.
__device__ __forceinline__ float gram_step(float acc, float g, float s) {
  return fmaf(acc, 0.0f, ex2(fminf(fmaf(g, 2.0f * LOG2E, -s), 0.0f)));
}

// What a warp reads from shared memory for one rep.  A warp owns 16 x 16
// elements, two mma tiles of 16 x 8 side by side (8 elements a lane).  Xs
// holds row r's k = t and t + 4 split as (hi, hi', lo, lo') at r * 4 + t,
// so a lane's part of a fragment is one 16-byte load.
struct GramOps {
  uint4 ra[2], cb[2];   // the fragments of rows r0 + g, r0 + 8 + g and columns c0 (+ 8) + g
  float n2r[2];         // L n2 of the lane's rows
  float2 n2c[2];        // L n2 of the lane's columns
  float4 xa, xb;        // X row 0
  float n20;            // L n2[0]
};

__device__ __forceinline__ void gram_load(GramOps& o, const uint4* Xs, const float* n2s,
                                          const float* x0, int r0, int c0, int g, int t) {
  asm volatile("" ::: "memory");   // X and n2 are read anew: the dots run every rep
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    o.ra[h] = Xs[(r0 + 8 * h + g) * 4 + t];
    o.cb[h] = Xs[(c0 + 8 * h + g) * 4 + t];
    o.n2r[h] = n2s[r0 + 8 * h + g];
    o.n2c[h] = reinterpret_cast<const float2*>(n2s + c0 + 8 * h)[t];
  }
  o.xa = reinterpret_cast<const float4*>(x0)[0];
  o.xb = reinterpret_cast<const float4*>(x0)[1];
  o.n20 = n2s[0];
}

// Pass p (0 lo.lo, 1 lo.hi, 2 hi.lo, 3 hi.hi) of both tiles into dn.
__device__ __forceinline__ void gram_pass(const GramOps& o, int p, float (&dn)[2][4]) {
  const bool alo = p < 2, blo = p % 2 == 0;
  const uint2 a01 = alo ? make_uint2(o.ra[0].z, o.ra[1].z) : make_uint2(o.ra[0].x, o.ra[1].x);
  const uint2 a23 = alo ? make_uint2(o.ra[0].w, o.ra[1].w) : make_uint2(o.ra[0].y, o.ra[1].y);
#pragma unroll
  for (int q = 0; q < 2; ++q)
    mma_tf32(dn[q], a01, a23,
             blo ? make_uint2(o.cb[q].z, o.cb[q].w) : make_uint2(o.cb[q].x, o.cb[q].y));
}

// The exps of tile q: acc <- acc * 0 + exp(-d2) on the dots d, c = acc[0, 0].
__device__ __forceinline__ void gram_exps(const GramOps& o, float c, int q,
                                          const float (&d)[2][4], float (&acc)[2][4]) {
  const float cl = c * (1e-9f * LOG2E);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    acc[q][e] = gram_step(acc[q][e], d[q][e],
                          (o.n2r[e / 2] + cl) + (e % 2 ? o.n2c[q].y : o.n2c[q].x));
}

// The acc[0, 0] chain's step: c after a rep that read c.
__device__ __forceinline__ float gram_c(const GramOps& o, float c) {
  float g00 = o.xa.x * o.xa.x;
  g00 = fmaf(o.xa.y, o.xa.y, g00);
  g00 = fmaf(o.xa.z, o.xa.z, g00);
  g00 = fmaf(o.xa.w, o.xa.w, g00);
  g00 = fmaf(o.xb.x, o.xb.x, g00);
  g00 = fmaf(o.xb.y, o.xb.y, g00);
  g00 = fmaf(o.xb.z, o.xb.z, g00);
  g00 = fmaf(o.xb.w, o.xb.w, g00);
  return gram_step(c, g00, (o.n20 + c * (1e-9f * LOG2E)) + o.n20);
}

// Rep it, d[K] its dots, ca and cb the c of reps it and it + 1: read rep
// it + 1's operands, step the acc[0, 0] chain for rep it + 2, and run rep
// it's exps between the four passes that form rep it + 2's dots into
// d[(K + 2) % 3] from what was just read.  So every wait is a rep or two
// long: the loads', the chain's (a dot, then an exp) and the dependent
// passes' of a tile.
template <int K>
__device__ __forceinline__ void gram_rep(GramOps& cur, const uint4* Xs, const float* n2s,
                                         const float* x0, int r0, int c0, int g, int t,
                                         float (&acc)[2][4], float (&d)[3][2][4], float& ca,
                                         float& cb) {
  GramOps nx;
  gram_load(nx, Xs, n2s, x0, r0, c0, g, t);
  const float cc = gram_c(cur, cb);
  float (&dn)[2][4] = d[(K + 2) % 3];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) dn[q][e] = 0.0f;
  gram_exps(cur, ca, 0, d[K], acc);
#pragma unroll
  for (int p = 4 - G_PASSES; p < 2; ++p) gram_pass(nx, p, dn);
  gram_exps(cur, ca, 1, d[K], acc);
#pragma unroll
  for (int p = 2; p < 4; ++p) gram_pass(nx, p, dn);
  cur = nx;
  ca = cb;
  cb = cc;
}

// A block: 2 x 2 warps, 32 x 32 elements.
__global__ void __launch_bounds__(128) gram_kernel(const float* __restrict__ X,
                                                   const float* __restrict__ n2,
                                                   float* __restrict__ out, int B, int reps) {
  extern __shared__ __align__(16) float gsm[];
  uint4* Xs = reinterpret_cast<uint4*>(gsm);   // (B, 4) split pairs
  float* n2s = gsm + 16 * B;                   // L n2
  float* x0 = n2s + B;                         // X row 0, for the acc[0, 0] chain
  for (int e = threadIdx.x; e < 4 * B; e += blockDim.x) {
    const float a = X[(e / 4) * GD + e % 4], b = X[(e / 4) * GD + e % 4 + 4];
    const unsigned ha = tf32_rna(a), hb = tf32_rna(b);
    Xs[e] = make_uint4(ha, hb, tf32_rna(a - __uint_as_float(ha)),
                       tf32_rna(b - __uint_as_float(hb)));
  }
  for (int e = threadIdx.x; e < B; e += blockDim.x) n2s[e] = n2[e] * LOG2E;
  if (threadIdx.x < GD) x0[threadIdx.x] = X[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.y * G_B + (w / 2) * 16;
  const int c0 = blockIdx.x * G_B + (w % 2) * 16;
  float acc[2][4], d[3][2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = d[0][q][e] = d[1][q][e] = 0.0f;
  // Reps 0 and 1's dots, each from a read of its own; then rep it forms rep
  // it + 2's (the last two reps form two that no rep reads).  The ring d of
  // three is indexed by constants: the loop is unrolled by 3.
  GramOps cur;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    gram_load(cur, Xs, n2s, x0, r0, c0, g, t);
#pragma unroll
    for (int p = 4 - G_PASSES; p < 4; ++p) gram_pass(cur, p, d[k]);
  }
  float ca = 0.0f;                // acc[0, 0] before rep it: the c rep it reads
  float cb = gram_c(cur, ca);     // and before rep it + 1
  int it = 0;
  for (; it + 3 <= reps; it += 3) {
    gram_rep<0>(cur, Xs, n2s, x0, r0, c0, g, t, acc, d, ca, cb);
    gram_rep<1>(cur, Xs, n2s, x0, r0, c0, g, t, acc, d, ca, cb);
    gram_rep<2>(cur, Xs, n2s, x0, r0, c0, g, t, acc, d, ca, cb);
  }
  if (it < reps) gram_rep<0>(cur, Xs, n2s, x0, r0, c0, g, t, acc, d, ca, cb);
  if (it + 1 < reps) gram_rep<1>(cur, Xs, n2s, x0, r0, c0, g, t, acc, d, ca, cb);
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      reinterpret_cast<float2*>(out + (size_t)(r0 + 8 * h + g) * B + c0 + 8 * q)[t] =
          make_float2(acc[q][2 * h], acc[q][2 * h + 1]);
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

constexpr int ST_SLOTS = 64;      // big's slots
constexpr int ST_CHUNK = 4096;    // bf16 a warp owns and copies at once: 8 KiB
constexpr int ST_STAGES = 4;      // a warp's ring of stages in shared memory
constexpr int ST_WARPS = 4;       // warps of a block, each on its own
constexpr int ST_Q = ST_CHUNK / (32 * 8);   // 16-byte pieces of a lane: 16
constexpr int ST_MAX_CLASSES = 8; // so that a slot's copies lie >= 8 of a warp's copies apart

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned bf2(float a, float b, float s) {
  const bf162 v = __floats2bfloat162_rn(__fadd_rn(a, s), __fadd_rn(b, s));
  return *reinterpret_cast<const unsigned*>(&v);
}

// Warp w = chunk + chunks * cls owns the 8 KiB chunk `chunk` of the
// flattened (B, B) tile (A's 4096 floats in registers, 128 a lane) and the
// iterations it = cls, cls + classes, ...; classes divides 64, so every
// copy into a slot's chunk comes from that one warp, in order of it.  A
// lane owns the 16-byte pieces q * 32 + lane.
__global__ void __launch_bounds__(32 * ST_WARPS, 1) store_kernel(const float* __restrict__ A,
                                                                 bf16* __restrict__ big,
                                                                 float* __restrict__ o, int B,
                                                                 int n, int classes, int bulk) {
  extern __shared__ __align__(128) unsigned char ssm[];
  const int lane = threadIdx.x % 32, wib = threadIdx.x / 32;
  const int w = blockIdx.x * ST_WARPS + wib;
  const int chunks = B * B / ST_CHUNK;
  const int chunk = w % chunks, cls = w / chunks;
  const size_t base = (size_t)chunk * ST_CHUNK;
  const float4* A4 = reinterpret_cast<const float4*>(A + base);
  float4 a[2 * ST_Q];
#pragma unroll
  for (int q = 0; q < ST_Q; ++q) {
    a[2 * q] = A4[2 * (q * 32 + lane)];
    a[2 * q + 1] = A4[2 * (q * 32 + lane) + 1];
  }
  uint4* ring = reinterpret_cast<uint4*>(ssm) + wib * ST_STAGES * (ST_CHUNK / 8);
  int j = 0;   // the warp's copies so far
  for (int it = cls; it < n; it += classes, ++j) {
    const float s = __fmul_rn((float)it, 1e-9f);   // unfused, as the reference rounds it
    uint4* dst = reinterpret_cast<uint4*>(big + (size_t)(it % ST_SLOTS) * B * B + base);
    if (bulk) {
      uint4* st = ring + (j % ST_STAGES) * (ST_CHUNK / 8);
      // The copy that last read this stage, ST_STAGES copies ago, has read it.
      if (lane == 0 && j >= ST_STAGES)
        asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(ST_STAGES - 1) : "memory");
      __syncwarp();
#pragma unroll
      for (int q = 0; q < ST_Q; ++q) {
        const float4 u = a[2 * q], v = a[2 * q + 1];
        st[q * 32 + lane] = make_uint4(bf2(u.x, u.y, s), bf2(u.z, u.w, s), bf2(v.x, v.y, s),
                                       bf2(v.z, v.w, s));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        // This slot's previous copy (64 / classes >= 8 copies ago) has landed,
        // so the copies of one slot land in order of it.
        asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(64 / ST_MAX_CLASSES - 1) : "memory");
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                     "r"(smem_addr(st)), "r"(ST_CHUNK * 2)
                     : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else {
#pragma unroll
      for (int q = 0; q < ST_Q; ++q) {
        const float4 u = a[2 * q], v = a[2 * q + 1];
        dst[q * 32 + lane] = make_uint4(bf2(u.x, u.y, s), bf2(u.z, u.w, s), bf2(v.x, v.y, s),
                                        bf2(v.z, v.w, s));
      }
    }
  }
  if (bulk && lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  if (cls == 0) {
    const float4 nf = make_float4((float)n, (float)n, (float)n, (float)n);
    float4* o4 = reinterpret_cast<float4*>(o + base);
    for (int e = lane; e < ST_CHUNK / 4; e += 32) o4[e] = nf;
  }
}

}  // namespace

extern "C" int gpc_vpu_exp(const float* a, float* out, int n, int reps, void* stream) {
  exp_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, out, n, reps);
  return (int)cudaGetLastError();
}

// X (B, 8), n2 (B) = row sums of X * X, out (B, B); B a multiple of 32.
extern "C" int gpc_vpu_gram(const float* X, const float* n2, float* out, int B, int reps,
                            void* stream) {
  if (B <= 0 || B % G_B) return (int)cudaErrorInvalidValue;
  const int smem = (B * (4 * 4 + 1) + GD) * (int)sizeof(float);
  cudaFuncSetAttribute(gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gram_kernel<<<dim3(B / G_B, B / G_B), 128, smem, (cudaStream_t)stream>>>(X, n2, out, B, reps);
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

// The store's layout as probes/vpu.py's store_plan must read it: the chunk
// (bf16 values), the warps of a block and the most iteration classes.
extern "C" int gpc_vpu_store_layout(int* out) {
  out[0] = ST_CHUNK;
  out[1] = ST_WARPS;
  out[2] = ST_MAX_CLASSES;
  return 0;
}

// A (B, B) f32, big (64, B, B) bf16, o (B, B) f32; B a multiple of 128, <= 1024;
// classes (probes/vpu.py's store_plan) 1, 2, 4 or 8.
extern "C" int gpc_vpu_store(const float* A, void* big, float* o, int B, int n, int classes,
                             int bulk, void* stream) {
  if (B <= 0 || B % 128 || B > 1024 || classes < 1 || classes > ST_MAX_CLASSES ||
      (classes & (classes - 1)))
    return (int)cudaErrorInvalidValue;
  const int warps = B * B / ST_CHUNK * classes;
  const int smem = bulk ? ST_WARPS * ST_STAGES * ST_CHUNK * (int)sizeof(bf16) : 0;
  cudaFuncSetAttribute(store_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  store_kernel<<<warps / ST_WARPS, 32 * ST_WARPS, smem, (cudaStream_t)stream>>>(
      A, static_cast<bf16*>(big), o, B, n, classes, bulk);
  return (int)cudaGetLastError();
}
