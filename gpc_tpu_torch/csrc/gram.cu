// K1 and K4: fused cross-covariance tiles of the two kernel families.
//
// K1 replaces gpc_tpu/ops/gram_pallas.py::dist_gram (_dist_tile_kernel):
// out[i, j] = map(max(|x1_i|^2 + |x2_j|^2 - 2 x1_i.x2_j, 0)) for the five
// distance maps of gram.cuh.  K4 replaces its inner_gram
// (_inner_tile_kernel): out[i, j] = map(x1_i.x2_j, |x1_i|^2, |x2_j|^2) for
// lin, poly and mlp.  One kernel serves both, templated on the map.
//
// What bounds it on the H100: with the small input widths this system sees
// (q of 1 to a few tens) the rank-q product is a few FLOPs per output, so the
// kernel is bound by the n*m*4 bytes it writes (at q = 8, 16384 x 8192: 537
// MB out against 0.8 MB in, and 22 (K1) to 26 (K4) operations an output, far
// below the f32 rate).  The first design (64 x 64 tiles, one per block)
// wrote at 19-37 % of the 3.35 TB/s: a block staged X1 and X2 through shared
// memory in zero-padded q-chunks behind three barriers before its first
// store, then wrote only 16 KB in scalar stores.  This design keeps the
// store pipe full:
//
//  * a block owns a stripe of 128 columns: it stages that stripe of X2 in
//    shared memory once (k-major, so lane l reads columns 4l..4l+3 as one
//    float4) and then walks row groups, grid-stride, with no further block
//    barrier; about four blocks an SM;
//  * a thread computes 4 consecutive columns x 4 rows; the q loop runs to q
//    exactly (no padding); X1's rows are warp-uniform loads (one broadcast
//    each) and its norms are summed beside the product;
//  * each row's 4 values go out as one 16-byte streaming store (__stcs: the
//    537 MB output does not evict the inputs from L2), so a warp writes 512
//    contiguous bytes a row.  A row whose start is not 16-byte aligned (m %
//    4 != 0) and the ragged column edge take scalar streaming stores.
//
// The three parameters are read from a device pointer, so a launch never
// waits for the host to read them (ops/gram.py).  For q above QCH the
// stripe is staged in chunks of QCH per row group, behind block barriers.
// poly at a whole degree 0..16 multiplies (ideg >= 0) instead of powf: a
// deviation from gram.cuh's map, within a few ulp of it.
//
// A leading batch axis (PITC's block Grams, gpc_tpu's vmapped kern.gram),
// compiled apart (BATCHED) so that the 2-D kernel stays as it was: the
// grid's z index is the batch, whose X1, X2 and out start at z*n*q, z*m*q
// and z*n*m, and a row takes the 16-byte store when its address is
// aligned; everything else is the 2-D kernel's, so each batch's values are
// bit for bit those of its own 2-D launch.  The row blocks a stripe gets
// shrink with the batch so that the grid stays about four blocks an SM.
// One kernel for both (2-D as a batch of one) ran 2-D calls 3-6 % slower
// (K1 rbf, K4 poly and mlp at 16384 x 8192, q = 8; H100 80GB HBM3, 700 W;
// chip_smoke.py phase 2 alternated with the single-variant kernel).
#include <cuda_runtime.h>
#include <stddef.h>

#include "gram.cuh"

namespace {

constexpr int STRIPE = 128;       // columns a block keeps on chip
constexpr int GT = 256;           // threads a block
constexpr int WARPS = GT / 32;
constexpr int RPT = 4;            // rows a thread computes per group
constexpr int QCH = 96;           // input width staged at once: 48 KB
constexpr int BLOCKS_PER_SM = 4;

template <bool INNER, int FAM>
__device__ __forceinline__ float gram_map(float cross, float n1, float n2, float p0,
                                          float p1, float p2, float degree, int ideg) {
  if (INNER) {
    if (FAM == FAM_POLY && ideg >= 0) {
      const float x = p0 * cross + p1;
      float r = 1.0f;
      for (int i = 0; i < ideg; ++i) r *= x;
      return p2 * r;
    }
    return inner_map(FAM, cross, n1, n2, p0, p1, p2, degree);
  }
  return dist_map(FAM, sq_dist(n1, n2, cross), p0, p1, p2);
}

template <bool INNER, int FAM, bool BATCHED>
__global__ void __launch_bounds__(GT)
    gram_stripe_kernel(const float* __restrict__ X1, const float* __restrict__ X2,
                       int n, int m, int q, const float* __restrict__ params,
                       float degree, int ideg, float* __restrict__ out) {
  constexpr bool NORMS = !INNER || FAM == FAM_MLP;
  extern __shared__ __align__(16) float xs[];   // xs[k * STRIPE + c]
  const size_t z = BATCHED ? blockIdx.z : 0;
  if (BATCHED) {
    X1 += z * n * q;
    X2 += z * m * q;
  }
  const size_t zout = z * n * m;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * STRIPE;
  const int c = col0 + 4 * lane;
  const float p0 = params[0], p1 = params[1], p2 = params[2];
  const int qch = q < QCH ? q : QCH;
  const bool once = q <= QCH;

  auto stage = [&](int k0, int kn) {
    for (int e = threadIdx.x; e < kn * STRIPE; e += GT) {
      const int cc = e / kn;
      const int k = e % kn;
      const int col = col0 + cc;
      xs[k * STRIPE + cc] = col < m ? X2[(size_t)col * q + k0 + k] : 0.0f;
    }
  };
  float n2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (once) {
    stage(0, q);
    __syncthreads();
    if (NORMS)
      for (int k = 0; k < q; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(xs + k * STRIPE + 4 * lane);
        n2[0] = fmaf(b.x, b.x, n2[0]);
        n2[1] = fmaf(b.y, b.y, n2[1]);
        n2[2] = fmaf(b.z, b.z, n2[2]);
        n2[3] = fmaf(b.w, b.w, n2[3]);
      }
  }

  // row groups of RPT rows, WARPS groups a block round (every warp of the
  // block runs the same number of rounds: the chunked path has barriers)
  const int groups = (n + RPT - 1) / RPT;
  for (int g0 = blockIdx.y * WARPS; g0 < groups; g0 += gridDim.y * WARPS) {
    const int r0 = (g0 + warp) * RPT;
    float acc[RPT][4], n1[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      n1[i] = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    }
    const float* xr[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) xr[i] = X1 + (size_t)min(r0 + i, n - 1) * q;
    if (!once) n2[0] = n2[1] = n2[2] = n2[3] = 0.0f;
    for (int k0 = 0; k0 < q; k0 += qch) {
      const int kn = q - k0 < qch ? q - k0 : qch;
      if (!once) {
        __syncthreads();
        stage(k0, kn);
        __syncthreads();
      }
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(xs + k * STRIPE + 4 * lane);
        if (NORMS && !once) {
          n2[0] = fmaf(b.x, b.x, n2[0]);
          n2[1] = fmaf(b.y, b.y, n2[1]);
          n2[2] = fmaf(b.z, b.z, n2[2]);
          n2[3] = fmaf(b.w, b.w, n2[3]);
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float a = __ldg(xr[i] + k0 + k);
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
          if (NORMS) n1[i] = fmaf(a, a, n1[i]);
        }
      }
    }
    if (c >= m) continue;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i;
      if (r >= n) break;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = gram_map<INNER, FAM>(acc[i][e], n1[i], n2[e], p0, p1, p2, degree, ideg);
      const size_t o = zout + (size_t)r * m + c;
      float* dst = out + o;
      const bool aligned =
          BATCHED ? (reinterpret_cast<size_t>(dst) & 15) == 0 : (o & 3) == 0;
      if (c + 3 < m && aligned) {
        __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < m) __stcs(dst + e, v[e]);
      }
    }
  }
}

template <bool INNER, int FAM>
int launch_stripes(int batch, const float* X1, const float* X2, int n, int m, int q,
                   const float* params, float degree, int ideg, float* out,
                   cudaStream_t stream) {
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
  }
  const int stripes = (m + STRIPE - 1) / STRIPE;
  const int groups = (n + RPT - 1) / RPT;
  const long long spread = (long long)stripes * batch;
  int rows = (int)((BLOCKS_PER_SM * sm_count + spread - 1) / spread);
  const int most = (groups + WARPS - 1) / WARPS;
  if (rows > most) rows = most;
  if (rows < 1) rows = 1;
  const size_t smem = (size_t)(q < QCH ? q : QCH) * STRIPE * sizeof(float);
  if (batch == 1) {
    gram_stripe_kernel<INNER, FAM, false><<<dim3(stripes, rows), GT, smem, stream>>>(
        X1, X2, n, m, q, params, degree, ideg, out);
    return (int)cudaGetLastError();
  }
  constexpr int ZMAX = 65535;     // the grid's z limit
  for (int b0 = 0; b0 < batch; b0 += ZMAX) {
    const int nb = batch - b0 < ZMAX ? batch - b0 : ZMAX;
    gram_stripe_kernel<INNER, FAM, true><<<dim3(stripes, rows, nb), GT, smem, stream>>>(
        X1 + (size_t)b0 * n * q, X2 + (size_t)b0 * m * q, n, m, q, params, degree, ideg,
        out + (size_t)b0 * n * m);
  }
  return (int)cudaGetLastError();
}

int dist_gram(int batch, const float* X1, const float* X2, int n, int m, int q,
              int family, const float* params, float* out, void* stream) {
  if (n <= 0 || m <= 0 || batch <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (family) {
    case FAM_RBF:
      return launch_stripes<false, FAM_RBF>(batch, X1, X2, n, m, q, params, 0.0f, -1, out, s);
    case FAM_EXP:
      return launch_stripes<false, FAM_EXP>(batch, X1, X2, n, m, q, params, 0.0f, -1, out, s);
    case FAM_RATQUAD:
      return launch_stripes<false, FAM_RATQUAD>(batch, X1, X2, n, m, q, params, 0.0f, -1, out,
                                                s);
    case FAM_MATERN32:
      return launch_stripes<false, FAM_MATERN32>(batch, X1, X2, n, m, q, params, 0.0f, -1, out,
                                                 s);
    case FAM_MATERN52:
      return launch_stripes<false, FAM_MATERN52>(batch, X1, X2, n, m, q, params, 0.0f, -1, out,
                                                 s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int inner_gram(int batch, const float* X1, const float* X2, int n, int m, int q, int family,
               const float* params, float degree, int ideg, float* out, void* stream) {
  if (n <= 0 || m <= 0 || batch <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (family) {
    case FAM_LIN:
      return launch_stripes<true, FAM_LIN>(batch, X1, X2, n, m, q, params, degree, ideg, out, s);
    case FAM_POLY:
      return launch_stripes<true, FAM_POLY>(batch, X1, X2, n, m, q, params, degree, ideg, out, s);
    case FAM_MLP:
      return launch_stripes<true, FAM_MLP>(batch, X1, X2, n, m, q, params, degree, ideg, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// params: the kernel's three parameters (padded), float32 on the device.
extern "C" int gpc_dist_gram(const float* X1, const float* X2, int n, int m,
                             int q, int family, const float* params,
                             float* out, void* stream) {
  return dist_gram(1, X1, X2, n, m, q, family, params, out, stream);
}

// ideg: poly's degree when it is a whole number 0..16, else -1 (powf).
extern "C" int gpc_inner_gram(const float* X1, const float* X2, int n, int m,
                              int q, int family, const float* params,
                              float degree, int ideg, float* out, void* stream) {
  return inner_gram(1, X1, X2, n, m, q, family, params, degree, ideg, out, stream);
}

// The batched Grams: X1 (batch, n, q), X2 (batch, m, q), out (batch, n, m).
extern "C" int gpc_dist_gram_batched(int batch, const float* X1, const float* X2, int n,
                                     int m, int q, int family, const float* params,
                                     float* out, void* stream) {
  return dist_gram(batch, X1, X2, n, m, q, family, params, out, stream);
}

extern "C" int gpc_inner_gram_batched(int batch, const float* X1, const float* X2, int n,
                                      int m, int q, int family, const float* params,
                                      float degree, int ideg, float* out, void* stream) {
  return inner_gram(batch, X1, X2, n, m, q, family, params, degree, ideg, out, stream);
}
