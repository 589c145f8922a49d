// K1 and K4: fused cross-covariance tiles of the two kernel families.
//
// K1 replaces gpc_tpu/ops/gram_pallas.py::dist_gram (_dist_tile_kernel):
// out[i, j] = map(max(|x1_i|^2 + |x2_j|^2 - 2 x1_i.x2_j, 0)) for the five
// distance maps of gram.cuh.  K4 replaces its inner_gram
// (_inner_tile_kernel): out[i, j] = map(x1_i.x2_j, |x1_i|^2, |x2_j|^2) for
// lin, poly and mlp; mlp needs both row norms, which the tile keeps in
// shared memory for K1 anyway.  One tile kernel serves both, templated on
// the epilogue.
//
// What bounds it on the H100: with the small input widths this system sees
// (q of 1 to a few tens) the rank-q product is a few FLOPs per output, so the
// kernel is bound by the n*m*4 bytes it writes (at q = 8, 16384 x 8192: 537
// MB out against 0.8 MB in, and 22 (K1) to 26 (K4) operations an output, far
// below the f32 rate).  The design keeps K out of device memory in any
// intermediate form (no separate dist2 or X1 X2^T pass): each block
// stages a 64-row tile of X1 and of X2 in shared memory in q-chunks, keeps
// the cross products and row norms on chip, applies the map and writes each
// output once, a warp covering 32 consecutive columns (coalesced 128 B
// stores).  Ragged n, m are masked at the edge instead of falling back.
#include <cuda_runtime.h>
#include <stddef.h>

#include "gram.cuh"

namespace {

constexpr int TILE = 64;      // output tile is TILE x TILE
constexpr int QC = 16;        // input-width chunk staged per step
constexpr int THREADS = 256;  // thread t: column t % 64, rows t / 64 + 4 i
constexpr int ROWS_PER_THREAD = TILE * TILE / THREADS;

// INNER = false: K1 (distance maps); true: K4 (inner-product maps).
template <bool INNER>
__global__ void __launch_bounds__(THREADS)
    gram_tile_kernel(const float* __restrict__ X1, const float* __restrict__ X2,
                     int n, int m, int q, int family, float p0, float p1,
                     float p2, float degree, float* __restrict__ out) {
  __shared__ float xs1[TILE][QC + 1];
  __shared__ float xs2[TILE][QC + 1];
  __shared__ float nrm1[TILE];
  __shared__ float nrm2[TILE];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const int tc = tid % TILE;
  const int tr = tid / TILE;

  float cross[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) cross[i] = 0.0f;
  if (tid < TILE) nrm1[tid] = 0.0f;
  else if (tid < 2 * TILE) nrm2[tid - TILE] = 0.0f;

  for (int k0 = 0; k0 < q; k0 += QC) {
    __syncthreads();  // previous chunk fully consumed
    for (int e = tid; e < TILE * QC; e += THREADS) {
      const int i = e / QC;
      const int k = e % QC;
      const int kk = k0 + k;
      const int r = row0 + i;
      const int c = col0 + i;
      xs1[i][k] = (r < n && kk < q) ? X1[(size_t)r * q + kk] : 0.0f;
      xs2[i][k] = (c < m && kk < q) ? X2[(size_t)c * q + kk] : 0.0f;
    }
    __syncthreads();
    if (tid < TILE) {
      float s = 0.0f;
      for (int k = 0; k < QC; ++k) s += xs1[tid][k] * xs1[tid][k];
      nrm1[tid] += s;
    } else if (tid < 2 * TILE) {
      float s = 0.0f;
      for (int k = 0; k < QC; ++k) s += xs2[tid - TILE][k] * xs2[tid - TILE][k];
      nrm2[tid - TILE] += s;
    }
    for (int k = 0; k < QC; ++k) {
      const float b = xs2[tc][k];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
        cross[i] += xs1[tr + 4 * i][k] * b;
    }
  }
  __syncthreads();  // norms complete

  const int c = col0 + tc;
  if (c >= m) return;
  const float n2 = nrm2[tc];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int r = row0 + tr + 4 * i;
    if (r >= n) continue;
    const float n1 = nrm1[tr + 4 * i];
    out[(size_t)r * m + c] =
        INNER ? inner_map(family, cross[i], n1, n2, p0, p1, p2, degree)
              : dist_map(family, sq_dist(n1, n2, cross[i]), p0, p1, p2);
  }
}

template <bool INNER>
int launch_gram(const float* X1, const float* X2, int n, int m, int q,
                int family, float p0, float p1, float p2, float degree,
                float* out, void* stream) {
  if (n > 0 && m > 0) {
    const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
    gram_tile_kernel<INNER><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        X1, X2, n, m, q, family, p0, p1, p2, degree, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gpc_dist_gram(const float* X1, const float* X2, int n, int m,
                             int q, int family, float p0, float p1, float p2,
                             float* out, void* stream) {
  return launch_gram<false>(X1, X2, n, m, q, family, p0, p1, p2, 0.0f, out,
                            stream);
}

extern "C" int gpc_inner_gram(const float* X1, const float* X2, int n, int m,
                              int q, int family, float p0, float p1, float p2,
                              float degree, float* out, void* stream) {
  return launch_gram<true>(X1, X2, n, m, q, family, p0, p1, p2, degree, out,
                           stream);
}
