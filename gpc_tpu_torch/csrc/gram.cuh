// Distance-family covariance maps, shared by the Gram tile kernel (gram.cu)
// and the Gram fill of the panel factorization (chol_panel.cu).
//
// One convention only: a map takes the squared distance of UNSCALED inputs
// and the kernel's own parameters in gpc_tpu_torch.kernels order:
//   rbf, exp          [inverseWidth, variance, -]
//   ratquad           [alpha, lengthScale, variance]
//   matern32/52       [lengthScale, variance, -]
// (the TPU panel kernel pre-scaled X by sqrt(gamma/2) instead; nothing here
// does, so the rbf map is always variance * exp(-gamma/2 * d2)).
#pragma once

#include <cuda_runtime.h>

enum DistFamily {
  FAM_RBF = 0,
  FAM_EXP = 1,
  FAM_RATQUAD = 2,
  FAM_MATERN32 = 3,
  FAM_MATERN52 = 4,
};

// max(|x|^2 + |x'|^2 - 2 x.x', 0): the GEMM form of the squared distance.
__device__ __forceinline__ float sq_dist(float n1, float n2, float cross) {
  return fmaxf(n1 + n2 - 2.0f * cross, 0.0f);
}

__device__ __forceinline__ float dist_map(int family, float d2, float p0,
                                          float p1, float p2) {
  switch (family) {
    case FAM_RBF:
      return p1 * expf(-0.5f * p0 * d2);
    case FAM_EXP:
      return p1 * expf(-p0 * sqrtf(d2 + 1e-30f));
    case FAM_RATQUAD:
      return p2 * powf(1.0f + d2 * (0.5f / (p1 * p1 * p0)), -p0);
    case FAM_MATERN32: {
      const float u = sqrtf(d2 * (3.0f / (p0 * p0)) + 1e-30f);
      return p1 * (1.0f + u) * expf(-u);
    }
    default: {  // FAM_MATERN52
      const float n2 = d2 * (5.0f / (p0 * p0));
      const float u = sqrtf(n2 + 1e-30f);
      return p1 * (1.0f + u + n2 / 3.0f) * expf(-u);
    }
  }
}
