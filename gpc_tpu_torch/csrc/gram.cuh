// Covariance maps: the distance family, shared by the Gram tile kernel K1
// (gram.cu) and the Gram fill of the panel factorization (chol_panel.cu),
// and the inner-product family of K4 (gram.cu).
//
// One convention only: a map takes the squared distance of UNSCALED inputs
// and the kernel's own parameters in gpc_tpu_torch.kernels order:
//   rbf, exp          [inverseWidth, variance, -]
//   ratquad           [alpha, lengthScale, variance]
//   matern32/52       [lengthScale, variance, -]
// (the TPU panel kernel pre-scaled X by sqrt(gamma/2) instead; nothing here
// does, so the rbf map is always variance * exp(-gamma/2 * d2)).
//   lin               [variance, -, -]
//   poly, mlp         [weightVariance, biasVariance, variance], poly's degree
//                     a separate argument
// The guards are gpc_tpu/kernels.py's: the sqrt of exp and matern adds
// FLT_MIN, and mlp clamps its arcsin argument to +-(1 - 2^-24), the largest
// float below 1, so that the plain version's gradient stays finite where
// the argument rounds to 1.
#pragma once

#include <cuda_runtime.h>
#include <float.h>

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
      return p1 * expf(-p0 * sqrtf(d2 + FLT_MIN));
    case FAM_RATQUAD:
      return p2 * powf(1.0f + d2 * (0.5f / (p1 * p1 * p0)), -p0);
    case FAM_MATERN32: {
      const float u = sqrtf(d2 * (3.0f / (p0 * p0)) + FLT_MIN);
      return p1 * (1.0f + u) * expf(-u);
    }
    default: {  // FAM_MATERN52
      const float n2 = d2 * (5.0f / (p0 * p0));
      const float u = sqrtf(n2 + FLT_MIN);
      return p1 * (1.0f + u + n2 / 3.0f) * expf(-u);
    }
  }
}

enum InnerFamily {
  FAM_LIN = 0,
  FAM_POLY = 1,
  FAM_MLP = 2,
};

// The inner-product maps of x.x' = cross, with |x|^2 = n1 and |x'|^2 = n2.
__device__ __forceinline__ float inner_map(int family, float cross, float n1,
                                           float n2, float p0, float p1,
                                           float p2, float degree) {
  switch (family) {
    case FAM_LIN:
      return p0 * cross;
    case FAM_POLY:
      return p2 * powf(p0 * cross + p1, degree);
    default: {  // FAM_MLP
      const float lim = 1.0f - 5.9604645e-08f;  // 1 - 2^-24
      const float d1 = p0 * n1 + p1 + 1.0f;
      const float d2 = p0 * n2 + p1 + 1.0f;
      const float arg = (p0 * cross + p1) / sqrtf(d1 * d2);
      return p2 * asinf(fminf(fmaxf(arg, -lim), lim));
    }
  }
}
