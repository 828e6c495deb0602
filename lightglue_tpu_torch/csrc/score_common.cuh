// What B11's and B12's fp32 kernel (score_head.cu) and bf16 kernel
// (score_wgmma.cuh) share: the align-corners lerp of a branch axis, and the
// sigmoid (with the ex2 that SELU also takes).
#pragma once

#include <math.h>

namespace lg {
namespace score {

__host__ __device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

// Align-corners lerp of output index g (of n) into a branch axis of size
// nk: the rows i0, i1 and the weight of i1, as ops/sampling.py::upsample
// computes them (a float64 linspace: g times the step, the last index
// exactly nk - 1, and 0 when n is 1). A branch dimension of 1 takes its
// single row (i0 = i1 = 0, weight 0).
struct Lerp {
  int i0, i1;
  float w;
};

__host__ __device__ __forceinline__ Lerp lerp_of(int g, int n, int nk) {
  const double c = n == 1 ? 0.0
                   : g == n - 1 ? (double)(nk - 1)
                                : g * ((double)(nk - 1) / (double)(n - 1));
  const double f = floor(c);
  Lerp l;
  l.i0 = (int)f;
  l.i1 = l.i0 + 1 < nk - 1 ? l.i0 + 1 : nk - 1;
  l.w = (float)(c - f);
  return l;
}

__device__ __forceinline__ float ex2(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
#endif
}

// 1 / (1 + 2^(-x log2 e))
__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(1.f + ex2(-x * 1.4426950408889634f));
}

}  // namespace score
}  // namespace lg
