// The FFN on 32 rows held in shared memory: K3's body (ffn.cu).
#pragma once

#include "common.cuh"

namespace lg {

constexpr int FFN_ROWS = 32;  // rows of one FFN pass: 8 warps x 4 rows
constexpr int FFN_KC = 16;    // weight rows staged per step

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Floats of shared memory ffn_rows uses at width D: Xs and Hs (32 x 2D
// each) and the staged weight rows (16 x 2D).
template <int D>
constexpr int ffn_floats() {
  return 2 * FFN_ROWS * 2 * D + FFN_KC * 2 * D;
}

// out[row0 + r] = x_r + W2^T GELU(LN(Xs[r] W1 + b1)) + b2 for the 32 rows
// r of Xs = [x | m] (32 x 2D, filled by the caller and not yet
// synchronised), W1 (2D, 2D) and W2 (2D, D) stored (in, out), LayerNorm
// eps 1e-5 and the exact erf GELU; rows at or past `rows` are not written.
// Each warp owns 4 rows and each lane 2D/32 columns of them, so the
// LayerNorm statistics are warp sums; weights stream through Ws 16 input
// rows at a time.
template <int D>
__device__ __forceinline__ void ffn_rows(
    const float* Xs, float* Hs, float* Ws, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ out, int row0,
    int rows) {
  constexpr int D2 = 2 * D;
  constexpr int C1 = D2 / 32;  // hidden columns per lane
  constexpr int C2 = D / 32;   // output columns per lane
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  float acc[4][C1] = {};
  for (int k0 = 0; k0 < D2; k0 += FFN_KC) {
    __syncthreads();  // Xs filled; previous Ws readers done
    for (int idx = t; idx < FFN_KC * D2; idx += THREADS)
      Ws[idx] = w1[(size_t)k0 * D2 + idx];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FFN_KC; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[(warp * 4 + i) * D2 + k0 + kk];
#pragma unroll
      for (int j = 0; j < C1; ++j) {
        const float w = Ws[kk * D2 + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < C1; ++j) {
      acc[i][j] += b1[lane + 32 * j];
      s += acc[i][j];
    }
    const float mean = warp_sum(s) / D2;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < C1; ++j) {
      const float c = acc[i][j] - mean;
      sq += c * c;
    }
    const float inv = 1.0f / sqrtf(warp_sum(sq) / D2 + 1e-5f);
#pragma unroll
    for (int j = 0; j < C1; ++j) {
      const int c = lane + 32 * j;
      const float hn = (acc[i][j] - mean) * inv * gamma[c] + beta[c];
      Hs[(warp * 4 + i) * D2 + c] =
          0.5f * hn * (1.0f + erff(hn * 0.7071067811865476f));
    }
  }

  float acc2[4][C2] = {};
  for (int k0 = 0; k0 < D2; k0 += FFN_KC) {
    __syncthreads();  // Hs complete; previous Ws readers done
    for (int idx = t; idx < FFN_KC * D; idx += THREADS)
      Ws[idx] = w2[(size_t)k0 * D + idx];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FFN_KC; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Hs[(warp * 4 + i) * D2 + k0 + kk];
#pragma unroll
      for (int j = 0; j < C2; ++j) {
        const float w = Ws[kk * D + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc2[i][j] = fmaf(a[i], w, acc2[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + warp * 4 + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < C2; ++j) {
      const int c = lane + 32 * j;
      out[(size_t)row * D + c] =
          Xs[(warp * 4 + i) * D2 + c] + (acc2[i][j] + b2[c]);
    }
  }
}

}  // namespace lg
