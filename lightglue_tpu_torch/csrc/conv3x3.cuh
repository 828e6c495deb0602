// Shared pieces of the SuperPoint encoder kernels (stem.cu, stem2.cu): a
// 3x3 64 -> 64 convolution over a shared-memory tile, then bias, ReLU and a
// 2x2 max-pool, fp32 on the CUDA cores.
//
// A block of 256 threads computes a tile of up to 16 x 16 conv outputs for
// all 64 output channels. Thread t owns one 2x2 window of outputs (t % 64:
// window row t/8 % 8, column t % 8; a tile of WIN x WIN windows leaves the
// others idle) for 16 output channels (16 * (t / 64) ...), so 64
// accumulators; the channel group is uniform across a warp, so weight reads
// are broadcasts. The conv's input is a shared-memory tile [channels][rows]
// [AS] (the output tile plus a 1-pixel ring), rows padded to AS = 24
// floats: a half-warp's 8-byte loads then hit 16 distinct bank pairs.
// Weights stream through shared memory a few input channels at a time, in
// the layout [ci][tap][co].
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sp {

constexpr int NT = 256;        // threads per block
constexpr int TS = 16;         // conv-output tile edge
constexpr int AR = TS + 2;     // rows (and used columns) of the input tile
constexpr int AS = 24;         // padded row stride of the input tile
constexpr int QC = 16;         // input channels per tile stage
constexpr int KC = 8;          // input channels per weight chunk (stem)
constexpr int C = 64;          // channels in and out
constexpr int WROW = 9 * C;    // one input channel's weights: [tap][co]
constexpr int A_FLOATS = QC * AR * AS;   // a [QC][AR][AS] input tile
constexpr int WC_FLOATS = KC * WROW;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// acc[k][2 py + px] += sum over the NCH channels of A and the 3x3 taps of
// w[ci_base + c][tap][co0 + k] * A[c][2 wr + py + dy][2 wc + px + dx], for
// threads whose window lies in the WIN x WIN tile. A: [NCH][ROWS][AS] in
// shared memory; w: [64][9][64] in device memory; Wc: a shared buffer of
// KCH * WROW floats. Starts with a barrier, so A may have been written just
// before the call; ends without one.
template <int NCH, int ROWS, int KCH, int WIN>
__device__ __forceinline__ void conv_accumulate(const float* A,
                                                const float* __restrict__ w,
                                                int ci_base, float* Wc,
                                                float acc[16][4]) {
  const int t = threadIdx.x, co0 = (t >> 6) * 16;
  const int wr = (t & 63) >> 3, wc = t & 7;
  const bool active = wr < WIN && wc < WIN;
  for (int c0 = 0; c0 < NCH; c0 += KCH) {
    __syncthreads();
    const float4* src =
        reinterpret_cast<const float4*>(w + (size_t)(ci_base + c0) * WROW);
    float4* dst = reinterpret_cast<float4*>(Wc);
    for (int i = t; i < KCH * WROW / 4; i += NT) dst[i] = src[i];
    __syncthreads();
    if (!active) continue;
#pragma unroll 1
    for (int c = 0; c < KCH; ++c) {
      const float* a = A + (c0 + c) * ROWS * AS + 2 * wr * AS + 2 * wc;
      float x[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 lo = *reinterpret_cast<const float2*>(a + i * AS);
        const float2 hi = *reinterpret_cast<const float2*>(a + i * AS + 2);
        x[i][0] = lo.x; x[i][1] = lo.y; x[i][2] = hi.x; x[i][3] = hi.y;
      }
      const float* wrow = Wc + c * WROW + co0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        float wv[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(wrow + tap * C + 4 * q);
          wv[4 * q] = v.x; wv[4 * q + 1] = v.y; wv[4 * q + 2] = v.z; wv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int k = 0; k < 16; ++k)
#pragma unroll
          for (int py = 0; py < 2; ++py)
#pragma unroll
            for (int px = 0; px < 2; ++px)
              acc[k][2 * py + px] =
                  fmaf(wv[k], x[py + dy][px + dx], acc[k][2 * py + px]);
      }
    }
  }
}

// out[co][oy0 + wr][ox0 + wc] = max over the window of relu(acc + bias[co])
// for the thread's 16 channels, if its window lies in the WIN x WIN tile;
// out is one image's (64, Ho, Wo) map.
template <int WIN>
__device__ __forceinline__ void bias_relu_pool_store(
    const float acc[16][4], const float* __restrict__ bias,
    float* __restrict__ out, int Ho, int Wo, int oy0, int ox0) {
  const int t = threadIdx.x, co0 = (t >> 6) * 16;
  const int wr = (t & 63) >> 3, wc = t & 7;
  const int oy = oy0 + wr, ox = ox0 + wc;
  if (wr >= WIN || wc >= WIN || oy >= Ho || ox >= Wo) return;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float b = bias[co0 + k];
    float m = fmaxf(acc[k][0] + b, 0.f);
#pragma unroll
    for (int p = 1; p < 4; ++p) m = fmaxf(m, fmaxf(acc[k][p] + b, 0.f));
    out[((size_t)(co0 + k) * Ho + oy) * Wo + ox] = m;
  }
}

}  // namespace sp
