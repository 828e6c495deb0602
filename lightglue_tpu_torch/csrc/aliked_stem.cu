// B10: ALIKED's block 1 and its two consumers in one pass, fp32:
// conv3x3 3 -> C1 + BN + SELU, conv3x3 C1 -> C1 + BN + SELU (x1), then the
// aggregation branch y1 = SELU(1x1 C1 -> CY of x1) and the pooled map
// x1p = 2x2 average of x1. x1 itself never reaches device memory.
//
// Replaces the TPU kernel lightglue_tpu/ops/aliked_stem.py::
// _aliked_stem_kernel (fused_aliked_stem): image (B, 3, H, W) NCHW ->
// y1 (B, H, W, CY) channels-last and x1p (B, C1, H/2, W/2) NCHW. Both convs
// zero-pad their own input, so conv1 values outside the image are 0.
// (C1, CY) is (8, 16) (aliked-t16) or (16, 32) (the other models), as
// compile-time widths.
//
// What bounds it on an H100: arithmetic. At C1 16 a pixel takes 432 + 2304
// + 512 multiply-adds, 5.1 GFLOP per 768 x 1024 image (0.077 ms at the 67
// TFLOP/s fp32 CUDA-core peak), against 12 B in and 144 B out per pixel
// (0.037 ms at 3.35 TB/s).
//
// Design: one block of 256 threads per 32 x 32 output tile. The image tile
// with a 2-pixel ring (3 x 36 x 36) and every weight go to shared memory,
// the weights with the output channel innermost, so that one broadcast
// float4 load feeds four output channels. conv1 + BN + SELU fills a
// C1 x 34 x 34 tile (the 1-pixel ring conv2 needs) in shared memory, 0
// outside the image. Each thread then owns one 2x2 window of conv2 outputs
// for all C1 channels (4 C1 accumulators, its 4 x 4 input window read as
// float2 pairs, a half-warp reading 128 consecutive bytes), applies BN +
// SELU in registers, and writes the window's average (x1p) and its four y1
// rows (CY channels each, 8 at a time, float4).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;            // threads: one 2x2 window each
constexpr int T = 32;              // output tile edge
constexpr int AR = T + 2;          // conv1 tile edge (1-pixel ring)
constexpr int AS = 36;             // padded row stride of the conv1 tile
constexpr int IR = T + 4;          // image tile edge (2-pixel ring)
constexpr float kAlpha = 1.6732632423543772848170429916717f;
constexpr float kScale = 1.0507009873554804934193349852946f;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float selu(float x) {
  return kScale * (x > 0.f ? x : kAlpha * expm1f(x));
}

template <int C1, int CY>
constexpr int smem_floats() {
  return C1 * AR * AS + 3 * IR * IR + C1 * 27 + C1 * 9 * C1 + C1 * CY + 4 * C1;
}

template <int C1, int CY>
__global__ void __launch_bounds__(NT)
    aliked_stem_kernel(const float* __restrict__ img,  // (B, 3, H, W)
                       const float* __restrict__ w1,   // (27, C1): [ci dy dx][co]
                       const float* __restrict__ bn,   // s1, b1, s2, b2: (4, C1)
                       const float* __restrict__ w2,   // (C1 ci, 9, C1 co)
                       const float* __restrict__ wy,   // (C1 ci, CY co)
                       float* __restrict__ y1,         // (B, H, W, CY)
                       float* __restrict__ xp,         // (B, C1, H/2, W/2)
                       int H, int W) {
  extern __shared__ __align__(16) float as_smem[];
  float* A = as_smem;             // [C1][AR][AS] conv1 tile
  float* I = A + C1 * AR * AS;    // [3][IR][IR] image tile
  float* W1 = I + 3 * IR * IR;    // [27][C1]
  float* W2 = W1 + C1 * 27;       // [C1 ci][9][C1 co]
  float* WY = W2 + C1 * 9 * C1;   // [C1 ci][CY]
  float* BN = WY + C1 * CY;       // [4][C1]

  const int t = threadIdx.x, b = blockIdx.z;
  const int y0 = blockIdx.y * T, x0 = blockIdx.x * T;
  const float* im = img + (size_t)b * 3 * H * W;
  for (int i = t; i < 3 * IR * IR; i += NT) {
    const int c = i / (IR * IR), p = i % (IR * IR);
    const int gy = y0 - 2 + p / IR, gx = x0 - 2 + p % IR;
    I[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
               ? im[((size_t)c * H + gy) * W + gx] : 0.f;
  }
  for (int i = t; i < C1 * 27; i += NT) W1[i] = w1[i];
  for (int i = t; i < C1 * 9 * C1; i += NT) W2[i] = w2[i];
  for (int i = t; i < C1 * CY; i += NT) WY[i] = wy[i];
  for (int i = t; i < 4 * C1; i += NT) BN[i] = bn[i];
  __syncthreads();

  // conv1 + BN + SELU at positions (y0 - 1 + r, x0 - 1 + c), r, c < AR
  for (int p = t; p < AR * AR; p += NT) {
    const int r = p / AR, c = p % AR;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float acc[C1];
#pragma unroll
    for (int co = 0; co < C1; ++co) acc[co] = 0.f;
#pragma unroll
    for (int k = 0; k < 27; ++k) {  // k = (ci, dy, dx)
      const float x = I[((k / 9) * IR + r + k % 9 / 3) * IR + c + k % 3];
      const float4* wk = reinterpret_cast<const float4*>(W1 + k * C1);
#pragma unroll
      for (int q = 0; q < C1 / 4; ++q) {
        const float4 w = wk[q];
        acc[4 * q] = fmaf(w.x, x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(w.y, x, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(w.z, x, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(w.w, x, acc[4 * q + 3]);
      }
    }
#pragma unroll
    for (int co = 0; co < C1; ++co)
      A[(co * AR + r) * AS + c] = in ? selu(fmaf(acc[co], BN[co], BN[C1 + co])) : 0.f;
  }
  __syncthreads();

  // conv2: this thread's 2x2 window at tile rows 2 wr.., columns 2 wc..
  const int wr = t / (T / 2), wc = t % (T / 2);
  float acc[C1][4];
#pragma unroll
  for (int co = 0; co < C1; ++co)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[co][p] = 0.f;
#pragma unroll 1
  for (int ci = 0; ci < C1; ++ci) {
    const float* a = A + (ci * AR + 2 * wr) * AS + 2 * wc;
    float x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 lo = *reinterpret_cast<const float2*>(a + i * AS);
      const float2 hi = *reinterpret_cast<const float2*>(a + i * AS + 2);
      x[i][0] = lo.x; x[i][1] = lo.y; x[i][2] = hi.x; x[i][3] = hi.y;
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float4* wrow = reinterpret_cast<const float4*>(W2 + (ci * 9 + tap) * C1);
#pragma unroll
      for (int q = 0; q < C1 / 4; ++q) {
        const float4 w4 = wrow[q];
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int py = 0; py < 2; ++py)
#pragma unroll
            for (int px = 0; px < 2; ++px)
              acc[4 * q + i][2 * py + px] =
                  fmaf(w[i], x[py + dy][px + dx], acc[4 * q + i][2 * py + px]);
      }
    }
  }

  const int oy = y0 / 2 + wr, ox = x0 / 2 + wc;  // pooled coordinates
  if (2 * oy >= H || 2 * ox >= W) return;  // H, W even: whole windows only
  const int Ho = H / 2, Wo = W / 2;
#pragma unroll
  for (int co = 0; co < C1; ++co) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      acc[co][p] = selu(fmaf(acc[co][p], BN[2 * C1 + co], BN[3 * C1 + co]));
      s += acc[co][p];
    }
    xp[(((size_t)b * C1 + co) * Ho + oy) * Wo + ox] = s * 0.25f;
  }
  // y1 = SELU(wy . x1) at the 4 pixels, 8 output channels at a time
#pragma unroll 1
  for (int j0 = 0; j0 < CY; j0 += 8) {
    float o[4][8];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) o[p][j] = 0.f;
#pragma unroll
    for (int ci = 0; ci < C1; ++ci) {
      const float4* w4 = reinterpret_cast<const float4*>(WY + ci * CY + j0);
      const float4 a = w4[0], e = w4[1];
      const float w[8] = {a.x, a.y, a.z, a.w, e.x, e.y, e.z, e.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) o[p][j] = fmaf(w[j], acc[ci][p], o[p][j]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int gy = 2 * oy + p / 2, gx = 2 * ox + p % 2;
      float4* dst = reinterpret_cast<float4*>(
          y1 + (((size_t)b * H + gy) * W + gx) * CY + j0);
      dst[0] = make_float4(selu(o[p][0]), selu(o[p][1]), selu(o[p][2]), selu(o[p][3]));
      dst[1] = make_float4(selu(o[p][4]), selu(o[p][5]), selu(o[p][6]), selu(o[p][7]));
    }
  }
}

template <int C1, int CY>
cudaError_t launch(const float* img, const float* w1, const float* bn,
                   const float* w2, const float* wy, float* y1, float* xp,
                   int B, int H, int W, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<C1, CY>();
  cudaError_t err = cudaFuncSetAttribute(
      aliked_stem_kernel<C1, CY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(W, T), cdiv(H, T), B);
  aliked_stem_kernel<C1, CY><<<grid, NT, smem, stream>>>(img, w1, bn, w2, wy,
                                                         y1, xp, H, W);
  return cudaGetLastError();
}

}  // namespace

// img (B, 3, H, W); w1 (27, C1) as [ci dy dx][co]; bn (4, C1) = folded scale and bias of
// bn1, then of bn2; w2 (C1, 9, C1) as [ci][tap][co]; wy (C1, CY) as
// [ci][co]; y1 (B, H, W, CY); xp (B, C1, H/2, W/2). H, W even; (C1, CY)
// (8, 16) or (16, 32).
extern "C" cudaError_t lg_aliked_stem(const float* img, const float* w1,
                                      const float* bn, const float* w2,
                                      const float* wy, float* y1, float* xp,
                                      int B, int H, int W, int C1, int CY,
                                      cudaStream_t stream) {
  if (C1 == 16 && CY == 32)
    return launch<16, 32>(img, w1, bn, w2, wy, y1, xp, B, H, W, stream);
  if (C1 == 8 && CY == 16)
    return launch<8, 16>(img, w1, bn, w2, wy, y1, xp, B, H, W, stream);
  return cudaErrorInvalidValue;
}
