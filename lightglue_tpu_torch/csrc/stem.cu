// B7: SuperPoint's stem, conv3x3 1 -> 64 + ReLU, conv3x3 64 -> 64 + ReLU,
// 2x2 max-pool, in one pass, fp32.
//
// Replaces the TPU kernel lightglue_tpu/ops/stem.py::_stem_kernel
// (fused_stem_pallas): (B, 1, H, W) image -> (B, 64, H/2, W/2), NCHW here.
// conv1a zero-pads the image; conv1b zero-pads conv1a's output, so conv1a
// values outside the image are 0, not conv1a of a padded image.
//
// What bounds it on an H100: arithmetic. conv1b is 58 GFLOP per 768 x 1024
// image against 3 MB of image in and 50 MB of pooled map out, and the
// plain chain also writes and reads two full-resolution 64-channel maps
// (201 MB each per image in fp32). At the 67 TFLOP/s fp32 CUDA-core peak
// the floor is 0.88 ms per image.
//
// Design: one block per (image, 16 x 16 conv-output tile). conv1a is cheap
// (9 MACs per value), so the block recomputes it on the tile plus a 1-pixel
// ring, 16 channels at a time, from a 20 x 20 image tile in shared memory,
// and never writes it out. conv1b then accumulates those 16 channels into
// registers with its weights streamed 8 input channels at a time
// (conv3x3.cuh): conv1b's 147 KB of weights and a 64-channel conv1a tile
// would not both fit in a block's shared memory. Bias, ReLU and the 2x2
// max-pool happen in registers before the one write.
#include "conv3x3.cuh"

namespace {

using namespace sp;

constexpr int IT = TS + 4;  // image tile edge: conv1a's ring and conv1b's

__global__ void __launch_bounds__(NT, 2)
    fused_stem_kernel(const float* __restrict__ img,
                      const float* __restrict__ w1a,  // (64, 9)
                      const float* __restrict__ b1a,  // (64,)
                      const float* __restrict__ w1b,  // (64 ci, 9, 64 co)
                      const float* __restrict__ b1b,  // (64,)
                      float* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) float st_smem[];
  float* A = st_smem;            // [QC][AR][AS] conv1a tile
  float* Wc = A + A_FLOATS;      // conv1b weight chunk
  float* I = Wc + WC_FLOATS;     // [IT][IT] image tile
  float* W1 = I + IT * IT;       // [64][9]
  float* B1 = W1 + C * 9;        // [64]

  const int t = threadIdx.x, b = blockIdx.z;
  const int y0 = blockIdx.y * TS, x0 = blockIdx.x * TS;
  const float* im = img + (size_t)b * H * W;
  for (int i = t; i < IT * IT; i += NT) {
    const int gy = y0 - 2 + i / IT, gx = x0 - 2 + i % IT;
    I[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? im[(size_t)gy * W + gx] : 0.f;
  }
  for (int i = t; i < C * 9; i += NT) W1[i] = w1a[i];
  if (t < C) B1[t] = b1a[t];

  float acc[16][4];
#pragma unroll
  for (int k = 0; k < 16; ++k)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[k][p] = 0.f;

  for (int q0 = 0; q0 < C; q0 += QC) {
    // conv1a channels q0 .. q0 + 15 at conv-input positions
    // (y0 - 1 + ry, x0 - 1 + rx); the barrier also ends the previous
    // stage's reads of A
    __syncthreads();
    for (int i = t; i < QC * AR * AR; i += NT) {
      const int c = i / (AR * AR), p = i % (AR * AR);
      const int ry = p / AR, rx = p % AR;
      const int gy = y0 - 1 + ry, gx = x0 - 1 + rx;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float* wk = W1 + (q0 + c) * 9;
        float s = 0.f;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          s = fmaf(wk[tap], I[(ry + tap / 3) * IT + rx + tap % 3], s);
        v = fmaxf(s + B1[q0 + c], 0.f);
      }
      A[(c * AR + ry) * AS + rx] = v;
    }
    conv_accumulate<QC, AR, KC, 8>(A, w1b, q0, Wc, acc);
  }
  bias_relu_pool_store<8>(acc, b1b, out + (size_t)b * C * (H / 2) * (W / 2),
                       H / 2, W / 2, y0 / 2, x0 / 2);
}

}  // namespace

// img (B, 1, H, W); w1a (64, 9); b1a, b1b (64); w1b (64, 9, 64) as
// [ci][tap][co]; out (B, 64, H/2, W/2). H, W even.
extern "C" cudaError_t lg_fused_stem(const float* img, const float* w1a,
                                     const float* b1a, const float* w1b,
                                     const float* b1b, float* out, int B,
                                     int H, int W, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (sp::A_FLOATS + sp::WC_FLOATS + IT * IT +
                                       sp::C * 9 + sp::C);
  cudaError_t err = cudaFuncSetAttribute(
      fused_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(sp::cdiv(W, sp::TS), sp::cdiv(H, sp::TS), B);
  fused_stem_kernel<<<grid, sp::NT, smem, stream>>>(img, w1a, b1a, w1b, b1b, out,
                                                H, W);
  return cudaGetLastError();
}
