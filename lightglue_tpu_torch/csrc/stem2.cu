// B8: SuperPoint's block 2, conv3x3 64 -> 64 + ReLU twice, then a 2x2
// max-pool, in one pass at half resolution, fp32.
//
// Replaces the TPU kernel lightglue_tpu/ops/stem2.py::_block2_kernel
// (fused_block2_pallas): (B, 64, H2, W2) -> (B, 64, H2/2, W2/2), NCHW, fed
// directly by the stem kernel's output. conv2a zero-pads its input and
// conv2b zero-pads conv2a's output, so conv2a values outside the H2 x W2
// extent are 0.
//
// What bounds it on an H100: arithmetic, 29 GFLOP per 768 x 1024 image
// (floor 0.43 ms at 67 TFLOP/s fp32), where the plain chain also writes and
// reads two (64, H2, W2) maps.
//
// Design: one block per (image, 14 x 14 conv2b-output tile). conv2b needs
// conv2a on the tile plus a 1-pixel ring, 16 x 16: exactly the 8 x 8 windows
// x 4 channel groups that the 256 threads of conv3x3.cuh cover, so conv2a
// runs with the same register-blocked loop as the stem's conv1b, over its
// 64 input channels in four stages of a 16-channel 18 x 18 input tile. Its
// 64 output channels (bias, ReLU, 0 outside the extent) then stay in shared
// memory, 96 KB, over the input tile's space, and conv2b reads them with the
// same loop on 7 x 7 windows (49 of the 64 window slots busy). Both convs'
// weights (295 KB) stream through shared memory 4 input channels at a time,
// so a block needs 105 KB and two fit on an SM; only one conv's
// accumulators are live at a time. The 1.31x recompute of the ring and the
// idle window slots cost about a quarter of the arithmetic. Bias, ReLU and
// the 2x2 max-pool happen in registers before the one write.
#include "conv3x3.cuh"

namespace {

using namespace sp;

constexpr int TO = 14;                      // conv2b output tile edge
constexpr int R2 = TO + 2;                  // conv2a tile edge (= TS)
constexpr int KC2 = 4;                      // input channels per weight chunk
constexpr int A2_FLOATS = C * R2 * AS;      // conv2a tile [64][R2][AS]
constexpr int WC2_FLOATS = KC2 * WROW;
static_assert(R2 == TS, "conv2a covers the 8 x 8 windows of conv3x3.cuh");
static_assert(A_FLOATS <= A2_FLOATS, "the input tile lives in the conv2a tile");

__global__ void __launch_bounds__(NT, 2)
    fused_block2_kernel(const float* __restrict__ x,
                        const float* __restrict__ w2a,  // (64 ci, 9, 64 co)
                        const float* __restrict__ b2a,
                        const float* __restrict__ w2b,  // (64 ci, 9, 64 co)
                        const float* __restrict__ b2b,
                        float* __restrict__ out, int H2, int W2) {
  extern __shared__ __align__(16) float b2_smem[];
  float* A2 = b2_smem;            // conv2a outputs, [64][R2][AS]
  float* Ain = b2_smem;           // conv2a's input stage, [QC][AR][AS]
  float* Wc = b2_smem + A2_FLOATS;

  const int t = threadIdx.x, b = blockIdx.z;
  const int y0 = blockIdx.y * TO, x0 = blockIdx.x * TO;
  const float* xb = x + (size_t)b * C * H2 * W2;

  float acc[16][4];
#pragma unroll
  for (int k = 0; k < 16; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

  // conv2a at positions (y0 - 1 + r, x0 - 1 + c), r, c < 16, from the input
  // at (y0 - 2 + r, x0 - 2 + c), r, c < 18
  for (int q0 = 0; q0 < C; q0 += QC) {
    __syncthreads();  // the previous stage's reads of Ain are done
    for (int i = t; i < QC * AR * AR; i += NT) {
      const int c = i / (AR * AR), p = i % (AR * AR);
      const int r = p / AR, col = p % AR;
      const int gy = y0 - 2 + r, gx = x0 - 2 + col;
      Ain[(c * AR + r) * AS + col] =
          (gy >= 0 && gy < H2 && gx >= 0 && gx < W2)
              ? xb[((size_t)(q0 + c) * H2 + gy) * W2 + gx]
              : 0.f;
    }
    conv_accumulate<QC, AR, KC2, 8>(Ain, w2a, q0, Wc, acc);
  }
  __syncthreads();  // every read of Ain is done before A2 overwrites it
  {
    const int co0 = (t >> 6) * 16, wr = (t & 63) >> 3, wc = t & 7;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float bias = b2a[co0 + k];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int r = 2 * wr + p / 2, c = 2 * wc + p % 2;
        const int gy = y0 - 1 + r, gx = x0 - 1 + c;
        const bool in = gy >= 0 && gy < H2 && gx >= 0 && gx < W2;
        A2[((co0 + k) * R2 + r) * AS + c] = in ? fmaxf(acc[k][p] + bias, 0.f) : 0.f;
        acc[k][p] = 0.f;
      }
    }
  }
  conv_accumulate<C, R2, KC2, TO / 2>(A2, w2b, 0, Wc, acc);
  bias_relu_pool_store<TO / 2>(acc, b2b,
                               out + (size_t)b * C * (H2 / 2) * (W2 / 2),
                               H2 / 2, W2 / 2, y0 / 2, x0 / 2);
}

}  // namespace

// x (B, 64, H2, W2); w2a, w2b (64, 9, 64) as [ci][tap][co]; b2a, b2b (64);
// out (B, 64, H2/2, W2/2). H2, W2 even.
extern "C" cudaError_t lg_fused_block2(const float* x, const float* w2a,
                                       const float* b2a, const float* w2b,
                                       const float* b2b, float* out, int B,
                                       int H2, int W2, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (A2_FLOATS + WC2_FLOATS);
  cudaError_t err = cudaFuncSetAttribute(
      fused_block2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(sp::cdiv(W2, TO), sp::cdiv(H2, TO), B);
  fused_block2_kernel<<<grid, sp::NT, smem, stream>>>(x, w2a, b2a, w2b, b2b, out,
                                                      H2, W2);
  return cudaGetLastError();
}
