// B8: SuperPoint's block 2, conv3x3 64 -> 64 + ReLU twice, then a 2x2
// max-pool, at half resolution, fp32 by 3xTF32 on the tensor cores, and its
// bf16 form (mp: bf16 m16n8k16 tiles).
//
// Replaces the TPU kernel lightglue_tpu/ops/stem2.py::_block2_kernel
// (fused_block2_pallas): (B, 64, H2, W2) -> (B, 64, H2/2, W2/2), NCHW, fed
// by the stem's output as it is. conv2a zero-pads its input and conv2b
// zero-pads conv2a's output, so conv2a values outside the H2 x W2 extent
// are 0.
//
// What bounds it on an H100: arithmetic, 29.0 GFLOP per 768 x 1024 image.
// In 3xTF32 at the 495 TFLOP/s dense TF32 peak the floor is 0.176 ms an
// image (0.351 at B 2); on the CUDA cores (67 TFLOP/s fp32) 0.43.
//
// Design: two launches of conv_tc.cuh's implicit GEMM with the map source,
// where the TPU used a single program: conv2a with bias + ReLU into a
// (B, 64, H2, W2) scratch that the wrapper allocates, then conv2b with the
// pooling epilogue. The scratch costs 2 x 50 MB of HBM traffic a 768 x 1024
// image (about 0.03 ms); in exchange neither launch recomputes conv2a's
// ring or leaves window slots idle, as the one-pass SIMT form did (a
// quarter of its arithmetic).
//
// The bf16 form (lg_conv3x3_bf16, the TPU kernel at mp=True): bf16 input
// (B7's bf16 output), bf16 scratch and output, each fp32 sum rounded to
// bf16 before its fp32 bias, as _block2_kernel rounds. Bound on an H100:
// 29.0 GFLOP an image at 989 TFLOP/s, 0.029 ms an image (0.059 at B 2);
// the bytes (25 MB in, 6 MB out, 2 x 25 MB of scratch) 0.024.
#include "conv_tc.cuh"

// x (B, 64, H, W); w prepare_conv's (9, 64, 128); bias (64); out (B, 64,
// H, W), or (B, 64, H/2, W/2) when pool (H, W even): relu(conv3x3(x) +
// bias), max-pooled 2x2 when pool.
extern "C" cudaError_t lg_conv3x3(const float* x, const float* w,
                                  const float* bias, float* out, int B, int H,
                                  int W, int pool, cudaStream_t stream) {
  using lg::conv::MapTile;
  return pool ? lg::conv::launch<MapTile, float, false, true>(
                    x, nullptr, nullptr, w, bias, out, B, H, W, stream)
              : lg::conv::launch<MapTile, float, false, false>(
                    x, nullptr, nullptr, w, bias, out, B, H, W, stream);
}

// The bf16 form: x (B, 64, H, W) bf16, w prepare_conv's bf16 layout (9, 64,
// 64), bias (64) fp32, out bf16 as above.
extern "C" cudaError_t lg_conv3x3_bf16(const lg::tc::bf16* x,
                                       const lg::tc::bf16* w,
                                       const float* bias, lg::tc::bf16* out,
                                       int B, int H, int W, int pool,
                                       cudaStream_t stream) {
  using lg::conv::MapTile;
  using lg::tc::bf16;
  return pool ? lg::conv::launch<MapTile, bf16, false, true>(
                    x, nullptr, nullptr, w, bias, out, B, H, W, stream)
              : lg::conv::launch<MapTile, bf16, false, false>(
                    x, nullptr, nullptr, w, bias, out, B, H, W, stream);
}
