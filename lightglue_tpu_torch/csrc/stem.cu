// B7: SuperPoint's stem, conv3x3 1 -> 64 + ReLU, conv3x3 64 -> 64 + ReLU,
// 2x2 max-pool, in one launch, fp32 (conv1b by 3xTF32 on the tensor cores),
// and its bf16 form (mp: conv1b on bf16 m16n8k16 tiles).
//
// Replaces the TPU kernel lightglue_tpu/ops/stem.py::_stem_kernel
// (fused_stem_pallas): (B, 1, H, W) image -> (B, 64, H/2, W/2), NCHW here.
// conv1a zero-pads the image; conv1b zero-pads conv1a's output, so conv1a
// values outside the image are 0, not conv1a of a padded image.
//
// What bounds it on an H100: arithmetic. conv1a + conv1b are 58.9 GFLOP
// per 768 x 1024 image against 3 MB of image in and 50 MB of pooled map
// out. As fp32-accurate work in 3xTF32 (three tf32 products a product) at
// the 495 TFLOP/s dense TF32 peak, the floor is 0.357 ms an image (0.714
// at B 2); on the CUDA cores (67 TFLOP/s fp32) it is 0.88.
//
// Design: one launch of conv_tc.cuh's implicit GEMM with the image source
// and the pooling epilogue. A block computes conv1a + ReLU for its tile plus
// a 1-pixel ring, all 64 channels, on the CUDA cores straight into the
// staged A tile (conv1a never reaches device memory, as on the TPU), then
// runs conv1b as 3xTF32 mma.sync tiles over 9 taps x 64 channels while the
// split weights stream through a cp.async ring; bias, ReLU and the 2x2
// max-pool happen in registers before the one write.
//
// The bf16 form (lg_fused_stem_bf16, the TPU kernel at mp=True): the same
// launch with conv_tc.cuh's bf16 element type. Bound on an H100: 58.9
// GFLOP an image at the 989 TFLOP/s dense bf16 peak, 0.060 ms an image
// (0.119 at B 2), against 3 MB in and 25 MB of bf16 map out (0.0084 ms).
// It rounds where _stem_kernel rounds: the image read as bf16, conv1a's
// weights bf16, conv1a's fp32 sum rounded to bf16 before its fp32 bias,
// ReLU, bf16 into the staged tile; conv1b's weights bf16, its fp32 sum
// rounded before its bias; the pooled output bf16.
#include "conv_tc.cuh"

// img (B, 1, H, W); w1a (64, 9); b1a, b1b (64); w1b prepare_conv's
// (9, 64, 128); out (B, 64, H/2, W/2). H, W even.
extern "C" cudaError_t lg_fused_stem(const float* img, const float* w1a,
                                     const float* b1a, const float* w1b,
                                     const float* b1b, float* out, int B,
                                     int H, int W, cudaStream_t stream) {
  return lg::conv::launch<lg::conv::StemTile, float, true, true>(
      img, w1a, b1a, w1b, b1b, out, B, H, W, stream);
}

// The bf16 form: img, w1a, b1a, b1b fp32 as above; w1b prepare_conv's bf16
// layout (9, 64, 64); out (B, 64, H/2, W/2) bf16.
extern "C" cudaError_t lg_fused_stem_bf16(const float* img, const float* w1a,
                                          const float* b1a,
                                          const lg::tc::bf16* w1b,
                                          const float* b1b, lg::tc::bf16* out,
                                          int B, int H, int W,
                                          cudaStream_t stream) {
  return lg::conv::launch<lg::conv::StemTile, lg::tc::bf16, true, true>(
      img, w1a, b1a, w1b, b1b, out, B, H, W, stream);
}
