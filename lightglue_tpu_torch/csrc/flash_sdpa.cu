// K1: masked scaled dot-product attention, fp32.
//
// Replaces the TPU kernel lightglue_tpu/ops/flash.py::_attn_kernel_4d (the
// exact variant of flash_sdpa): o = softmax(q k^T / sqrt(64) + key bias) v,
// with an fp32 softmax and rows whose keys are all masked set to 0.
//
// What bounds it on an H100: arithmetic. At the main path's shape
// (B 4, H 4, N 1024, head_dim 64) the two tile products are 4.3 GFLOP for
// 17 MB of q, k, v and o, about 250 flop per byte, far above the ~20 flop
// per byte where fp32 CUDA-core work (67 TFLOP/s) stops waiting on HBM.
//
// Design: the TPU kernel keeps a whole (256, N) fp32 score strip in VMEM;
// at N = 1024 a 64-row strip alone is 256 KB, over the 227 KB a block can
// have. So one block takes one (batch, head, 64-query tile) and walks the
// keys in 64-row tiles with an online softmax (running max and sum), the
// output accumulator in registers (16 floats a thread). K and V tiles are
// re-read from L2 by each query tile. An online softmax over all-masked keys
// returns mean(v), so the block tracks whether any key is valid and writes 0
// when none is, as the TPU kernel does. The ragged last key tile is masked
// with -inf, so any N >= 1 is taken. Tensor cores (wgmma) are later work.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(lg::THREADS)
    flash_sdpa_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ kbias, float* __restrict__ o,
                      int H, int Nq, int Nk, float scale) {
  lg::row_softmax_attention(q, k, v, kbias, o, nullptr, H, Nq, Nk, scale,
                            /*zero_empty=*/true);
}

}  // namespace

// q, o: (B, H, Nq, 64); k, v: (B, H, Nk, 64); kbias: (B, Nk) or null.
extern "C" cudaError_t lg_flash_sdpa(const float* q, const float* k,
                                     const float* v, const float* kbias,
                                     float* o, int B, int H, int Nq, int Nk,
                                     cudaStream_t stream) {
  const size_t smem = lg::kRowAttnSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_sdpa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lg::cdiv(Nq, lg::TILE), H, B);
  const float scale = 1.0f / sqrtf((float)lg::HD);
  flash_sdpa_kernel<<<grid, lg::THREADS, smem, stream>>>(q, k, v, kbias, o, H, Nq, Nk, scale);
  return cudaGetLastError();
}
