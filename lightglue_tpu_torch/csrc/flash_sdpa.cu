// K1: masked scaled dot-product attention, fp32, exact or constant-shift.
//
// Replaces the TPU kernels lightglue_tpu/ops/flash.py::_attn_kernel_4d (the
// exact variant of flash_sdpa): o = softmax(q k^T / sqrt(64) + key bias) v,
// with an fp32 softmax and rows whose keys are all masked set to 0; and
// ::_attn_kernel_shift (the constant-shift variant, B1s): with scale *
// log2(e) folded into q, o = sum_j e_j v_j / max(sum_j e_j, 1e-30) with
// e_j = exp2(min(s_j - shift * log2(e), 100)), no row max, and an
// all-masked row 0 because every e_j is.
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
// when none is, as the TPU kernel does. The shift variant is the same walk
// without the max and the rescale: a template flag of the one kernel. The
// ragged last key tile is masked with -inf, so any N >= 1 is taken. Tensor
// cores (wgmma) are later work.
#include "common.cuh"

namespace {

template <bool SHIFT>
__global__ void __launch_bounds__(lg::THREADS)
    flash_sdpa_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ kbias, float* __restrict__ o,
                      int H, int Nq, int Nk, float scale, float shift2) {
  lg::row_softmax_attention<SHIFT>(q, k, v, kbias, nullptr, o, nullptr, H, Nq,
                                   Nk, scale, /*zero_empty=*/true, shift2);
}

template <bool SHIFT>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* kbias, float* o, int B, int H, int Nq, int Nk,
                   float scale, float shift2, cudaStream_t stream) {
  const size_t smem = lg::kRowAttnSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_sdpa_kernel<SHIFT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lg::cdiv(Nq, lg::TILE), H, B);
  flash_sdpa_kernel<SHIFT><<<grid, lg::THREADS, smem, stream>>>(q, k, v, kbias, o, H, Nq, Nk, scale, shift2);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, H, Nq, 64); k, v: (B, H, Nk, 64); kbias: (B, Nk) or null.
// scale multiplies q (1/8 exact; 1/8 * log2(e) with a shift); shift2 =
// shift * log2(e).
extern "C" cudaError_t lg_flash_sdpa(const float* q, const float* k,
                                     const float* v, const float* kbias,
                                     float* o, int B, int H, int Nq, int Nk,
                                     int shift, float scale, float shift2,
                                     cudaStream_t stream) {
  return shift ? launch<true>(q, k, v, kbias, o, B, H, Nq, Nk, scale, shift2,
                              stream)
               : launch<false>(q, k, v, kbias, o, B, H, Nq, Nk, scale, shift2,
                               stream);
}
