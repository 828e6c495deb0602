// K1: masked scaled dot-product attention, fp32, exact or constant-shift,
// head_dim 64 or 128; and B1', both directions of the shared-QK cross
// attention at head_dim 64 or 128 in one launch.
//
// K1 replaces the TPU kernels lightglue_tpu/ops/flash.py::_attn_kernel_4d
// (the exact variant of flash_sdpa): o = softmax(q k^T / sqrt(d) + key
// bias) v, with an fp32 softmax and rows whose keys are all masked set to 0;
// and ::_attn_kernel_shift (the constant-shift variant, B1s): with scale *
// log2(e) folded into q, o = sum_j e_j v_j / max(sum_j e_j, 1e-30) with
// e_j = exp2(min(s_j - shift * log2(e), 100)), no row max, and an
// all-masked row 0 because every e_j is.
//
// B1' replaces lightglue_tpu/ops/flash.py::flash_cross_pair, which runs the
// exact flash_sdpa pallas_call twice with the roles swapped:
//   m0 = attn(qk0, qk1, v1, valid1),  m1 = attn(qk1, qk0, v0, valid0).
// The JAX matcher takes it for the cross blocks at head_dim 128, where the
// ones column of B3's and B6's augmented V does not fit. Here it is one
// launch over both directions (grid z = 2 B, the low bit the direction):
// at head_dim 128 a matcher has two heads, so one direction at B 1 and
// N 1024 is 16 x 2 = 32 blocks for 132 SMs; one launch doubles that and
// halves the launches. Rows of masked queries are not zeroed, as in the
// TPU pair.
//
// What bounds them on an H100: arithmetic. At the main path's shape
// (B 4, H 4, N 1024, head_dim 64, or H 2 at 128) the two tile products are
// 4.3 GFLOP for 17 MB of q, k, v and o, about 250 flop per byte, far above
// the ~20 flop per byte where fp32 CUDA-core work (67 TFLOP/s) stops
// waiting on HBM.
//
// Design: the TPU kernel keeps a whole (256, N) fp32 score strip in VMEM;
// at N = 1024 a 64-row strip alone is 256 KB, over the 227 KB a block can
// have. So one block takes one (batch, head, 64-query tile) and walks the
// keys in 64-row tiles with an online softmax (running max and sum), the
// output accumulator in registers (16 floats a thread at head_dim 64, 32 at
// 128). At 128 each score tile is two 64-deep products in order, and the
// value tile overwrites the key tile once the scores are taken
// (common.cuh::AttnShape). K and V tiles are re-read from L2 by each query
// tile. An online softmax over all-masked keys returns mean(v), so the block
// tracks whether any key is valid and writes 0 when none is, as the TPU
// kernel does. The shift variant is the same walk without the max and the
// rescale: a template flag of the one kernel. The ragged last key tile is
// masked with -inf, so any N >= 1 is taken. Tensor cores (wgmma) are later
// work.
#include "common.cuh"

namespace {

template <bool SHIFT, int D>
__global__ void __launch_bounds__(lg::THREADS)
    flash_sdpa_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ kbias, float* __restrict__ o,
                      int H, int Nq, int Nk, float scale, float shift2) {
  lg::row_softmax_attention<SHIFT, D>(q, k, v, kbias, nullptr, o, nullptr, H,
                                      Nq, Nk, scale, /*zero_empty=*/true,
                                      shift2);
}

// Grid (cdiv(max(M, N), 64), H, 2 B); z = 2 b + direction. A block whose
// tile lies past its direction's query count returns at once.
template <int D>
__global__ void __launch_bounds__(lg::THREADS)
    flash_cross_pair_kernel(const float* __restrict__ qk0,
                            const float* __restrict__ qk1,
                            const float* __restrict__ v0,
                            const float* __restrict__ v1,
                            const float* __restrict__ bias0,
                            const float* __restrict__ bias1,
                            float* __restrict__ m0, float* __restrict__ m1,
                            int H, int M, int N, float scale) {
  const int b = blockIdx.z >> 1;
  const bool dir1 = blockIdx.z & 1;  // messages into image 1
  const int nq = dir1 ? N : M, nk = dir1 ? M : N;
  if ((int)blockIdx.x * lg::TILE >= nq) return;
  lg::attend_tile<false, D>(dir1 ? qk1 : qk0, dir1 ? qk0 : qk1,
                            dir1 ? v0 : v1, dir1 ? bias0 : bias1, nullptr,
                            dir1 ? m1 : m0, nullptr, H, nq, nk, scale,
                            /*zero_empty=*/true, 0.f, b, blockIdx.y,
                            blockIdx.x, 0);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool SHIFT, int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* kbias, float* o, int B, int H, int Nq, int Nk,
                   float scale, float shift2, cudaStream_t stream) {
  constexpr size_t smem = lg::row_attn_smem<D>();
  cudaError_t err = allow_smem(flash_sdpa_kernel<SHIFT, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lg::cdiv(Nq, lg::TILE), H, B);
  flash_sdpa_kernel<SHIFT, D><<<grid, lg::THREADS, smem, stream>>>(q, k, v, kbias, o, H, Nq, Nk, scale, shift2);
  return cudaGetLastError();
}

template <bool SHIFT>
cudaError_t launch_d(int d, const float* q, const float* k, const float* v,
                     const float* kbias, float* o, int B, int H, int Nq,
                     int Nk, float scale, float shift2, cudaStream_t stream) {
  if (d == 64)
    return launch<SHIFT, 64>(q, k, v, kbias, o, B, H, Nq, Nk, scale, shift2,
                             stream);
  if (d == 128)
    return launch<SHIFT, 128>(q, k, v, kbias, o, B, H, Nq, Nk, scale, shift2,
                              stream);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_pair(const float* qk0, const float* qk1, const float* v0,
                        const float* v1, const float* bias0,
                        const float* bias1, float* m0, float* m1, int B,
                        int H, int M, int N, float scale,
                        cudaStream_t stream) {
  constexpr size_t smem = lg::row_attn_smem<D>();
  cudaError_t err = allow_smem(flash_cross_pair_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lg::cdiv(M > N ? M : N, lg::TILE), H, 2 * B);
  flash_cross_pair_kernel<D><<<grid, lg::THREADS, smem, stream>>>(qk0, qk1, v0, v1, bias0, bias1, m0, m1, H, M, N, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, H, Nq, d); k, v: (B, H, Nk, d); kbias: (B, Nk) or null;
// d 64 or 128. scale multiplies q (1/sqrt(d) exact; times log2(e) with a
// shift); shift2 = shift * log2(e).
extern "C" cudaError_t lg_flash_sdpa(const float* q, const float* k,
                                     const float* v, const float* kbias,
                                     float* o, int B, int H, int Nq, int Nk,
                                     int d, int shift, float scale,
                                     float shift2, cudaStream_t stream) {
  return shift ? launch_d<true>(d, q, k, v, kbias, o, B, H, Nq, Nk, scale,
                                shift2, stream)
               : launch_d<false>(d, q, k, v, kbias, o, B, H, Nq, Nk, scale,
                                 shift2, stream);
}

// qk0, v0, m0: (B, H, M, d); qk1, v1, m1: (B, H, N, d); bias0 (B, M),
// bias1 (B, N), each or null; d 64 or 128; scale multiplies the queries of
// both directions (1/sqrt(d)).
extern "C" cudaError_t lg_flash_cross_pair(
    const float* qk0, const float* qk1, const float* v0, const float* v1,
    const float* bias0, const float* bias1, float* m0, float* m1, int B,
    int H, int M, int N, int d, float scale, cudaStream_t stream) {
  if (d == 64)
    return launch_pair<64>(qk0, qk1, v0, v1, bias0, bias1, m0, m1, B, H, M,
                           N, scale, stream);
  if (d == 128)
    return launch_pair<128>(qk0, qk1, v0, v1, bias0, bias1, m0, m1, B, H, M,
                            N, scale, stream);
  return cudaErrorInvalidValue;
}
