// K3: the transformer blocks' FFN with its residual, fp32.
//
// Replaces the TPU kernel lightglue_tpu/ops/ffn.py::_ffn_kernel:
//   out = x + W2^T GELU(LN(x W1[:D] + m W1[D:] + b1)) + b2
// for rows of x and the message m (both (rows, D)), W1 (2D, 2D) and W2
// (2D, D) stored (in, out), LayerNorm eps 1e-5 and the exact erf GELU. The
// concat [x, m] is algebraic: the two halves fill one shared-memory row.
//
// What bounds it on an H100: arithmetic. Per row the two products are
// 2 (2D 2D + 2D D) = 0.79 MFLOP at D = 256 against 3 KB of row traffic; the
// 1.5 MB of weights are read from L2 once per block.
//
// Design: one block takes 32 rows. The 2D-wide input rows and the fp32
// hidden rows (32 x 512 x 4 B = 64 KB each) stay in shared memory, over the
// 48 KB static limit, so the buffer is dynamic and the launcher raises the
// kernel's limit to the 160 KB it carves. The body, lg::ffn_rows in
// ffn.cuh, is shared with the whole-block kernels B5 and B6: each warp
// owns 4 rows and each lane 2D/32 columns of them, so the LayerNorm
// statistics are warp sums, and weights stream through shared memory 16
// input rows at a time. The erf is the library's erff; the TPU kernel's
// polynomial erf exists only because its compiler has none.
#include "ffn.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(lg::THREADS)
    ffn_residual_kernel(const float* __restrict__ x,
                        const float* __restrict__ msg,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2, float* __restrict__ out,
                        int rows) {
  constexpr int D2 = 2 * D;
  extern __shared__ __align__(16) float lg_smem[];
  float* Xs = lg_smem;                 // 32 x D2: [x | m]
  float* Hs = Xs + lg::FFN_ROWS * D2;  // 32 x D2: hidden
  float* Ws = Hs + lg::FFN_ROWS * D2;  // 16 x D2: staged weight rows
  const int row0 = blockIdx.x * lg::FFN_ROWS;
  for (int idx = threadIdx.x; idx < lg::FFN_ROWS * D2; idx += lg::THREADS) {
    const int rr = idx / D2, c = idx % D2, row = row0 + rr;
    float val = 0.f;
    if (row < rows)
      val = c < D ? x[(size_t)row * D + c] : msg[(size_t)row * D + c - D];
    Xs[idx] = val;
  }
  lg::ffn_rows<D>(Xs, Hs, Ws, w1, b1, gamma, beta, w2, b2, out, row0, rows);
}

template <int D>
cudaError_t launch(const float* x, const float* msg, const float* w1,
                   const float* b1, const float* gamma, const float* beta,
                   const float* w2, const float* b2, float* out, int rows,
                   cudaStream_t stream) {
  const size_t smem = lg::ffn_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_residual_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lg::cdiv(rows, lg::FFN_ROWS));
  ffn_residual_kernel<D><<<grid, lg::THREADS, smem, stream>>>(x, msg, w1, b1, gamma, beta, w2, b2, out, rows);
  return cudaGetLastError();
}

}  // namespace

// x, msg, out: (rows, D); w1 (2D, 2D), w2 (2D, D) stored (in, out);
// b1, gamma, beta (2D); b2 (D). D is 128 or 256.
extern "C" cudaError_t lg_ffn_residual(const float* x, const float* msg,
                                       const float* w1, const float* b1,
                                       const float* gamma, const float* beta,
                                       const float* w2, const float* b2,
                                       float* out, int rows, int D,
                                       cudaStream_t stream) {
  if (D == 256)
    return launch<256>(x, msg, w1, b1, gamma, beta, w2, b2, out, rows, stream);
  if (D == 128)
    return launch<128>(x, msg, w1, b1, gamma, beta, w2, b2, out, rows, stream);
  return cudaErrorInvalidValue;
}
