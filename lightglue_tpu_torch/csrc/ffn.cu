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
// kernel's limit to the 160 KB it carves. Each warp owns 4 rows and each
// lane 2D/32 columns of them, so the LayerNorm statistics are warp sums.
// Weights stream through shared memory 16 input rows at a time. The erf is
// the library's erff; the TPU kernel's polynomial erf exists only because
// its compiler has none.
#include "common.cuh"

namespace {

constexpr int ROWS = 32;  // rows of x per block: 8 warps x 4 rows
constexpr int KC = 16;    // weight rows staged per step

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

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
  constexpr int C1 = D2 / 32;  // hidden columns per lane
  constexpr int C2 = D / 32;   // output columns per lane
  extern __shared__ __align__(16) float lg_smem[];
  float* Xs = lg_smem;         // ROWS x D2: [x | m]
  float* Hs = Xs + ROWS * D2;  // ROWS x D2: hidden
  float* Ws = Hs + ROWS * D2;  // KC x D2: staged weight rows

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int row0 = blockIdx.x * ROWS;

  for (int idx = t; idx < ROWS * D2; idx += lg::THREADS) {
    const int rr = idx / D2, c = idx % D2, row = row0 + rr;
    float val = 0.f;
    if (row < rows)
      val = c < D ? x[(size_t)row * D + c] : msg[(size_t)row * D + c - D];
    Xs[idx] = val;
  }

  float acc[4][C1] = {};
  for (int k0 = 0; k0 < D2; k0 += KC) {
    __syncthreads();
    for (int idx = t; idx < KC * D2; idx += lg::THREADS)
      Ws[idx] = w1[(size_t)k0 * D2 + idx];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[(warp * 4 + i) * D2 + k0 + kk];
#pragma unroll
      for (int j = 0; j < C1; ++j) {
        const float w = Ws[kk * D2 + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < C1; ++j) {
      acc[i][j] += b1[lane + 32 * j];
      s += acc[i][j];
    }
    const float mean = warp_sum(s) / D2;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < C1; ++j) {
      const float c = acc[i][j] - mean;
      sq += c * c;
    }
    const float inv = 1.0f / sqrtf(warp_sum(sq) / D2 + 1e-5f);
#pragma unroll
    for (int j = 0; j < C1; ++j) {
      const int c = lane + 32 * j;
      const float hn = (acc[i][j] - mean) * inv * gamma[c] + beta[c];
      Hs[(warp * 4 + i) * D2 + c] =
          0.5f * hn * (1.0f + erff(hn * 0.7071067811865476f));
    }
  }

  float acc2[4][C2] = {};
  for (int k0 = 0; k0 < D2; k0 += KC) {
    __syncthreads();  // Hs complete; previous Ws readers done
    for (int idx = t; idx < KC * D; idx += lg::THREADS)
      Ws[idx] = w2[(size_t)k0 * D + idx];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Hs[(warp * 4 + i) * D2 + k0 + kk];
#pragma unroll
      for (int j = 0; j < C2; ++j) {
        const float w = Ws[kk * D + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc2[i][j] = fmaf(a[i], w, acc2[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + warp * 4 + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < C2; ++j) {
      const int c = lane + 32 * j;
      out[(size_t)row * D + c] = x[(size_t)row * D + c] + (acc2[i][j] + b2[c]);
    }
  }
}

template <int D>
cudaError_t launch(const float* x, const float* msg, const float* w1,
                   const float* b1, const float* gamma, const float* beta,
                   const float* w2, const float* b2, float* out, int rows,
                   cudaStream_t stream) {
  const size_t smem = (2 * ROWS * 2 * D + KC * 2 * D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_residual_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lg::cdiv(rows, ROWS));
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
