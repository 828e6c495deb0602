// B12 and B11: ALIKED's score-head tail, fp32,
//   score = sigmoid(conv3x3 4->1(SELU(conv3x3 4->4(SELU(conv3x3 8->4(
//           SELU(s0)))))))
// on the 8-channel pre-activation s0 of the head's 1x1 stage. Every conv
// zero-pads its own input, so each stage is 0 outside the image.
//
// B12 (lg_score_head) replaces lightglue_tpu/ops/score_head.py::
// _score_head_kernel (score_head_pallas_cplane): s0 (B, 8, H, W) is given.
// B11 (lg_score_head_lazy) replaces _score_lazy_kernel
// (score_head_pallas_lazy): s0 is built in the kernel as
//   s0 = s1 + up(s2) + up(s3) + up(s4)
// from the branch partials at their own sizes (s1 (B, 8, H, W), sk
// (B, 8, hk, wk)), up() the align-corners bilinear upsampling to H x W,
// whose two-point weights (models/aliked.py::_lerp_matrix) are computed per
// tile row and column in double, as numpy computes them, with no lerp
// matrices. A branch dimension of 1 takes its single row (y0 = y1 = 0,
// weight 0); the TPU kernel's clamp to hk - 2 is not reproduced.
//
// What bounds it on an H100: arithmetic, narrowly. B12 does 468
// multiply-adds per pixel (0.022 ms for two 768 x 1024 maps at 67 TFLOP/s)
// against 32 B read and 4 B written (0.017 ms at 3.35 TB/s); B11 adds the
// three lerps (0.026 ms) and reads the partials once, 44.5 B per pixel
// (0.021 ms).
//
// Design: one block of 256 threads per 32 x 32 output tile. SELU(s0) fills
// an 8 x 38 x 38 shared tile (3-pixel ring), stage 1 a 4 x 36 x 36 tile,
// stage 2 a 4 x 34 x 34 tile over stage 0's space, and the sigmoid of stage
// 3 is written; the 468 weights sit in shared memory with the output
// channel innermost, every read of them a broadcast.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int T = 32;          // output tile edge
constexpr int R0 = T + 6;      // SELU(s0) tile edge
constexpr int R1 = T + 4;      // stage-1 tile edge
constexpr int R2 = T + 2;      // stage-2 tile edge
constexpr int NW = 9 * (8 * 4 + 4 * 4 + 4 * 1);  // weights, [ci][tap][co]
constexpr float kAlpha = 1.6732632423543772848170429916717f;
constexpr float kScale = 1.0507009873554804934193349852946f;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float selu(float x) {
  return kScale * (x > 0.f ? x : kAlpha * expm1f(x));
}

// Align-corners lerp of output index g (of n) into a branch axis of size
// nk: the rows y0, y1 and the weight of y1, as _lerp_matrix computes them
// (numpy linspace in double: g times the step, the last index exactly
// nk - 1, and 0 when n is 1).
struct Lerp {
  int i0, i1;
  float w;
};

__device__ __forceinline__ Lerp lerp_of(int g, int n, int nk) {
  const double c = n == 1 ? 0.0
                   : g == n - 1 ? (double)(nk - 1)
                                : g * ((double)(nk - 1) / (double)(n - 1));
  const double f = floor(c);
  Lerp l;
  l.i0 = (int)f;
  l.i1 = min(l.i0 + 1, nk - 1);
  l.w = (float)(c - f);
  return l;
}

struct Branches {
  const float* s[3];  // s2, s3, s4: (B, 8, hk, wk)
  int h[3], w[3];
};

// One conv stage: out[co][r][c] (edge RO) = SELU(sum_ci,tap w[ci][tap][co] *
// in[ci][r + dy][c + dx]) (edge RO + 2) where (oy0 + r, ox0 + c) lies in
// the image, else 0. The four output channels' weights are one broadcast
// float4 load.
template <int CI, int RO>
__device__ __forceinline__ void conv_stage(const float* in, float* out,
                                           const float* w, int oy0, int ox0,
                                           int H, int W) {
  constexpr int RI = RO + 2;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  for (int p = threadIdx.x; p < RO * RO; p += NT) {
    const int r = p / RO, c = p % RO;
    const int gy = oy0 + r, gx = ox0 + c;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ci = 0; ci < CI; ++ci)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float x = in[(ci * RI + r + tap / 3) * RI + c + tap % 3];
        const float4 wv = w4[ci * 9 + tap];
        acc[0] = fmaf(wv.x, x, acc[0]);
        acc[1] = fmaf(wv.y, x, acc[1]);
        acc[2] = fmaf(wv.z, x, acc[2]);
        acc[3] = fmaf(wv.w, x, acc[3]);
      }
#pragma unroll
    for (int co = 0; co < 4; ++co)
      out[(co * RO + r) * RO + c] = inside ? selu(acc[co]) : 0.f;
  }
}

template <bool LAZY>
__global__ void __launch_bounds__(NT)
    score_head_kernel(const float* __restrict__ s0,  // (B, 8, H, W): s0 or s1
                      Branches br, const float* __restrict__ wts,
                      float* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) float sh_smem[];
  float* S0 = sh_smem;             // [8][R0][R0]; stage 2 [4][R2][R2] after
  float* S1 = S0 + 8 * R0 * R0;    // [4][R1][R1]
  float* Wt = S1 + 4 * R1 * R1;    // [NW]
  __shared__ Lerp ly[3][R0], lx[3][R0];

  const int t = threadIdx.x, b = blockIdx.z;
  const int y0 = blockIdx.y * T, x0 = blockIdx.x * T;
  for (int i = t; i < NW; i += NT) Wt[i] = wts[i];
  if (LAZY) {
    for (int i = t; i < 3 * 2 * R0; i += NT) {
      const int k = i / (2 * R0), j = i % (2 * R0);
      if (j < R0) {
        const int g = min(max(y0 - 3 + j, 0), H - 1);
        ly[k][j] = lerp_of(g, H, br.h[k]);
      } else {
        const int g = min(max(x0 - 3 + j - R0, 0), W - 1);
        lx[k][j - R0] = lerp_of(g, W, br.w[k]);
      }
    }
    __syncthreads();
  }

  // stage 0: SELU(s0) on the tile plus a 3-pixel ring, 0 outside
  const float* sb = s0 + (size_t)b * 8 * H * W;
  for (int p = t; p < R0 * R0; p += NT) {
    const int r = p / R0, c = p % R0;
    const int gy = y0 - 3 + r, gx = x0 - 3 + c;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll 1
    for (int ch = 0; ch < 8; ++ch) {
      float v = 0.f;
      if (inside) {
        v = sb[((size_t)ch * H + gy) * W + gx];
        if (LAZY) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const Lerp a = ly[k][r], e = lx[k][c];
            const int hk = br.h[k], wk = br.w[k];
            const float* m = br.s[k] + ((size_t)b * 8 + ch) * hk * wk;
            const float t0 = (1.f - a.w) * m[a.i0 * wk + e.i0] + a.w * m[a.i1 * wk + e.i0];
            const float t1 = (1.f - a.w) * m[a.i0 * wk + e.i1] + a.w * m[a.i1 * wk + e.i1];
            v += (1.f - e.w) * t0 + e.w * t1;
          }
        }
        v = selu(v);
      }
      S0[(ch * R0 + r) * R0 + c] = v;
    }
  }
  __syncthreads();
  conv_stage<8, R1>(S0, S1, Wt, y0 - 2, x0 - 2, H, W);
  __syncthreads();
  float* S2 = S0;  // stage 0 is consumed
  conv_stage<4, R2>(S1, S2, Wt + 9 * 8 * 4, y0 - 1, x0 - 1, H, W);
  __syncthreads();

  const float* w3 = Wt + 9 * (8 * 4 + 4 * 4);
  for (int p = t; p < T * T; p += NT) {
    const int r = p / T, c = p % T;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    float acc = 0.f;
#pragma unroll
    for (int ci = 0; ci < 4; ++ci)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        acc = fmaf(w3[ci * 9 + tap], S2[(ci * R2 + r + tap / 3) * R2 + c + tap % 3], acc);
    out[((size_t)b * H + gy) * W + gx] = 1.f / (1.f + expf(-acc));
  }
}

template <bool LAZY>
cudaError_t launch(const float* s0, const Branches& br, const float* w,
                   float* out, int B, int H, int W, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (8 * R0 * R0 + 4 * R1 * R1 + NW);
  cudaError_t err = cudaFuncSetAttribute(
      score_head_kernel<LAZY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(W, T), cdiv(H, T), B);
  score_head_kernel<LAZY><<<grid, NT, smem, stream>>>(s0, br, w, out, H, W);
  return cudaGetLastError();
}

}  // namespace

// s0 (B, 8, H, W); w: the weights of the three convs as [ci][tap][co],
// (8, 9, 4), (4, 9, 4), (4, 9, 1), concatenated (468 floats); out
// (B, H, W).
extern "C" cudaError_t lg_score_head(const float* s0, const float* w,
                                     float* out, int B, int H, int W,
                                     cudaStream_t stream) {
  return launch<false>(s0, Branches{}, w, out, B, H, W, stream);
}

// s1 (B, 8, H, W); s2, s3, s4 (B, 8, hk, wk) for k = 2, 3, 4, any hk, wk
// >= 1; w and out as lg_score_head.
extern "C" cudaError_t lg_score_head_lazy(const float* s1, const float* s2,
                                          const float* s3, const float* s4,
                                          const float* w, float* out, int B,
                                          int H, int W, int h2, int w2, int h3,
                                          int w3, int h4, int w4,
                                          cudaStream_t stream) {
  const Branches br{{s2, s3, s4}, {h2, h3, h4}, {w2, w3, w4}};
  return launch<true>(s1, br, w, out, B, H, W, stream);
}
