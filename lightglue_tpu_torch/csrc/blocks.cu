// B5 and B6: the whole-block kernels' own launches, fp32. B5 (SelfBlock)
// and B6 (CrossBlock, both images) run as the ops ops/flash_self.py and
// ops/flash_cross_block.py, each a short chain of hand-written launches:
//   B5: project_heads_kernel (q, k, v with rotary), the K1 key walk of
//       flash_sdpa.cu (exact or shift, head_dim 64 or 128) on them,
//       block_tail_kernel;
//   B6: project_heads_kernel for each image (qk, v), the row and column
//       launches of flash_cross.cu (mode 1 exact, mode 2 shift; head_dim
//       64, as the TPU kernel),
//       block_tail_kernel for each image.
//
// Replaces the TPU kernels lightglue_tpu/ops/flash_self.py::_kernel
// (fused_self_block) and lightglue_tpu/ops/flash_cross_block.py::_kernel
// (fused_cross_block): for one block,
//   out = x + FFN(cat[x, sum_h ctx_h Wo[h] + bo])
// with the per-head context ctx_h of self attention (rot(q), rot(k), v
// from Wqkv) or of the shared-QK cross attention (to_qk, to_v), the softmax
// scale (times log2(e) with a shift) folded into the projection weights by
// the host (prepare in the ops). Rotary stays in the reference's interleaved
// pair layout; the TPU kernel's deinterleaved layout is a lane trick that
// changes no score.
//
// What bounds them on an H100: arithmetic. B5 per image and layer at N 1024,
// D 256: 2.42 GFLOP (Wqkv 0.40, attention 1.07, out_proj 0.13, FFN 0.81)
// against 1 MB of x, 2.6 MB of weights and 1 MB of output, about 36 us at
// the 67 TFLOP/s fp32 CUDA-core peak; B6 per pair at M = N = 1024: 4.03
// GFLOP, about 60 us.
//
// Design: the TPU kernels keep a whole block's activations in VMEM (every
// head's k and v, a (BQ, N) or (M, N) score strip); a block's 227 KB cannot,
// and the card needs many blocks in flight where the TPU walks one grid in
// order. A first version followed the TPU's shape with two launches for
// B5, the second one block per 64-row query tile running every head's
// attention, out_proj and the FFN: 64 blocks for 132 SMs at B 4, 1.10 ms
// on an H100 SXM at 700 W against 0.57 ms for this design (chip_smoke.py).
// This one splits at the head boundary instead, so each launch has a grid
// of its own size: the projection one block per (64-row tile, head and
// group, batch), the attention one per (64-row tile, head, batch), the tail
// one per 32 rows. The context goes through device memory (1 MB per image
// at N 1024, under a microsecond of HBM time); the projected q, k, v never
// pass through a separate rotary or head-split pass, and out_proj is fused
// into the FFN's launch.
#include "ffn.cuh"

namespace {

using lg::HD;
using lg::LD;
using lg::THREADS;
using lg::TILE;

// x (B, N, D); wT (G * D, D), one row per output channel; bias (G * D);
// cs, sn (B, N, hd / 2) rotary cos / sin per channel pair, or null;
// out (G, B, H, N, hd), D = H hd, hd a multiple of 64. Grid (cdiv(N, 64),
// G * D / 64, B): one 64-channel tile of one group and head per block;
// groups below n_rot get rotary (a pair never straddles two tiles).
__global__ void __launch_bounds__(THREADS)
    project_heads_kernel(const float* __restrict__ x,
                         const float* __restrict__ wT,
                         const float* __restrict__ bias,
                         const float* __restrict__ cs,
                         const float* __restrict__ sn, float* __restrict__ out,
                         int B, int N, int H, int hd, int n_rot) {
  extern __shared__ __align__(16) float lg_smem[];
  float* As = lg_smem;         // 64 x LD: x rows, then the output tile
  float* Bs = As + TILE * LD;  // 64 x LD: weight rows
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int n0 = blockIdx.x * TILE, ct = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, ch0 = ct * TILE;  // first channel of the G * D
  const int g = ch0 / D, h = ch0 % D / hd, c0 = ch0 % hd;
  const float* xb = x + (size_t)b * N * D;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += HD) {
    __syncthreads();
    lg::load_tile(As, LD, xb, n0, N, D, k0, 1.f);
    lg::load_tile(Bs, LD, wT, ch0, gridDim.y * TILE, D, k0, 1.f);
    __syncthreads();
    lg::tile_abt(As, Bs, acc);  // acc[i][j]: row ty + 16i, channel tx + 16j
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      As[(ty + 16 * i) * LD + tx + 16 * j] =
          acc[i][j] + bias[ch0 + tx + 16 * j];
  __syncthreads();

  // rotary, interleaved pairs (ops/rotary.py::apply_rotary):
  //   o[2p] = t[2p] c_p - t[2p+1] s_p;  o[2p+1] = t[2p+1] c_p + t[2p] s_p
  float* ob = out + (((size_t)g * B + b) * H + h) * N * hd + c0;
  const bool rot = g < n_rot;
  for (int idx = t; idx < TILE * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD, row = n0 + r;
    if (row >= N) continue;
    float val = As[r * LD + c];
    if (rot) {
      const size_t at = ((size_t)b * N + row) * (hd / 2) + ((c0 + c) >> 1);
      const float co = cs[at], si = sn[at], other = As[r * LD + (c ^ 1)];
      val = (c & 1) ? val * co + other * si : val * co - other * si;
    }
    ob[(size_t)row * hd + c] = val;
  }
}

constexpr size_t kProjSmem = 2 * TILE * LD * sizeof(float);

// ctx (B, H, N, hd) per-head context, D = H hd; x, out (B, N, D). Grid
// (cdiv(N, 32), B): Xs = [x | ctx] for 32 rows, the message
// ctx Wo + bo (a 32 x D x D product, Wo streamed 16 rows at a time)
// replaces the ctx half, then K3's FFN body.
template <int D>
__global__ void __launch_bounds__(THREADS)
    block_tail_kernel(const float* __restrict__ ctx,
                      const float* __restrict__ x,
                      const float* __restrict__ wo,
                      const float* __restrict__ bo,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2, float* __restrict__ out,
                      int N, int hd) {
  constexpr int D2 = 2 * D, C = D / 32;
  const int H = D / hd;
  extern __shared__ __align__(16) float lg_smem[];
  float* Xs = lg_smem;                 // 32 x D2: [x | ctx], then [x | msg]
  float* Hs = Xs + lg::FFN_ROWS * D2;  // 32 x D2
  float* Ws = Hs + lg::FFN_ROWS * D2;  // 16 x D2
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int b = blockIdx.y, row0 = blockIdx.x * lg::FFN_ROWS;
  const float* xb = x + (size_t)b * N * D;

  for (int idx = t; idx < lg::FFN_ROWS * D2; idx += THREADS) {
    const int rr = idx / D2, c = idx % D2, row = row0 + rr;
    float val = 0.f;
    if (row < N) {
      const int hc = c - D;  // merged-head channel h * hd + chan
      val = c < D ? xb[(size_t)row * D + c]
                  : ctx[(((size_t)b * H + hc / hd) * N + row) * hd + hc % hd];
    }
    Xs[idx] = val;
  }

  float acc[4][C] = {};
  for (int k0 = 0; k0 < D; k0 += lg::FFN_KC) {
    __syncthreads();  // Xs filled; previous Ws readers done
    for (int idx = t; idx < lg::FFN_KC * D; idx += THREADS)
      Ws[idx] = wo[(size_t)k0 * D + idx];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < lg::FFN_KC; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[(warp * 4 + i) * D2 + D + k0 + kk];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float w = Ws[kk * D + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
  }
  __syncthreads();  // every read of the ctx half is done
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = lane + 32 * j;
      Xs[(warp * 4 + i) * D2 + D + c] = acc[i][j] + bo[c];
    }
  lg::ffn_rows<D>(Xs, Hs, Ws, w1, b1, gamma, beta, w2, b2,
                  out + (size_t)b * N * D, row0, N);
}

template <int D>
cudaError_t launch_tail(const float* ctx, const float* x, const float* wo,
                        const float* bo, const float* w1, const float* b1,
                        const float* gamma, const float* beta, const float* w2,
                        const float* b2, float* out, int B, int N, int hd,
                        cudaStream_t stream) {
  constexpr size_t smem = lg::ffn_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block_tail_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lg::cdiv(N, lg::FFN_ROWS), B);
  block_tail_kernel<D><<<grid, THREADS, smem, stream>>>(ctx, x, wo, bo, w1, b1, gamma, beta, w2, b2, out, N, hd);
  return cudaGetLastError();
}

}  // namespace

// x (B, N, D); wT (G * D, D); bias (G * D); cos, sin (B, N, hd / 2) or
// null; out (G, B, H, N, hd) with D = H hd and hd a multiple of 64; the
// first n_rot groups get rotary.
extern "C" cudaError_t lg_project_heads(const float* x, const float* wT,
                                        const float* bias, const float* cs,
                                        const float* sn, float* out, int B,
                                        int N, int G, int H, int hd,
                                        int n_rot, cudaStream_t stream) {
  if ((n_rot > 0 && (cs == nullptr || sn == nullptr)) || hd < HD ||
      hd % HD != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      project_heads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kProjSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lg::cdiv(N, TILE), G * H * hd / TILE, B);
  project_heads_kernel<<<grid, THREADS, kProjSmem, stream>>>(x, wT, bias, cs, sn, out, B, N, H, hd, n_rot);
  return cudaGetLastError();
}

// ctx (B, H, N, hd); x, out (B, N, D), D = H hd 128 or 256; wo (D, D), w1
// (2D, 2D), w2 (2D, D) stored (in, out); bo, b2 (D); b1, gamma, beta (2D).
extern "C" cudaError_t lg_block_tail(
    const float* ctx, const float* x, const float* wo, const float* bo,
    const float* w1, const float* b1, const float* gamma, const float* beta,
    const float* w2, const float* b2, float* out, int B, int H, int hd, int N,
    cudaStream_t stream) {
  if (H * hd == 256)
    return launch_tail<256>(ctx, x, wo, bo, w1, b1, gamma, beta, w2, b2, out,
                            B, N, hd, stream);
  if (H * hd == 128)
    return launch_tail<128>(ctx, x, wo, bo, w1, b1, gamma, beta, w2, b2, out,
                            B, N, hd, stream);
  return cudaErrorInvalidValue;
}
