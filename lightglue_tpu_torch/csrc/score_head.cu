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
// (B, 8, hk, wk)), up() the align-corners bilinear upsampling to H x W, rows
// first and then columns as ops/sampling.py::upsample does, with two-point
// weights computed per tile row and column in double, as numpy's linspace
// computes them. A branch dimension of 1 takes its single row (y0 = y1 = 0,
// weight 0); the TPU kernel's clamp to hk - 2 is not reproduced.
//
// What bounds it on an H100: arithmetic, narrowly. B12 does 468
// multiply-adds per pixel (0.022 ms for two 768 x 1024 maps at 67 TFLOP/s)
// against 32 B read and 4 B written (0.017 ms at 3.35 TB/s); B11 adds the
// three lerps (0.026 ms) and reads the partials once, 44.5 B per pixel
// (0.021 ms). On the CUDA cores an FFMA takes a whole issue slot of its
// warp scheduler, so every other instruction (a shared load, a weight's
// uniform load, SELU, an index) is time taken from the multiply-adds.
//
// Design: one block of 256 threads per Tile::TH x TW output tile, one
// launch a call, four blocks an SM (57 KB of shared memory, 64 registers).
// - The 468 weights are a kernel parameter (Weights, [conv][ci][tap][co],
//   copied from the caller's host array), each multiply-add taking its
//   weight from the constant bank through a uniform register: every loop
//   over them is unrolled at compile time.
// - Register micro-tiles: a thread computes R rows x 2 columns of a stage
//   for all its output channels; each staged input row is two float2
//   loads, used by every tap of every output it feeds (24 FFMAs a load in
//   conv 8->4). Columns come in pairs so that every stage's loads stay
//   8-byte aligned with no wasted column: the staged rings shrink by one
//   pixel a side a stage (halo recompute 1.17x at 48 x 32).
// - Conv 8->4 streams its input channels: SELU(s0) of one channel at a time
//   fills a (TH + 6) x (TW + 6) plane, two planes in turn, while each
//   thread keeps its micro-tile's 32 sums in registers over the eight
//   channels. The next channel's copies (cp.async) are in flight while the
//   current one is summed, and SELU is applied in place to a thread's own
//   copies, so one barrier a channel. Only the 4-channel stages are staged
//   whole: stage 1 (TH + 4) x (TW + 4), then stage 2 (TH + 2) x (TW + 2)
//   over the planes' space.
// - B11 stages each branch's window of the tile's ring once a channel with
//   coalesced copies (in stage 1's space, free until the channel loop
//   ends), lerps it along rows for every ring row (a warp a window column,
//   a lane a row), and each staged pixel adds its column lerps of the three
//   branches to s1: no per-pixel global gather of branch values. The lerp
//   rows and columns of the tile are computed once a block.
// - SELU's negative side is the exp form exp(x) - 1 by one MUFU.EX2, the
//   sigmoid 1 / (1 + 2^(-x log2 e)).
// scripts/score_study.py builds the variants (tiles, blocks an SM, the
// staging loops' forms) and times probes with one part cut out.
//
// The bf16 form (lg_score_head_bf16, lg_score_head_lazy_bf16; the TPU
// kernels at mp=True, lightglue_tpu/ops/score_head.py:82-83, 135-136,
// 224-225, 232-239) is a kernel of its own designed for Hopper,
// score_wgmma.cuh: conv 8->4 and conv 4->4 on wgmma with pixels as M (conv
// 4->1 on the CUDA cores), persistent blocks walking strips with a ring a
// stage, the weights resident, s0's rows fed by TMA. Both take the
// align-corners lerps (lerp_of) and the sigmoid from score_common.cuh.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include "score_common.cuh"
#include "score_wgmma.cuh"

namespace {

using lg::score::clampi;
using lg::score::ex2;
using lg::score::Lerp;
using lg::score::lerp_of;
using lg::score::sigmoid;

constexpr int NT = 256;
constexpr int NW = 9 * (8 * 4 + 4 * 4 + 4 * 1);  // 468 weights
constexpr int O2 = 9 * 8 * 4, O3 = O2 + 9 * 4 * 4;  // conv 2 and conv 3
constexpr float kAlpha = 1.6732632423543772848170429916717f;
constexpr float kScale = 1.0507009873554804934193349852946f;
constexpr float kLog2e = 1.4426950408889634f;

// The tile: TH x TW outputs a block, and the rows of a thread's micro-tile
// in conv 1 (R1), conv 2 (R2) and conv 3 (R3). Stage s's outputs lie on the
// tile with a (3 - s)-pixel ring; the SELU(s0) planes have a 3-pixel ring.
template <int TH_, int TW_, int R1_, int R2_, int R3_>
struct ScoreTile {
  static constexpr int TH = TH_, TW = TW_, R1 = R1_, R2 = R2_, R3 = R3_;
  static constexpr int PH = TH + 6, PW = TW + 6;  // a SELU(s0) plane
  static constexpr int H1 = TH + 4, W1 = TW + 4;  // stage 1
  static constexpr int H2 = TH + 2, W2 = TW + 2;  // stage 2
  static constexpr int MC1 = W1 / 2, MC2 = W2 / 2, MC3 = TW / 2;
  static constexpr int N1 = H1 / R1 * MC1, N2 = H2 / R2 * MC2, N3 = TH / R3 * MC3;
  static constexpr int RG = NT / PW;  // staging: RG groups of PW threads,
  static constexpr int NS = (PH + RG - 1) / RG;  // NS rows each
  static constexpr int NQ = (PH + 31) / 32;  // B11's row lerps: rows a lane
  // shared floats: region A holds the two planes, then stage 2; region B
  // B11's tables, windows and row lerps, then stage 1
  static constexpr int A = 2 * PH * PW > 4 * H2 * W2 ? 2 * PH * PW : 4 * H2 * W2;
  static constexpr int S1 = 4 * H1 * W1;
  // B11's head of region B: the lerp rows and columns (3 words each),
  // then the three windows' places (Window, 6 words each)
  static constexpr int GEO = 9 * (PH + PW);
  static constexpr int TABLES = (GEO + 18 + 3) & ~3;
  static_assert(TW % 2 == 0 && H1 % R1 == 0 && H2 % R2 == 0 && TH % R3 == 0,
                "micro-tiles tile every stage");
  static_assert(N1 <= NT, "one conv-1 micro-tile a thread");
  static_assert(RG >= 1 && A % 4 == 0, "staging");
};

using Tile = ScoreTile<48, 32, 4, 2, 4>;
constexpr int kBlocksSM = 4;
// The staging loops over a thread's NS rows, unrolled: the rows' copies
// issue back to back and their SELUs' latencies overlap. B11's, with three
// lerps a row, by three rows at a time: by nine it spills.
constexpr int kCopyUnroll = 9;
constexpr int kSeluUnroll = 9;
constexpr int kSeluUnrollLazy = 3;

// v, opaque to the compiler: what is computed from it is computed where it
// is used, a channel at a time, and not hoisted out of the channel loop to
// stay live in registers across it (nine rows' addresses and bounds would
// spill at the 64 registers that four blocks an SM leave a thread).
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

struct Weights {
  float w[NW];  // [conv][ci][tap][co]: (8, 9, 4), (4, 9, 4), (4, 9, 1)
};

__device__ __forceinline__ float selu(float x) {
  constexpr float kSA = kScale * kAlpha;
  return x > 0.f ? kScale * x : fmaf(kSA, ex2(fminf(x, 0.f) * kLog2e), -kSA);
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// A 4-byte cp.async into shared memory (zero fill where !valid), and the
// wait for all of a thread's copies, after which it reads them.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
#else
  *dst = valid ? *src : 0.f;
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

struct Branches {
  const float* s[3];  // s2, s3, s4: (B, 8, hk, wk)
  int h[3], w[3];
  int nr[3], nc[3];  // the most rows and columns a tile's window spans
};

// A branch's window in a tile: its first row and column, its extent, and
// the offsets (in floats from region B) of the window and its row lerps.
struct Window {
  int y, x, nr, nc, win, rows;
};

// Conv micro-tile: acc[r][j][co] += sum over taps of w[OFF + tap CO + co] x
// src[r + dy][j + dx], src a staged input at the micro-tile's first row and
// column, PITCH floats a row. Each input row is two float2 loads.
template <int R, int CO, int PITCH, int OFF>
__device__ __forceinline__ void conv_in(const float* src, const Weights& wt,
                                        float (&acc)[R][2][CO]) {
#pragma unroll
  for (int i = 0; i < R + 2; ++i) {
    const float2 a = *reinterpret_cast<const float2*>(src + i * PITCH);
    const float2 c = *reinterpret_cast<const float2*>(src + i * PITCH + 2);
    const float x[4] = {a.x, a.y, c.x, c.y};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      if (i - dy < 0 || i - dy >= R) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int co = 0; co < CO; ++co)
            acc[i - dy][j][co] = fmaf(wt.w[OFF + (dy * 3 + dx) * CO + co],
                                      x[j + dx], acc[i - dy][j][co]);
    }
  }
}

// Conv 1's share of input channel ci, on its SELU(s0) plane.
template <class T>
__device__ __forceinline__ void conv1_channel(int ci, const float* src,
                                              const Weights& wt,
                                              float (&acc)[T::R1][2][4]) {
  switch (ci) {
    case 0: conv_in<T::R1, 4, T::PW, 0 * 36>(src, wt, acc); break;
    case 1: conv_in<T::R1, 4, T::PW, 1 * 36>(src, wt, acc); break;
    case 2: conv_in<T::R1, 4, T::PW, 2 * 36>(src, wt, acc); break;
    case 3: conv_in<T::R1, 4, T::PW, 3 * 36>(src, wt, acc); break;
    case 4: conv_in<T::R1, 4, T::PW, 4 * 36>(src, wt, acc); break;
    case 5: conv_in<T::R1, 4, T::PW, 5 * 36>(src, wt, acc); break;
    case 6: conv_in<T::R1, 4, T::PW, 6 * 36>(src, wt, acc); break;
    default: conv_in<T::R1, 4, T::PW, 7 * 36>(src, wt, acc); break;
  }
}

// SELU of a micro-tile's sums into a staged stage, 0 where the output
// pixel (gy0 + r, gx0 + j) lies outside the image; float2 stores.
template <int R, int PITCH, int HS>
__device__ __forceinline__ void store_stage(const float (&acc)[R][2][4],
                                            float* dst, int gy0, int gx0,
                                            int H, int W) {
  const bool x0in = gx0 >= 0 && gx0 < W, x1in = gx0 + 1 >= 0 && gx0 + 1 < W;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool yin = gy0 + r >= 0 && gy0 + r < H;
#pragma unroll
    for (int co = 0; co < 4; ++co)
      *reinterpret_cast<float2*>(dst + (co * HS + r) * PITCH) = make_float2(
          yin && x0in ? selu(acc[r][0][co]) : 0.f,
          yin && x1in ? selu(acc[r][1][co]) : 0.f);
  }
}

template <bool LAZY, class T>
__global__ void __launch_bounds__(NT, kBlocksSM)
    score_head_kernel(const float* __restrict__ s0,  // (B, 8, H, W): s0 or s1
                      const Branches br, const __grid_constant__ Weights wt,
                      float* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) float sh_smem[];
  float* RA = sh_smem;        // SELU(s0) planes [2][PH][PW]; stage 2 [4][H2][W2]
  float* RB = sh_smem + T::A;  // B11: tables, windows, row lerps; stage 1 [4][H1][W1]
  // B11's three windows' records live in region B, not in static shared
  // memory: there the channel loop's stores into region B keep the compiler
  // from loading them once and holding their 18 values in registers across
  // the loop, where they spill
  Window* geo = reinterpret_cast<Window*>(RB + T::GEO);

  const int t = threadIdx.x, b = blockIdx.z, warp = t / 32, lane = t % 32;
  const int y0 = blockIdx.y * T::TH, x0 = blockIdx.x * T::TW;
  // staging: a fixed column pc of the footprint, rows pr, pr + RG, ...
  const int pc = t % T::PW, pr = t / T::PW;
  const int gx = x0 - 3 + pc;
  const bool xin = gx >= 0 && gx < W;
  // conv 1's micro-tile: rows R1 band1 .., columns 2 mc1 .. of stage 1
  const int band1 = t / T::MC1, mc1 = t % T::MC1;

  Lerp* rt = reinterpret_cast<Lerp*>(RB);  // [3][PH]: the footprint's rows
  Lerp* ct = rt + 3 * T::PH;               // [3][PW]: its columns
  if constexpr (LAZY) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      for (int j = t; j < T::PH + T::PW; j += NT)
        if (j < T::PH)
          rt[k * T::PH + j] = lerp_of(clampi(y0 - 3 + j, 0, H - 1), H, br.h[k]);
        else
          ct[k * T::PW + j - T::PH] =
              lerp_of(clampi(x0 - 3 + j - T::PH, 0, W - 1), W, br.w[k]);
    __syncthreads();
    if (t == 0) {
      int off = T::TABLES;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        Window g;
        g.y = rt[k * T::PH].i0;
        g.x = ct[k * T::PW].i0;
        g.nr = rt[k * T::PH + T::PH - 1].i1 - g.y + 1;
        g.nc = ct[k * T::PW + T::PW - 1].i1 - g.x + 1;
        g.win = off;
        off += br.nr[k] * br.nc[k];
        g.rows = off;
        off += T::PH * br.nc[k];
        geo[k] = g;
      }
    }
    __syncthreads();
  }

  float acc[T::R1][2][4];
#pragma unroll
  for (int r = 0; r < T::R1; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int co = 0; co < 4; ++co) acc[r][j][co] = 0.f;

  // Channel ci's copies, in flight while conv 1 sums channel ci - 1: s0
  // (B11: s1) of the thread's staging positions into plane ci & 1, zero
  // outside the image; B11's windows into region B.
  auto prefetch = [&](int ci) {
    float* P = RA + (ci & 1) * T::PH * T::PW;
    const float* sp = s0 + ((size_t)b * 8 + ci) * H * W;
    if (pr < T::RG) {
      const int gy0 = opaque(y0 - 3 + pr);
#pragma unroll kCopyUnroll
      for (int i = 0; i < T::NS; ++i) {
        const int r = pr + i * T::RG, gy = gy0 + i * T::RG;
        const bool ok = xin && gy >= 0 && gy < H;
        if (r < T::PH) copy4(P + r * T::PW + pc, ok ? sp + (size_t)gy * W + gx : sp, ok);
      }
    }
    if constexpr (LAZY) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const Window g = geo[k];
        const float* src = br.s[k] + (((size_t)b * 8 + ci) * br.h[k] + g.y) * br.w[k] + g.x;
        float* dst = RB + g.win;
        for (int i = warp; i < g.nr; i += NT / 32)
          for (int j = lane; j < g.nc; j += 32)
            copy4(dst + i * g.nc + j, src + (size_t)i * br.w[k] + j, true);
      }
    }
    copy_commit();
  };

  prefetch(0);
#pragma unroll 1
  for (int ci = 0; ci < 8; ++ci) {
    float* P = RA + (ci & 1) * T::PH * T::PW;
    copy_wait();
    if constexpr (LAZY) {
      __syncthreads();  // every thread's window copies have landed
      // the lerp along rows, for every row of the footprint: a warp a
      // window column, a lane a row; the row lerps column-major, PH a column
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const Window g = geo[k];
        int o0[T::NQ], o1[T::NQ];
        float wy[T::NQ];
#pragma unroll
        for (int q = 0; q < T::NQ; ++q) {
          const Lerp e = rt[k * T::PH + min(lane + 32 * q, T::PH - 1)];
          o0[q] = g.win + (e.i0 - g.y) * g.nc;
          o1[q] = g.win + (e.i1 - g.y) * g.nc;
          wy[q] = e.w;
        }
        for (int j = warp; j < g.nc; j += NT / 32) {
          float* dst = RB + g.rows + j * T::PH;
#pragma unroll
          for (int q = 0; q < T::NQ; ++q) {
            const int r = lane + 32 * q;
            const float a = RB[o0[q] + j], c = RB[o1[q] + j];
            if (r < T::PH) dst[r] = fmaf(wy[q], c - a, a);
          }
        }
      }
      __syncthreads();
    }
    // SELU(s0) in place on the thread's own copies; B11 first adds the
    // column lerps of the three branches to s1
    if (pr < T::RG) {
      const float* at0[3];  // the pixel's two row-lerped columns at row pr
      const float* at1[3];
      float wx[3];
      if constexpr (LAZY) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const Window g = geo[k];
          const Lerp e = ct[k * T::PW + pc];
          at0[k] = RB + g.rows + (e.i0 - g.x) * T::PH + pr;
          at1[k] = RB + g.rows + (e.i1 - g.x) * T::PH + pr;
          wx[k] = e.w;
        }
      }
      const int gy0 = opaque(y0 - 3 + pr);
#pragma unroll (LAZY ? kSeluUnrollLazy : kSeluUnroll)
      for (int i = 0; i < T::NS; ++i) {
        const int r = pr + i * T::RG, gy = gy0 + i * T::RG;
        if (r >= T::PH) break;
        const bool ok = xin && gy >= 0 && gy < H;
        float v = P[r * T::PW + pc];
        if (LAZY && ok) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float a = at0[k][i * T::RG], c = at1[k][i * T::RG];
            v += fmaf(wx[k], c - a, a);
          }
        }
        P[r * T::PW + pc] = ok ? selu(v) : 0.f;
      }
    }
    __syncthreads();
    if (ci < 7) prefetch(ci + 1);
    if (t < T::N1)
      conv1_channel<T>(ci, P + band1 * T::R1 * T::PW + 2 * mc1, wt, acc);
  }

  // stage 1 over region B: every thread is past its last read of the
  // tables, windows and row lerps (the channel loop's last barrier)
  float* S1 = RB;
  if (t < T::N1)
    store_stage<T::R1, T::W1, T::H1>(acc, S1 + band1 * T::R1 * T::W1 + 2 * mc1,
                                     y0 - 2 + band1 * T::R1, x0 - 2 + 2 * mc1, H, W);
  __syncthreads();

  // stage 2 over region A
  float* S2 = RA;
  for (int p = t; p < T::N2; p += NT) {
    const int band = p / T::MC2, mc = p % T::MC2;
    float a2[T::R2][2][4];
#pragma unroll
    for (int r = 0; r < T::R2; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int co = 0; co < 4; ++co) a2[r][j][co] = 0.f;
    const float* src = S1 + band * T::R2 * T::W1 + 2 * mc;
    conv_in<T::R2, 4, T::W1, O2 + 0 * 36>(src + 0 * T::H1 * T::W1, wt, a2);
    conv_in<T::R2, 4, T::W1, O2 + 1 * 36>(src + 1 * T::H1 * T::W1, wt, a2);
    conv_in<T::R2, 4, T::W1, O2 + 2 * 36>(src + 2 * T::H1 * T::W1, wt, a2);
    conv_in<T::R2, 4, T::W1, O2 + 3 * 36>(src + 3 * T::H1 * T::W1, wt, a2);
    store_stage<T::R2, T::W2, T::H2>(a2, S2 + band * T::R2 * T::W2 + 2 * mc,
                                     y0 - 1 + band * T::R2, x0 - 1 + 2 * mc, H, W);
  }
  __syncthreads();

  // stage 3 and the sigmoid
  for (int p = t; p < T::N3; p += NT) {
    const int band = p / T::MC3, mc = p % T::MC3;
    float a3[T::R3][2][1];
#pragma unroll
    for (int r = 0; r < T::R3; ++r) a3[r][0][0] = a3[r][1][0] = 0.f;
    const float* src = S2 + band * T::R3 * T::W2 + 2 * mc;
    conv_in<T::R3, 1, T::W2, O3 + 0 * 9>(src + 0 * T::H2 * T::W2, wt, a3);
    conv_in<T::R3, 1, T::W2, O3 + 1 * 9>(src + 1 * T::H2 * T::W2, wt, a3);
    conv_in<T::R3, 1, T::W2, O3 + 2 * 9>(src + 2 * T::H2 * T::W2, wt, a3);
    conv_in<T::R3, 1, T::W2, O3 + 3 * 9>(src + 3 * T::H2 * T::W2, wt, a3);
    const int gx0 = x0 + 2 * mc;
#pragma unroll
    for (int r = 0; r < T::R3; ++r) {
      const int gy = y0 + band * T::R3 + r;
      if (gy >= H) break;
      float* o = out + ((size_t)b * H + gy) * W + gx0;
      if (gx0 < W) o[0] = sigmoid(a3[r][0][0]);
      if (gx0 + 1 < W) o[1] = sigmoid(a3[r][1][0]);
    }
  }
}

// The most branch rows (of nk) that one tile of `tile` outputs and its
// 3-pixel ring lerp from, over the tiles of an axis of n outputs: the
// capacity of a window in region B.
int window_extent(int n, int nk, int tile) {
  int most = 1;
  for (int i = 0; i < cdiv(n, tile); ++i) {
    const int a = lerp_of(clampi(i * tile - 3, 0, n - 1), n, nk).i0;
    const int e = lerp_of(clampi(i * tile + tile + 2, 0, n - 1), n, nk).i1;
    most = e - a + 1 > most ? e - a + 1 : most;
  }
  return most;
}

// Lets the kernel take `smem` bytes of dynamic shared memory.
template <bool LAZY>
cudaError_t configure(size_t smem) {
  return cudaFuncSetAttribute(score_head_kernel<LAZY, Tile>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool LAZY>
cudaError_t launch(const float* s0, Branches br, const float* w_host,
                   float* out, int B, int H, int W, cudaStream_t stream) {
  using T = Tile;
  Weights wt;
  memcpy(wt.w, w_host, sizeof(wt.w));
  int region_b = T::S1;
  if (LAZY) {
    int need = T::TABLES;
    for (int k = 0; k < 3; ++k) {
      br.nr[k] = window_extent(H, br.h[k], T::TH);
      br.nc[k] = window_extent(W, br.w[k], T::TW);
      need += br.nr[k] * br.nc[k] + T::PH * br.nc[k];
    }
    region_b = need > region_b ? need : region_b;
  }
  const size_t smem = sizeof(float) * (T::A + region_b);
  const cudaError_t err = configure<LAZY>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(W, T::TW), cdiv(H, T::TH), B);
  score_head_kernel<LAZY, T><<<grid, NT, smem, stream>>>(s0, br, wt, out, H, W);
  return cudaGetLastError();
}

}  // namespace

// s0 (B, 8, H, W) on the device; w_host: the weights of the three convs as
// [ci][tap][co], (8, 9, 4), (4, 9, 4), (4, 9, 1), concatenated (468 floats)
// in host memory, passed to the kernel by value; out (B, H, W).
extern "C" cudaError_t lg_score_head(const float* s0, const float* w_host,
                                     float* out, int B, int H, int W,
                                     cudaStream_t stream) {
  return launch<false>(s0, Branches{}, w_host, out, B, H, W, stream);
}

// The bf16 form's tensor map of s (B, 8, H, Wp) fp32, Wp a multiple of 4
// and s 16-byte aligned (s0 for B12, s1 for B11), into the 128 bytes at map
// (score_wgmma.cuh's plane_map); the stream is not used.
extern "C" cudaError_t lg_score_head_bf16_map(void* map, const float* s,
                                              int B, int H, int Wp,
                                              cudaStream_t) {
  CUtensorMap m;
  const cudaError_t err = lg::swg::plane_map(&m, s, B, H, Wp);
  if (err == cudaSuccess) memcpy(map, &m, sizeof m);
  return err;
}

// The bf16 form (score_wgmma.cuh): map lg_score_head_bf16_map's of s0 (B,
// 8, H, W) (its width padded to Wp); wts ops/score_head.py::prepare_bf16's
// blob; out (B, H, W) fp32; grid ops/conv_plan.py's persistent blocks
// (score_wgmma.cuh's PER_SM an SM, strips of its STRIP).
extern "C" cudaError_t lg_score_head_bf16(const void* map,
                                          const lg::tc::bf16* wts, float* out,
                                          int B, int H, int W, int grid,
                                          cudaStream_t stream) {
  CUtensorMap m;
  memcpy(&m, map, sizeof m);
  return lg::swg::launch<false>(m, lg::swg::Branches{}, wts, out, B, H, W,
                                grid, stream);
}

// s1 (B, 8, H, W); s2, s3, s4 (B, 8, hk, wk) for k = 2, 3, 4, any hk, wk
// >= 1 (a branch larger than the image takes more shared memory); w_host
// and out as lg_score_head.
extern "C" cudaError_t lg_score_head_lazy(const float* s1, const float* s2,
                                          const float* s3, const float* s4,
                                          const float* w_host, float* out,
                                          int B, int H, int W, int h2, int w2,
                                          int h3, int w3, int h4, int w4,
                                          cudaStream_t stream) {
  const Branches br{{s2, s3, s4}, {h2, h3, h4}, {w2, w3, w4}, {}, {}};
  return launch<true>(s1, br, w_host, out, B, H, W, stream);
}

// The bf16 form (score_wgmma.cuh): map lg_score_head_bf16_map's of s1 (B,
// 8, H, W); s2, s3, s4 (B, 8, hk, wk) fp32, any hk, wk >= 1 (wider
// branches take more shared memory); wts, out and grid as
// lg_score_head_bf16.
extern "C" cudaError_t lg_score_head_lazy_bf16(
    const void* map, const float* s2, const float* s3, const float* s4,
    const lg::tc::bf16* wts, float* out, int B, int H, int W, int h2, int w2,
    int h3, int w3, int h4, int w4, int grid, cudaStream_t stream) {
  CUtensorMap m;
  memcpy(&m, map, sizeof m);
  const lg::swg::Branches br{{s2, s3, s4}, {h2, h3, h4}, {w2, w3, w4}};
  return lg::swg::launch<true>(m, br, wts, out, B, H, W, grid, stream);
}

// Blocks an SM of B12 (lazy 0) or of B11 (lazy 1) at the shared memory of
// a launch whose branch windows fit in stage 1's space, as ALIKED's do.
extern "C" cudaError_t lg_score_head_blocks(int lazy, int* blocks,
                                            cudaStream_t) {
  const size_t smem = sizeof(float) * (Tile::A + Tile::S1);
  cudaError_t err = lazy ? configure<true>(smem) : configure<false>(smem);
  if (err != cudaSuccess) return err;
  return lazy ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks, score_head_kernel<true, Tile>, NT, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks, score_head_kernel<false, Tile>, NT, smem);
}
