// A 3x3, 64 -> 64 convolution (stride 1, zero padding 1) on Hopper's tensor
// cores: SuperPoint's conv1b (stem.cu, B7) and conv2a / conv2b (stem2.cu,
// B8), fp32 by 3xTF32 (tc.cuh). The bf16 forms (mp) are conv_wgmma.cuh.
//
// An implicit GEMM: M the output pixels of a block's TH x TW tile, N all 64
// output channels, K 9 taps x 64 input channels. Nothing is written out as
// im2col: the block stages its input tile plus a 1-pixel ring in shared
// memory as [ci][row][col] and reads tap (dy, dx)'s A fragments from it at
// that offset. The staged rows are the 16-byte-aligned span x0 - 4 ..
// x0 + TW + 3 of each input row (the ring's first column, x0 - 1, is not
// aligned), copied by cp.async in 16-byte pieces (4-byte pieces where W is
// not a multiple of 4), positions outside the map zero-filled. The channel
// stride CS is 8 or 24 mod 32, so that a fragment's 8 pixels (lanes g) and
// 4 channels (lanes t) fall on 32 distinct banks.
//
// The A source is compile-time: a (B, 64, H, W) map in device memory,
// each channel group copied with the first weight slot that reads it (with
// one group, NQ 1, the whole tile with the first slot); or
// (B7) an image, from which the block computes conv1a + ReLU on the CUDA
// cores straight into the staged tile (9 MACs a value, 1.5 % of the
// stem's FLOPs), 0 outside the image (conv1b zero-pads conv1a's output).
//
// The weights are prepared once per parameter tree (ops/stem.py::
// prepare_conv): K-major per tap, [tap][co][128], already split into tf32
// big and small parts, and within each 8-deep chunk of input channels laid
// out as lane t's float4 {big ci t, big ci t + 4, small ci t, small ci
// t + 4}: one 16-byte read is a lane's whole split B fragment. They stream
// through a cp.async ring of STAGES slots, a slot being one tap of one
// channel group (QC = 64 / NQ input channels); the K order is group-major
// (group, tap, chunk).
//
// Fragment order: an m16 tile takes its pixels as a 2 x 8 patch (rows 0-7
// of the mma tile the upper row of pixels, 8-15 the lower), so the
// accumulator's rows g and g + 8 are vertically adjacent pixels and the
// horizontal neighbour is lane ^ 4. Each warp owns two m16 tiles (32
// pixels) x all 64 channels (8 n8 tiles), 64 accumulators a thread; a
// block of 128 pixels (4 warps) leaves room for two blocks an SM.
//
// Two epilogues (compile-time): bias + ReLU + the 2x2 max-pool, in
// registers with one __shfl_xor_sync; or bias + ReLU at full resolution.
// Both stage the tile through shared memory (over the input tile) so that
// NCHW rows are written as float4s. Every output is written by one block,
// there are no atomics, and a result repeats to the bit.
//
// Against the bound: 3xTF32 on mma.sync reaches at most 109.9 TFLOP/s of
// fp32 work on an H100 (scripts/conv_study.py's ceiling kernel, products
// from registers only), two thirds of the 165 that the 495 TFLOP/s TF32
// peak allows; these kernels reach 64-70, the rest going to the A-operand
// splits and shared-memory reads, nine barriers a block, and a prologue
// and epilogue that one block an SM does not overlap. wgmma (and TMA) is
// the way past the ceiling.
//
#pragma once

#include "tc.cuh"

namespace lg {
namespace conv {

constexpr int C = 64;          // channels in and out
constexpr int KROW = 2 * C;    // one (tap, co) row of the prepared weights

// Truncating tensor-core adds: the products are summed in place, in the
// mma's fp32 accumulator, which truncates. Over K = 576 they drift: on an
// H100 (scripts/conv_study.py, two 768 x 1024 images, conv weights x 3) B7,
// conv2a and B8 read 5.3e-6, 6.7e-6 and 8.1e-6 of max(1, max |out|) from
// float64, against 6.8e-7, 6.6e-7 and 5.8e-7 with each 8-deep step summed
// in a zeroed register tile first (gemm_tc.cuh's kStepSums, which B2 needs)
// and 9.1e-7, 1.3e-6 and 8.0e-7 for cuDNN's fp32. The step sums cost 19-25
// % of the time (their registers spill at 255) and in place stays 12x under
// the smoke's CONV_TOL of 1e-4, so the sums stay in place.

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// the least n' >= n with n' mod 32 in {8, 24}
__host__ __device__ constexpr int bank_stride(int n) {
  return (n % 32 == 8 || n % 32 == 24) ? n : bank_stride(n + 1);
}

template <int TH_, int TW_, int NQ_, int STAGES_>
struct Tile {
  static constexpr int TH = TH_, TW = TW_, NQ = NQ_, STAGES = STAGES_;
  static constexpr int THREADS = TH * TW;        // a warp 32 pixels
  static constexpr int ROWS = TH + 2;            // input rows y0 - 1 .. y0 + TH
  static constexpr int QC = C / NQ;              // input channels of a group
  static constexpr int SLOTS = 9 * NQ;
  static constexpr int MTW = TW / 8;             // m16 tiles across the tile
  // epilogue staging strides (4 mod 32: lanes t write 8 banks apart)
  static constexpr int PCS = TH * TW / 4 + 4, FCS = TH * TW + 4;
  static_assert(THREADS == 128 || THREADS == 256, "4 or 8 warps");
  static_assert(TH % 2 == 0 && TW % 8 == 0, "whole 2 x 8 patches");
  static_assert(QC % 16 == 0 && C % NQ == 0, "whole 16-deep chunks");
};

// The layout of a tile's shared memory, in 32-bit words: a word of the
// staged input is a channel of one pixel.
template <class T>
struct Geo {
  static constexpr int PLANES = C;                  // word planes of the input
  static constexpr int LPAD = 4;                    // row x0 - LPAD .. x0 + TW + LPAD - 1
  static constexpr int RS = T::TW + 2 * LPAD;
  static constexpr int CS = bank_stride(T::ROWS * RS);
  static constexpr int KSTEP = 8;                   // channels of an mma k-step
  static constexpr int CHUNKS = T::QC / KSTEP;      // k-steps of a slot
  // a slot's (tap, co) row: 16 floats a chunk (mod 32 = 16)
  static constexpr int LDW = 16 * CHUNKS + 16;
  static constexpr int KROW_W = KROW;               // words of a (tap, co) row in memory
  // the k-step of a slot before which the next slot's copies are issued:
  // mid-slot, B8's launches ran 1-3 % faster than with the copies right
  // after the barrier, B7 within 1 % (conv_study.py, two runs)
  static constexpr int LOAD_AT = CHUNKS / 2;
  static constexpr int kIn = PLANES * CS;           // words of the input tile
  static constexpr int kSlot = C * LDW;
  // the image source's image tile, conv1a's weights and biases
  static constexpr int kImage = (T::TH + 4) * (T::TW + 4) + C * 9 + C;
  static constexpr size_t bytes(bool image) {
    return (kIn + T::STAGES * kSlot + (image ? kImage : 0)) * sizeof(float);
  }
  static_assert(LDW % 32 == 16 && CS % 4 == 0, "banks and alignment");
};

// The fastest tiles of scripts/conv_study.py at B 1, 2 and 8: a weight slot
// of a whole tap (NQ 1: 9 barriers a block; 2 and 4 channel groups were
// 4-22 % slower) in a ring of two, 8 warps and one block an SM. The stem
// takes a wide 8 x 32 tile (up to 2 % faster than 16 x 16 at B 2 and 8),
// B8's launches 16 x 16 (the two within 2 % of each other there).
using StemTile = Tile<8, 32, 1, 2>;
using MapTile = Tile<16, 16, 1, 2>;

// out = relu(conv3x3(A) + bias), 2x2 max-pooled when kPool; one block a
// TH x TW tile of one image (grid (cdiv(W, TW), cdiv(H, TH), B)).
// kImage: src is the (B, 1, H, W) fp32 image and A = relu(conv1a(src) +
// b1a), 0 outside the image (w1a (64, 9), b1a (64)); else src is A itself,
// (B, 64, H, W). w: prepare_conv's (9, 64, 128); bias (64); out (B, 64, H,
// W), or (B, 64, H / 2, W / 2) when kPool (H, W even).
template <class T, bool kImage, bool kPool>
__global__ void __launch_bounds__(T::THREADS, 256 / T::THREADS)
    conv_tc_kernel(const float* __restrict__ src,
                   const float* __restrict__ w1a,
                   const float* __restrict__ b1a,
                   const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int W) {
  using G = Geo<T>;
  static_assert(C * (kPool ? T::PCS : T::FCS) <= G::kIn,
                "the epilogue fits in the input tile");
  extern __shared__ __align__(16) float lg_smem[];
  float* In = lg_smem;              // [PLANES][CS] words: rows y0 - 1 .., cols x0 - LPAD ..
  float* Wr = In + G::kIn;          // STAGES x [C][LDW]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, y0 = blockIdx.y * T::TH, x0 = blockIdx.x * T::TW;
  const float* xb = src + (size_t)b * (kImage ? 1 : C) * H * W;

  // the input channels of group q into In (map source)
  auto load_group = [&](int q) {
    if ((W & 3) == 0) {
      constexpr int CPR = G::RS / 4;  // 16-byte pieces of a row
      for (int i = tid; i < T::QC * T::ROWS * CPR; i += T::THREADS) {
        const int c = q * T::QC + i / (T::ROWS * CPR);
        const int r = i % (T::ROWS * CPR) / CPR, j = i % CPR;
        const int gy = y0 - 1 + r, gx = x0 - 4 + 4 * j;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
        tc::cp_async16(In + c * G::CS + r * G::RS + 4 * j,
                       ok ? xb + ((size_t)c * H + gy) * W + gx : xb, ok);
      }
    } else {
      for (int i = tid; i < T::QC * T::ROWS * G::RS; i += T::THREADS) {
        const int c = q * T::QC + i / (T::ROWS * G::RS);
        const int r = i % (T::ROWS * G::RS) / G::RS, j = i % G::RS;
        const int gy = y0 - 1 + r, gx = x0 - 4 + j;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
        tc::cp_async4(In + c * G::CS + r * G::RS + j,
                      ok ? xb + ((size_t)c * H + gy) * W + gx : xb, ok);
      }
    }
  };
  // slot s = (group s / 9, tap s % 9) into its ring stage, one commit group
  auto load_slot = [&](int s) {
    const int q = s / 9, tap = s % 9;
    if constexpr (!kImage) {
      if (tap == 0) load_group(q);
    }
    constexpr int PER_ROW = G::CHUNKS * 4;  // 16-byte pieces of a co row
    float* dst = Wr + (s % T::STAGES) * G::kSlot;
    const float* wt = w + (size_t)tap * C * G::KROW_W + q * G::CHUNKS * 16;
    for (int i = tid; i < C * PER_ROW; i += T::THREADS) {
      const int co = i / PER_ROW, j = i % PER_ROW;
      tc::cp_async16(dst + co * G::LDW + 4 * j, wt + co * G::KROW_W + 4 * j, true);
    }
    tc::cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) load_slot(s);

  if constexpr (kImage) {
    // conv1a + ReLU at rows y0 - 1 .. y0 + TH, cols x0 - 1 .. x0 + TW, all
    // 64 channels, from the image at rows y0 - 2 .., cols x0 - 2 ..
    constexpr int IW = T::TW + 4, CW = T::TW + 2, P = T::ROWS * CW;
    float* I = Wr + T::STAGES * G::kSlot;  // [TH + 4][IW]
    float* W1 = I + (T::TH + 4) * IW;      // [64][9]
    float* B1 = W1 + C * 9;
    for (int i = tid; i < (T::TH + 4) * IW; i += T::THREADS) {
      const int gy = y0 - 2 + i / IW, gx = x0 - 2 + i % IW;
      I[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? xb[(size_t)gy * W + gx]
                                                      : 0.f;
    }
    for (int i = tid; i < C * 9; i += T::THREADS) W1[i] = w1a[i];
    if (tid < C) B1[tid] = b1a[tid];
    __syncthreads();
    for (int i = tid; i < 4 * P; i += T::THREADS) {  // 16 channels an item
      const int c0 = 16 * (i / P), p = i % P, r = p / CW, cc = p % CW;
      const int gy = y0 - 1 + r, gx = x0 - 1 + cc;
      const int at = r * G::RS + cc + G::LPAD - 1;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float v[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        v[tap] = in ? I[(r + tap / 3) * IW + cc + tap % 3] : 0.f;
      float* dst = In + c0 * G::CS + at;
      if (!in) {
#pragma unroll
        for (int k = 0; k < 16; ++k) dst[k * G::CS] = 0.f;
        continue;
      }
#pragma unroll 4
      for (int k = 0; k < 16; ++k) {
        const float* wk = W1 + (c0 + k) * 9;
        float s = 0.f;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) s = fmaf(wk[tap], v[tap], s);
        dst[k * G::CS] = fmaxf(s + B1[c0 + k], 0.f);
      }
    }
  }

  // this warp's two m16 tiles: m-tile i = 2 warp + mt is the 2 x 8 patch at
  // rows 2 (i / MTW) .., cols 8 (i % MTW) ..; its A fragments at tap (dy,
  // dx) start at In[plane][2 rp + dy][8 cb + g + LPAD - 1 + dx]
  int aoff[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int i = 2 * warp + mt;
    aoff[mt] = 2 * (i / T::MTW) * G::RS + 8 * (i % T::MTW) + g + G::LPAD - 1;
  }
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  // one commit group a slot (empty past the last), so that waiting for all
  // but the STAGES - 2 youngest groups waits for slot s
  for (int s = 0; s < T::SLOTS; ++s) {
    tc::cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // slot s (and its input group) landed for every
                      // thread; every read of slot s - 1's stage is done,
                      // so slot s + STAGES - 1 may overwrite it
    const int q = s / 9, tap = s % 9;
    const int plane0 = q * T::QC;
    const float* As = In + (plane0 + t) * G::CS + (tap / 3) * G::RS + tap % 3;
    const float* Ws = Wr + (s % T::STAGES) * G::kSlot + g * G::LDW + 4 * t;
#pragma unroll
    for (int kc = 0; kc < G::CHUNKS; ++kc) {
      if (kc == G::LOAD_AT) {
        if (s + T::STAGES - 1 < T::SLOTS) load_slot(s + T::STAGES - 1);
        else tc::cp_async_commit();
      }
      // a0 (pixel g, channel t), a1 (pixel g + 8: the row below), a2
      // (g, t + 4), a3 (g + 8, t + 4), split as they are read
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = As + 8 * kc * G::CS + aoff[mt];
        tc::split_tf32(p[0], ab[mt][0], as[mt][0]);
        tc::split_tf32(p[G::RS], ab[mt][1], as[mt][1]);
        tc::split_tf32(p[4 * G::CS], ab[mt][2], as[mt][2]);
        tc::split_tf32(p[4 * G::CS + G::RS], ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        // b0 (ci t, co 8 nt + g), b1 (ci t + 4, co 8 nt + g), big and small
        const float4 bv = *reinterpret_cast<const float4*>(
            Ws + 8 * nt * G::LDW + 16 * kc);
        const uint32_t bb[2] = {__float_as_uint(bv.x), __float_as_uint(bv.y)};
        const uint32_t bs[2] = {__float_as_uint(bv.z), __float_as_uint(bv.w)};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          tc::mma3(acc[mt][nt], ab[mt], as[mt], bb, bs);
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // every read of In is done: the epilogue stages there

  // acc[mt][nt]: channels 8 nt + 2t (0, 2) and + 1 (1, 3) at pixel (2 rp,
  // 8 cb + g) (0, 1) and the one below it (2, 3)
  float* S = In;
  float* ob;
  int Ho, Wo, oy0, ox0;
  if constexpr (kPool) {
    Ho = H / 2, Wo = W / 2, oy0 = y0 / 2, ox0 = x0 / 2;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int i = 2 * warp + mt;
      const int idx = (i / T::MTW) * (T::TW / 2) + 4 * (i % T::MTW) + g / 2;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float m0 = fmaxf(acc[mt][nt][0], acc[mt][nt][2]);
        float m1 = fmaxf(acc[mt][nt][1], acc[mt][nt][3]);
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
        if ((g & 1) == 0) {
          const int co = 8 * nt + 2 * t;
          S[co * T::PCS + idx] = fmaxf(m0 + bias[co], 0.f);
          S[(co + 1) * T::PCS + idx] = fmaxf(m1 + bias[co + 1], 0.f);
        }
      }
    }
  } else {
    Ho = H, Wo = W, oy0 = y0, ox0 = x0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int i = 2 * warp + mt;
      const int p0 = 2 * (i / T::MTW) * T::TW + 8 * (i % T::MTW) + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int co = 8 * nt + 2 * t;
        const float b0 = bias[co], b1 = bias[co + 1];
        S[co * T::FCS + p0] = fmaxf(acc[mt][nt][0] + b0, 0.f);
        S[(co + 1) * T::FCS + p0] = fmaxf(acc[mt][nt][1] + b1, 0.f);
        S[co * T::FCS + p0 + T::TW] = fmaxf(acc[mt][nt][2] + b0, 0.f);
        S[(co + 1) * T::FCS + p0 + T::TW] = fmaxf(acc[mt][nt][3] + b1, 0.f);
      }
    }
  }
  __syncthreads();
  // the staged (R, CW) tile of each channel to out rows oy0 .., cols ox0 ..
  constexpr int R = kPool ? T::TH / 2 : T::TH, CW = kPool ? T::TW / 2 : T::TW;
  constexpr int SCS = kPool ? T::PCS : T::FCS;
  ob = out + (size_t)b * C * Ho * Wo;
  if ((Wo & 3) == 0) {
    constexpr int V = CW / 4;
    for (int i = tid; i < C * R * V; i += T::THREADS) {
      const int co = i / (R * V), r = i % (R * V) / V, j = i % V;
      const int oy = oy0 + r, ox = ox0 + 4 * j;
      if (oy < Ho && ox < Wo) {
        *reinterpret_cast<float4*>(ob + ((size_t)co * Ho + oy) * Wo + ox) =
            *reinterpret_cast<const float4*>(S + co * SCS + r * CW + 4 * j);
      }
    }
  } else {
    for (int i = tid; i < C * R * CW; i += T::THREADS) {
      const int co = i / (R * CW), r = i % (R * CW) / CW, j = i % CW;
      const int oy = oy0 + r, ox = ox0 + j;
      if (oy < Ho && ox < Wo) {
        ob[((size_t)co * Ho + oy) * Wo + ox] = S[co * SCS + r * CW + j];
      }
    }
  }
}

// One launch of conv_tc_kernel<T, kImage, kPool> on B images of H x W.
template <class T, bool kImage, bool kPool>
cudaError_t launch(const float* src, const float* w1a, const float* b1a,
                   const float* w, const float* bias, float* out, int B, int H,
                   int W, cudaStream_t stream) {
  auto* kern = conv_tc_kernel<T, kImage, kPool>;
  const size_t smem = Geo<T>::bytes(kImage);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(W, T::TW), cdiv(H, T::TH), B);
  kern<<<grid, T::THREADS, smem, stream>>>(src, w1a, b1a, w, bias, out, H, W);
  return cudaGetLastError();
}

}  // namespace conv
}  // namespace lg
