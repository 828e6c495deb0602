// B10: ALIKED's block 1 and its two consumers in one pass, fp32:
// conv3x3 3 -> C1 + BN + SELU, conv3x3 C1 -> C1 + BN + SELU (x1), then the
// aggregation branch y1 = SELU(1x1 C1 -> CY of x1) and the pooled map
// x1p = 2x2 average of x1. x1 itself never reaches device memory.
//
// Replaces the TPU kernel lightglue_tpu/ops/aliked_stem.py::
// _aliked_stem_kernel (fused_aliked_stem): image (B, 3, H, W) NCHW ->
// y1 (B, H, W, CY) channels-last and x1p (B, C1, H/2, W/2) NCHW. Both convs
// zero-pad their own input, so conv1 values outside the image are 0.
// (C1, CY) is (8, 16) (aliked-t16) or (16, 32) (the other models), as
// compile-time widths.
//
// What bounds it on an H100: at C1 16 a pixel takes 432 + 2304 + 512
// multiply-adds, 10.2 GFLOP at B 2 and 768 x 1024: 0.0619 ms as 3xTF32 on
// the tensor cores (three tf32 products a product at 495 TFLOP/s), against
// 0.0733 ms for the bytes (12 B in, 144 B out a pixel; y1 is 82 % of them).
// It runs in about 3.4x that: a block's conv1, conv2 and epilogue take
// their turns, and two blocks an SM overlap them only in part
// (scripts/extract_study.py's probes cut each out).
//
// Design. An implicit GEMM for conv2 on tc.cuh's 3xTF32 mma.sync m16n8k8
// tiles: M the output pixels, N the C1 channels (two n8 tiles at C1 16),
// K 9 taps x C1. An m16 tile takes its pixels as a 2 x 8 patch, so the
// accumulator's rows g and g + 8 are vertical neighbours and lane ^ 4 the
// horizontal one: the 2x2 average pool is formed in registers. A warp owns
// MT m16 tiles side by side (a 2-row strip).
//  - conv1 (3 -> C1, 7 % of the products) stays on the CUDA cores: each
//    thread computes a run of VP staged positions down one column, each
//    weight (bn1's scale folded in) read once for the run (broadcast
//    float4s from shared memory), and writes BN + SELU into the staged tile
//    with its 1-pixel ring, 0 outside the image. It splits each value
//    there, once, into tf32 big and small parts: an A fragment here feeds
//    only C1 / 8 n8 tiles, so a split on every read costs about as much as
//    the products it feeds.
//  - The staged tile is pixel-major: a pixel's channels as C1 / 2 quads
//    {big c, small c, big c + 4, small c + 4} (c = 8 kc + t), so that one
//    16-byte read is a lane's two A values of a row, both parts. The quads
//    of a pixel are rotated by its column (slot()), so that the 8 lanes of
//    a quarter warp read, and conv1's lanes write, 8 distinct bank groups.
//  - The weights are prepared once per tree (ops/aliked_stem.py::prepare),
//    conv2's and the 1x1's laid out as each lane's float4 B fragment {big,
//    big, small, small}, and copied to shared memory whole (cp.async),
//    conv2's while conv1 runs.
//  - BN + SELU on conv2's accumulators, the pool, then the 1x1 branch as a
//    second product on the same tiles, fed from the accumulators with no
//    trip through shared memory: a C fragment holds channels 2t and 2t + 1
//    of each n8 tile where an A fragment wants columns t and t + 4, so the
//    prepared 1x1 weights have their K rows permuted (channel 2t to column
//    t, 2t + 1 to t + 4) and the registers are the A fragment as they are,
//    split once for all CY / 8 n tiles.
//  - Stores: each warp stages its m16 tile's y1 (16 pixels x CY) in shared
//    memory and writes two rows of 8 whole pixels (8 x CY x 4 contiguous
//    bytes) as float4s; x1p goes the same way, its strip as NCHW rows.
// Every output is written by one block, with no atomics: a result repeats
// to the bit.
//
// The bf16 form (lg_aliked_stem_bf16; the TPU kernel at mp=True,
// lightglue_tpu/ops/aliked_stem.py:75-141): a bf16 image in, y1 and x1p
// bf16 out, rounded where _aliked_stem_kernel rounds, is a kernel of its
// own designed for Hopper, aliked_wgmma.cuh: persistent blocks walking
// strips, conv1, conv2 and the 1x1 on wgmma, the weights resident, image
// rows by TMA.
#include <cstring>

#include "aliked_wgmma.cuh"
#include "tc.cuh"

namespace {

namespace tc = lg::tc;

constexpr float kAlpha = 1.6732632423543772848170429916717f;
constexpr float kScale = 1.0507009873554804934193349852946f;

// SELU's negative side: expm1f, or the exp form exp(x) - 1 (the TPU
// kernel's; scripts/extract_study.py measures both against float64)
constexpr bool kExpForm = true;

// 2^x by one MUFU.EX2 (denormal results flushed to 0; __expf adds a range
// fix-up of three instructions for them, which SELU does not need)
__device__ __forceinline__ float ex2(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
#endif
}

__device__ __forceinline__ float selu(float x) {
  constexpr float kSA = kScale * kAlpha;
  const float n = fminf(x, 0.f);  // one exp a value, of its negative side
  if constexpr (kExpForm)
    return x > 0.f ? kScale * x : fmaf(kSA, ex2(n * 1.4426950408889634f), -kSA);
  else
    return x > 0.f ? kScale * x : kSA * expm1f(n);
}

// conv1 writes its outputs split into tf32 big and small parts (quads
// {big c, small c, big c + 4, small c + 4}), or plain as pairs {c, c + 4}
// that conv2 splits as it reads them (scripts/extract_study.py)
constexpr bool kSplitOnce = true;
// conv2's products summed in place in the mma's accumulator (K = 9 C1 =
// 144), or each 8-deep step in a zeroed register tile, then added in fp32
constexpr bool kStepSums = false;
// conv2's loop over the three rows of taps stays a loop (1): unrolled (3),
// the A fragments the compiler hoists spill at 128 registers
// (scripts/extract_study.py); the taps of a row are always unrolled
constexpr int kRowUnroll = 1;

template <int C1_, int CY_, int TH_, int TW_, int MT_, int VP_>
struct StemTile {
  static constexpr int C1 = C1_, CY = CY_, TH = TH_, TW = TW_, MT = MT_,
                       VP = VP_;
  static constexpr int KC = C1 / 8;               // 8-deep chunks of C1
  static constexpr int NTY = CY / 8;              // n8 tiles of the 1x1
  static constexpr int MTW = TW / 8;              // m16 tiles across
  static constexpr int WARPS = TH / 2 * MTW / MT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int AR = TH + 2, AC = TW + 2;  // staged rows y0 - 1 .., cols x0 - 1 ..
  static constexpr int PX = kSplitOnce ? 2 * C1 : C1;  // floats a pixel
  static constexpr int IR = TH + 4, IC = TW + 4;  // image rows y0 - 2 .., cols x0 - 2 ..
  static constexpr int YS = CY + 8;               // y1 staging: a pixel (8 or 24 mod 32)
  static constexpr int PS = 4 * MT + 4;           // x1p staging: a channel's row
  static constexpr int kStage = 16 * YS + C1 * PS;
  // the staged tile, and the epilogue's staging over it
  static constexpr int kA = AR * AC * PX > WARPS * kStage ? AR * AC * PX : WARPS * kStage;
  static constexpr int kI = 3 * IR * IC;
  static constexpr int kW2 = 9 * KC * KC * 128;   // [tap][kc][nt][lane][4]
  static constexpr int kWY = KC * NTY * 128;      // [kk][n][lane][4]
  static constexpr int kK1 = 30 * C1;             // conv1 x s1 [ci dy dx][co], b1, s2, b2
  static constexpr size_t bytes() { return (size_t)(kA + kI + kW2 + kWY + kK1) * sizeof(float); }
  static_assert(C1 == 8 || C1 == 16, "C1 8 or 16");
  static_assert(TH % 2 == 0 && TW % 8 == 0 && MTW % MT == 0, "whole strips");
  static_assert(AR % VP == 0, "conv1's column runs tile the staged rows");
  static_assert(YS % 32 == 8 || YS % 32 == 24, "y1 staging banks");
};

// The tiles (scripts/extract_study.py): 16 x 32 outputs, 8 warps of four
// m16 tiles, two blocks an SM at C1 16.
using TileN16 = StemTile<16, 32, 16, 32, 4, 3>;
using TileT16 = StemTile<8, 16, 16, 32, 4, 3>;

// blocks of 256 threads an SM that the registers must allow (two: the
// staged tile of a split-once 16 x 32 tile holds the shared memory to two)
constexpr int kBlocksPerSM = 2;

// the quad slot of channels (8 kc + t, + 4) at staged column col: a
// rotation by the column, so that 8 consecutive columns (conv1's writes)
// and 2 columns x 4 t (an A read's quarter warp) take distinct bank groups
template <int C1>
__host__ __device__ __forceinline__ int slot(int kc, int t, int col) {
  if constexpr (C1 == 16) return (2 * t + kc + col) & 7;  // 128 B a pixel
  else return (t + (col >> 1)) & 3;                       // 64 B a pixel
}

// the pair slot of channels (8 kc + t, + 4) when conv2 splits on read: 16
// lanes (4 columns x 4 t) of a 64-bit read on 16 distinct bank pairs
template <int C1>
__host__ __device__ __forceinline__ int pair_slot(int kc, int t, int col) {
  if constexpr (C1 == 16) return t + 4 * (kc ^ ((col >> 1) & 1));  // 64 B a pixel
  else return t;                                                    // 32 B a pixel
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::THREADS > kBlocksPerSM * 256
                                                  ? 1 : kBlocksPerSM * 256 / T::THREADS)
    aliked_stem_tc_kernel(const float* __restrict__ img,  // (B, 3, H, W)
                          const float* __restrict__ k1,   // conv1 and both BNs
                          const float4* __restrict__ w2,  // [tap][kc][nt][lane]
                          const float4* __restrict__ wy,  // [kk][n][lane]
                          float* __restrict__ y1,         // (B, H, W, CY)
                          float* __restrict__ xp,         // (B, C1, H/2, W/2)
                          int H, int W) {
  constexpr int C1 = T::C1, CY = T::CY, KC = T::KC;
  extern __shared__ __align__(16) float lg_smem[];
  float* A = lg_smem;           // [AR][AC] pixels of PX floats
  float* I = A + T::kA;         // [3][IR][IC]
  float* W2 = I + T::kI;        // conv2's B fragments
  float* WY = W2 + T::kW2;      // the 1x1's B fragments
  float* K1 = WY + T::kWY;      // conv1's weights x s1 [ci dy dx][co], b1, s2, b2
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, y0 = blockIdx.y * T::TH, x0 = blockIdx.x * T::TW;

  // conv1's weights and the image tile (0 outside the image) first, one
  // commit group, then conv2's and the 1x1's weights, which land while
  // conv1 runs; all by cp.async, so no thread waits on a load alone
  for (int i = tid; i < T::kK1 / 4; i += T::THREADS)
    tc::cp_async16(K1 + 4 * i, k1 + 4 * i, true);
  const float* im = img + (size_t)b * 3 * H * W;
  for (int i = tid; i < T::kI; i += T::THREADS) {
    const int c = i / (T::IR * T::IC), r = i / T::IC % T::IR, cc = i % T::IC;
    const int gy = y0 - 2 + r, gx = x0 - 2 + cc;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    tc::cp_async4(I + i, ok ? im + ((size_t)c * H + gy) * W + gx : im, ok);
  }
  tc::cp_async_commit();
  for (int i = tid; i < (T::kW2 + T::kWY) / 4; i += T::THREADS)
    tc::cp_async16(W2 + 4 * i,
                   reinterpret_cast<const float*>(i < T::kW2 / 4 ? w2 + i : wy + (i - T::kW2 / 4)),
                   true);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();
  __syncthreads();

  // conv1 + BN + SELU at staged rows r0 .. r0 + VP - 1 of column cc, split
  for (int i = tid; i < T::AR / T::VP * T::AC; i += T::THREADS) {
    const int r0 = i / T::AC * T::VP, cc = i % T::AC;
    float acc[T::VP][C1];
    const float* b1 = K1 + 27 * C1;  // bn1's bias (its scale is in the weights)
#pragma unroll
    for (int co = 0; co < C1; ++co) {
      const float bias = b1[co];
#pragma unroll
      for (int v = 0; v < T::VP; ++v) acc[v][co] = bias;
    }
    // each weight once, for the VP positions of the run
#pragma unroll
    for (int k = 0; k < 27; ++k) {  // k = (ci, dy, dx)
      const int ci = k / 9, dy = k / 3 % 3, dx = k % 3;
      float w[C1];
#pragma unroll
      for (int q = 0; q < C1 / 4; ++q) {
        const float4 w4 = reinterpret_cast<const float4*>(K1 + k * C1)[q];
        w[4 * q] = w4.x, w[4 * q + 1] = w4.y, w[4 * q + 2] = w4.z, w[4 * q + 3] = w4.w;
      }
#pragma unroll
      for (int v = 0; v < T::VP; ++v) {
        const float x = I[(ci * T::IR + r0 + v + dy) * T::IC + cc + dx];
#pragma unroll
        for (int co = 0; co < C1; ++co) acc[v][co] = fmaf(w[co], x, acc[v][co]);
      }
    }
    const int gx = x0 - 1 + cc;
#pragma unroll
    for (int v = 0; v < T::VP; ++v) {
      const int r = r0 + v, gy = y0 - 1 + r;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float* px = A + (r * T::AC + cc) * T::PX;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 8 * kc + q;
          const float v0 = in ? selu(acc[v][c]) : 0.f;
          const float v4 = in ? selu(acc[v][c + 4]) : 0.f;
          if constexpr (kSplitOnce) {
            uint32_t b0, s0, b4, s4;
            tc::split_tf32(v0, b0, s0);
            tc::split_tf32(v4, b4, s4);
            *reinterpret_cast<float4*>(px + 4 * slot<C1>(kc, q, cc)) =
                make_float4(__uint_as_float(b0), __uint_as_float(s0),
                            __uint_as_float(b4), __uint_as_float(s4));
          } else {
            *reinterpret_cast<float2*>(px + 2 * pair_slot<C1>(kc, q, cc)) =
                make_float2(v0, v4);
          }
        }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // this warp's m16 tiles: i = MT warp + m, the 2 x 8 patches at tile rows
  // 2 rp .., cols 8 (cb0 + m) ..; lane (g, t) reads staged column 8 cb + g
  // + dx (its slot depends on g + dx only: 8 cb is a multiple of 8)
  const int rp = T::MT * warp / T::MTW, cb0 = T::MT * warp % T::MTW;
  constexpr int QS = T::PX / (kSplitOnce ? 4 : 2);  // quads or pairs a pixel
  int abase[T::MT];
#pragma unroll
  for (int m = 0; m < T::MT; ++m) abase[m] = (2 * rp * T::AC + 8 * (cb0 + m) + g) * QS;
  float acc[T::MT][KC][4];
#pragma unroll
  for (int m = 0; m < T::MT; ++m)
#pragma unroll
    for (int nt = 0; nt < KC; ++nt)
      acc[m][nt][0] = acc[m][nt][1] = acc[m][nt][2] = acc[m][nt][3] = 0.f;
  const float4* W24 = reinterpret_cast<const float4*>(W2);
#pragma unroll kRowUnroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = 3 * dy + dx;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        float4 bq[KC];
#pragma unroll
        for (int nt = 0; nt < KC; ++nt) bq[nt] = W24[((tap * KC + kc) * KC + nt) * 32 + lane];
        const int sl = kSplitOnce ? slot<C1>(kc, t, g + dx) : pair_slot<C1>(kc, t, g + dx);
#pragma unroll
        for (int m = 0; m < T::MT; ++m) {
          const int up = abase[m] + (dy * T::AC + dx) * QS + sl, lo = up + T::AC * QS;
          uint32_t ab[4], as[4];  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
          if constexpr (kSplitOnce) {
            const float4 u = reinterpret_cast<const float4*>(A)[up];
            const float4 l = reinterpret_cast<const float4*>(A)[lo];
            ab[0] = __float_as_uint(u.x), as[0] = __float_as_uint(u.y);
            ab[1] = __float_as_uint(l.x), as[1] = __float_as_uint(l.y);
            ab[2] = __float_as_uint(u.z), as[2] = __float_as_uint(u.w);
            ab[3] = __float_as_uint(l.z), as[3] = __float_as_uint(l.w);
          } else {
            const float2 u = reinterpret_cast<const float2*>(A)[up];
            const float2 l = reinterpret_cast<const float2*>(A)[lo];
            tc::split_tf32(u.x, ab[0], as[0]);
            tc::split_tf32(l.x, ab[1], as[1]);
            tc::split_tf32(u.y, ab[2], as[2]);
            tc::split_tf32(l.y, ab[3], as[3]);
          }
#pragma unroll
          for (int nt = 0; nt < KC; ++nt) {
            const uint32_t bb[2] = {__float_as_uint(bq[nt].x), __float_as_uint(bq[nt].y)};
            const uint32_t bs[2] = {__float_as_uint(bq[nt].z), __float_as_uint(bq[nt].w)};
            if constexpr (kStepSums) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              tc::mma3(d, ab, as, bb, bs);
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[m][nt][j] += d[j];
            } else {
              tc::mma3(acc[m][nt], ab, as, bb, bs);
            }
          }
        }
      }
    }
  }
  __syncthreads();  // every read of A is done: the epilogue stages there

  // acc[m][nt]: channels 8 nt + 2t (0, 2) and + 1 (1, 3) at pixel (2 rp,
  // 8 cb + g) (0, 1) and the one below it (2, 3)
  float* Ys = A + warp * T::kStage;  // [16 pixels][YS]
  float* Ps = Ys + 16 * T::YS;       // [C1][PS]: the strip's pooled row
  // bn2 of this lane's channels 8 nt + 2t + e
  float s2[KC][2], b2[KC][2];
#pragma unroll
  for (int nt = 0; nt < KC; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s2[nt][e] = K1[28 * C1 + 8 * nt + 2 * t + e];
      b2[nt][e] = K1[29 * C1 + 8 * nt + 2 * t + e];
    }
  const float4* WY4 = reinterpret_cast<const float4*>(WY);
  const int gy0 = y0 + 2 * rp;
#pragma unroll
  for (int m = 0; m < T::MT; ++m) {  // unrolled: acc stays in registers
    float x[KC][4];
#pragma unroll
    for (int nt = 0; nt < KC; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[nt][j] = selu(fmaf(acc[m][nt][j], s2[nt][j & 1], b2[nt][j & 1]));
    // 2x2 average: rows g and g + 8, then lanes g and g ^ 1
#pragma unroll
    for (int nt = 0; nt < KC; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = x[nt][e] + x[nt][e + 2];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        if ((g & 1) == 0) Ps[(8 * nt + 2 * t + e) * T::PS + 4 * m + (g >> 1)] = v * 0.25f;
      }
    // y1 = SELU(wy . x1): the accumulators as A fragments (K permuted)
    float ya[T::NTY][4];
#pragma unroll
    for (int n = 0; n < T::NTY; ++n) ya[n][0] = ya[n][1] = ya[n][2] = ya[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t ab[4], as[4];
      tc::split_tf32(x[kk][0], ab[0], as[0]);
      tc::split_tf32(x[kk][2], ab[1], as[1]);
      tc::split_tf32(x[kk][1], ab[2], as[2]);
      tc::split_tf32(x[kk][3], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < T::NTY; ++n) {
        const float4 wq = WY4[(kk * T::NTY + n) * 32 + lane];
        const uint32_t bb[2] = {__float_as_uint(wq.x), __float_as_uint(wq.y)};
        const uint32_t bs[2] = {__float_as_uint(wq.z), __float_as_uint(wq.w)};
        tc::mma3(ya[n], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < T::NTY; ++n) {
      const int c = 8 * n + 2 * t;
      *reinterpret_cast<float2*>(Ys + g * T::YS + c) = make_float2(selu(ya[n][0]), selu(ya[n][1]));
      *reinterpret_cast<float2*>(Ys + (8 + g) * T::YS + c) = make_float2(selu(ya[n][2]), selu(ya[n][3]));
    }
    __syncwarp();
    // two rows of 8 whole pixels, CY / 4 float4s each
    const int gx0 = x0 + 8 * (cb0 + m);
    for (int e = lane; e < 16 * (CY / 4); e += 32) {
      const int px = e / (CY / 4), q = e % (CY / 4);
      const int gy = gy0 + (px >> 3), gx = gx0 + (px & 7);
      if (gy < H && gx < W)
        *reinterpret_cast<float4*>(y1 + (((size_t)b * H + gy) * W + gx) * CY + 4 * q) =
            *reinterpret_cast<const float4*>(Ys + px * T::YS + 4 * q);
    }
    __syncwarp();
  }
  // the strip's pooled row: C1 rows of 4 MT floats
  const int Ho = H / 2, Wo = W / 2, oy = gy0 / 2, ox0 = (x0 + 8 * cb0) / 2;
  if (oy < Ho) {
    if ((Wo & 3) == 0) {
      for (int e = lane; e < C1 * T::MT; e += 32) {
        const int c = e / T::MT, q = e % T::MT, ox = ox0 + 4 * q;
        if (ox < Wo)
          *reinterpret_cast<float4*>(xp + (((size_t)b * C1 + c) * Ho + oy) * Wo + ox) =
              *reinterpret_cast<const float4*>(Ps + c * T::PS + 4 * q);
      }
    } else {
      for (int e = lane; e < C1 * 4 * T::MT; e += 32) {
        const int c = e / (4 * T::MT), j = e % (4 * T::MT), ox = ox0 + j;
        if (ox < Wo) xp[(((size_t)b * C1 + c) * Ho + oy) * Wo + ox] = Ps[c * T::PS + j];
      }
    }
  }
}

template <class T>
cudaError_t launch(const float* img, const float* k1, const float* w2,
                   const float* wy, float* y1, float* xp, int B, int H, int W,
                   cudaStream_t stream) {
  auto* kern = aliked_stem_tc_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::bytes());
  if (err != cudaSuccess) return err;
  const dim3 grid((W + T::TW - 1) / T::TW, (H + T::TH - 1) / T::TH, B);
  kern<<<grid, T::THREADS, T::bytes(), stream>>>(
      img, k1, reinterpret_cast<const float4*>(w2),
      reinterpret_cast<const float4*>(wy), y1, xp, H, W);
  return cudaGetLastError();
}

}  // namespace

// img (B, 3, H, W); k1, w2, wy: ops/aliked_stem.py::prepare's conv1
// weights with bn1's scale folded in [ci dy dx][co] (27 C1), bn1's bias and
// bn2's scale and bias (C1 each), and conv2's and the 1x1's B fragments; y1 (B,
// H, W, CY); xp (B, C1, H/2, W/2). H, W even; (C1, CY) (8, 16) or (16, 32).
extern "C" cudaError_t lg_aliked_stem(const float* img, const float* k1,
                                      const float* w2, const float* wy,
                                      float* y1, float* xp, int B, int H,
                                      int W, int C1, int CY,
                                      cudaStream_t stream) {
  if (C1 == 16 && CY == 32)
    return launch<TileN16>(img, k1, w2, wy, y1, xp, B, H, W, stream);
  if (C1 == 8 && CY == 16)
    return launch<TileT16>(img, k1, w2, wy, y1, xp, B, H, W, stream);
  return cudaErrorInvalidValue;
}

// The bf16 form's tensor map of img (B, 3, H, Wp) bf16, Wp a multiple of 8
// and img 16-byte aligned, into the 128 bytes at map (aliked_wgmma.cuh's
// image_map); the stream is not used.
extern "C" cudaError_t lg_aliked_stem_bf16_map(void* map,
                                               const lg::tc::bf16* img, int B,
                                               int H, int Wp, cudaStream_t) {
  CUtensorMap m;
  const cudaError_t err = lg::awg::image_map(&m, img, B, H, Wp);
  if (err == cudaSuccess) memcpy(map, &m, sizeof m);
  return err;
}

// The bf16 form: map lg_aliked_stem_bf16_map's of the image (B, 3, H, W)
// (its width padded to Wp); wts ops/aliked_stem.py::prepare_bf16's blob; y1
// (B, H, W, CY) and xp (B, C1, H/2, W/2) bf16; grid ops/conv_plan.py's
// persistent blocks (aliked_wgmma.cuh's PER_SM an SM).
extern "C" cudaError_t lg_aliked_stem_bf16(const void* map,
                                           const lg::tc::bf16* wts,
                                           lg::tc::bf16* y1, lg::tc::bf16* xp,
                                           int B, int H, int W, int C1, int CY,
                                           int grid, cudaStream_t stream) {
  CUtensorMap m;
  memcpy(&m, map, sizeof m);
  if (C1 == 16 && CY == 32)
    return lg::awg::launch<16>(m, wts, y1, xp, B, H, W, grid, stream);
  if (C1 == 8 && CY == 16)
    return lg::awg::launch<8>(m, wts, y1, xp, B, H, W, grid, stream);
  return cudaErrorInvalidValue;
}
