// B10's bf16 form on Hopper's warpgroup products: ALIKED's block 1 (conv3x3
// 3 -> C1 + BN + SELU, conv3x3 C1 -> C1 + BN + SELU = x1) and its two
// consumers, the aggregation branch y1 = SELU(1x1 C1 -> CY of x1) and the
// 2x2 average pool x1p, in one persistent launch (aliked_stem.cu's
// lg_aliked_stem_bf16). The fp32 form stays in aliked_stem.cu.
//
// What it computes is lightglue_tpu/ops/aliked_stem.py::_aliked_stem_kernel
// at mp=True, rounding where it rounds: conv1's fp32 sum -> bf16, x s1 ->
// bf16, + b1 -> bf16, SELU in fp32, stored bf16 (0 outside the image); conv2
// the same with x1 kept fp32; the 1x1 on round(x1), its sum rounded before
// its SELU, y1 bf16; the pool (round(upper) + lower) x 0.5, then the column
// pair's sum x 0.5, bf16. Only the order of the fp32 sums differs. The image
// (B, 3, H, W) is bf16 NCHW; y1 (B, H, W, CY) channels-last; x1p (B, C1, H/2,
// W/2) NCHW (block 2's cuDNN convs read it). (C1, CY) is (16, 32) or (8, 16).
//
// What bounds it on an H100: the bytes, 6 in and 72 out a pixel at C1 16
// (0.0366 ms at B 2, 768 x 1024); the 10.2 GFLOP take 0.0103 ms at 989
// TFLOP/s. Beside them the elementwise work that no bound counts: 64 SELUs
// a pixel (16 after conv1, 16 after conv2, 32 after the 1x1), each one
// MUFU.EX2 and a few FMA-pipe instructions, and the bf16 roundings.
//
// Design. Pixels are M (C1 channels cannot fill 64 rows); a pixel's C1
// channels are one row of a K-major tile without swizzle: 8-pixel groups
// of 16-byte rows (channels 8 kc .. 8 kc + 7) 128 bytes apart, the chunks
// kc one plane apart (LBO), so a tap is the same descriptor moved by whole
// 16-byte rows and nothing is copied.
// - Persistent blocks, three an SM, walk (image, 128-column strip, row pair)
//   units as conv_wgmma.cuh's Plan cuts them (ops/conv_plan.py mirrors it):
//   each conv1 row of a segment is computed once, only the side columns
//   repeat in the next strip.
// - Every weight (conv1's, conv2's, the 1x1's, the four BN vectors as bf16:
//   7.3 KB at C1 16) arrives by one bulk copy of prepare_bf16's blob and
//   stays in shared memory for the block's life.
// - A producer warpgroup: one thread keeps image rows in flight by TMA (a
//   3-d map over the NCHW image, box 144 columns x 3 channels from x0 - 8,
//   zeros outside it) into a ring of IMG_SLOTS; the warpgroup lays out a
//   conv1 row's taps (136 pixels x K = 9 (channel, dy) values padded to
//   16) and computes conv1 on the tensor cores, 3 wgmma m64nC1k16 a 64-
//   pixel tile (dx as the moved descriptor), then BN + SELU, rounding and
//   the image mask into the ring of R (8) staged rows (136 pixels from
//   x0 - 1; 130 written, the rest stay 0).
// - A consumer warpgroup takes the row pairs: conv2 as 2 rows x 2
//   tiles of 64 pixels, each 9 wgmma m64n16k16 (one a tap) at C1 16, or 6
//   m64n8k16 at C1 8 (taps (dy, 0) and (dy, 1) in one k-step: chunk 1 is
//   the next pixel, LBO 16 bytes; (dy, 2) with a zero partner). Then BN +
//   SELU in registers; the pool: the two rows are two accumulator sets,
//   the column pair lanes 4 apart (one shfl.xor 4); the 1x1 is one wgmma
//   m64nCYk16 a row with A from registers (conv2's rounded accumulators
//   are the A fragment as they lie; at C1 8 its upper half is 0): 2 %
//   faster than CY / 8 mma.sync m16n8k16 a warp (on an H100 at B 2,
//   scripts/aliked_wgmma_study.py). Its output channels are permuted in the
//   prepared weights so that a lane holds 8 (CY 32) or 4 (CY 16)
//   consecutive channels of a pixel: y1 goes out from registers as 16- or
//   8-byte stores, 512 contiguous bytes a warp. x1p goes through 2 KB of
//   swizzled staging as NCHW channel rows of the strip (64 pooled columns,
//   128 bytes) in 16-byte stores. A block's consumer epilogue runs beside
//   its producer's conv1 and the other two blocks' products: one producer
//   a consumer and three blocks an SM were 8 % faster than two consumers a
//   block and two blocks an SM, and setmaxnreg (72 / 88) 20 % faster than
//   none, which spills (the same study).
// - BN: round(round(round(acc) x s) + b) as one cvt.rn.bf16x2 and the
//   bf16x2 multiply and add (each one rounding, as the fp32 operation then
//   a rounding gives for bf16 operands); SELU as one ex2 and no branch.
// Every output is written by one block, no atomics: a result repeats to
// the bit.
#pragma once

#include "conv_wgmma.cuh"

namespace lg {
namespace awg {

using tc::bf16;
using wconv::Plan;

constexpr int STRIP = wconv::STRIP;  // output columns of a strip (128)
constexpr int RP = 136;              // pixels of a staged conv1 row: x0 - 1 + s
constexpr int READ_PX = STRIP + 2;   // the pixels conv1 writes (x0 - 1 .. x0 + 128)
// image columns a TMA box (x0 - 8 + j): a box row must start on a 16-byte
// boundary of the image row (an unaligned start is an illegal instruction)
constexpr int IMW = 144;
constexpr int TP = 136;              // pixels of a row's taps: x0 - 2 + c (column c + 6)
constexpr int kPlane = RP * 16;      // one 8-channel plane of a staged row
constexpr int kTapPlane = TP * 16;   // one 8-value plane of a row's taps
constexpr int kImgSlot = 896;        // a box: 3 channel rows of IMW bf16 (864 bytes)
constexpr int IMG_SLOTS = 8, IMG_AHEAD = 3;  // image rows in flight past the three read
constexpr int NCONS = 1;             // consumer warpgroups a block
constexpr int THREADS = 128 * (NCONS + 1);
constexpr int PER_SM = 3;            // blocks an SM (the plan's grid)
// setmaxnreg: within the registers a thread launches with (80 at 3 x 256)
constexpr int kProdRegs = 72, kConsRegs = 88;
static_assert(128 * kProdRegs + 128 * NCONS * kConsRegs <=
                  THREADS * (65536 / (THREADS * PER_SM) / 8 * 8),
              "registers");

// conv1's three 64-pixel tiles of a staged row start at pixels 0, 64 and
// 66 (the last writes only 128 and 129)
__host__ __device__ constexpr int tile1(int ti) { return ti == 0 ? 0 : ti == 1 ? 64 : 66; }

template <int C1_>
struct Geo {
  static constexpr int C1 = C1_, CY = 2 * C1, KC = C1 / 8;
  static constexpr int STEPS = C1 == 16 ? 9 : 6;  // conv2's k-steps
  static constexpr int R = 8;                     // staged rows in the ring
  static constexpr int kRow = KC * kPlane;
  // prepare_bf16's blob (bytes): conv1 [dx][chunk][co][8 (ci, dy)], conv2
  // [step][chunk][co][8 ci], the 1x1 [chunk][n][8 ci], then s1, b1, s2, b2
  static constexpr int oW1 = 0;
  static constexpr int oW2 = oW1 + 3 * 2 * C1 * 16;
  static constexpr int oWY = oW2 + STEPS * 2 * C1 * 16;
  static constexpr int oBN = oWY + 2 * CY * 16;
  static constexpr int kWeights = oBN + 128;
  // shared memory from a 128-byte boundary: the blob, the ring, a row's
  // taps, the image boxes, the consumers' x1p staging, the barriers
  static constexpr int oRing = kWeights;
  static constexpr int oTaps = oRing + R * kRow;
  static constexpr int oImg = oTaps + 2 * kTapPlane;
  static constexpr int kStage = C1 * 128;
  static constexpr int oStage = oImg + IMG_SLOTS * kImgSlot;
  static constexpr int oBar = oStage + NCONS * kStage;
  static constexpr int bytes = 128 + oBar + (2 * R + IMG_SLOTS + 1) * 8;
  static_assert(C1 == 8 || C1 == 16, "C1 8 or 16");
  static_assert(kWeights % 128 == 0 && kRow % 128 == 0 && oImg % 128 == 0 &&
                kImgSlot % 128 == 0 && oStage % 128 == 0, "aligned parts");
  static_assert(8 * C1 <= 128, "the BN vectors fit their 128 bytes");
  static_assert(PER_SM * bytes <= 228 * 1024, "PER_SM blocks an SM");
};

// A K-major tile without swizzle at p: 8-row groups of 16-byte rows 128
// bytes apart (SBO), 8-deep K chunks lbo bytes apart (LBO).
__device__ __forceinline__ uint64_t desc_k(const void* p, uint32_t lbo) {
  return (uint64_t)((wg::smem_addr(p) & 0x3ffff) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (N == 16) wg::mma_ss16(d, da, db, accumulate);
  else wg::mma_ss8(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) wg::mma_rs32(d, a, db, 0);
  else wg::mma_rs16(d, a, db, 0);
}

// 2^x by one MUFU.EX2 (denormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// SELU with the TPU kernel's exp(x) - 1, one ex2 and no branch: for x > 0
// the second term is kSA x 1 - kSA = 0 exactly
__device__ __forceinline__ float selu(float x) {
  constexpr float kScale = 1.0507009873554804934193349852946f;
  constexpr float kSA = kScale * 1.6732632423543772848170429916717f;
  const float e = ex2(fminf(x, 0.f) * 1.4426950408889634f);
  return fmaf(kScale, fmaxf(x, 0.f), fmaf(kSA, e, -kSA));
}

// Two sums (a0, a1) of channels c, c + 1: SELU(round(round(round(a) x s) +
// b)) with (s, b) the bf16x2 of those channels, as fp32. The multiply and
// the add carry an explicit .rn: without it ptxas may contract them into
// one fma.rn.bf16x2, which rounds once where the TPU kernel rounds twice
// (half the outputs one bf16 step off on an H100).
__device__ __forceinline__ void bn_selu2(float a0, float a1, uint32_t s,
                                         uint32_t b, float& v0, float& v1) {
  const uint32_t p = tc::pack_bf16(a0, a1);
  uint32_t m, u;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(m) : "r"(p), "r"(s));
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(u) : "r"(m), "r"(b));
  v0 = selu(__uint_as_float(u << 16));
  v1 = selu(__uint_as_float(u & 0xffff0000u));
}

// image (B, 3, H, W) bf16 (w = W: a multiple of 8, 16-byte aligned) read as
// (W, H, 3 B) in boxes of IMW columns x 1 row x 3 channels (16-byte
// aligned starts: x0 - 8)
inline cudaError_t image_map(CUtensorMap* map, const bf16* img, int B, int H,
                             int W) {
  const uint64_t dims[3] = {(uint64_t)W, (uint64_t)H, (uint64_t)3 * B};
  const uint64_t strides[2] = {(uint64_t)W * 2, (uint64_t)H * W * 2};
  const uint32_t box[3] = {IMW, 1, 3};
  return wg::bf16_map(map, img, 3, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
}

// y1, x1p of the (B, 3, H, W) bf16 image read through `map` (its width
// padded to a multiple of 8 past W with zeros, or W itself): wts
// prepare_bf16's blob; H, W even.
template <int C1>
__global__ void __launch_bounds__(THREADS, PER_SM)
    aliked_wg_kernel(const __grid_constant__ CUtensorMap map,
                     const bf16* __restrict__ wts, bf16* __restrict__ y1,
                     bf16* __restrict__ xp, int B, int H, int W) {
  using G = Geo<C1>;
  constexpr int R = G::R, KC = G::KC, CY = G::CY;
  extern __shared__ unsigned char lg_awg_smem[];
  unsigned char* base =
      lg_awg_smem + ((128 - (wg::smem_addr(lg_awg_smem) & 127)) & 127);
  unsigned char* Ws = base;
  unsigned char* ring = base + G::oRing;
  unsigned char* taps = base + G::oTaps;
  unsigned char* img = base + G::oImg;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + G::oBar);
  uint64_t* empty = full + R;
  uint64_t* ifull = empty + R;
  uint64_t* wbar = ifull + IMG_SLOTS;
  const Plan plan(B, H, W);
  const long long u0 = plan.first(blockIdx.x, gridDim.x);
  const long long u1 = plan.first(blockIdx.x + 1, gridDim.x);
  if (u0 == u1) return;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) {
      wg::bar_init(&full[s], 128);     // the producer's threads
      wg::bar_init(&empty[s], 4 * 2);  // two pairs' four warps
    }
    for (int s = 0; s < IMG_SLOTS; ++s) wg::bar_init(&ifull[s], 1);
    wg::bar_init(wbar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  if (wgi == NCONS) {  // the producer
    wg::regs_dec<kProdRegs>();
    if (tid == 0) {  // the weights, once; the map
      wg::prefetch_map(&map);
      wg::bar_expect(wbar, G::kWeights);
      wg::bulk_load(Ws, wts, G::kWeights, wbar);
    }
    // the ring's and the taps' pixels that no row writes stay 0: finite
    // for the products that read past the written ones
    for (int i = tid; i < (R * G::kRow + 2 * kTapPlane) / 16; i += 128)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
    wg::bar_wait(wbar, 0);
    // bn1 of the thread's channels 8 j + 2t, + 1 (bf16x2)
    uint32_t s1[KC], b1[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      s1[j] = *reinterpret_cast<const uint32_t*>(Ws + G::oBN + 2 * (8 * j + 2 * t));
      b1[j] = *reinterpret_cast<const uint32_t*>(Ws + G::oBN + 2 * (C1 + 8 * j + 2 * t));
    }
    // descriptors of the taps from pixel 0 and of tap column 0's weights:
    // a pixel or a tap column further is a constant added (16-byte units)
    const uint64_t dtaps = desc_k(taps, kTapPlane), dw1 = desc_k(Ws + G::oW1, 16 * C1);
    int k = 0, ib = 0;  // staged rows filled; image rows loaded
    for (long long u = u0; u < u1;) {
      const int col = (int)(u / plan.P), q0 = (int)(u % plan.P);
      const int q1 = (int)min((long long)plan.P, q0 + (u1 - u));
      const int b = col / plan.S, x0 = (col % plan.S) * STRIP;
      const int ra = 2 * q0 - 1, nr = 2 * (q1 - q0) + 2;  // conv1 rows ra ..
      int issued = 0;  // image rows ra - 1 + i of the segment, in slot (ib + i) % IMG_SLOTS
#pragma unroll 1
      for (int l = 0; l < nr; ++l, ++k) {
        // every thread is done with row l - 1: its image rows and taps read
        wg::named_sync(3, 128);
        if (tid == 0)
          for (; issued < min(nr + 2, l + 3 + IMG_AHEAD); ++issued) {
            const int n = ib + issued, s = n % IMG_SLOTS;
            wg::bar_expect(&ifull[s], 3 * IMW * 2);
            wg::tma_load3(img + s * kImgSlot, &map, &ifull[s], x0 - 8,
                          ra - 1 + issued, 3 * b);
          }
        // image rows l .. l + 2 (rows r - 1 .. r + 1); each loaded row is
        // waited for before its slot is loaded again
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int n = ib + l + i;
          wg::bar_wait(&ifull[n % IMG_SLOTS], (n / IMG_SLOTS) & 1);
        }
        const int r = ra + l, s = k % R;
        const bool in = r >= 0 && r < H;
        float acc[3][C1 / 2];
        if (in) {
          // the row's taps: pixel c (x0 - 2 + c: box column c + 6), value
          // k = 3 ci + dy at image row r - 1 + dy; plane 0 values 0-7, plane
          // 1 value 8
          const unsigned char* I[3];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
            I[dy] = img + ((ib + l + dy) % IMG_SLOTS) * kImgSlot;
          for (int i = tid; i < TP / 2; i += 128) {  // pixels 2i, 2i + 1
            uint32_t v[9];
#pragma unroll
            for (int kk = 0; kk < 9; ++kk)
              v[kk] = *reinterpret_cast<const uint32_t*>(I[kk % 3] + (kk / 3) * IMW * 2 + 4 * i + 12);
            *reinterpret_cast<uint4*>(taps + 32 * i) = make_uint4(
                __byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                __byte_perm(v[4], v[5], 0x5410), __byte_perm(v[6], v[7], 0x5410));
            *reinterpret_cast<uint4*>(taps + 32 * i + 16) = make_uint4(
                __byte_perm(v[0], v[1], 0x7632), __byte_perm(v[2], v[3], 0x7632),
                __byte_perm(v[4], v[5], 0x7632), __byte_perm(v[6], v[7], 0x7632));
            *reinterpret_cast<unsigned short*>(taps + kTapPlane + 32 * i) =
                (unsigned short)(v[8] & 0xffffu);
            *reinterpret_cast<unsigned short*>(taps + kTapPlane + 32 * i + 16) =
                (unsigned short)(v[8] >> 16);
          }
          wg::fence_async_smem();  // the taps, seen by wgmma
          wg::named_sync(3, 128);
          // conv1: three 64-pixel tiles, tap column dx the descriptor moved
          // dx pixels
          wg::mma_fence();
#pragma unroll
          for (int ti = 0; ti < 3; ++ti)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              mma_ss<C1>(acc[ti], dtaps + (tile1(ti) + dx), dw1 + dx * 2 * C1, dx > 0);
          wg::mma_commit();
          wg::mma_wait<0>();
#pragma unroll
          for (int ti = 0; ti < 3; ++ti) wg::reg_fence(acc[ti]);
        }
        wg::bar_wait(&empty[s], ((k / R) & 1) ^ 1);
        unsigned char* dst = ring + s * G::kRow;
        if (in) {
          // acc[ti][4 j + 2 h + e]: channel 8 j + 2t + e at pixel
          // tile1(ti) + 16 warp + g + 8 h
#pragma unroll
          for (int ti = 0; ti < 3; ++ti)
#pragma unroll
            for (int j = 0; j < KC; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int sp = tile1(ti) + 16 * warp + g + 8 * h, x = x0 - 1 + sp;
                if (ti < 2 || sp >= 2 * 64) {
                  float v0, v1;
                  bn_selu2(acc[ti][4 * j + 2 * h], acc[ti][4 * j + 2 * h + 1], s1[j], b1[j], v0, v1);
                  *reinterpret_cast<uint32_t*>(dst + j * kPlane + sp * 16 + 4 * t) =
                      x >= 0 && x < W ? tc::pack_bf16(v0, v1) : 0u;
                }
              }
        } else {  // a conv1 row outside the image: zeros
          for (int i = tid; i < KC * READ_PX; i += 128)
            *reinterpret_cast<uint4*>(dst + (i / READ_PX) * kPlane + (i % READ_PX) * 16) =
                make_uint4(0, 0, 0, 0);
        }
        wg::fence_async_smem();  // the row, seen by wgmma
        wg::bar_arrive(&full[s]);
      }
      ib += nr + 2;
      u += q1 - q0;
    }
    return;
  }

  // the consumers
  wg::regs_inc<kConsRegs>();
  unsigned char* stage = base + G::oStage + wgi * G::kStage;
  wg::bar_wait(wbar, 0);
  uint32_t s2[KC], b2[KC];  // bn2 of channels 8 j + 2t, + 1
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    s2[j] = *reinterpret_cast<const uint32_t*>(Ws + G::oBN + 2 * (2 * C1 + 8 * j + 2 * t));
    b2[j] = *reinterpret_cast<const uint32_t*>(Ws + G::oBN + 2 * (3 * C1 + 8 * j + 2 * t));
  }
  const uint64_t dw2 = desc_k(Ws + G::oW2, 16 * C1), dwy = desc_k(Ws + G::oWY, 16 * CY);
  const int Ho = H / 2, Wo = W / 2;
  const int n = (int)(u1 - u0);
  const int col0 = (int)(u0 / plan.P);
  // this consumer's unit u0 + j as (col, q), stepped without a division
  int col = col0, q = (int)(u0 % plan.P) + wgi - NCONS;
#pragma unroll 1
  for (int j = wgi; j < n; j += NCONS) {
    for (q += NCONS; q >= plan.P; q -= plan.P) ++col;
    const int b = col / plan.S, x0 = (col % plan.S) * STRIP;
    // the pair's four staged rows (each earlier segment staged two more)
    const int k0 = 2 * j + 2 * (col - col0);
    const bool first = q == 0 || j == 0, last = q == plan.P - 1 || j == n - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wg::bar_wait(&full[(k0 + i) % R], ((k0 + i) / R) & 1);
    // conv2: rows 2q (r 0) and 2q + 1 (r 1), pixels 64 m .. of the strip;
    // the four rows' descriptors from pixel 0, a pixel further one added
    uint64_t drow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      drow[i] = desc_k(ring + ((k0 + i) % R) * G::kRow, C1 == 16 ? kPlane : 16);
    float acc[2][2][C1 / 2];
    wg::mma_fence();
#pragma unroll
    for (int st = 0; st < G::STEPS; ++st) {
      // C1 16: tap st; C1 8: taps (dy, dx) and (dy, dx + 1), dx 0 or 2
      const int dy = C1 == 16 ? st / 3 : st / 2;
      const int dx = C1 == 16 ? st % 3 : 2 * (st % 2);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          mma_ss<C1>(acc[r][m], drow[r + dy] + (64 * m + dx), dw2 + st * 2 * C1, st > 0);
    }
    wg::mma_commit();
    wg::mma_wait<0>();
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int m = 0; m < 2; ++m) wg::reg_fence(acc[r][m]);
    if (lane == 0) {  // the four rows read; twice the rows only this pair reads
#pragma unroll
      for (int i = 0; i < 4; ++i) wg::bar_arrive(&empty[(k0 + i) % R]);
      if (first) {
        wg::bar_arrive(&empty[k0 % R]);
        wg::bar_arrive(&empty[(k0 + 1) % R]);
      }
      if (last) {
        wg::bar_arrive(&empty[(k0 + 2) % R]);
        wg::bar_arrive(&empty[(k0 + 3) % R]);
      }
    }

    // epilogue; acc[r][m][4 jj + 2 h + e]: channel 8 jj + 2t + e at pixel
    // 64 m + 16 warp + g + 8 h of row 2q + r
    wg::named_sync(1 + wgi, 128);  // the staging's last reads are done
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float x[2][C1 / 2];
      uint32_t a[2][4];  // round(x1): the 1x1's A fragments
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int jj = 0; jj < KC; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * jj + 2 * h;
            bn_selu2(acc[r][m][i], acc[r][m][i + 1], s2[jj], b2[jj], x[r][i], x[r][i + 1]);
            a[r][2 * jj + h] = tc::pack_bf16(x[r][i], x[r][i + 1]);
          }
        if constexpr (KC == 1) a[r][2] = a[r][3] = 0u;
      }
      // y1 = SELU(round(wy . round(x1))): one wgmma m64nCYk16 a row, A from
      // the registers as they hold it, waited for after the pool; column
      // 8 jj + 2t + e of the product is channel (CY / 4) t + 2 jj + e
      float ya[2][CY / 2];
      wg::mma_fence();
      mma_rs<CY>(ya[0], a[0], dwy);
      mma_rs<CY>(ya[1], a[1], dwy);
      wg::mma_commit();
      // the pool: the rows (round(upper) is the A fragment's half), then
      // the column pair (lanes 4 apart); lane g even stages channel 8 jj +
      // 2t, g odd 8 jj + 2t + 1, at pooled column 32 m + 8 warp + 4 h + g / 2
#pragma unroll
      for (int jj = 0; jj < KC; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * jj + 2 * h;
          const uint32_t up = a[0][2 * jj + h];
          float v0 = (__uint_as_float(up << 16) + x[1][i]) * 0.5f;
          float v1 = (__uint_as_float(up & 0xffff0000u) + x[1][i + 1]) * 0.5f;
          v0 = (v0 + __shfl_xor_sync(0xffffffffu, v0, 4)) * 0.5f;
          v1 = (v1 + __shfl_xor_sync(0xffffffffu, v1, 4)) * 0.5f;
          const int e = g & 1, c = 8 * jj + 2 * t + e;
          *reinterpret_cast<bf16*>(stage + c * 128 + (((4 * m + warp) ^ (c & 7)) << 4) +
                                   (4 * h + (g >> 1)) * 2) = __float2bfloat16_rn(e ? v1 : v0);
        }
      wg::mma_wait<0>();
      wg::reg_fence(ya[0]);
      wg::reg_fence(ya[1]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = x0 + 64 * m + 16 * warp + g + 8 * h;
          uint32_t w[CY / 8];
#pragma unroll
          for (int jj = 0; jj < CY / 8; ++jj) {  // two roundings by one conversion
            const uint32_t pr = tc::pack_bf16(ya[r][4 * jj + 2 * h], ya[r][4 * jj + 2 * h + 1]);
            w[jj] = tc::pack_bf16(selu(__uint_as_float(pr << 16)),
                                  selu(__uint_as_float(pr & 0xffff0000u)));
          }
          bf16* o = y1 + (((size_t)b * H + 2 * q + r) * W + x) * CY + (CY / 4) * t;
          if (x < W) {
            if constexpr (CY == 32)
              *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
            else
              *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
          }
        }
    }
    wg::named_sync(1 + wgi, 128);
    // x1p: C1 channel rows of 64 pooled columns, 16 bytes a thread
    for (int i = tid; i < C1 * 8; i += 128) {
      const int c = i >> 3, ch = i & 7, ox = x0 / 2 + 8 * ch;
      const uint4 v = *reinterpret_cast<const uint4*>(stage + c * 128 + ((ch ^ (c & 7)) << 4));
      bf16* o = xp + (((size_t)b * C1 + c) * Ho + q) * Wo + ox;
      if ((Wo & 7) == 0 && ox + 8 <= Wo) {
        *reinterpret_cast<uint4*>(o) = v;
      } else {
        const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int z = 0; z < 8; ++z)
          if (ox + z < Wo)
            o[z] = __ushort_as_bfloat16((unsigned short)(wv[z >> 1] >> (16 * (z & 1))));
      }
    }
  }
}

// One launch on B images of H x W (H, W even) with `grid` persistent blocks
// (ops/conv_plan.py, PER_SM an SM): map the image's (image_map).
template <int C1>
cudaError_t launch(const CUtensorMap& map, const bf16* wts, bf16* y1, bf16* xp,
                   int B, int H, int W, int grid, cudaStream_t stream) {
  if (grid < 1 || B < 1 || H < 2 || W < 2 || (H | W) & 1)
    return cudaErrorInvalidValue;
  auto* kern = aliked_wg_kernel<C1>;
  const size_t smem = Geo<C1>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, stream>>>(map, wts, y1, xp, B, H, W);
  return cudaGetLastError();
}

}  // namespace awg
}  // namespace lg
