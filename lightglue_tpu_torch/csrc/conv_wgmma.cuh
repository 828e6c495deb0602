// The bf16 3x3, 64 -> 64 convolution (stride 1, zero padding 1) on Hopper's
// warpgroup products: SuperPoint's stem (B7 at mp, stem.cu: conv1a on the
// tensor cores into the staged map, conv1b, the pool) and block 2 (B8 at
// mp, stem2.cu: conv2a into an NHWC scratch, conv2b with the pool). The fp32
// forms stay in conv_tc.cuh.
//
// What it computes is lightglue_tpu/ops/stem.py::_stem_kernel and
// stem2.py::_block2_kernel at mp=True: bf16 operands (the image and
// conv1a's weights rounded), each conv's fp32 sum rounded to bf16 before its
// fp32 bias, then ReLU (and the 2x2 max-pool), bf16 out; conv1a (conv2a)
// values outside the image are 0, not conv1a of zeros plus its bias. Only
// the order of the fp32 sums differs (the tensor cores take their own).
//
// What bounds it on an H100: the products, 58.9 GFLOP (B7) and 29.0 (B8)
// a 768 x 1024 image, 0.060 and 0.029 ms at the 989 TFLOP/s dense bf16
// peak, against 3 MB of image in and 6-25 MB of bf16 maps in and out.
//
// Design. Output channels are M (64: one wgmma row block), pixels N: a
// product is one tap's 64 x 64 weight slab (A, shared memory) times 128
// pixels of one staged input row, each pixel's 64 channels one 128-byte
// swizzled row (B, K-major); tap (dy, dx) is the same B descriptor moved
// dy staged rows down and dx pixels right (dx x 128 bytes, inside the
// 1024-byte swizzle pattern: wgmma swizzles by the address bits, so the
// base offset stays 0; scripts/conv_wgmma_study.py measured both).
//
// - Persistent blocks, one an SM, walk strips of 128 output columns down
//   the image: conv_plan cuts the (image, strip, row pair) units of a
//   launch into one contiguous run a block (ops/conv_plan.py mirrors it).
// - The 9 x 64 x 64 bf16 weights (73.7 KB, prepare_conv's 128-byte
//   swizzled K-major layout) arrive once a block by bulk copies and stay
//   in shared memory for its whole life.
// - A producer warpgroup fills a ring of R staged input rows (136 pixels:
//   x0 - 1 .. x0 + 134; 130 are read): for a map source (B8) one thread
//   loads each row by TMA (a 4-d tensor map over the NHWC map, zeros
//   outside it); for the image source (B7) its four warps stage image rows
//   (fp32, cp.async, two rows ahead), lay out a staged row's taps (136
//   pixels x K = 9 taps zero-padded to 16, as the TPU kernel pads them:
//   lightglue_tpu/ops/stem.py:100) and compute conv1a as two wgmma (64
//   channels x 64 and x 72 pixels), rounding, bias, ReLU and masking on the
//   way into the swizzled row: each conv1a row is computed once a segment
//   of a strip; only the two side columns repeat in the next strip. The
//   producer's products queue behind the consumers' on the tensor cores,
//   so a row takes as few as fit the registers (18 mma.sync a warp ran
//   1.8x slower, scripts/conv_wgmma_study.py).
// - Two consumer warpgroups take alternate row pairs of the block's run.
//   A pair is two accumulator sets of 64 x 128 (rows y and y + 1: 72
//   wgmma m64n128k16 over 4 staged rows), so the 2 x 2 max-pool is
//   register-local (accumulator columns 2t and 2t + 1 are horizontal
//   neighbours, the other set the row below). Each staged row is read by
//   two pairs, so its empty barrier completes after two pairs' arrivals
//   (the first and last pair of a segment arrive twice on the rows only
//   they read). One consumer's epilogue (round, bias, ReLU, pool, bf16)
//   runs beside the other's products: through 8 KB of shared memory (4 KB
//   for the stem, whose ring fits 8 rows so) in a conflict-free swizzle,
//   out as 16-byte stores (NHWC rows, or NCHW channel rows).
// - setmaxnreg: producer 72 (image) or 40 (map) registers, consumers 216
//   or 232, within the 168 a thread the block launches with.
// Every output is written by one block, no atomics: a result repeats to the
// bit.
#pragma once

#include "tc.cuh"
#include "wgmma.cuh"

namespace lg {
namespace wconv {

using tc::bf16;

constexpr int C = 64;                 // channels in and out
constexpr int STRIP = 128;            // output columns of a strip: N
constexpr int RP = 136;               // pixels of a staged row
constexpr int READ_PX = STRIP + 2;    // the pixels of it the products read
constexpr int kRow = RP * 128;        // bytes of a staged row (17 x 1024)
constexpr int kTap = C * 128;         // bytes of one tap's weights
constexpr int kWeights = 9 * kTap;
constexpr int NCONS = 2;              // consumer warpgroups
constexpr int THREADS = 128 * (NCONS + 1);
// the image source's staged image rows: x0 - 4 .. x0 + 139 in fp32, a ring
// of IMG_SLOTS, IMG_AHEAD rows in flight ahead of the three conv1a reads
constexpr int IMG_ROW = 144, IMG_SLOTS = 6, IMG_AHEAD = 2;
constexpr int kImg = IMG_SLOTS * IMG_ROW * 4;
// the image source's conv1a operands, bf16 in the 32-byte swizzle (at16):
// its weights (64 channels x 16 taps) and a staged row's taps (RP pixels x
// 16 taps)
constexpr int kW1a = 64 * 32, kCol = RP * 32;

// Where element (r, k) of a 16-deep K-major tile lies: rows of 32 bytes,
// the 16-byte chunk k / 8 at chunk (k / 8) ^ ((r / 4) % 2) (the 32-byte
// swizzle: address bit 4 ^= bit 7).
__host__ __device__ constexpr int at16(int r, int k) {
  return r * 32 + (((k >> 3) ^ ((r >> 2) & 1)) << 4) + (k & 7) * 2;
}

// A descriptor of such a tile at p (256-byte aligned): 32-byte swizzle,
// 8-row groups 256 bytes apart.
__device__ __forceinline__ uint64_t desc_sw32(const void* p) {
  return (uint64_t)((wg::smem_addr(p) & 0x3ffff) >> 4) | (1ull << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

// conv1a's products: m64n72k16, A and B from shared memory (both K-major),
// 36 accumulators a thread in wgmma's layout (with wg::mma_ss64, a staged
// row's 136 pixels in two).
__device__ __forceinline__ void mma_ss72(float (&d)[36], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35}"
      ", %36, %37, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(da), "l"(db), "r"(accumulate));
}

// One of conv1a's products for a staged row: channels (M) x the N pixels
// from p0 (N 64 or 72) x 16 taps, then each sum rounded to bf16 before its
// fp32 bias (b1: the thread's channels 16 warp + g, + 8), ReLU, 0 outside
// the image (x0 - 1 + p outside [0, W)), bf16 into the staged row at dst;
// c[4 j + 2 h + e] is channel 16 warp + g + 8 h at pixel p0 + 8 j + 2 t + e.
template <int N>
__device__ __forceinline__ void conv1a_part(const unsigned char* W1,
                                            const unsigned char* Col, int p0,
                                            const float (&b1)[2],
                                            unsigned char* dst, int x0, int W,
                                            int warp, int g, int t) {
  float c[N / 2];
  wg::mma_fence();
  if constexpr (N == 64)
    wg::mma_ss64<0, 0>(c, desc_sw32(W1), desc_sw32(Col + 32 * p0), 0);
  else
    mma_ss72(c, desc_sw32(W1), desc_sw32(Col + 32 * p0), 0);
  wg::mma_commit();
  wg::mma_wait<0>();
  wg::reg_fence(c);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int px = p0 + 8 * j + 2 * t + e, x = x0 - 1 + px;
      if (px < READ_PX) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int co = 16 * warp + g + 8 * h;
          const float v = x >= 0 && x < W
              ? fmaxf(tc::round_bf16(c[4 * j + 2 * h + e]) + b1[h], 0.f)
              : 0.f;
          *reinterpret_cast<bf16*>(
              dst + px * 128 + (((co >> 3) ^ (px & 7)) << 4) + (co & 7) * 2) =
              __float2bfloat16_rn(v);
        }
      }
    }
}

enum { kImage = 0, kMap = 1 };                        // sources
enum { kPoolNHWC = 0, kFullNHWC = 1, kPoolNCHW = 2 };  // epilogues

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared memory of a source's kernel, from a 1024-byte boundary: the
// weights, R staged rows, the consumers' staging, the image rows, the
// barriers.
template <int kSrc>
struct Geo {
  static constexpr int R = 8;  // staged rows in the ring
  // a consumer's epilogue staging: 64 pixels x 64 channels, or for the
  // stem 32 pooled pixels (two halves a pair)
  static constexpr int kStage = kSrc == kImage ? 32 * 128 : 64 * 128;
  static constexpr int kProdRegs = kSrc == kImage ? 72 : 40;
  static constexpr int kConsRegs = kSrc == kImage ? 216 : 232;
  static constexpr int oRing = kWeights;
  static constexpr int oStage = oRing + R * kRow;
  static constexpr int oW1a = oStage + NCONS * kStage;
  static constexpr int oCol = oW1a + (kSrc == kImage ? kW1a : 0);
  static constexpr int oImg = oCol + (kSrc == kImage ? kCol : 0);
  static constexpr int oBar = oImg + (kSrc == kImage ? kImg : 0);
  static constexpr size_t bytes = 1024 + oBar + (2 * R + 1) * 8;
  static_assert(bytes <= 232448, "an H100 block's shared memory");
  static_assert(oW1a % 256 == 0 && oCol % 256 == 0, "32-byte swizzled tiles");
  // setmaxnreg moves registers within the block's launch allocation (168 a
  // thread at 384 threads): a consumer asking for more waits for ever
  static_assert(128 * kProdRegs + 256 * kConsRegs <= THREADS * 168, "registers");
};

// The units of a launch, (image, strip of `strip` columns, row pair) in that
// order; block i of G walks units [first(i), first(i + 1)). An odd H's last
// pair holds one row (the score head's; the convolutions take H even).
struct Plan {
  int S, P;
  long long units;
  __host__ __device__ Plan(int B, int H, int W, int strip = STRIP)
      : S(cdiv(W, strip)), P((H + 1) / 2), units((long long)B * S * P) {}
  __host__ __device__ long long first(int i, int G) const {
    return units * i / G;
  }
};

// out = relu(conv3x3(A) + bias), 2x2 max-pooled for the pool epilogues.
// kImage: img is the (B, 1, H, W) fp32 image and A = relu(conv1a(img) +
// b1a), 0 outside the image (w1a (64, 1, 3, 3) fp32, b1a (64)); kMap: A is
// the (B, H, W, 64) bf16 map read through `map`. w: prepare_conv's bf16
// layout (9, 64, 64) swizzled; bias (64) fp32. out bf16: (B, H / 2, W / 2,
// 64) for kPoolNHWC, (B, H, W, 64) for kFullNHWC, (B, 64, H / 2, W / 2) for
// kPoolNCHW. H and W even.
template <int kSrc, int kEpi>
__global__ void __launch_bounds__(THREADS, 1)
    conv_wg_kernel(const __grid_constant__ CUtensorMap map,
                   const float* __restrict__ img,
                   const float* __restrict__ w1a,
                   const float* __restrict__ b1a,
                   const bf16* __restrict__ w,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   int B, int H, int W) {
  using G = Geo<kSrc>;
  constexpr int R = G::R;
  extern __shared__ unsigned char lg_wconv_smem[];
  unsigned char* base =
      lg_wconv_smem + ((1024 - (wg::smem_addr(lg_wconv_smem) & 1023)) & 1023);
  unsigned char* Ws = base;
  unsigned char* ring = base + G::oRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + G::oBar);
  uint64_t* empty = full + R;
  uint64_t* wbar = empty + R;
  const Plan plan(B, H, W);
  const long long u0 = plan.first(blockIdx.x, gridDim.x);
  const long long u1 = plan.first(blockIdx.x + 1, gridDim.x);
  if (u0 == u1) return;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) {
      wg::bar_init(&full[s], kSrc == kImage ? 128 : 1);
      wg::bar_init(&empty[s], 4 * 2);  // two pairs' four warps
    }
    wg::bar_init(wbar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  if (wgi == NCONS) {  // the producer
    wg::regs_dec<G::kProdRegs>();
    if constexpr (kSrc == kMap) {
      if (tid != 0) return;
      wg::prefetch_map(&map);
    }
    if (tid == 0) {  // the weights, once
      wg::bar_expect(wbar, kWeights);
      for (int tap = 0; tap < 9; ++tap)
        wg::bulk_load(Ws + tap * kTap,
                      reinterpret_cast<const unsigned char*>(w) + tap * kTap,
                      kTap, wbar);
    }
    // conv1a's weights rounded to bf16 (tap k = 3 dx + dy as the TPU kernel
    // orders them, 0 past 8), once; the biases of the thread's accumulator
    // rows (channels 16 warp + g, + 8)
    unsigned char* W1 = base + G::oW1a;
    unsigned char* Col = base + G::oCol;
    float b1[2] = {0.f, 0.f};
    if constexpr (kSrc == kImage) {
      for (int i = tid; i < 64 * 16; i += 128) {
        const int co = i >> 4, k = i & 15;
        *reinterpret_cast<bf16*>(W1 + at16(co, k)) = __float2bfloat16_rn(
            k < 9 ? __ldg(w1a + co * 9 + (k % 3) * 3 + k / 3) : 0.f);
      }
      b1[0] = __ldg(b1a + 16 * warp + g), b1[1] = __ldg(b1a + 16 * warp + g + 8);
    }
    float* Img = reinterpret_cast<float*>(base + G::oImg);
    const bool vec = (W & 3) == 0 && (reinterpret_cast<uintptr_t>(img) & 15) == 0;
    int k = 0, ib = 0;  // staged rows filled; image rows staged
    for (long long u = u0; u < u1;) {
      const int col = (int)(u / plan.P), q0 = (int)(u % plan.P);
      const int q1 = (int)min((long long)plan.P, q0 + (u1 - u));
      const int b = col / plan.S, x0 = (col % plan.S) * STRIP;
      const int ra = 2 * q0 - 1, nr = 2 * (q1 - q0) + 2;  // input rows ra ..
      if constexpr (kSrc == kMap) {
        for (int l = 0; l < nr; ++l, ++k) {
          const int s = k % R;
          wg::bar_wait(&empty[s], ((k / R) & 1) ^ 1);
          wg::bar_expect(&full[s], kRow);
          wg::tma_load4(ring + s * kRow, &map, &full[s], 0, x0 - 1, ra + l, b);
        }
      } else {
        const float* im = img + (size_t)b * H * W;
        // image row i of the segment (row ra - 1 + i) into image slot
        // (ib + i) % IMG_SLOTS; one commit group a row (empty past the end)
        auto issue = [&](int i) {
          if (i < nr + 2) {
            const int gy = ra - 1 + i;
            const bool rok = gy >= 0 && gy < H;
            float* dst = Img + ((ib + i) % IMG_SLOTS) * IMG_ROW;
            if (vec) {
              for (int c = tid; c < IMG_ROW / 4; c += 128) {
                const int gx = x0 - 4 + 4 * c;
                const bool ok = rok && gx >= 0 && gx < W;
                tc::cp_async16(dst + 4 * c, ok ? im + (size_t)gy * W + gx : img, ok);
              }
            } else {
              for (int c = tid; c < IMG_ROW; c += 128) {
                const int gx = x0 - 4 + c;
                const bool ok = rok && gx >= 0 && gx < W;
                tc::cp_async4(dst + c, ok ? im + (size_t)gy * W + gx : img, ok);
              }
            }
          }
          tc::cp_async_commit();
        };
        wg::named_sync(3, 128);  // the last segment's image rows are read
#pragma unroll 1
        for (int i = 0; i < IMG_AHEAD + 2; ++i) issue(i);
#pragma unroll 1
        for (int l = 0; l < nr; ++l, ++k) {
          issue(l + IMG_AHEAD + 2);
          tc::cp_async_wait<IMG_AHEAD>();  // image rows l .. l + 2 landed
          wg::named_sync(3, 128);          // ... for every producer thread
          const int s = k % R, r = ra + l;
          wg::bar_wait(&empty[s], ((k / R) & 1) ^ 1);
          unsigned char* dst = ring + s * kRow;
          if (r >= 0 && r < H) {
            const float* I0 = Img + ((ib + l) % IMG_SLOTS) * IMG_ROW;
            const float* I1 = Img + ((ib + l + 1) % IMG_SLOTS) * IMG_ROW;
            const float* I2 = Img + ((ib + l + 2) % IMG_SLOTS) * IMG_ROW;
            // the row's taps (im2col): pixel p's tap k = 3 dx + dy is image
            // row dy, staged column p + dx + 2
            for (int p = tid; p < RP; p += 128) {
              float v[16];
#pragma unroll
              for (int kt = 0; kt < 16; ++kt) {
                const float* I = kt % 3 == 0 ? I0 : kt % 3 == 1 ? I1 : I2;
                v[kt] = kt < 9 ? I[p + kt / 3 + 2] : 0.f;
              }
#pragma unroll
              for (int h = 0; h < 2; ++h)
                *reinterpret_cast<uint4*>(Col + at16(p, 8 * h)) = make_uint4(
                    tc::pack_bf16(v[8 * h], v[8 * h + 1]),
                    tc::pack_bf16(v[8 * h + 2], v[8 * h + 3]),
                    tc::pack_bf16(v[8 * h + 4], v[8 * h + 5]),
                    tc::pack_bf16(v[8 * h + 6], v[8 * h + 7]));
            }
            wg::fence_async_smem();  // the taps (and the weights), seen by wgmma
            wg::named_sync(3, 128);
            // conv1a of the row: channels (M) x 136 pixels (N) x 16 taps, in
            // two products (64 and 72 pixels)
            conv1a_part<64>(W1, Col, 0, b1, dst, x0, W, warp, g, t);
            conv1a_part<72>(W1, Col, 64, b1, dst, x0, W, warp, g, t);
          } else {  // a conv1a row outside the image: zeros
            for (int i = tid; i < READ_PX * 8; i += 128)
              *reinterpret_cast<uint4*>(dst + 16 * i) = make_uint4(0, 0, 0, 0);
          }
          wg::fence_async_smem();  // the row, seen by wgmma
          wg::bar_arrive(&full[s]);
        }
        ib += nr + 2;
      }
      u += q1 - q0;
    }
    if constexpr (kSrc == kImage) tc::cp_async_wait<0>();
    return;
  }

  // the consumers
  wg::regs_inc<G::kConsRegs>();
  unsigned char* stage = base + G::oStage + wgi * G::kStage;
  // this thread's output channels: rows g and g + 8 of its warp's 16
  const float bco[2] = {__ldg(bias + 16 * warp + g), __ldg(bias + 16 * warp + g + 8)};
  const long long n = u1 - u0;
  const int col0 = (int)(u0 / plan.P);
  wg::bar_wait(wbar, 0);
  for (long long j = wgi; j < n; j += NCONS) {
    const long long u = u0 + j;
    const int col = (int)(u / plan.P), q = (int)(u % plan.P);
    const int b = col / plan.S, x0 = (col % plan.S) * STRIP;
    // the pair's four staged rows: each earlier segment staged two rows
    // more than its pairs' two each
    const int k0 = (int)(2 * j) + 2 * (col - col0);
    const bool first = q == 0 || j == 0, last = q == plan.P - 1 || j == n - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wg::bar_wait(&full[(k0 + i) % R], ((k0 + i) / R) & 1);
    wg::fence_async_smem();
    float acc0[64], acc1[64];  // output rows 2q and 2q + 1
    wg::mma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const unsigned char* r0 = ring + ((k0 + dy) % R) * kRow + dx * 128;
      const unsigned char* r1 = ring + ((k0 + 1 + dy) % R) * kRow + dx * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = wg::desc_sw128(Ws + tap * kTap + 32 * kk, 16, 1024);
        const int on = tap > 0 || kk > 0;
        wg::mma_ss128<0, 0>(acc0, da, wg::desc_sw128(r0 + 32 * kk, 16, 1024), on);
        wg::mma_ss128<0, 0>(acc1, da, wg::desc_sw128(r1 + 32 * kk, 16, 1024), on);
      }
    }
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::reg_fence(acc0);
    wg::reg_fence(acc1);
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

    // epilogue: each sum rounded to bf16 before the fp32 bias, ReLU; d[4 j'
    // + 2 h + e] is channel 16 warp + g + 8 h at pixel 8 j' + 2 t + e
    if constexpr (kEpi == kFullNHWC) {
      // each row (acc0: 2q, acc1: 2q + 1) in two halves of 64 pixels,
      // staged [pixel][channel]
#pragma unroll
      for (int part = 0; part < 4; ++part) {
        const int row = part >> 1, hf = part & 1, y = 2 * q + row;
        wg::named_sync(1 + wgi, 128);  // the staging's last reads are done
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * (8 * hf + jj) + 2 * h + e;
              const float v = row == 0 ? acc0[i] : acc1[i];
              const int co = 16 * warp + g + 8 * h, px = 8 * jj + 2 * t + e;
              *reinterpret_cast<bf16*>(
                  stage + px * 128 + (((co >> 3) ^ (px & 7)) << 4) + (co & 7) * 2) =
                  __float2bfloat16_rn(fmaxf(tc::round_bf16(v) + bco[h], 0.f));
            }
        wg::named_sync(1 + wgi, 128);
        for (int i = tid; i < 512; i += 128) {
          const int px = i >> 3, ch = i & 7, x = x0 + 64 * hf + px;
          if (x < W)
            *reinterpret_cast<uint4*>(out + (((size_t)b * H + y) * W + x) * C + 8 * ch) =
                *reinterpret_cast<const uint4*>(stage + px * 128 + ((ch ^ (px & 7)) << 4));
        }
      }
    } else {
      // pooled pixel 4 jj + t of channel co: NCHW staged [channel][pixel]
      // in one part; NHWC [pixel][channel] in halves of 32 pixels where
      // the staging holds 32 (the stem)
      constexpr int PP = G::kStage / 128, NPART = 64 / PP;
      static_assert(kEpi == kPoolNHWC || PP == 64, "NCHW staged whole");
      const int Ho = H / 2, Wo = W / 2, ox0 = x0 / 2;
#pragma unroll
      for (int part = 0; part < NPART; ++part) {
        wg::named_sync(1 + wgi, 128);  // the staging's last reads are done
#pragma unroll
        for (int jl = 0; jl < PP / 4; ++jl)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jj = part * (PP / 4) + jl, a = 4 * jj + 2 * h;
            const float v = fmaxf(fmaxf(acc0[a], acc0[a + 1]), fmaxf(acc1[a], acc1[a + 1]));
            const int co = 16 * warp + g + 8 * h, pp = 4 * jj + t - part * PP;
            const int off = kEpi == kPoolNHWC
                                ? pp * 128 + (((co >> 3) ^ (pp & 7)) << 4) + (co & 7) * 2
                                : co * 128 + (((pp >> 3) ^ (co & 7)) << 4) + (pp & 7) * 2;
            *reinterpret_cast<bf16*>(stage + off) =
                __float2bfloat16_rn(fmaxf(tc::round_bf16(v) + bco[h], 0.f));
          }
        wg::named_sync(1 + wgi, 128);
        for (int i = tid; i < PP * 8; i += 128) {
          if constexpr (kEpi == kPoolNHWC) {
            const int pp = i >> 3, ch = i & 7, ox = ox0 + part * PP + pp;
            if (ox < Wo)
              *reinterpret_cast<uint4*>(out + (((size_t)b * Ho + q) * Wo + ox) * C + 8 * ch) =
                  *reinterpret_cast<const uint4*>(stage + pp * 128 + ((ch ^ (pp & 7)) << 4));
          } else {
            const int co = i >> 3, ch = i & 7, ox = ox0 + 8 * ch;
            const uint4 v =
                *reinterpret_cast<const uint4*>(stage + co * 128 + ((ch ^ (co & 7)) << 4));
            bf16* o = out + (((size_t)b * C + co) * Ho + q) * Wo + ox;
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
    }
  }
}

// One launch on B images of H x W (H, W even) with `grid` persistent blocks
// (ops/conv_plan.py: at most the launch's units). kMap: src is the (B, H, W,
// 64) bf16 map (16-byte aligned), read by TMA through a tensor map encoded
// here; kImage: src is the fp32 image.
template <int kSrc, int kEpi>
cudaError_t launch(const void* src, const float* w1a, const float* b1a,
                   const bf16* w, const float* bias, bf16* out, int B, int H,
                   int W, int grid, cudaStream_t stream) {
  if (grid < 1 || B < 1 || H < 2 || W < 2 || (H | W) & 1)
    return cudaErrorInvalidValue;
  CUtensorMap map{};
  if constexpr (kSrc == kMap) {
    const uint64_t dims[4] = {C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint64_t strides[3] = {C * 2, (uint64_t)W * C * 2,
                                 (uint64_t)H * W * C * 2};
    const uint32_t box[4] = {C, RP, 1, 1};
    const cudaError_t err = wg::bf16_map(&map, src, 4, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  auto* kern = conv_wg_kernel<kSrc, kEpi>;
  const size_t smem = Geo<kSrc>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, stream>>>(
      map, static_cast<const float*>(src), w1a, b1a, w, bias, out, B, H, W);
  return cudaGetLastError();
}

}  // namespace wconv
}  // namespace lg
