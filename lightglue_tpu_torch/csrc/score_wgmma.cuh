// B11's and B12's bf16 forms on Hopper's warpgroup products: ALIKED's
// score-head tail
//   score = sigmoid(conv3x3 4->1(SELU(conv3x3 4->4(SELU(conv3x3 8->4(
//           SELU(s0)))))))
// in one persistent launch (score_head.cu's lg_score_head_bf16 and
// lg_score_head_lazy_bf16). The fp32 forms stay in score_head.cu.
//
// What it computes is lightglue_tpu/ops/score_head.py::_score_head_kernel
// (B12, s0 (B, 8, H, W) given) and _score_lazy_kernel (B11, s0 = s1 +
// up(s2) + up(s3) + up(s4), in that order, fp32, the align-corners lerps
// rows first with lerp_of's two-point weights) at mp=True, rounding where
// they round: s0 -> bf16, SELU in fp32 -> bf16; then conv 8->4, SELU ->
// bf16; conv 4->4, SELU -> bf16; conv 4->1, sigmoid; the weights bf16
// (prepare_bf16), every product of two bf16 values exact in the fp32 sums.
// Only the order of the fp32 sums differs. Every conv zero-pads its own
// input: each staged stage is 0 outside the image. The map out is fp32 (B,
// H, W).
//
// What bounds it on an H100: the bytes, 32 in and 4 out a pixel (B12; B11
// reads s1 and its branches once, 44.5), 0.017 ms (0.021) at B 2, 768 x
// 1024; the 0.37 GFLOP an image of the convs take 0.001 ms on the tensor
// cores. Beside them the elementwise work: 17 MUFU a pixel (8 + 4 + 4
// SELUs and the sigmoid), the roundings, B11's lerps (168 FLOP a pixel),
// and the fp32 NCHW planes turned into pixel rows.
//
// Design. Pixels are M: a staged row holds 16-byte pixel slots, as in
// aliked_wgmma.cuh (8-pixel groups 128 bytes apart, no swizzle), so a tap
// is the descriptor moved by whole slots and nothing is copied for a tap.
// - N is filled with outputs: one wgmma m64n8k16 sums two output rows x 4
//   channels (n = 4 rr + co) of 64 pixels, K walking the four input rows
//   both need; every accumulator lane holds a real output, so no lane runs
//   SELU on padding (1.4-1.5x faster than N = 4 channels of one row, a
//   variant of scripts/score_wgmma_study.py, on an H100).
// - s0's row slot holds its 8 channels: a k-step pairs taps (dy, 0) and
//   (dy, 1) (chunk 1 the next pixel, LBO 16 bytes), (dy, 2) takes a zero
//   partner: 8 k-steps a pair of rows. Stages 1 and 2 (4 channels) are
//   stored packed, slot p = (pixel p, pixel p + 1): one k-step of conv
//   4->4 covers the three taps of an input row (chunk 1 two slots on, LBO
//   32 bytes; its second tap has zero weights), 4 k-steps a pair.
// - conv 4->1 runs on the CUDA cores: a thread sums both rows of a pixel,
//   36 FFMA each, from the pair's four packed stage-2 rows, its 36 weights
//   in registers, then the sigmoid and one store a row (on wgmma, with the
//   sums staged in shared memory, the study's variant, 10-18 % slower: each
//   small wgmma costs some 60-75 clocks of the consumer's step, however few
//   its N).
// - Persistent blocks (PER_SM an SM) walk (image, 122-column strip,
//   row pair) units as conv_wgmma.cuh's Plan cuts them (ops/conv_plan.py
//   mirrors it): 122 output columns need 124, 126 and 128 pixels of stage
//   2, stage 1 and s0, so every stage is two 64-pixel tiles and each
//   producer thread stages one pixel. Each row of each stage is computed
//   once a segment (a run of pairs down one strip); only the side columns
//   repeat in the next strip.
// - All 468 weights arrive by one bulk copy of prepare_bf16's blob (16
//   k-steps of 16 x 8 bf16 B tiles, 4 KB) and stay in shared memory.
// - A producer warpgroup: one thread keeps s0's (B12) or s1's (B11) rows in
//   flight by TMA (a 3-d map over the NCHW fp32 planes, a box of 132
//   columns x 8 channels from (x0 - 3) & ~3, zeros outside it) into
//   IMG_SLOTS slots; the 128 threads turn a row into 128 pixel slots of
//   the s0 ring (R0 rows): round, SELU, round, 0 outside the image. B11
//   first adds the three branches: a window of each branch row is lerped
//   along rows once a row (its loads issued a row ahead, from L2), then
//   each pixel adds its column lerps from shared memory.
// - A consumer warpgroup walks a segment's pairs in steps: step J runs
//   conv 8->4 of pair J, conv 4->4 of pair J - 2 and conv 4->1 of pair J -
//   3 (each reads rows that earlier steps staged), the products as one
//   group of wgmma (their k-steps round-robin over the accumulators) and
//   one wait; then the epilogues (SELU, rounding, masks, packed stores into
//   the stage rings of R1 and R2 rows) and one barrier, then conv 4->1.
//   The rings are deep enough that no epilogue writes a slot that a
//   product of its own step, or a later read, still needs.
// What holds it back (scripts/score_wgmma_study.py --trace, clocks of one
// block's steps): the consumer's chain of products, epilogues and conv
// 4->1, each some 1.2-1.7 K clocks a step, at three blocks an SM.
// Every output is written by one block, no atomics: a result repeats to
// the bit.
#pragma once

#include <math.h>

#include "aliked_wgmma.cuh"
#include "score_common.cuh"

namespace lg {
namespace swg {

using score::clampi;
using score::Lerp;
using score::lerp_of;
using score::sigmoid;
using tc::bf16;
using wconv::Plan;

constexpr int STRIP = 122;             // output columns of a strip
constexpr int S0_PX = STRIP + 6;       // s0 pixels of a strip row: x0 - 3 + i
// columns of a TMA box, from (x0 - 3) & ~3: a box row must start on a
// 16-byte boundary (an unaligned start is an illegal instruction)
constexpr int BOX = 132;
constexpr int RP = 136;                // 16-byte pixel slots of a staged row
constexpr int kRow = RP * 16;          // bytes of a staged row
constexpr int kImgSlot = 8 * BOX * 4;  // a box: 8 channel rows of BOX fp32
constexpr int IMG_SLOTS = 4, IMG_AHEAD = 3;  // input rows in flight
constexpr int THREADS = 256;           // a consumer and a producer warpgroup
// blocks an SM (the plan's grid), and the setmaxnreg split of the
// producer (kRegsP) and the consumer (kRegsC) within the registers a thread
// launches with (80 at 3 x 256)
constexpr int PER_SM = 3;
constexpr int kRegsP = 72, kRegsC = 88;
constexpr int TILES = 2;  // 64-pixel tiles a stage row
// the stages' lags: step J runs conv 4->4 of pair J - O2 and conv 4->1 of
// pair J - O3, behind the rows that earlier steps staged; conv 4->1 reads
// the stage-2 ring after the step's barrier, rows the next step's epilogue
// does not overwrite
constexpr int O2 = 2, O3 = 3;
// staged rows: s0, stage 1, stage 2 (a step's epilogues write no slot that
// its own products read: a warp's wgmma wait need not cover the reads made
// for the other warps' rows)
constexpr int R0 = 8, R1 = 6, R2 = 6;
static_assert(128 * (kRegsP + kRegsC) <= THREADS * (65536 / (THREADS * PER_SM) / 8 * 8),
              "registers");

// prepare_bf16's blob: k-steps of [chunk 2][n 8][8 k] bf16 (256 bytes):
// conv 8->4 (2 ri + dp: input row ri, taps 2 dp + chunk), conv 4->4 and
// conv 4->1 (ri: k = 8 chunk + 4 half + ci, tap 2 chunk + half; the CUDA
// cores read conv 4->1's column 0 of k-steps 0 .. 2, the study's wgmma
// variant the tiles)
constexpr int kStep = 256;
constexpr int oW1 = 0, oW2 = 8 * kStep, oW3 = 12 * kStep, kWeights = 16 * kStep;
// shared memory from a 128-byte boundary: the blob, the input boxes, the
// three rings, the barriers; B11's column tables and two row-lerped windows
constexpr int oImg = kWeights;
constexpr int oS0 = oImg + IMG_SLOTS * kImgSlot;
constexpr int oS1 = oS0 + R0 * kRow;
constexpr int oS2 = oS1 + R1 * kRow;
constexpr int oBar = oS2 + R2 * kRow;
constexpr int kBars = 2 * R0 + IMG_SLOTS + 1;
constexpr int oLazy = oBar + (kBars * 8 + 127) / 128 * 128;
constexpr int kTables = (3 * S0_PX * 8 + 127) / 128 * 128;
constexpr int kWinCol = 32;  // a window column: 8 fp32 channels
static_assert(kImgSlot % 128 == 0 && kRow % 128 == 0 && oS0 % 128 == 0 &&
                  oBar % 128 == 0, "aligned parts");
static_assert(BOX * 4 % 16 == 0 && BOX >= S0_PX + 3, "the box covers s0's row");
static_assert(S0_PX == 128, "a producer thread a pixel");

// Bytes of shared memory a block takes: B11's with windows of `cols`
// columns in all (the most a strip's three windows span).
__host__ __device__ constexpr int smem_bytes(bool lazy, int cols) {
  return 128 + oLazy + (lazy ? kTables + 2 * cols * kWinCol : 0);
}

struct Branches {
  const float* s[3];  // s2, s3, s4: (B, 8, hk, wk) fp32
  int h[3], w[3];
};

// B11's windows of a strip: branch k's columns xs[k] .. lie at columns
// off[k] .. off[k + 1] - 1 of the row-lerped window buffer (off[3] in all).
struct Windows {
  int xs[3], off[4];
};

__host__ __device__ __forceinline__ Windows windows_of(const Branches& br,
                                                       int x0, int W) {
  Windows g;
  g.off[0] = 0;
  for (int k = 0; k < 3; ++k) {
    const int a = lerp_of(clampi(x0 - 3, 0, W - 1), W, br.w[k]).i0;
    const int e = lerp_of(clampi(x0 - 3 + S0_PX - 1, 0, W - 1), W, br.w[k]).i1;
    g.xs[k] = a;
    g.off[k + 1] = g.off[k] + e - a + 1;
  }
  return g;
}

// a, b or c for k 0, 1 or 2: a runtime index into a parameter's or a
// local array would place the array in local memory
template <class T>
__device__ __forceinline__ T pick(int k, T a, T b, T c) {
  return k == 0 ? a : k == 1 ? b : c;
}

// (a, b) rounded to bf16, SELU in fp32, rounded again: one bf16x2
__device__ __forceinline__ uint32_t round_selu2(float a, float b) {
  const uint32_t p = tc::pack_bf16(a, b);
  return tc::pack_bf16(awg::selu(__uint_as_float(p << 16)),
                       awg::selu(__uint_as_float(p & 0xffff0000u)));
}

// s0 (B12) or s1 (B11) (B, 8, H, Wp) fp32 (Wp a multiple of 4, 16-byte
// aligned) read as (Wp, H, 8 B) in boxes of BOX columns x 1 row x 8
// channels (16-byte aligned starts: (x0 - 3) & ~3)
inline cudaError_t plane_map(CUtensorMap* map, const float* s, int B, int H,
                             int Wp) {
  const uint64_t dims[3] = {(uint64_t)Wp, (uint64_t)H, (uint64_t)8 * B};
  const uint64_t strides[2] = {(uint64_t)Wp * 4, (uint64_t)H * Wp * 4};
  const uint32_t box[3] = {BOX, 1, 8};
  return wg::bf16_map(map, s, 3, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// The score map out (B, H, W) of s0 (B12) or of s1 and the branches br
// (B11), s0 / s1 read through `map` (its width padded past W with zeros, or
// W itself); wts prepare_bf16's blob.
template <bool LAZY>
__global__ void __launch_bounds__(THREADS, PER_SM)
    score_wg_kernel(const __grid_constant__ CUtensorMap map, const Branches br,
                    const bf16* __restrict__ wts, float* __restrict__ out,
                    int B, int H, int W) {
  extern __shared__ unsigned char lg_swg_smem[];
  unsigned char* base =
      lg_swg_smem + ((128 - (wg::smem_addr(lg_swg_smem) & 127)) & 127);
  unsigned char* Ws = base;
  float* img = reinterpret_cast<float*>(base + oImg);
  unsigned char* s0r = base + oS0;
  unsigned char* s1r = base + oS1;
  unsigned char* s2r = base + oS2;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + oBar);
  uint64_t* empty = full + R0;
  uint64_t* ifull = empty + R0;
  uint64_t* wbar = ifull + IMG_SLOTS;
  const Plan plan(B, H, W, STRIP);
  const long long u0 = plan.first(blockIdx.x, gridDim.x);
  const long long u1 = plan.first(blockIdx.x + 1, gridDim.x);
  if (u0 == u1) return;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R0; ++s) {
      wg::bar_init(&full[s], 128);         // the producer's threads
      wg::bar_init(&empty[s], 4);  // the consumer's warps
    }
    for (int s = 0; s < IMG_SLOTS; ++s) wg::bar_init(&ifull[s], 1);
    wg::bar_init(wbar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  if (wgi == 1) {  // the producer
    wg::regs_dec<kRegsP>();
    if (tid == 0) {  // the weights, once; the map
      wg::prefetch_map(&map);
      wg::bar_expect(wbar, kWeights);
      wg::bulk_load(Ws, wts, kWeights, wbar);
    }
    // the s0 ring's slots past the 128 written stay 0: finite for the
    // products that read past the written ones with zero weights
    for (int i = tid; i < R0 * kRow / 16; i += 128)
      reinterpret_cast<uint4*>(s0r)[i] = make_uint4(0, 0, 0, 0);
    // B11: [3][S0_PX] (window columns j0 | j1 << 16, weight of j1) of each
    // s0 pixel, and two windows [cols][8] of row-lerped branch values
    int2* tab = reinterpret_cast<int2*>(base + oLazy);
    float* win = reinterpret_cast<float*>(base + oLazy + kTables);
    int k = 0, ib = 0;  // s0 rows staged; input rows loaded
    for (long long u = u0; u < u1;) {
      const int col = (int)(u / plan.P), q0 = (int)(u % plan.P);
      const int q1 = (int)min((long long)plan.P, q0 + (u1 - u));
      const int b = col / plan.S, x0 = (col % plan.S) * STRIP;
      const int ra = 2 * q0 - 3, nr = 2 * (q1 - q0) + 6;  // s0 rows ra ..
      Windows gw = {};
      int cols = 0;
      // B11: window column c of row r, its branch's two rows' 8 channels
      // (the loads in flight until lerp_store), and its row lerp weight
      float ra8[8], rc8[8], wy = 0.f;
      auto fetch = [&](int r, int c) {
        const int kb = c < gw.off[1] ? 0 : c < gw.off[2] ? 1 : 2;
        const int hk = pick(kb, br.h[0], br.h[1], br.h[2]);
        const int wk = pick(kb, br.w[0], br.w[1], br.w[2]);
        const Lerp lr = lerp_of(r, H, hk);
        wy = lr.w;
        const float* p = pick(kb, br.s[0], br.s[1], br.s[2]) +
                         ((size_t)b * 8 * hk + lr.i0) * wk +
                         pick(kb, gw.xs[0], gw.xs[1], gw.xs[2]) +
                         (c - pick(kb, gw.off[0], gw.off[1], gw.off[2]));
        const size_t d1 = (size_t)(lr.i1 - lr.i0) * wk, plane = (size_t)hk * wk;
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) {
          ra8[ch] = __ldg(p + ch * plane);
          rc8[ch] = __ldg(p + ch * plane + d1);
        }
      };
      auto lerp_store = [&](float* wb, int c) {
        float4* d = reinterpret_cast<float4*>(wb + c * 8);
        d[0] = make_float4(fmaf(wy, rc8[0] - ra8[0], ra8[0]), fmaf(wy, rc8[1] - ra8[1], ra8[1]),
                           fmaf(wy, rc8[2] - ra8[2], ra8[2]), fmaf(wy, rc8[3] - ra8[3], ra8[3]));
        d[1] = make_float4(fmaf(wy, rc8[4] - ra8[4], ra8[4]), fmaf(wy, rc8[5] - ra8[5], ra8[5]),
                           fmaf(wy, rc8[6] - ra8[6], ra8[6]), fmaf(wy, rc8[7] - ra8[7], ra8[7]));
      };
      if constexpr (LAZY) {
        gw = windows_of(br, x0, W);
        cols = gw.off[3];
        wg::named_sync(2, 128);  // the last segment's tables and windows read
        for (int i = tid; i < 3 * S0_PX; i += 128) {
          const int kb = i / S0_PX;
          const Lerp l = lerp_of(clampi(x0 - 3 + i % S0_PX, 0, W - 1), W,
                                 pick(kb, br.w[0], br.w[1], br.w[2]));
          const int o = pick(kb, gw.off[0] - gw.xs[0], gw.off[1] - gw.xs[1],
                             gw.off[2] - gw.xs[2]);
          tab[i] = make_int2((l.i0 + o) | ((l.i1 + o) << 16), __float_as_int(l.w));
        }
        if (ra >= 0 && ra < H)  // row 0's windows
          for (int c = tid; c < cols; c += 128) {
            fetch(ra, c);
            lerp_store(win, c);
          }
      }
      int issued = 0;  // input rows ra + i of the segment, in slot (ib + i) % IMG_SLOTS
#pragma unroll 1
      for (int l = 0; l < nr; ++l, ++k) {
        // every thread is done with row l - 1: its slot, its window
        wg::named_sync(2, 128);
        if (tid == 0)
          for (; issued < min(nr, l + 1 + IMG_AHEAD); ++issued) {
            const int n = ib + issued, s = n % IMG_SLOTS;
            wg::bar_expect(&ifull[s], kImgSlot);
            wg::tma_load3(img + s * (kImgSlot / 4), &map, &ifull[s], (x0 - 3) & ~3,
                          ra + issued, 8 * b);
          }
        const int r = ra + l;
        // B11: row r + 1's window column tid, its loads in flight over row r
        const bool ahead = LAZY && l + 1 < nr && r + 1 >= 0 && r + 1 < H;
        if (ahead && tid < cols) fetch(r + 1, tid);
        const int n = ib + l;
        wg::bar_wait(&ifull[n % IMG_SLOTS], (n / IMG_SLOTS) & 1);
        const bool rin = r >= 0 && r < H;
        // pixel 0 (x0 - 3) is box column (x0 - 3) & 3
        const float* src = img + (n % IMG_SLOTS) * (kImgSlot / 4) + ((x0 - 3) & 3);
        const float* wcur = win + (l & 1) * cols * 8;
        // pixel i's slot (x0 - 3 + i): 0 outside the image
        auto pixel = [&](int i) {
          const int x = x0 - 3 + i;
          uint32_t wd[4] = {0u, 0u, 0u, 0u};
          if (rin && x >= 0 && x < W) {
            float v[8];
#pragma unroll
            for (int ch = 0; ch < 8; ++ch) v[ch] = src[ch * BOX + i];
            if constexpr (LAZY) {
#pragma unroll
              for (int kb = 0; kb < 3; ++kb) {
                const int2 e = tab[kb * S0_PX + i];
                const float wx = __int_as_float(e.y);
                const float4* A = reinterpret_cast<const float4*>(wcur + (e.x & 0xffff) * 8);
                const float4* C = reinterpret_cast<const float4*>(wcur + ((unsigned)e.x >> 16) * 8);
                const float4 a0 = A[0], a1 = A[1], c0 = C[0], c1 = C[1];
                v[0] += fmaf(wx, c0.x - a0.x, a0.x);
                v[1] += fmaf(wx, c0.y - a0.y, a0.y);
                v[2] += fmaf(wx, c0.z - a0.z, a0.z);
                v[3] += fmaf(wx, c0.w - a0.w, a0.w);
                v[4] += fmaf(wx, c1.x - a1.x, a1.x);
                v[5] += fmaf(wx, c1.y - a1.y, a1.y);
                v[6] += fmaf(wx, c1.z - a1.z, a1.z);
                v[7] += fmaf(wx, c1.w - a1.w, a1.w);
              }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) wd[j] = round_selu2(v[2 * j], v[2 * j + 1]);
          }
          return make_uint4(wd[0], wd[1], wd[2], wd[3]);
        };
        const uint4 mine = pixel(tid);  // computed before the slot is free
        wg::bar_wait(&empty[k % R0], ((k / R0) & 1) ^ 1);
        *reinterpret_cast<uint4*>(s0r + (k % R0) * kRow + 16 * tid) = mine;
        wg::fence_async_smem();  // the row, seen by wgmma
        wg::bar_arrive(&full[k % R0]);
        if (ahead) {  // row r + 1's window, read after the next barrier
          float* wnext = win + ((l + 1) & 1) * cols * 8;
          if (tid < cols) lerp_store(wnext, tid);
          for (int c = tid + 128; c < cols; c += 128) {
            fetch(r + 1, c);
            lerp_store(wnext, c);
          }
        }
      }
      ib += nr;
      u += q1 - q0;
    }
    return;
  }

  // the consumer: both 64-pixel tiles of every stage row
  wg::regs_inc<kRegsC>();
  // the stage rings' slots past the written ones stay 0 (s1r, s2r adjoin)
  for (int i = tid; i < (R1 + R2) * kRow / 16; i += 128)
    reinterpret_cast<uint4*>(s1r)[i] = make_uint4(0, 0, 0, 0);
  wg::fence_async_smem();
  wg::bar_wait(wbar, 0);
  wg::named_sync(1, 128);
  const uint64_t dw1 = awg::desc_k(Ws + oW1, 128), dw2 = awg::desc_k(Ws + oW2, 128);
  float w3[3][3][4];  // conv 4->1 on the CUDA cores: [dy][dx][ci]
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int ci = 0; ci < 4; ++ci)
        w3[dy][dx][ci] = __bfloat162float(*reinterpret_cast<const bf16*>(
            Ws + oW3 + dy * kStep + (dx >> 1) * 128 + (4 * (dx & 1) + ci) * 2));
  // Step J of a segment of n pairs from pair q0: conv 8->4 of pair J (rows
  // 2 q0 - 2 + 2 J, + 1; s0 rows kseg + 2 J .. + 3), conv 4->4 of pair J -
  // O2 (rows 2 q0 - 1 + 2 (J - O2), + 1; stage-1 rows 2 (J - O2) .. + 3 of
  // the segment), conv 4->1 of pair J - O3 (rows 2 q0 + 2 (J - O3), + 1;
  // stage-2 rows 2 (J - O3) .. + 3).
  float acc[2][TILES][4];
  int xin1 = 0, xin2 = 0;  // the segment's column masks (below)
  auto issue = [&](int J, int n, int kseg) {
    const bool a1 = J <= n + 1, a2 = J >= O2 && J <= n + O2;
    const int k1 = kseg + 2 * J;
    if (a1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wg::bar_wait(&full[(k1 + i) % R0], ((k1 + i) / R0) & 1);
    // k-step s of conv 8->4 (input row s / 2 of the pair's four, taps
    // 2 (s % 2) ..) and k-step j of conv 4->4 (input row j)
    auto conv1 = [&](int ti, int s) {
      const uint64_t da = awg::desc_k(s0r + ((k1 + s / 2) % R0) * kRow, 16) +
                          64 * ti + 2 * (s % 2);
      wg::mma_ss8(acc[0][ti], da, dw1 + s * (kStep / 16), s > 0);
    };
    auto conv2 = [&](int ti, int j) {
      wg::mma_ss8(acc[1][ti],
                  awg::desc_k(s1r + ((2 * (J - O2) + j) % R1) * kRow, 32) + 64 * ti,
                  dw2 + j * (kStep / 16), j > 0);
    };
    // the k-steps round-robin over the accumulators (as fast as each
    // accumulator's in a row, scripts/score_wgmma_study.py on an H100)
    wg::mma_fence();
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int ti = 0; ti < TILES; ++ti) {
        if (a1) conv1(ti, s);
        if (s % 2 == 0 && a2) conv2(ti, s / 2);
      }
    wg::mma_commit();
  };
  // step J's epilogues (its products done) and its rows of the score
  auto finish = [&](int J, int n, int kseg, int q0, int b, int x0) {
    const bool a1 = J <= n + 1, a2 = J >= O2 && J <= n + O2;
    const bool a3 = J >= O3 && J < n + O3;
    const int k1 = kseg + 2 * J;
#pragma unroll
    for (int ti = 0; ti < TILES; ++ti) {
      if (a1) wg::reg_fence(acc[0][ti]);
      if (a2) wg::reg_fence(acc[1][ti]);
    }
    if (a1 && lane == 0) {  // s0 rows that no later pair reads
      wg::bar_arrive(&empty[k1 % R0]);
      wg::bar_arrive(&empty[(k1 + 1) % R0]);
      if (J == n + 1) {
        wg::bar_arrive(&empty[(k1 + 2) % R0]);
        wg::bar_arrive(&empty[(k1 + 3) % R0]);
      }
    }
    // acc[stage][ti][2 h + e] is column n = 2t + e (row rr = n / 4 of the
    // pair, channel n % 4) of pixel 64 ti + 16 warp + g + 8 h of the stage
    // row
    const int rr = t >> 1;
#pragma unroll
    for (int ti = 0; ti < TILES; ++ti)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 64 * ti + 16 * warp + g + 8 * h;
        const int bit = 1 << (2 * ti + h);
        if (a1) {  // stage 1: pixel p is x0 - 2 + p; packed slots p, p - 1
          const int row = 2 * q0 - 2 + 2 * J + rr;
          const bool ok = row >= 0 && row < H && (xin1 & bit);
          const uint32_t v = ok ? tc::pack_bf16(awg::selu(acc[0][ti][2 * h]),
                                                awg::selu(acc[0][ti][2 * h + 1]))
                                : 0u;
          unsigned char* d = s1r + ((2 * J + rr) % R1) * kRow + 4 * (t & 1);
          *reinterpret_cast<uint32_t*>(d + 16 * p) = v;
          if (p > 0) *reinterpret_cast<uint32_t*>(d + 16 * p - 8) = v;
        }
        if (a2) {  // stage 2: pixel p is x0 - 1 + p
          const int row = 2 * q0 - 1 + 2 * (J - O2) + rr;
          const bool ok = row >= 0 && row < H && (xin2 & bit);
          const uint32_t v = ok ? tc::pack_bf16(awg::selu(acc[1][ti][2 * h]),
                                                awg::selu(acc[1][ti][2 * h + 1]))
                                : 0u;
          unsigned char* d = s2r + ((2 * (J - O2) + rr) % R2) * kRow + 4 * (t & 1);
          *reinterpret_cast<uint32_t*>(d + 16 * p) = v;
          if (p > 0) *reinterpret_cast<uint32_t*>(d + 16 * p - 8) = v;
        }
      }
    wg::fence_async_smem();  // the stage rows, seen by wgmma
    wg::named_sync(1, 128);
    // conv 4->1 on the CUDA cores from the stage-2 ring, rows 2 q0 + 2 (J -
    // O3) + rr: thread o sums both rows of pixel x0 + o from the pair's
    // four input rows
    const int o = tid, x = x0 + o, rows0 = 2 * q0 + 2 * (J - O3);
    if (a3 && o < STRIP && x < W) {
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const unsigned char* rw = s2r + ((2 * (J - O3) + ri) % R2) * kRow;
        const uint4 ab = *reinterpret_cast<const uint4*>(rw + 16 * o);
        const uint2 cc = *reinterpret_cast<const uint2*>(rw + 16 * (o + 2));
        const uint32_t wv[3][2] = {{ab.x, ab.y}, {ab.z, ab.w}, {cc.x, cc.y}};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) {
            const uint32_t q = wv[dx][ci >> 1];
            const float v = __uint_as_float(ci & 1 ? q & 0xffff0000u : q << 16);
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2)
              if (ri - r2 >= 0 && ri - r2 < 3) s[r2] = fmaf(w3[ri - r2][dx][ci], v, s[r2]);
          }
      }
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2)
        if (rows0 + r2 < H) out[((size_t)b * H + rows0 + r2) * W + x] = sigmoid(s[r2]);
    }
  };
  int kseg = 0;  // the s0 ring index of the segment's first row
  for (long long u = u0; u < u1;) {
    const int col = (int)(u / plan.P), q0 = (int)(u % plan.P);
    const int q1 = (int)min((long long)plan.P, q0 + (u1 - u));
    const int b = col / plan.S, x0 = (col % plan.S) * STRIP;
    const int n = q1 - q0, steps = n + O3;
    // bit 2 ti + h: the thread's stage-1 (xin1) and stage-2 (xin2) pixel of
    // (ti, h) lies inside the image's columns
    xin1 = xin2 = 0;
#pragma unroll
    for (int ti = 0; ti < TILES; ++ti)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 64 * ti + 16 * warp + g + 8 * h;
        const int bit = 1 << (2 * ti + h);
        if (x0 - 2 + p >= 0 && x0 - 2 + p < W) xin1 |= bit;
        if (x0 - 1 + p >= 0 && x0 - 1 + p < W) xin2 |= bit;
      }
#pragma unroll 1
    for (int J = 0; J < steps; ++J) {
      issue(J, n, kseg);
      wg::mma_wait<0>();
      finish(J, n, kseg, q0, b, x0);
    }
    kseg += 2 * n + 6;
    u += q1 - q0;
  }
}

// One launch on B images of H x W with `grid` persistent blocks
// (ops/conv_plan.py with the strip STRIP, PER_SM an SM): s0 / s1 through
// `map` (plane_map); B11's shared memory holds the widest strip's windows.
template <bool LAZY>
cudaError_t launch(const CUtensorMap& map, const Branches& br, const bf16* wts,
                   float* out, int B, int H, int W, int grid,
                   cudaStream_t stream) {
  if (grid < 1 || B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  int cols = 0;
  if (LAZY) {
    for (int k = 0; k < 3; ++k)
      if (br.h[k] < 1 || br.w[k] < 1) return cudaErrorInvalidValue;
    for (int x0 = 0; x0 < W; x0 += STRIP) {
      const int c = windows_of(br, x0, W).off[3];
      cols = c > cols ? c : cols;
    }
  }
  auto* kern = score_wg_kernel<LAZY>;
  const size_t smem = smem_bytes(LAZY, cols);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, stream>>>(map, br, wts, out, B, H, W);
  return cudaGetLastError();
}

}  // namespace swg
}  // namespace lg
