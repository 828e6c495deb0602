// A tile product on Hopper's tensor cores, C = A B^T in fp32 by 3xTF32:
// the projections and the out_proj + FFN chain of B5 and B6 (blocks.cu), and
// the score tiles of the assignment reductions B2 (assignment_fused.cu).
//
// A (R, K) holds activation rows and B (C, K) one row per output channel,
// both K-major, so a k-step copies whole 32-float row segments of each. A
// block takes BM rows x BN channels and walks K in steps of 32: the A and B
// tiles arrive by cp.async (16 bytes a thread) into a ring of STAGES steps,
// the next STAGES - 1 in flight while step k's products run (one barrier a
// step), rows padded to 40 floats so that the fragment reads (a float2 of
// row g, channels 2t and 2t + 1) fall on distinct banks. Each warp owns
// WM x WN outputs as mma.sync m16n8k8 tiles; each 8-deep k-step takes its
// channels in the order 0 2 4 6 1 3 5 7 in both operands (as attn_tc.cuh
// does), so a fragment is one 8-byte read.
// Operands are split into big and small tf32 parts as they are read, and
// every product is the 3xTF32 sum of tc.cuh into fp32 accumulators.
//
// Two compile-time hooks: the A source (the prologue) says where row r's
// channels k .. k + 31 lie and may rewrite each landed A tile in place
// (LayerNorm and GELU in lin2, from row statistics it gathers first); the
// epilogue writes a warp's accumulators (bias, rotary, statistics,
// residual). Every output is written by one block and there are no
// atomics, so a result repeats to the bit.
#pragma once

#include "tc.cuh"

namespace lg {
namespace gemm {

constexpr int BK = 32;        // depth of a k-step
constexpr int LDS = BK + 8;   // padded row of a staged tile (floats)
constexpr int STAGES = 2;     // k-steps in the ring
constexpr int PART = 16;      // channels of one LayerNorm partial

template <int BM_, int BN_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * (BM / WM) * WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles of a warp
  static constexpr int kStage = (BM + BN) * LDS;   // floats of one stage
  // the ring, then 2 BM floats for the A source (lin2's row statistics)
  static constexpr size_t kBytes = (STAGES * kStage + 2 * BM) * sizeof(float);
  static_assert(BM * (BK / 4) % THREADS == 0 && BN * (BK / 4) % THREADS == 0,
                "each thread copies whole 16-byte chunks");
  static_assert(NT % 2 == 0, "a LayerNorm partial is two 8-wide tiles");
};

// The tiles a launch may take, in the order of ops/block_tc.py::TILES:
// the plan takes the first that gives every SM a block. The largest is wide
// rather than tall: lin2 redoes its LayerNorm + GELU for each of its D / BN
// column tiles (64 x 128 read lin2 16 % faster than 128 x 64 at B 16, and
// the other launches as fast: scripts/tile_study.py).
using Tile0 = Tile<64, 128, 32, 32>;  // 8 warps
using Tile1 = Tile<64, 64, 32, 32>;   // 4 warps
using Tile2 = Tile<32, 64, 16, 32>;   // 4 warps
using Tile3 = Tile<32, 32, 16, 16>;   // 4 warps

// f(TileN{}) for tile index `tile`
template <class F>
cudaError_t with_tile(int tile, F&& f) {
  switch (tile) {
    case 0: return f(Tile0{});
    case 1: return f(Tile1{});
    case 2: return f(Tile2{});
    case 3: return f(Tile3{});
    default: return cudaErrorInvalidValue;
  }
}

// The A source's hooks for a source that rewrites nothing.
struct NoTransform {
  static constexpr bool kTransform = false;
  template <class T>
  __device__ void begin(float*, int, int) const {}
  template <class T>
  __device__ void transform(float*, const float*, int) const {}
};

// acc += A[m0 .., :] B[n0 .., :]^T for this block's BM x BN tile; rows at
// or past R read as 0. A source `a`: a.at(row) -> a cursor for row < R,
// a.src(cursor, k0) -> the address of the row's channels k0 .. k0 + 31
// (contiguous); kTransform, begin and transform as NoTransform. w (C, K)
// row-major; with kBoundB its rows at or past C read as 0 (else the tile's
// BN rows must exist); K a multiple of 32; dynamic shared memory T::kBytes.
// kStepSums: each 8-deep step's three products go into a zeroed register
// tile that an fp32 add then puts into acc. The tensor core's own adds
// truncate the products aligned to the accumulator, so over a deep K at
// large |C| its errors add up with one sign (B2 at scores up to 160, K 256,
// on an H100: 9.5e-5 from float64 summed in place, 1.3e-5 with the step
// sums, 3.1e-5 for the fp32 plain product; scripts/assign_study.py), at
// 11-12 % of B2's time. B5's and B6's products (blocks.cu) keep the
// in-place sums: over K 256 and 512 their outputs are of order 1-10, and
// every launch stays within 1.2e-5 of its plain version (chip_smoke.py,
// phase 2c), so the step sums would cost time there and buy nothing.
template <class T, class ASrc, bool kBoundB = false, bool kStepSums = false>
__device__ __forceinline__ void mainloop(const ASrc& a,
                                         const float* __restrict__ w, int K,
                                         int R, int m0, int n0,
                                         float (&acc)[T::MT][T::NT][4],
                                         int C = 0) {
  extern __shared__ __align__(16) float lg_smem[];
  constexpr int CH = BK / 4;  // 16-byte chunks of a row segment
  constexpr int AC = T::BM * CH / T::THREADS, BC = T::BN * CH / T::THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / T::WARPS_N) * T::WM, wn = (warp % T::WARPS_N) * T::WN;
  float* extra = lg_smem + STAGES * T::kStage;

  // the thread's chunks: (row, column) in the tile, fixed over k
  typename ASrc::Cursor cur[AC];
  bool ok[AC];
#pragma unroll
  for (int i = 0; i < AC; ++i) {
    const int row = m0 + (tid + i * T::THREADS) / CH;
    ok[i] = row < R;
    cur[i] = a.at(ok[i] ? row : m0);  // m0 < R: a valid address
  }
  const float* wrow[BC];
  bool okb[BC];
#pragma unroll
  for (int i = 0; i < BC; ++i) {
    const int idx = tid + i * T::THREADS, c = n0 + idx / CH;
    okb[i] = !kBoundB || c < C;
    wrow[i] = w + (size_t)(okb[i] ? c : n0) * K + 4 * (idx % CH);
  }
  auto load = [&](int stage, int k0) {
    float* As = lg_smem + stage * T::kStage;
    float* Bs = As + T::BM * LDS;
#pragma unroll
    for (int i = 0; i < AC; ++i) {
      const int idx = tid + i * T::THREADS, c = 4 * (idx % CH);
      tc::cp_async16(As + (idx / CH) * LDS + c, a.src(cur[i], k0) + c, ok[i]);
    }
#pragma unroll
    for (int i = 0; i < BC; ++i) {
      const int idx = tid + i * T::THREADS;
      tc::cp_async16(Bs + (idx / CH) * LDS + 4 * (idx % CH), wrow[i] + k0,
                     okb[i]);
    }
    tc::cp_async_commit();
  };

  // one commit group per k-step (empty past the last), so that waiting
  // for all but the STAGES - 2 youngest groups waits for step kt
  const int steps = K / BK;
  a.template begin<T>(extra, m0, R);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s * BK);
    else tc::cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt has landed for every thread, and every
                      // read of step kt - 1's slot is done
    const int next = kt + STAGES - 1;
    if (next < steps) load(next % STAGES, next * BK);
    else tc::cp_async_commit();
    float* As = lg_smem + (kt % STAGES) * T::kStage;
    const float* Bs = As + T::BM * LDS;
    if constexpr (ASrc::kTransform) {
      a.template transform<T>(As, extra, kt * BK);
      __syncthreads();
    }
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      // A fragments: a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1), a3 (g + 8,
      // 2t + 1) of the 8-deep step, split as they are read
      uint32_t ab[T::MT][4], as[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const float* ap = As + (wm + 16 * mt + g) * LDS + 8 * ks + 2 * t;
        const float2 lo = *reinterpret_cast<const float2*>(ap);
        const float2 hi = *reinterpret_cast<const float2*>(ap + 8 * LDS);
        tc::split_tf32(lo.x, ab[mt][0], as[mt][0]);
        tc::split_tf32(hi.x, ab[mt][1], as[mt][1]);
        tc::split_tf32(lo.y, ab[mt][2], as[mt][2]);
        tc::split_tf32(hi.y, ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        // B fragment: b0 (channel 2t, output g), b1 (2t + 1, g)
        const float2 bv = *reinterpret_cast<const float2*>(
            Bs + (wn + 8 * nt + g) * LDS + 8 * ks + 2 * t);
        uint32_t bb[2], bs[2];
        tc::split_tf32(bv.x, bb[0], bs[0]);
        tc::split_tf32(bv.y, bb[1], bs[1]);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          if constexpr (kStepSums) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            tc::mma3(d, ab[mt], as[mt], bb, bs);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] += d[i];
          } else {
            tc::mma3(acc[mt][nt], ab[mt], as[mt], bb, bs);
          }
        }
      }
    }
  }
}

// One block's tile of C = A w^T, written by epi.store<T>(acc, first row
// and first column of the warp's WM x WN outputs, R). In the accumulator
// acc[mt][nt], a thread holds rows 16 mt + g (0, 1) and 16 mt + g + 8 (2, 3)
// and columns 8 nt + 2t (0, 2) and 8 nt + 2t + 1 (1, 3) of the warp's
// outputs. Grid (C / BN, cdiv(R, BM)): the column tiles of a row tile run
// next to each other, so its A rows are read from memory once. kStepSums
// as mainloop's (scripts/tile_study.py builds the tail with it).
template <class T, bool kStepSums = false, class ASrc, class Epi>
__device__ __forceinline__ void product(const ASrc& a,
                                        const float* __restrict__ w, int K,
                                        int R, const Epi& epi) {
  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  mainloop<T, ASrc, false, kStepSums>(a, w, K, R, m0, n0, acc);
  const int warp = threadIdx.x >> 5;
  epi.template store<T>(acc, m0 + (warp / T::WARPS_N) * T::WM,
                        n0 + (warp % T::WARPS_N) * T::WN, R);
}

}  // namespace gemm
}  // namespace lg
