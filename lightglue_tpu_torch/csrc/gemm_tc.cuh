// A tile product on Hopper's tensor cores, C = A B^T with fp32 sums: the
// projections and the out_proj + FFN chain of B5 and B6 (blocks.cu), and the
// score tiles of the assignment reductions B2 (assignment_fused.cu).
//
// A (R, K) holds activation rows and B (C, K) one row per output channel,
// both K-major, so a k-step copies whole 32-element row segments of each. A
// block takes BM rows x BN channels and walks K in steps of 32: the A and B
// tiles arrive by cp.async (16 bytes a thread) into a ring of STAGES steps,
// the next STAGES - 1 in flight while step k's products run (one barrier a
// step), rows padded to 40 elements so that the fragment reads fall on
// distinct banks. Each warp owns WM x WN outputs as mma.sync tiles.
//
// Two element types, a template parameter of the operands:
// - fp32 (EA = EB = float): m16n8k8 tf32 tiles; each 8-deep k-step takes its
//   channels in the order 0 2 4 6 1 3 5 7 in both operands (as attn_tc.cuh
//   does), so a fragment is one 8-byte read (a float2 of row g, channels 2t
//   and 2t + 1). Operands are split into big and small tf32 parts as they
//   are read, and every product is the 3xTF32 sum of tc.cuh.
// - bf16 (EB = bf16, the mp form): m16n8k16 bf16 tiles, one pass a product,
//   fp32 accumulators; a fragment register is one 4-byte read of two
//   adjacent channels (rows of 40 bf16 are 20 words: rows g = 0..7 start on
//   banks 0, 20, 8, 28, 16, 4, 24, 12, each read 4 words wide). The A tile
//   may stay fp32 (EA = float: lin2 reads h in fp32 and applies LayerNorm
//   and GELU to it in place); its fragments are then rounded to bf16 as
//   they are read, where the TPU kernel casts its hidden before lin2.
//
// Two compile-time hooks: the A source (the prologue) says where row r's
// channels k .. k + 31 lie and may rewrite each landed A tile in place
// (LayerNorm and GELU in lin2, from row statistics it gathers first); the
// epilogue writes a warp's accumulators (bias, rotary, statistics,
// residual). Every output is written by one block and there are no
// atomics, so a result repeats to the bit.
#pragma once

#include <type_traits>

#include "tc.cuh"

namespace lg {
namespace gemm {

constexpr int BK = 32;        // depth of a k-step
constexpr int LDS = BK + 8;   // padded row of a staged tile (elements)
constexpr int STAGES = 2;     // k-steps in the ring
constexpr int PART = 16;      // channels of one LayerNorm partial

template <int BM_, int BN_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * (BM / WM) * WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles of a warp
  static constexpr int kStage = (BM + BN) * LDS;   // floats of one fp32 stage
  // bytes of one stage of A (EA) and B (EB) tiles
  template <class EA, class EB>
  __host__ __device__ static constexpr size_t stage_bytes() {
    return BM * LDS * sizeof(EA) + BN * LDS * sizeof(EB);
  }
  // the ring, then 2 BM floats for the A source (lin2's row statistics)
  template <class EA, class EB>
  __host__ __device__ static constexpr size_t bytes() {
    return STAGES * stage_bytes<EA, EB>() + 2 * BM * sizeof(float);
  }
  static constexpr size_t kBytes = bytes<float, float>();
  static_assert(BM * (BK / 8) % THREADS == 0 && BN * (BK / 8) % THREADS == 0,
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

// The A source's hooks for a source that rewrites nothing; Elem: the A
// operand's element type in memory (an A source of bf16 rows says so).
struct NoTransform {
  using Elem = float;
  static constexpr bool kTransform = false;
  template <class T>
  __device__ void begin(float*, int, int) const {}
  template <class T>
  __device__ void transform(float*, const float*, int) const {}
};

// acc += A[m0 .., :] B[n0 .., :]^T for this block's BM x BN tile; rows at
// or past R read as 0. A source `a`: a.at(row) -> a cursor for row < R,
// a.src(cursor, k0) -> the address of the row's channels k0 .. k0 + 31
// (contiguous, of type ASrc::Elem); kTransform, begin and transform as
// NoTransform. w (C, K) row-major, of element type EB (float: 3xTF32; bf16:
// bf16 products, A rounded to bf16 where it is fp32); with kBoundB its rows
// at or past C read as 0 (else the tile's BN rows must exist); K a multiple
// of 32; dynamic shared memory T::bytes<ASrc::Elem, EB>().
// kStepSums: each 8-deep (bf16: 16-deep) step's products go into a zeroed
// register tile that an fp32 add then puts into acc. The tensor core's own
// adds truncate the products aligned to the accumulator, so over a deep K at
// large |C| its errors add up with one sign (B2 at scores up to 160, K 256,
// on an H100: 9.5e-5 from float64 summed in place, 1.3e-5 with the step
// sums, 3.1e-5 for the fp32 plain product; scripts/assign_study.py), at
// 11-12 % of B2's time. B5's and B6's products (blocks.cu) keep the
// in-place sums: over K 256 and 512 their outputs are of order 1-10, and
// every launch stays within 1.2e-5 of its plain version (chip_smoke.py,
// phase 2c), so the step sums would cost time there and buy nothing.
template <class T, class ASrc, bool kBoundB = false, bool kStepSums = false,
          class EB = float>
__device__ __forceinline__ void mainloop(const ASrc& a,
                                         const EB* __restrict__ w, int K,
                                         int R, int m0, int n0,
                                         float (&acc)[T::MT][T::NT][4],
                                         int C = 0) {
  using EA = typename ASrc::Elem;
  constexpr bool kBf16 = std::is_same_v<EB, tc::bf16>;
  static_assert(kBf16 || std::is_same_v<EA, float>,
                "3xTF32 takes fp32 operands");
  extern __shared__ __align__(16) unsigned char lg_smem_bytes[];
  // 16-byte chunks of a 32-element row segment, and their elements
  constexpr int CHA = BK * sizeof(EA) / 16, EPA = 16 / sizeof(EA);
  constexpr int CHB = BK * sizeof(EB) / 16, EPB = 16 / sizeof(EB);
  constexpr int AC = T::BM * CHA / T::THREADS, BC = T::BN * CHB / T::THREADS;
  static_assert(AC * T::THREADS == T::BM * CHA && BC * T::THREADS == T::BN * CHB,
                "each thread copies whole 16-byte chunks");
  constexpr size_t kStageBytes = T::template stage_bytes<EA, EB>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / T::WARPS_N) * T::WM, wn = (warp % T::WARPS_N) * T::WN;
  float* extra = reinterpret_cast<float*>(lg_smem_bytes + STAGES * kStageBytes);
  auto a_tile = [&](int stage) {
    return reinterpret_cast<EA*>(lg_smem_bytes + stage * kStageBytes);
  };
  auto b_tile = [&](int stage) {
    return reinterpret_cast<EB*>(lg_smem_bytes + stage * kStageBytes +
                                 T::BM * LDS * sizeof(EA));
  };

  // the thread's chunks: (row, column) in the tile, fixed over k
  typename ASrc::Cursor cur[AC];
  bool ok[AC];
#pragma unroll
  for (int i = 0; i < AC; ++i) {
    const int row = m0 + (tid + i * T::THREADS) / CHA;
    ok[i] = row < R;
    cur[i] = a.at(ok[i] ? row : m0);  // m0 < R: a valid address
  }
  const EB* wrow[BC];
  bool okb[BC];
#pragma unroll
  for (int i = 0; i < BC; ++i) {
    const int idx = tid + i * T::THREADS, c = n0 + idx / CHB;
    okb[i] = !kBoundB || c < C;
    wrow[i] = w + (size_t)(okb[i] ? c : n0) * K + EPB * (idx % CHB);
  }
  auto load = [&](int stage, int k0) {
    EA* As = a_tile(stage);
    EB* Bs = b_tile(stage);
#pragma unroll
    for (int i = 0; i < AC; ++i) {
      const int idx = tid + i * T::THREADS, c = EPA * (idx % CHA);
      tc::cp_async16(As + (idx / CHA) * LDS + c, a.src(cur[i], k0) + c, ok[i]);
    }
#pragma unroll
    for (int i = 0; i < BC; ++i) {
      const int idx = tid + i * T::THREADS;
      tc::cp_async16(Bs + (idx / CHB) * LDS + EPB * (idx % CHB), wrow[i] + k0,
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
    EA* As = a_tile(kt % STAGES);
    const EB* Bs = b_tile(kt % STAGES);
    if constexpr (ASrc::kTransform) {
      a.template transform<T>(As, extra, kt * BK);
      __syncthreads();
    }
    if constexpr (kBf16) {
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        // A fragments of the 16-deep step: (g, c), (g + 8, c), (g, c + 8),
        // (g + 8, c + 8), c = 16 ks + 2t, two channels a register
        uint32_t af[T::MT][4];
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          const EA* ap = As + (wm + 16 * mt + g) * LDS + 16 * ks + 2 * t;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const EA* p = ap + (i & 1) * 8 * LDS + (i >> 1) * 8;
            if constexpr (std::is_same_v<EA, float>) {
              const float2 f = *reinterpret_cast<const float2*>(p);
              af[mt][i] = tc::pack_bf16(f.x, f.y);
            } else {
              af[mt][i] = *reinterpret_cast<const uint32_t*>(p);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          // B fragment: (channels c, c + 1 of output g), (c + 8, c + 9)
          const EB* bp = Bs + (wn + 8 * nt + g) * LDS + 16 * ks + 2 * t;
          const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(bp),
                                  *reinterpret_cast<const uint32_t*>(bp + 8)};
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) {
            if constexpr (kStepSums) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              tc::mma_bf16(d, af[mt], bf);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mt][nt][i] += d[i];
            } else {
              tc::mma_bf16(acc[mt][nt], af[mt], bf);
            }
          }
        }
      }
    } else {
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
}

// One block's tile of C = A w^T, written by epi.store<T>(acc, first row
// and first column of the warp's WM x WN outputs, R). In the accumulator
// acc[mt][nt], a thread holds rows 16 mt + g (0, 1) and 16 mt + g + 8 (2, 3)
// and columns 8 nt + 2t (0, 2) and 8 nt + 2t + 1 (1, 3) of the warp's
// outputs. Grid (C / BN, cdiv(R, BM)): the column tiles of a row tile run
// next to each other, so its A rows are read from memory once. kStepSums
// as mainloop's (scripts/tile_study.py builds the tail with it); EB the
// weights' element type, as mainloop's.
template <class T, bool kStepSums = false, class ASrc, class Epi, class EB>
__device__ __forceinline__ void product(const ASrc& a,
                                        const EB* __restrict__ w, int K,
                                        int R, const Epi& epi) {
  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  mainloop<T, ASrc, false, kStepSums, EB>(a, w, K, R, m0, n0, acc);
  const int warp = threadIdx.x >> 5;
  epi.template store<T>(acc, m0 + (warp / T::WARPS_N) * T::WM,
                        n0 + (warp % T::WARPS_N) * T::WN, R);
}

}  // namespace gemm
}  // namespace lg
