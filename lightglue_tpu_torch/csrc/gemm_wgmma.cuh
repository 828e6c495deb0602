// The bf16 tile product (mp) on Hopper's warpgroup products: C = A W^T with
// fp32 sums for B5's and B6's projection and tail and for B4 (blocks.cu's
// _bf16 entry points). The fp32 product (3xTF32 mma.sync) stays in
// gemm_tc.cuh, with B2's score tiles.
//
// What it computes is what gemm_tc.cuh's bf16 form computed: bf16 operands,
// fp32 sums, the epilogues' arithmetic (blocks.cu: HeadsEpi, BiasEpi,
// StatsEpi, ResidualEpi) on the fp32 accumulators, and lin2's A as h in fp32
// with LayerNorm and GELU applied, rounded to bf16 as the product reads it.
// Every output is written by one block, no atomics: a result repeats to the
// bit.
//
// What bounds it on an H100: at B 16 the products are 2-9 GFLOP a launch
// (9 us at 989 TFLOP/s for lin1 over 16384 rows) against 8-34 MB of
// activations, weights, h and outputs (3-10 us at 3.35 TB/s); lin2 also
// takes an erf a hidden value.
//
// Design. A persistent grid walks the output tiles of BM rows x BN
// channels, the column tiles of a row tile next to each other (its A rows
// read from memory once). A block is BM / 64 consumer warpgroups of 64 rows
// each and a producer warpgroup; the producer runs up to 3-4 k-steps of 64
// ahead, across tile boundaries, so one tile's epilogue overlaps the next
// tile's loads. The 128-row tiles (two consumers on one tile, one block an
// SM) reuse each weight tile over more rows; the 64-row tiles give a
// launch of few rows more tiles (at B 1 the 128-row tiles leave most SMs
// idle): one consumer, two blocks an SM, so that one block's epilogue runs
// beside the other's products; or (KS 2) two consumers on the tile, each
// taking every other k-step, their sums added in shared memory, which
// halves the chain of k-steps a tile waits for (lin2's LayerNorm and GELU
// on each landed step above all). ops/block_tc.py::bf16_plan picks the
// tile and the grid (at most BLOCKS blocks an SM). Per k-step the
// weights' BN x 64 tile arrives by TMA (a 2-d tensor map over W (C, K),
// K-major, 128-byte swizzled, encoded at each launch) and A's BM x 64 tile
// by cp.async, 16 bytes a producer thread, from wherever the A source's
// hooks (blocks.cu: XSrc, CatSrc, CtxSrc and LnSrc, segments of two images)
// say a row's channels lie, written into the same 128-byte swizzle; a full
// mbarrier completes on the TMA bytes and the producer threads' cp.async
// arrivals, an empty one on the consumers' warps. Each consumer warpgroup
// runs wgmma m64nBNk16 on its 64 rows: A and W from shared memory (both
// K-major), or for lin2 (LnSrc, fp32 h) A from registers: each thread reads
// its fragment of the landed fp32 tile, applies LayerNorm (its rows'
// statistics merged from lin1's partials once a tile) and the exact erf
// GELU, rounds to bf16 and packs (each step's product waited for before the
// next step's fragments are formed: an asynchronous product reads them from
// registers). The epilogue writes the accumulators as gemm_tc.cuh's product
// does, through the same hooks, seen as a warp tile of 16 x BN.
//
// Where the time goes (H100, scripts/gemm_study.py): without its epilogue
// each of B5's launches at B 16 runs in 25-60 % of its time, faster than
// cuBLAS's whole addmm; the epilogues' stores straight from the
// accumulator registers (4 or 8 bytes a thread, eight rows a warp store)
// take the rest. Neither 16-byte stores after a quad exchange nor two
// consumers of one block on 64-row tiles of their own in turn (ping-pong)
// moved that much (both tried on the card, not kept: the first spills, the
// second loses on lin2); staging through shared memory for TMA stores is
// the next step.
#pragma once

#include <type_traits>

#include "tc.cuh"
#include "wgmma.cuh"

namespace lg {
namespace wgemm {

using tc::bf16;

constexpr int BK = 64;       // depth of a k-step: one 128-byte panel of bf16
constexpr int LDF = BK + 8;  // padded row of lin2's fp32 A tile, floats

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

template <int BM_, int BN_, int KS_ = 1>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  // KS 2: two consumer warpgroups on one 64-row tile, each taking every
  // other k-step; the second's sums are added to the first's in shared
  // memory before the epilogue
  static constexpr int KS = KS_;
  static constexpr int NC = BM / 64 * KS;         // consumer warpgroups
  // the consumers' threads, then the producer's
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int BLOCKS = NC == 1 ? 2 : 1;  // blocks an SM
  static_assert((BM == 64 || BM == 128) && (KS == 1 || BM == 64),
                "64 rows a consumer warpgroup");
  // the epilogues' view of a warp's accumulators: 16 rows x BN channels
  static constexpr int WM = 16, WN = BN, MT = 1, NT = BN / 8;
  static constexpr int kB = BN * BK * 2;  // bytes of a weight tile
  static constexpr int kRed = KS == 2 ? BM * BN * 4 : 0;  // the second's sums
  // k-steps in the ring: 4, or 3 where 4 stages of fp32 A would not fit
  // BLOCKS blocks in an SM's 227 KB
  template <class EA>
  __host__ __device__ static constexpr int stages() {
    return std::is_same_v<EA, float> &&
                   ((BM == 128 && BN == 256) || (BLOCKS == 2 && BN == 128))
               ? 3
               : 4;
  }
  template <class EA>
  __host__ __device__ static constexpr int a_bytes() {
    return std::is_same_v<EA, float> ? BM * LDF * 4 : BM * BK * 2;
  }
  template <class EA>
  __host__ __device__ static constexpr int stage_bytes() {
    return a_bytes<EA>() + kB;  // both multiples of 1024
  }
  // 1024 bytes of slack to align the tiles, the ring, the barriers
  template <class EA>
  __host__ __device__ static constexpr size_t bytes() {
    return 1024 + kRed +
           stages<EA>() * (stage_bytes<EA>() + 2 * sizeof(uint64_t));
  }
};

// Whether T is one of these tiles (a launch of this product).
template <class T>
constexpr bool kIsTile = false;
template <int BM, int BN, int KS>
constexpr bool kIsTile<Tile<BM, BN, KS>> = true;

// The tiles a launch may take, in the order of ops/block_tc.py::TILES_BF16.
using Tile0 = Tile<128, 256>;
using Tile1 = Tile<128, 128>;
using Tile2 = Tile<128, 64>;
using Tile3 = Tile<64, 128>;
using Tile4 = Tile<64, 64>;
using Tile5 = Tile<64, 128, 2>;
using Tile6 = Tile<64, 64, 2>;

template <class F>
cudaError_t with_tile(int tile, F&& f) {
  switch (tile) {
    case 0: return f(Tile0{});
    case 1: return f(Tile1{});
    case 2: return f(Tile2{});
    case 3: return f(Tile3{});
    case 4: return f(Tile4{});
    case 5: return f(Tile5{});
    case 6: return f(Tile6{});
    default: return cudaErrorInvalidValue;
  }
}

// The weights' map: W (C, K) bf16, read in 128-byte swizzled tiles of BN
// rows x 64 channels.
inline cudaError_t weight_map(CUtensorMap* map, const bf16* w, int C, int K,
                              int BN) {
  const uint64_t dims[2] = {(uint64_t)K, (uint64_t)C};
  const uint64_t strides[1] = {(uint64_t)K * 2};
  const uint32_t box[2] = {(uint32_t)BK, (uint32_t)BN};
  return wg::bf16_map(map, w, 2, dims, strides, box);
}

// cp.async's completion as one arrival on bar (counted in its init)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   wg::smem_addr(bar))
               : "memory");
}

template <int BN>
__device__ __forceinline__ void mma_ss(float (&d)[BN / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (BN == 256)
    wg::mma_ss256<0, 0>(d, da, db, accumulate);
  else if constexpr (BN == 128)
    wg::mma_ss128<0, 0>(d, da, db, accumulate);
  else
    wg::mma_ss64<0, 0>(d, da, db, accumulate);
}

template <int BN>
__device__ __forceinline__ void mma_rs(float (&d)[BN / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  if constexpr (BN == 256)
    wg::mma_rs256<0>(d, a, db, accumulate);
  else if constexpr (BN == 128)
    wg::mma_rs128<0>(d, a, db, accumulate);
  else
    wg::mma_rs64<0>(d, a, db, accumulate);
}

// C = A W^T over R rows and C channels (K deep, a multiple of 64; C a
// multiple of T::BN), through the A source `a` (a.at(row) -> a cursor for
// row < R, a.src(cursor, k0) -> the address of the row's channels k0 ..
// k0 + 63, 16-byte aligned, of type ASrc::Elem) and the epilogue
// epi.store<T>(acc, first row and first column of the warp's 16 x BN
// outputs, R). ASrc::Elem float (LnSrc) takes A from registers:
// a.row_stats(row, mean, rstd) and a.ln_gelu(v, k, mean, rstd) give two
// values' hidden (channels k, k + 1) as lin2 reads them. Every thread of
// the block (T::THREADS) calls it with dynamic shared memory
// T::bytes<ASrc::Elem>().
template <class T, class ASrc, class Epi>
__device__ __forceinline__ void product(const CUtensorMap* wmap,
                                        const ASrc& a, const Epi& epi, int K,
                                        int R, int C) {
  using EA = typename ASrc::Elem;
  constexpr bool kRegA = std::is_same_v<EA, float>;
  constexpr int STAGES = T::template stages<EA>(), BN = T::BN, BM = T::BM;
  constexpr int NC = T::NC, KS = T::KS;
  static_assert(STAGES % KS == 0, "a stage always goes to one consumer");
  constexpr int kStage = T::template stage_bytes<EA>();
  constexpr int kA = T::template a_bytes<EA>();
  extern __shared__ unsigned char lg_wgemm_smem[];
  unsigned char* base =
      lg_wgemm_smem + ((1024 - (wg::smem_addr(lg_wgemm_smem) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(base + STAGES * kStage);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + STAGES * kStage + T::kRed);
  uint64_t* empty = full + STAGES;
  const int n_col = C / BN, tiles = cdiv(R, BM) * n_col, steps = K / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::bar_init(&full[s], 128 + 1);  // the producer's threads and TMA
      wg::bar_init(&empty[s], 4 * NC / KS);  // its consumer's warps
    }
    wg::bar_init_fence();
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128;

  if (wgi == NC) {  // the producer
    if constexpr (NC == 2) wg::regs_dec<56>();
    const int p = threadIdx.x - 128 * NC;
    // 16-byte chunks of a row's k-step, and the thread's chunks of a tile
    constexpr int EPC = 16 / sizeof(EA), CH = BK / EPC, AC = BM * CH / 128;
    static_assert(AC * 128 == BM * CH, "whole 16-byte chunks a thread");
    if (p == 0) wg::prefetch_map(wmap);
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_col) * BM, n0 = (tile % n_col) * BN;
      for (int ks = 0; ks < steps; ++ks, ++it) {
        const int s = it % STAGES;
        wg::bar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* As = base + s * kStage;
        if (p == 0) {
          wg::bar_expect(&full[s], T::kB);
          wg::tma_load2(As + kA, wmap, &full[s], ks * BK, n0);
        }
#pragma unroll 1
        for (int i = 0; i < AC; ++i) {
          const int idx = p + 128 * i, r = idx / CH, c = idx % CH;
          const bool ok = m0 + r < R;  // else zeros, from a valid address
          unsigned char* dst =
              kRegA ? As + (r * LDF + c * EPC) * 4
                    : As + r * 128 + ((c ^ (r & 7)) << 4);
          tc::cp_async16(dst, a.src(a.at(ok ? m0 + r : m0), ks * BK) + c * EPC,
                         ok);
        }
        cp_async_arrive(&full[s]);
      }
    }
    tc::cp_async_wait<0>();
  } else {  // the consumers
    if constexpr (NC == 2) wg::regs_inc<224>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    int it = 0;  // the ring's k-step
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_col) * BM, n0 = (tile % n_col) * BN;
      // the warp's first row in the tile
      const int rw = (KS == 2 ? 0 : 64 * wgi) + 16 * warp;
      const int wr = m0 + rw;
      float acc[BN / 2];
      float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
      if constexpr (kRegA) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (wr + g + 8 * h < R) a.row_stats(wr + g + 8 * h, mean[h], rstd[h]);
      }
      int prev = -1;
      bool first = true;  // the consumer's first k-step of the tile
      for (int ks = 0; ks < steps; ++ks, ++it) {
        if (KS == 2 && it % 2 != wgi) continue;  // the other consumer's
        const int s = it % STAGES;
        wg::bar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* As = base + s * kStage;
        const unsigned char* Bs = As + kA;
        if constexpr (kRegA) {
          // the thread's A fragments of the four 16-deep steps: rows g, g + 8
          // of the warp, channels 16 kk + 2t (+1) and + 8 (+9)
          const float* Af =
              reinterpret_cast<const float*>(As) + (rw + g) * LDF;
          uint32_t fr[BK / 16][4];
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int h = i & 1, c = 16 * kk + 2 * t + 8 * (i >> 1);
              const float2 v =
                  *reinterpret_cast<const float2*>(Af + 8 * h * LDF + c);
              const float2 y = a.ln_gelu(v, ks * BK + c, mean[h], rstd[h]);
              fr[kk][i] = tc::pack_bf16(y.x, y.y);
            }
          wg::mma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            mma_rs<BN>(acc, fr[kk], wg::desc_sw128(Bs + 32 * kk, 16, 1024),
                       !first || kk > 0);
        } else {
          // the consumer's 64 rows of the A tile
          const unsigned char* Aw = As + (KS == 2 ? 0 : 64 * 128 * wgi);
          wg::fence_async_smem();  // cp.async's A tile, seen by wgmma
          wg::mma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            mma_ss<BN>(acc, wg::desc_sw128(Aw + 32 * kk, 16, 1024),
                       wg::desc_sw128(Bs + 32 * kk, 16, 1024),
                       !first || kk > 0);
        }
        wg::mma_commit();
        first = false;
        if constexpr (kRegA) {
          // the step's A fragments live in registers the next step's would
          // take: wait for the product before they are rewritten
          wg::mma_wait<0>();
          if (lane == 0) wg::bar_arrive(&empty[s]);
        } else {
          wg::mma_wait<1>();  // the step before has run: release its stage
          if (prev >= 0 && lane == 0) wg::bar_arrive(&empty[prev]);
          prev = s;
        }
      }
      wg::mma_wait<0>();
      wg::reg_fence(acc);
      if (!kRegA && lane == 0) wg::bar_arrive(&empty[prev]);
      if constexpr (KS == 2) {
        // the second consumer's sums to the first, which adds them to its
        // own (in this order: a result repeats to the bit) and writes
        if (wgi == 1) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) red[i * 128 + tid] = acc[i];
        }
        wg::named_sync(1, 256);
        if (wgi == 0) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += red[i * 128 + tid];
        }
        wg::named_sync(2, 256);  // read before the next tile's are written
        if (wgi == 1) continue;
      }
      epi.template store<T>(
          reinterpret_cast<const float(&)[1][T::NT][4]>(acc), wr, n0, R);
    }
  }
}

}  // namespace wgemm
}  // namespace lg
