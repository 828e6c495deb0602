// The bf16 attention key walk (mp) of K1, B1s, B1', K2's three walks and
// B5's attention on Hopper's warpgroup products: wgmma fed by TMA, with a
// producer warp and two consumer warpgroups. The fp32 walk (3xTF32
// mma.sync) stays in attn_tc.cuh, whose split merge (merge_splits), weightings
// (Walk) and split bounds this walk shares.
//
// What it computes is what attn_tc.cuh's bf16 form computed (the TPU kernels
// fed bf16 under mp): q scaled in fp32 and rounded to bf16 (the caller passes
// the scale rounded to bf16); the scores and the softmax in fp32; the weights
// rounded to bf16 before P V; the row sum l adding the fp32 weights, or with
// kRoundedSums (K2) the rounded ones; the output rounded to bf16 once, after
// the division by l (or in merge_splits). Three weightings (exact, constant
// shift, fixed shift with K2's query bias), the key mask, all-masked rows set
// to 0 (zero_empty), rows and keys past the ends, and the key split with its
// in-order merge, so every result repeats to the bit.
//
// What bounds it on an H100: the two products, 4 Nq Nk d flops a (batch,
// head), at 989 TFLOP/s bf16 (0.0695 ms at (4, 4, 4096, 64)); the softmax's
// exponentials (one a score, MUFU at 16 a clock an SM) take about as long,
// so they have to run beside the products, not between them.
//
// Design. A block of 384 threads takes 128 query rows of one (batch, head)
// and one key split: warpgroup 2 is the producer (its first thread issues
// the TMA loads), warpgroups 0 and 1 the consumers, 64 query rows each. K
// and V arrive in 64-key tiles of 128-byte swizzled 64-channel panels (one
// panel at d 64, two at d 128) by cp.async.bulk.tensor from 3-d tensor maps
// over (batch head, key, channel), zeros past Nk, into a ring of 4 stages;
// a full mbarrier a stage completes on the bytes, an empty one on the
// consumers' eight warps. Each consumer writes its Q rows, scaled and
// rounded, into its own swizzled panels once, then per key tile:
//   S = Q K^T   wgmma m64n64k16, A and B from shared memory (both K-major),
//               fp32 accumulators;
//   softmax     in the accumulator's registers: a thread holds rows g and
//               g + 8 and keys 8 j + 2t (+1); the key mask as two warp
//               ballots a tile; exp(s - max) as ex2(s log2(e) - max log2(e))
//               on the MUFU, one fma and one ex2 a score (the subtraction
//               first where the max is a masked score, near -1e30), the
//               shifted forms as ex2 of the shifted score: the same fp32
//               softmax as expf within a few fp32 ulps;
//   pv = P V    wgmma m64nDk16 with P from registers (the accumulator of two
//               adjacent 8-key tiles is the A fragment of one 16-key step,
//               packed to bf16x2) and V as an MN-major B (the transpose bit;
//               no transpose in shared memory);
//   O = alpha O + pv  (kTileSums: the tensor core's own accumulation
//               truncates, so each tile's P V is summed apart and added in
//               fp32, as in the mma.sync walk; kept, without a new study).
// At d 64 tile i's softmax runs while tile i - 1's P V holds the tensor
// cores (S of tile i and P V of tile i - 1 issued together, the wait taking
// S alone), with setmaxnreg giving the consumers 232 registers and the
// producer 40; at d 128 S, P and both P V sums at once need more than 232,
// so the tiles run in turn (161 registers, no setmaxnreg), and it is the
// two consumer warpgroups, unsynchronised on the same stages, whose
// softmax and products overlap (scripts/walk_study.py times each form at
// both head_dims). The split and its merge are those of attn_tc.cuh: a
// block writes its unnormalised output and (max, sum) to scratch when the
// call is split.
#pragma once

#include "attn_tc.cuh"
#include "wgmma.cuh"

namespace lg {
namespace wg {

using tc::bf16;

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the MUFU (one instruction; 0 for -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct WalkShape {
  static_assert(D == 64 || D == 128, "the attention takes head_dim 64 or 128");
  static constexpr int BQ = 128;       // query rows of a block
  static constexpr int BK = 64;  // keys of a tile: S is one m64n64 product
  // tile i's softmax beside tile i - 1's P V (S, P and both P V sums
  // live at once: at d 128 that is over the consumers' 232 registers)
  static constexpr bool kPipelined = D == 64;
  static constexpr int THREADS = 384;
  static constexpr int PANELS = D / 64;
  static constexpr int STAGES = 4;
  static constexpr int kPanel = BK * 128;  // bytes of a BK x 64 panel
  static constexpr int kQ = 2 * PANELS * 64 * 128;  // both warpgroups' Q
  static constexpr int kTile = PANELS * kPanel;    // a K or a V tile
  static constexpr int kStage = 2 * kTile;
  // 1024 bytes of slack to align the tiles, then Q, the ring, the barriers
  static constexpr size_t kBytes =
      1024 + kQ + STAGES * kStage + 2 * STAGES * sizeof(uint64_t);
};

// A (batch head, key, channel) bf16 tensor's map for the walk's tiles.
inline cudaError_t walk_map(CUtensorMap* map, const bf16* t, int BH, int N,
                            int D) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)N, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)N * D * 2};
  const uint32_t box[3] = {64, 64, 1};
  return bf16_map(map, t, 3, dims, strides, box);
}

// One block's work, as attn_tc.cuh::attend_block's (whose comment states
// the arguments), with K and V read through kmap and vmap at (batch head)
// coordinate bh, 128 query rows a tile, and q, out bf16 (16-byte aligned
// rows). Launched with WalkShape<D>::THREADS threads and kBytes of dynamic
// shared memory; every thread of the block calls it.
template <int MODE, int D, bool kRoundedSums = false>
__device__ __forceinline__ void attend_wg(
    const CUtensorMap* kmap, const CUtensorMap* vmap, int bh,
    const bf16* __restrict__ q, const bool* __restrict__ kvalid,
    const bool* __restrict__ qvalid, bf16* __restrict__ out,
    float* __restrict__ part, float* __restrict__ ml,
    float* __restrict__ rmax, int rows, int row0, int Nq, int Nk, int tile,
    int split, int splits, float scale, float shift2, bool zero_empty) {
  using S = WalkShape<D>;
  constexpr int BK = S::BK, NJ = BK / 8, NO = D / 2;
  extern __shared__ unsigned char lg_wg_smem[];
  unsigned char* base =
      lg_wg_smem + ((1024 - (smem_addr(lg_wg_smem) & 1023)) & 1023);
  unsigned char* KV = base + S::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + S::STAGES * S::kStage);
  uint64_t* empty = full + S::STAGES;
  const int T = tc::cdiv(Nk, BK);
  const int t0 = tc::split_begin(split, splits, T);
  const int t1 = tc::split_begin(split + 1, splits, T);
  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 8);  // the consumers' warps
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wgi == 2) {  // the producer
    if constexpr (S::kPipelined) regs_dec<40>();
    if (threadIdx.x == 256) {
      prefetch_map(kmap);
      prefetch_map(vmap);
      for (int kt = t0; kt < t1; ++kt) {
        const int i = kt - t0, s = i % S::STAGES;
        bar_wait(&empty[s], ((i / S::STAGES) & 1) ^ 1);
        unsigned char* st = KV + s * S::kStage;
        bar_expect(&full[s], S::kStage);
#pragma unroll 1
        for (int p = 0; p < S::PANELS; ++p) {
          tma_load3(st + p * S::kPanel, kmap, &full[s], 64 * p, kt * BK, bh);
          tma_load3(st + S::kTile + p * S::kPanel, vmap, &full[s], 64 * p,
                    kt * BK, bh);
        }
      }
    }
  } else {  // the consumers
    if constexpr (S::kPipelined) regs_inc<232>();
    const int tid = threadIdx.x & 127, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // this warpgroup's 64 query rows, scaled in fp32 and rounded, into its
    // swizzled panels of 64 x 64 (16 bytes a thread at a time; rows past Nq
    // zero)
    constexpr int kQPanel = 64 * 128;
    unsigned char* Qw = base + wgi * S::PANELS * kQPanel;
    const int q0 = tile * S::BQ + 64 * wgi;
    for (int idx = tid; idx < 64 * D / 8; idx += 128) {
      const int r = idx / (D / 8), ch = idx % (D / 8);
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < Nq)
        raw = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * D + 8 * ch);
      uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        w[i] = tc::pack_bf16(scale * f.x, scale * f.y);
      }
      *reinterpret_cast<uint4*>(Qw + (ch >> 3) * kQPanel + r * 128 +
                                (((ch & 7) ^ (r & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    fence_async_smem();
    named_sync(1 + wgi, 128);

    const int r0 = q0 + 16 * (tid >> 5) + g, r1 = r0 + 8;
    float qb[2] = {0.f, 0.f};
    if (MODE != tc::kExact && qvalid != nullptr) {
      qb[0] = r0 < Nq && !qvalid[r0] ? tc::MASKED : 0.f;
      qb[1] = r1 < Nq && !qvalid[r1] ? tc::MASKED : 0.f;
    }

    // o[4 n + c]: rows g (c 0, 1) and g + 8 (2, 3), channels 8 n + 2t (+1)
    float o[NO];
#pragma unroll
    for (int c = 0; c < NO; ++c) o[c] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f};  // O's rescale before the pending P V
    bool valid = kvalid == nullptr;
    // s[4 j + c]: rows g (c 0, 1) and g + 8 (2, 3), keys 8 j + 2t (+1)
    float s[4 * NJ];
    // P's A fragments of the four 16-key steps: (g, 2t..), (g + 8, 2t..),
    // (g, 2t + 8..), (g + 8, 2t + 8..) are the accumulator's 8-key tiles
    // 2 kk and 2 kk + 1 as they are
    uint32_t pa[BK / 16][4];
    float pv[NO];

    auto stage_of = [](int i) { return i % S::STAGES; };
    // S = Q K^T of tile t0 + i, issued (after its stage has landed)
    auto issue_scores = [&](int i) {
      bar_wait(&full[stage_of(i)], (i / S::STAGES) & 1);
      const unsigned char* Ks = KV + stage_of(i) * S::kStage;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int q = (ks >> 2) * kQPanel + 32 * (ks & 3);
        const int k = (ks >> 2) * S::kPanel + 32 * (ks & 3);
        mma_ss64<0, 0>(s, desc_sw128(Qw + q, 16, 1024),
                       desc_sw128(Ks + k, 16, 1024), ks > 0);
      }
      mma_commit();
    };
    // pv = P V of tile t0 + i, issued
    auto issue_pv = [&](int i) {
      const unsigned char* Vs = KV + stage_of(i) * S::kStage + S::kTile;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // keys 16 kk .. of the V tile, MN-major: 8-key groups 1024 bytes
        // apart, 64-channel panels kPanel apart
        const uint64_t dv = desc_sw128(Vs + 2048 * kk, S::kPanel, 1024);
        if constexpr (D == 64)
          mma_rs64<1>(pv, pa[kk], dv, kk > 0);
        else
          mma_rs128<1>(pv, pa[kk], dv, kk > 0);
      }
      mma_commit();
    };
    // the registers of an A operand that an asynchronous product reads,
  // held live (and so not reused) up to this point
  auto keep = [](uint32_t(&a)[BK / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" ::"r"(a[kk][r]));
  };
  // the landed pv into O (the tile's P V summed apart, then added in fp32),
    // and the tile's stage released by this warp
    auto add_pv = [&](int i) {
      reg_fence(pv);
      if (lane == 0) bar_arrive(&empty[stage_of(i)]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[4 * n + c] = fmaf(o[4 * n + c], alpha[c >> 1], pv[4 * n + c]);
    };
    // the landed scores of tile t0 + i into weights: masks, row max, the
    // exponentials (exp(x) as ex2(x log2(e)), x = s - max or s - shift: an
    // fma of s log2(e) and the shift would lose x when both are near -1e30,
    // the mask); the new rescale of O into a_next, the row sums after the
    // weights are packed
    float a_next[2] = {1.f, 1.f};
    auto softmax = [&](int i) {
      reg_fence(s);
      const int k0 = (t0 + i) * BK;
      if (kvalid != nullptr || k0 + BK > Nk) {
        // lane l's ballots: keys 64 h + 2 l (vb[2 h]) and 64 h + 2 l + 1
        // (vb[2 h + 1]) of the tile valid (and below Nk), shifted to this
        // thread's keys: bit 4 j of vb[2 (j / 8) + e] is key 8 j + 2t + e
        uint32_t vb[BK / 32];
#pragma unroll
        for (int h = 0; h < BK / 32; ++h) vb[h] = ~0u;
        if (kvalid != nullptr) {
          uint32_t any = 0u;
#pragma unroll
          for (int h = 0; h < BK / 32; ++h) {
            const int ka = k0 + 64 * (h >> 1) + 2 * lane + (h & 1);
            vb[h] = __ballot_sync(0xffffffffu, ka < Nk && kvalid[ka]);
            any |= vb[h];
            vb[h] >>= t;
          }
          valid |= any != 0u;
        }
        const bool ragged = k0 + BK > Nk;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float kb = (vb[2 * (j >> 3) + e] >> (4 * (j & 7))) & 1u
                           ? 0.f
                           : tc::MASKED;
            if (ragged && k0 + 8 * j + 2 * t + e >= Nk) kb = -INFINITY;
            s[4 * j + e] += kb;
            s[4 * j + 2 + e] += kb;
          }
      }
      if (MODE != tc::kExact) {
#pragma unroll
        for (int c = 0; c < 4 * NJ; ++c) {
          const float x = s[c] + qb[(c >> 1) & 1] - shift2;
          s[c] = MODE == tc::kShift ? ex2(fminf(x, 100.f)) : ex2(x * kLog2e);
        }
        a_next[0] = a_next[1] = 1.f;
      } else {
        // each tile holds a key below Nk, so the new max is finite
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mt = -INFINITY;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mt = fmaxf(mt, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
          const float m_new = fmaxf(m_run[r], mt);
          a_next[r] = ex2((m_run[r] - m_new) * kLog2e);  // 0 on the first tile
          m_run[r] = m_new;
          // s log2(e) - m log2(e) in one fma where the row max is a score;
          // where it is a masked one (near -1e30, every key masked) the
          // subtraction comes first, which keeps the differences
          const float ml = m_new * kLog2e;
          const bool wide = m_new > 0.5f * tc::MASKED;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * j + 2 * r + e];
              x = ex2(wide ? fmaf(x, kLog2e, -ml) : (x - m_new) * kLog2e);
            }
        }
      }
    };
    // the weights packed to bf16 as P, and the row sums: of the fp32
    // weights, or with kRoundedSums of the packed ones
    auto pack = [&]() {
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float lo = s[8 * kk + 2 * r], hi = s[8 * kk + 2 * r + 1];
          pa[kk][r] = tc::pack_bf16(lo, hi);
          if constexpr (kRoundedSums) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&pa[kk][r]));
            ps[r & 1] += f.x + f.y;
          } else {
            ps[r & 1] += lo + hi;
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] = l_run[r] * a_next[r] + ps[r];
        alpha[r] = a_next[r];
      }
    };

    // Pipelined, tile i's softmax runs while tile i - 1's P V holds the
    // tensor cores: S of tile i and P V of tile i - 1 are issued together,
    // the wait takes S alone, and O takes pv after the softmax.
    const int n = t1 - t0;
    if constexpr (S::kPipelined) {
      mma_fence();
      issue_scores(0);
      mma_wait<0>();
      softmax(0);
      pack();
      for (int i = 1; i < n; ++i) {
        mma_fence();
        issue_scores(i);
        issue_pv(i - 1);
        mma_wait<1>();
        softmax(i);
        mma_wait<0>();
        keep(pa);  // P of tile i - 1 stays in its registers until here
        add_pv(i - 1);
        pack();
      }
      mma_fence();
      issue_pv(n - 1);
      mma_wait<0>();
      add_pv(n - 1);
    } else {
      for (int i = 0; i < n; ++i) {
        mma_fence();
        issue_scores(i);
        mma_wait<0>();
        softmax(i);
        pack();
        mma_fence();
        issue_pv(i);
        mma_wait<0>();
        add_pv(i);
      }
    }

    // the row sums over the quad; whether any key of the split is valid
    // (the lanes of a warp together cover every key)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    valid = __any_sync(0xffffffffu, valid);
    const bool is_empty = MODE == tc::kExact && zero_empty && !valid;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r1 : r0;
      if (row >= Nq) continue;
      if (splits == 1) {
        const float l = fmaxf(l_run[r], 1e-30f);
        bf16* dst = out + (size_t)row * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          if (is_empty)
            tc::store2(dst + 8 * n, 0.f, 0.f);
          else
            tc::store2(dst + 8 * n, o[4 * n + 2 * r] / l,
                       o[4 * n + 2 * r + 1] / l);
        }
        if (MODE == tc::kExact && rmax != nullptr && t == 0)
          rmax[row0 + row] = is_empty ? -INFINITY : m_run[r];
      } else {
        const size_t prow = (size_t)split * rows + row0 + row;
        float* dst = part + prow * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(dst + 8 * n) =
              make_float2(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
        if (t == 0)
          *reinterpret_cast<float2*>(ml + 2 * prow) =
              make_float2(is_empty ? -INFINITY : m_run[r], l_run[r]);
      }
    }
  }
}

// The dynamic shared memory of the walk at head_dim D, allowed for `kernel`.
template <int D, class Kernel>
cudaError_t allow_walk_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)WalkShape<D>::kBytes);
}

}  // namespace wg
}  // namespace lg
