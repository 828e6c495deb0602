// The attention key walk of K1, B1' and K2 on Hopper's tensor cores, in
// fp32 by 3xTF32, with asynchronous K/V copies and a key split.
//
// A block holds 4 warps and takes 64 query rows of one (batch, head); each
// warp owns 16 rows. Both products run as mma.sync m16n8k8 tf32 tiles with
// an fp32 accumulator (mma.sync rather than wgmma: wgmma takes tf32 B
// operands K-major only, so V would need a transpose in shared memory, and
// one warp per 16 rows keeps the softmax in the accumulator's registers).
//
// 3xTF32 (tc.cuh): each fp32 operand is split into a big and a small tf32
// part and a product sums three tf32 products in fp32, within about 1e-6
// relative of fp32.
//
// S = Q K^T: Q's fragments of the block are loaded once, scaled, and kept
// in shared memory in fragment order (thread-private, one float4 a k-step):
// at head_dim 128 they do not fit in registers beside the accumulators.
// K fragments are read from the tile and split as they are used.
//
// A tensor core's fp32 accumulation truncates each sum of products aligned
// to the accumulator, so over a long walk O drifts toward 0 with one sign
// (three such adds every 8 keys), while the row sum l, added on the CUDA
// cores, rounds to nearest. With kTileSums each key tile's P V goes into a
// zeroed register tile that an fp32 add then puts into O, as gemm_tc.cuh's
// step sums do for B2, so the truncation acts on one tile's sum only. On
// the trained matcher's own inputs at 2048 keypoints that took K2 (d 64,
// shift 12) from 2.7e-4 to 2.9e-5 of a float64 reference, and at two heads
// of 128 K1 from 7.6e-5 to 2.9e-5 and B1' from 1.4e-4 to 6.2e-5 (the fp32
// plain versions 2.9e-5, 4.3e-5 and 4.6e-5; outputs up to 9.6), for 0-3 %
// of K2's and K1's time and 0-5 % of B1''s on an H100 (scripts/walk_sums.py,
// which also builds the other orders: O's column tiles one at a time, P held
// split or split again, within 4 % of the register tile either way).
//
// O += P V without moving P: the accumulator of S gives a thread the keys
// 2t and 2t+1 of each 8-key step (t = lane % 4), where the A operand of the
// next product wants keys t and t+4. A product sums over its keys in any
// order, so each 8-key step takes its keys in the order 0 4 1 5 2 6 3 7 in
// both operands: P's fragments are then the accumulator's registers as
// they are, and V's rows are read as 2t and 2t+1. No shuffle and no staging
// buffer.
//
// K and V tiles arrive by cp.async, 16 bytes a thread, into a two-stage
// ring: tile i + 1 is in flight while tile i's products run. Rows are
// padded (Shape) so that both fragment reads (K by key row, V by key pair)
// fall on distinct banks. Rows past the key count are filled with zeros
// and masked with -inf.
//
// A key split: a block may take only the key tiles [s T / S, (s + 1) T / S)
// of its (batch, head, query tile) (T key tiles, S splits, S <= T). With S
// > 1 it writes its unnormalised output and its row max and row sum to
// scratch, and merge_splits combines the S states in split order, so a
// result repeats to the bit. The wrapper picks S (ops/flash.py).
//
// Three weightings (Walk): the exact online softmax; the constant shift
// (B1s, B3s); and a fixed shift read by the caller, with no running max and
// no rescale (K2's column direction, shifted by the largest score of the row
// direction). K2's query-row mask enters the two shifted forms as an
// additive -1e30 on the row's scores, as the TPU kernels' bias0 does.
//
// The bf16 form (E = bf16, head_dim 64 or 128: the TPU kernels fed bf16
// under mp): q, k, v and the output bf16 in memory, both products m16n8k16
// bf16 tiles with fp32 accumulators, the softmax in fp32. Q is scaled in
// fp32 and rounded to bf16 (the TPU kernels scale q in its own dtype), then
// kept in registers as A fragments (16 registers at d 64, 32 at d 128:
// beside O's 64, the P V tile's 64 and the 32-key tile's 16 scores that
// leaves room under the launch bound's 255, so Q stays out of shared
// memory at d 128 too; chip_smoke.py's phase 1 reads the spills). The m16n8k16
// accumulator of two adjacent 8-key score tiles is the A fragment of one
// 16-key step, so P goes from the accumulator into P V as it is, packed to
// bf16x2 (the rounding of the TPU kernels' e.astype(v.dtype)); no key
// permutation is needed. K's B fragments are 4-byte reads of a key row;
// V's come from ldmatrix.trans (two 8-channel tiles an instruction). Rows
// of 72 bf16 put both reads' words on distinct banks. The row sum l adds
// the fp32 weights (K1, as _attn_kernel_4d's jnp.sum(e)) or, with
// kRoundedSums, the weights rounded to bf16 (K2: its TPU kernels sum
// through a ones column of the bf16 V, so l sums what P V multiplies). The
// key tile's P V is summed apart (kTileSums) as in the fp32 form. The
// output is rounded to bf16 once, after the division by l (or in
// merge_splits).
#pragma once

#include <math.h>

#include <type_traits>

#include "tc.cuh"

namespace lg {
namespace tc {

constexpr int BQ = 64;  // query rows of a block, 16 a warp
constexpr int THREADS = 128;
constexpr float MASKED = -1e30f;  // the score bias of a masked key

// The walk's weights of a score s_rj (qb_r: the query row's bias, 0 or
// MASKED; shift2: the launch's shift):
//   kExact  exp(s_rj - max_j s_rj), an online softmax;
//   kShift  exp2(min(s_rj + qb_r - shift2, 100)), q in the log2 domain;
//   kFixed  exp(s_rj + qb_r - shift2), shift2 at or above every score.
enum Walk : int { kExact = 0, kShift = 1, kFixed = 2 };

// Keys of a tile and whether Q's fragments are kept split (big and small)
// or as fp32 and split as they are used, by head_dim, so that the blocks an
// SM holds are as many as the shared memory allows: 64 keys and split Q at
// 64 (104,448 bytes, two blocks an SM); 32 keys and fp32 Q at 128 (101,376
// bytes, two blocks an SM, where 64 keys and split Q take 204,800, one).
// kTileSums (above): the tile of P V takes 32 registers at 64 and 64 at
// 128, beside O's 32 and 64; the d-128 walks then use 234-238 registers,
// no spill (164-190 in place), still two blocks an SM.
template <int D>
struct Config;
template <>
struct Config<64> {
  static constexpr int BK = 64;
  static constexpr bool kSplitQ = true;
  static constexpr int kUnrollKs = 4;  // of the 8 steps of Q K^T
  static constexpr bool kTileSums = true;
};
template <>
struct Config<128> {
  static constexpr int BK = 32;
  static constexpr bool kSplitQ = false;
  static constexpr int kUnrollKs = 16;  // all: 1-5 % faster than 4 here
  static constexpr bool kTileSums = true;
};

// E: float (3xTF32) or bf16 (the mp form). The bf16 form keeps the key
// tile of Config<D>: at d 128 two 16-key steps a 32-key tile.
template <int D, class E = float>
struct Shape {
  static_assert(D == 64 || D == 128, "the attention takes head_dim 64 or 128");
  static constexpr bool kBf16 = std::is_same_v<E, bf16>;
  static constexpr int BK = Config<D>::BK;
  static constexpr bool kSplitQ = Config<D>::kSplitQ;
  static constexpr int NJ = BK / 8;      // 8-key steps of a tile
  static constexpr int KS = D / 8;       // 8-deep steps of Q K^T, 8-wide tiles of O
  // padded rows: fp32 K is read as (key g, channels 2t, 2t + 1) in 8-byte
  // words, V as (keys 2t and 2t + 1, channel g); D + 8 and D + 4 put each
  // read's words on distinct banks. bf16: 4-byte reads of K and
  // ldmatrix.trans rows of V, both at D + 8 (rows 4 banks apart)
  static constexpr int LDK = D + 8, LDV = kBf16 ? D + 8 : D + 4;
  static constexpr int kStage = BK * (LDK + LDV);  // elements of a K and a V tile
  // Q's fragments in shared memory (fp32 form; the bf16 form keeps them in
  // registers), floats
  static constexpr int kQ = kBf16 ? 0 : (kSplitQ ? 2 : 1) * BQ * D;
  static constexpr size_t kBytes =
      kQ * sizeof(float) + 2 * kStage * sizeof(E);
  // of an SM's 228 KB, with 1 KB reserved a block
  static constexpr int kBlocksPerSM = (228 * 1024) / (kBytes + 1024);
  // the launch bound's blocks an SM: the bf16 walk's shared memory would
  // allow 6 at d 64 and at d 128, whose 85 registers a thread would spill
  // O, the P V tile and S (96 at d 64, 144 at d 128); 2 leave the compiler
  // 255
  static constexpr int kLaunchBlocks = kBf16 ? 2 : kBlocksPerSM;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// The first key tile of split s of S over T key tiles.
__host__ __device__ __forceinline__ int split_begin(int s, int S, int T) {
  return s * T / S;
}

// Rows k0 .. k0 + BK - 1 of k and v (Nk, D) into the tiles Ks and Vs.
template <int D, class E>
__device__ __forceinline__ void load_kv(E* Ks, E* Vs,
                                        const E* __restrict__ k,
                                        const E* __restrict__ v, int k0,
                                        int Nk) {
  using S = Shape<D, E>;
  constexpr int EPC = 16 / sizeof(E);  // elements of a 16-byte chunk
  constexpr int CH = D / EPC;          // chunks of a row
#pragma unroll
  for (int i = 0; i < S::BK * CH / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / CH, c = EPC * (idx % CH);
    const bool ok = k0 + r < Nk;
    const size_t off = ok ? (size_t)(k0 + r) * D + c : 0;
    cp_async16(Ks + r * S::LDK + c, k + off, ok);
    cp_async16(Vs + r * S::LDV + c, v + off, ok);
  }
  cp_async_commit();
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void unpack(const float4& f, uint32_t a[4]) {
  a[0] = __float_as_uint(f.x);
  a[1] = __float_as_uint(f.y);
  a[2] = __float_as_uint(f.z);
  a[3] = __float_as_uint(f.w);
}

// One block's work: query tile `tile` (rows 64 tile ..) of one (batch,
// head) against key split `split` of `splits`, with
//   s_rj = (scale q_r) . k_j + (kvalid[j] ? 0 : -1e30)   (kvalid null: all valid)
// weighted as MODE says (qvalid null: every qb_r is 0; kExact ignores it).
// kExact with zero_empty: rows of a batch whose keys are all masked come
// out 0; without, they average v with equal weights, as the scores are.
// splits == 1: o[r] = sum_j w_rj v_j / max(sum_j w_rj, 1e-30) into out, and
// with rmax (kExact) the row max into rmax[row0 + r] (-inf where the row
// came out 0).
// splits > 1: the unnormalised sum into part (splits, rows, D) and (row
// max, row sum) into ml (splits, rows, 2) at row `row0` + r; the row max is
// -inf when zero_empty and the split has no valid key; merge_splits writes
// rmax.
// q, out: this (batch, head)'s (Nq, D); k, v: (Nk, D); kvalid (Nk),
// qvalid (Nq); dynamic shared memory Shape<D, E>::kBytes. E: q, k, v and
// out's element type (part, ml and rmax stay fp32); kRoundedSums (bf16):
// the row sum adds the weights rounded to bf16.
template <int MODE, int D, class E = float, bool kRoundedSums = false>
__device__ __forceinline__ void attend_block(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const bool* __restrict__ kvalid,
    const bool* __restrict__ qvalid, E* __restrict__ out,
    float* __restrict__ part, float* __restrict__ ml, float* __restrict__ rmax,
    int rows, int row0, int Nq, int Nk, int tile, int split, int splits,
    float scale, float shift2, bool zero_empty) {
  using S = Shape<D, E>;
  constexpr bool kBf16 = S::kBf16;
  constexpr int BK = S::BK, NJ = S::NJ;
  // a weight as P V multiplies it and l sums it
  auto weight = [](float e) {
    return kBf16 && kRoundedSums ? round_bf16(e) : e;
  };
  extern __shared__ __align__(16) float lg_smem[];
  float4* Qf = reinterpret_cast<float4*>(lg_smem);  // [KS][THREADS] (x2)
  // stage st at st kStage: K, then V
  E* KV = reinterpret_cast<E*>(lg_smem + S::kQ);
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int T = cdiv(Nk, BK);
  const int t0 = split_begin(split, splits, T);
  const int t1 = split_begin(split + 1, splits, T);

  load_kv<D, E>(KV, KV + BK * S::LDK, k, v, t0 * BK, Nk);

  // Q's A fragments of the warp's 16 rows, the channels of each 8-deep
  // step taken in the order 0 2 4 6 1 3 5 7 (A column t is channel 2t,
  // column t + 4 channel 2t + 1; K's B fragments alike), so that a thread's
  // two channels of a key are adjacent: a0 (g, c), a1 (g + 8, c), a2 (g,
  // c + 1), a3 (g + 8, c + 1), c = 8 ks + 2t
  const int r0 = tile * BQ + (tid >> 5) * 16 + g, r1 = r0 + 8;
  float qb[2] = {0.f, 0.f};
  if (MODE != kExact && qvalid != nullptr) {
    qb[0] = r0 < Nq && !qvalid[r0] ? MASKED : 0.f;
    qb[1] = r1 < Nq && !qvalid[r1] ? MASKED : 0.f;
  }
  // bf16: Q's A fragments of the 16-deep steps in registers, (g, c), (g +
  // 8, c), (g, c + 8), (g + 8, c + 8), c = 16 ks + 2t, scaled and rounded
  uint32_t qa[kBf16 ? D / 16 : 1][4];
  if constexpr (kBf16) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (i & 1) ? r1 : r0, c = 16 * ks + 2 * t + 8 * (i >> 1);
        const float2 f =
            r < Nq ? load2(q + (size_t)r * D + c) : make_float2(0.f, 0.f);
        qa[ks][i] = pack_bf16(scale * f.x, scale * f.y);
      }
  }
#pragma unroll
  for (int ks = 0; ks < (kBf16 ? 0 : S::KS); ++ks) {
    const int c = 8 * ks + 2 * t;
    const float a[4] = {
        r0 < Nq ? scale * to_float(q[(size_t)r0 * D + c]) : 0.f,
        r1 < Nq ? scale * to_float(q[(size_t)r1 * D + c]) : 0.f,
        r0 < Nq ? scale * to_float(q[(size_t)r0 * D + c + 1]) : 0.f,
        r1 < Nq ? scale * to_float(q[(size_t)r1 * D + c + 1]) : 0.f};
    if constexpr (S::kSplitQ) {
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
      Qf[ks * THREADS + tid] = make_float4(
          __uint_as_float(ab[0]), __uint_as_float(ab[1]),
          __uint_as_float(ab[2]), __uint_as_float(ab[3]));
      Qf[(S::KS + ks) * THREADS + tid] = make_float4(
          __uint_as_float(as[0]), __uint_as_float(as[1]),
          __uint_as_float(as[2]), __uint_as_float(as[3]));
    } else {
      Qf[ks * THREADS + tid] = make_float4(a[0], a[1], a[2], a[3]);
    }
  }

  // o[n]: rows g (0, 1) and g + 8 (2, 3), channels 8 n + 2t (+1)
  float o[S::KS][4];
#pragma unroll
  for (int n = 0; n < S::KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  bool valid = kvalid == nullptr;

  for (int kt = t0; kt < t1; ++kt) {
    const int st = (kt - t0) & 1;
    if (kt + 1 < t1) {
      E* nxt = KV + (st ^ 1) * S::kStage;
      load_kv<D, E>(nxt, nxt + BK * S::LDK, k, v, (kt + 1) * BK, Nk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every thread
    const E* Ks = KV + st * S::kStage;
    const E* Vs = Ks + BK * S::LDK;

    // s[j]: rows g (0, 1) and g + 8 (2, 3), keys 8 j + 2t (+1)
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kBf16) {
      // B (k x n) = K^T: (channels c, c + 1 of key g), (c + 8, c + 9)
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const E* kp = Ks + (8 * j + g) * S::LDK + 16 * ks + 2 * t;
          const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kp),
                                 *reinterpret_cast<const uint32_t*>(kp + 8)};
          mma_bf16(s[j], qa[ks], b);
        }
    }
#pragma unroll(Config<D>::kUnrollKs)
    for (int ks = 0; ks < (kBf16 ? 0 : S::KS); ++ks) {
      uint32_t ab[4], as[4];
      if constexpr (S::kSplitQ) {
        unpack(Qf[ks * THREADS + tid], ab);
        unpack(Qf[(S::KS + ks) * THREADS + tid], as);
      } else {
        const float4 f = Qf[ks * THREADS + tid];
        split_tf32(f.x, ab[0], as[0]);
        split_tf32(f.y, ab[1], as[1]);
        split_tf32(f.z, ab[2], as[2]);
        split_tf32(f.w, ab[3], as[3]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        // B (k x n) = K^T: b0 (channel 2t, key g), b1 (2t + 1, key g)
        const float2 kf = load2(Ks + (8 * j + g) * S::LDK + 8 * ks + 2 * t);
        uint32_t bb[2], bs[2];
        split_tf32(kf.x, bb[0], bs[0]);
        split_tf32(kf.y, bb[1], bs[1]);
        mma3(s[j], ab, as, bb, bs);
      }
    }

    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        float kb = 0.f;
        if (kvalid != nullptr && key < Nk) {
          const bool ok = kvalid[key];
          kb = ok ? 0.f : MASKED;
          valid |= ok;
        }
        if (MODE == kExact) {
          s[j][e] = key < Nk ? s[j][e] + kb : -INFINITY;
          s[j][e + 2] = key < Nk ? s[j][e + 2] + kb : -INFINITY;
        } else {
          s[j][e] = key < Nk ? s[j][e] + kb + qb[0] : -INFINITY;
          s[j][e + 2] = key < Nk ? s[j][e + 2] + kb + qb[1] : -INFINITY;
        }
      }

    if (MODE != kExact) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] = weight(MODE == kShift
                               ? exp2f(fminf(s[j][c] - shift2, 100.f))
                               : expf(s[j][c] - shift2));
          l_run[c >> 1] += s[j][c];
        }
    } else {
      // each tile holds a key below Nk, so the new max is finite
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mt = fmaxf(mt, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m_run[r], mt);
        const float alpha = expf(m_run[r] - m_new);  // 0 on the first tile
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[j][2 * r + e] = weight(expf(s[j][2 * r + e] - m_new));
            ps += s[j][2 * r + e];
          }
        l_run[r] = l_run[r] * alpha + ps;
        m_run[r] = m_new;
#pragma unroll
        for (int n = 0; n < S::KS; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }
    }

    // O += P V, keys of step j taken as 2t (A column t) and 2t + 1 (A
    // column t + 4): a = (s0, s2, s1, s3), b0 = V[2t], b1 = V[2t + 1]; with
    // kTileSums into the tile pv, then added to O. bf16: 16-key steps,
    // a = (s[2jj] 0 1, s[2jj] 2 3, s[2jj + 1] 0 1, s[2jj + 1] 2 3) packed,
    // V's fragments of two 8-channel tiles from one ldmatrix.trans (lanes
    // 0-15: keys 16 jj + lane % 16 of the first tile, 16-31 of the second)
    constexpr bool kTileSums = Config<D>::kTileSums;
    float pv[kTileSums ? S::KS : 1][4];
    if constexpr (kTileSums) {
#pragma unroll
      for (int n = 0; n < S::KS; ++n)
        pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
    }
    if constexpr (kBf16) {
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        const uint32_t pa[4] = {pack_bf16(s[2 * jj][0], s[2 * jj][1]),
                                pack_bf16(s[2 * jj][2], s[2 * jj][3]),
                                pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                                pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3])};
        const E* vrow = Vs + (16 * jj + (lane & 15)) * S::LDV + 8 * (lane >> 4);
#pragma unroll
        for (int n = 0; n < S::KS; n += 2) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vrow + 8 * n);
          mma_bf16(kTileSums ? pv[n] : o[n], pa, vb);
          mma_bf16(kTileSums ? pv[n + 1] : o[n + 1], pa, vb + 2);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < (kBf16 ? 0 : NJ); ++j) {
      uint32_t pb[4], ps[4];
      split_tf32(s[j][0], pb[0], ps[0]);
      split_tf32(s[j][2], pb[1], ps[1]);
      split_tf32(s[j][1], pb[2], ps[2]);
      split_tf32(s[j][3], pb[3], ps[3]);
      const E* vp = Vs + (8 * j + 2 * t) * S::LDV + g;
#pragma unroll
      for (int n = 0; n < S::KS; ++n) {
        uint32_t bb[2], bs[2];
        split_tf32(to_float(vp[8 * n]), bb[0], bs[0]);
        split_tf32(to_float(vp[S::LDV + 8 * n]), bb[1], bs[1]);
        if constexpr (kTileSums)
          mma3(pv[n], pb, ps, bb, bs);
        else
          mma3(o[n], pb, ps, bb, bs);
      }
    }
    if constexpr (kTileSums) {
#pragma unroll
      for (int n = 0; n < S::KS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[n][i] += pv[n][i];
    }
    __syncthreads();  // every read of this stage is done before its reload
  }

  // the row sums over the quad; whether any key of the split is valid
  // (the lanes of a warp together cover every key)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  valid = __any_sync(0xffffffffu, valid);
  const bool empty = MODE == kExact && zero_empty && !valid;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? r1 : r0;
    if (row >= Nq) continue;
    if (splits == 1) {
      const float l = fmaxf(l_run[r], 1e-30f);
      E* dst = out + (size_t)row * D + 2 * t;
#pragma unroll
      for (int n = 0; n < S::KS; ++n) {
        if (empty)
          store2(dst + 8 * n, 0.f, 0.f);
        else
          store2(dst + 8 * n, o[n][2 * r] / l, o[n][2 * r + 1] / l);
      }
      if (MODE == kExact && rmax != nullptr && t == 0)
        rmax[row0 + row] = empty ? -INFINITY : m_run[r];
    } else {
      const size_t prow = (size_t)split * rows + row0 + row;
      float* dst = part + prow * D + 2 * t;
#pragma unroll
      for (int n = 0; n < S::KS; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(o[n][2 * r], o[n][2 * r + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(ml + 2 * prow) =
            make_float2(empty ? -INFINITY : m_run[r], l_run[r]);
    }
  }
}

// o[row] = sum_s w_s part[s][row] / max(sum_s w_s l_s, 1e-30) over rows
// (rows, D), w_s = exp(m_s - max_s m_s) (exact; 0 when every m_s is -inf,
// which leaves the row 0) or 1 (SHIFT: the shifted walks, kShift and
// kFixed); splits summed in order. Exact, with rmax: the row max max_s m_s
// into rmax[row]. One thread per 4 channels of a row; o in E (bf16: rounded
// once, here).
template <bool SHIFT, class E = float>
__global__ void __launch_bounds__(256)
    merge_splits(const float* __restrict__ part, const float* __restrict__ ml,
                 E* __restrict__ o, float* __restrict__ rmax, int rows,
                 int D, int splits) {
  const int per_row = D / 4;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)rows * per_row) return;
  const int row = (int)(i / per_row), c = 4 * (int)(i % per_row);
  float mx = 0.f;
  if (!SHIFT) {
    mx = -INFINITY;
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, ml[2 * ((size_t)s * rows + row)]);
    if (rmax != nullptr && c == 0) rmax[row] = mx;
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  if (SHIFT || mx != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const size_t pr = (size_t)s * rows + row;
      const float w = SHIFT ? 1.f : expf(ml[2 * pr] - mx);
      const float4 p = *reinterpret_cast<const float4*>(part + pr * D + c);
      l += w * ml[2 * pr + 1];
      acc.x += w * p.x;
      acc.y += w * p.y;
      acc.z += w * p.z;
      acc.w += w * p.w;
    }
    l = fmaxf(l, 1e-30f);
    acc = make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
  }
  store2(o + (size_t)row * D + c, acc.x, acc.y);
  store2(o + (size_t)row * D + c + 2, acc.z, acc.w);
}

}  // namespace tc
}  // namespace lg
