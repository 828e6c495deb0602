// Shared pieces of the matcher kernels: fp32 SIMT tiles in shared memory.
//
// Every kernel here works on 64 x 64 tiles with 256 threads. For a tile
// product a thread owns a 4 x 4 block of outputs, rows ty + 16*i and
// columns tx + 16*j (ty = t / 16, tx = t % 16), so a warp reads two rows of
// the left tile (broadcast) and 16 consecutive rows of the right tile, which
// the padded leading dimension LD spreads over distinct banks. Row-wise
// reductions (max, sum, argmax) use four threads per row, each over 16
// consecutive columns, combined with two xor shuffles.
//
// Shared memory is always the one dynamic buffer `lg_smem`, carved by each
// kernel; above 48 KB the launcher raises the kernel's limit first.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lg {

constexpr int TILE = 64;      // rows of a query tile and of a key tile
constexpr int HD = 64;        // depth of one tile product (a 64-channel chunk)
constexpr int LD = TILE + 1;  // padded leading dimension of tiles read by rows
constexpr int THREADS = 256;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// dst[r][c] = scale * src[(row0 + r) * src_ld + col0 + c] for r, c < 64;
// rows at or past n_rows read as 0.
__device__ __forceinline__ void load_tile(float* dst, int dst_ld,
                                          const float* __restrict__ src,
                                          int row0, int n_rows, int src_ld,
                                          int col0, float scale) {
  for (int idx = threadIdx.x; idx < TILE * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD;
    const int row = row0 + r;
    dst[r * dst_ld + c] =
        row < n_rows ? scale * src[(size_t)row * src_ld + col0 + c] : 0.f;
  }
}

// acc[i][j] += sum_d A[ty + 16i][d] * B[tx + 16j][d] over one 64-deep chunk
// (A and B with leading dimension LD). The sum runs over d in order, so the
// same two rows give the same bits whichever side they come from.
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         float acc[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k P[ty + 16i][k] * V[k][tx + 16j] for j < NJ (P with LD,
// V with leading dimension 16 NJ: 64 or 128 columns).
template <int NJ = 4>
__device__ __forceinline__ void tile_pv(const float* P, const float* V,
                                        float acc[4][NJ]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    float p[4], v[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * LD + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) v[j] = V[k * 16 * NJ + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
  }
}

// Reductions over the four threads of one row group (lanes 4r .. 4r+3).
__device__ __forceinline__ float group4_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float group4_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shared-memory carve of the row attention below, for head_dim D (64 or
// 128). A row of q or k is NC = D / 64 chunks of 64 channels, each chunk a
// 64 x LD tile, so a score tile is NC tile products in chunk order. At 64
// the value tile has its own buffer and is loaded with the keys. At 128 it
// overwrites the keys once the scores are taken (a 64 x 128 value tile is
// 8192 floats, the two key chunks 8320): 83.7 KB a block instead of 117,
// two blocks per SM instead of one.
template <int D>
struct AttnShape {
  static_assert(D == 64 || D == 128, "the attention takes head_dim 64 or 128");
  static constexpr int NC = D / HD;       // 64-channel chunks of a row
  static constexpr int NJ = D / 16;       // accumulator columns a thread
  static constexpr bool kVOverK = NC > 1;  // values overwrite the keys
  static constexpr int kKV = NC * TILE * LD + (kVOverK ? 0 : TILE * D);
  // floats: queries, keys (and values), scores, row_a, row_m, the flag
  static constexpr int kFloats = NC * TILE * LD + kKV + TILE * LD + 2 * TILE + 4;
  static_assert(!kVOverK || TILE * D <= kKV, "values must fit over the keys");
};

struct AttnTile {
  float* Qs;     // NC chunks of 64 x LD, pre-scaled queries
  float* Ks;     // NC chunks of 64 x LD
  float* Vs;     // 64 x D
  float* Ss;     // 64 x LD, scores then weights
  float* row_a;  // 64: per-row rescale, then the row sum
  float* row_m;  // 64: per-row max
  int* any_valid;
};

template <int D>
__device__ __forceinline__ AttnTile carve_attn(float* base) {
  using S = AttnShape<D>;
  AttnTile sm;
  sm.Qs = base;
  sm.Ks = sm.Qs + S::NC * TILE * LD;
  sm.Vs = S::kVOverK ? sm.Ks : sm.Ks + S::NC * TILE * LD;
  sm.Ss = sm.Ks + S::kKV;
  sm.row_a = sm.Ss + TILE * LD;
  sm.row_m = sm.row_a + TILE;
  sm.any_valid = reinterpret_cast<int*>(sm.row_m + TILE);
  return sm;
}

// Rows k0 .. k0 + 63 of a (Nk, D) matrix into NC chunks of 64 x LD (keys:
// dst_ld LD, chunk stride 64 LD) or into one 64 x D tile (values: dst_ld D,
// chunk stride 64).
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int dst_ld,
                                          int chunk_stride,
                                          const float* __restrict__ src,
                                          int k0, int Nk) {
#pragma unroll
  for (int c = 0; c < D / HD; ++c)
    load_tile(dst + c * chunk_stride, dst_ld, src, k0, Nk, D, c * HD, 1.f);
}

// The key loop of one 64-row query tile, already in sm.Qs (pre-scaled),
// against all Nk keys of one (batch, head), in 64-key tiles, with
//   s_rj = q_r . k_j + kbias[j]   (kbias: 0 valid / -1e30 masked, or null),
// the dot product over the NC chunks in order.
// Exact (!SHIFT): an online softmax, weights exp(s_rj - max_j s_rj) with a
// running max and sum. SHIFT: weights exp2(min(s_rj - shift2, 100)) with no
// max (q in the log2 domain); a masked key's weight is exactly 0.
// On return (synchronised) acc[i][j] holds sum_j w_rj v_j for row ty + 16i
// and channel tx + 16j (j < D / 16), sm.row_a[r] the row sum, sm.row_m[r]
// the row max (exact), *sm.any_valid whether some key has kbias >= 0.
template <bool SHIFT, int D>
__device__ __forceinline__ void attend_keys(const AttnTile& sm,
                                            const float* __restrict__ kb,
                                            const float* __restrict__ vb,
                                            const float* __restrict__ bias,
                                            int Nk, float shift2,
                                            float acc[4][D / 16]) {
  using S = AttnShape<D>;
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int r = t >> 2, seg = t & 3;
  if (t == 0) *sm.any_valid = 0;
  float m_run = -INFINITY, l_run = 0.f;  // this row's, same in its 4 threads

  for (int k0 = 0; k0 < Nk; k0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(sm.Ks, LD, TILE * LD, kb, k0, Nk);
    if (!S::kVOverK) load_rows<D>(sm.Vs, D, HD, vb, k0, Nk);
    __syncthreads();
    float s[4][4] = {};
#pragma unroll
    for (int c = 0; c < S::NC; ++c)
      tile_abt(sm.Qs + c * TILE * LD, sm.Ks + c * TILE * LD, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        sm.Ss[(ty + 16 * i) * LD + tx + 16 * j] =
            col < Nk ? s[i][j] + (bias ? bias[col] : 0.f) : -INFINITY;
      }
    if (bias && t < TILE && k0 + t < Nk && bias[k0 + t] >= 0.f)
      *sm.any_valid = 1;
    __syncthreads();  // also: every read of the keys is done
    if (S::kVOverK) load_rows<D>(sm.Vs, D, HD, vb, k0, Nk);

    float* srow = sm.Ss + r * LD + seg * 16;
    if (SHIFT) {
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = exp2f(fminf(srow[c] - shift2, 100.f));
        srow[c] = p;
        ps += p;
      }
      l_run += group4_sum(ps);
      __syncthreads();
    } else {
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mt = fmaxf(mt, srow[c]);
      const float m_new = fmaxf(m_run, group4_max(mt));
      const float alpha = expf(m_run - m_new);  // 0 on the first tile
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        ps += p;
      }
      l_run = l_run * alpha + group4_sum(ps);
      m_run = m_new;
      if (seg == 0) sm.row_a[r] = alpha;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = sm.row_a[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < S::NJ; ++j) acc[i][j] *= a;
      }
    }
    tile_pv<S::NJ>(sm.Ss, sm.Vs, acc);
  }

  __syncthreads();  // the last tile's reads of Ss and row_a are done
  if (seg == 0) {
    sm.row_a[r] = l_run;
    sm.row_m[r] = m_run;
  }
  __syncthreads();
}

// Row attention of query tile `tile` (rows 64 tile ..) of batch b, head h,
// written to o:
//   o[r] = sum_j w_rj v_j / max(sum_j w_rj, 1e-30)   (attend_keys' weights)
// with the queries scaled by `scale` as they are loaded.
// zero_empty (exact): rows of a batch whose keys are all masked come out 0.
// rbias (B, Nq) (0 valid / -1e30 masked, or null): with SHIFT, masked query
// rows come out 0, as the weights of a row with a -1e30 bias all are; exact,
// tile_max skips them.
// tile_max (exact, optional): writes the max over this tile's (unmasked)
// rows of the row max to tile_max[(b * H + h) * n_tiles + tile].
// q, o (B, H, Nq, D); k, v (B, H, Nk, D); dynamic shared memory
// AttnShape<D>::kFloats floats.
template <bool SHIFT, int D>
__device__ __forceinline__ void attend_tile(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ kbias,
    const float* __restrict__ rbias, float* __restrict__ o,
    float* __restrict__ tile_max, int H, int Nq, int Nk, float scale,
    bool zero_empty, float shift2, int b, int h, int tile, int n_tiles) {
  extern __shared__ __align__(16) float lg_smem[];
  using S = AttnShape<D>;
  const AttnTile sm = carve_attn<D>(lg_smem);
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int q0 = tile * TILE;
  const size_t bh = (size_t)b * H + h;
  const float* bias = kbias ? kbias + (size_t)b * Nk : nullptr;
  const float* rb = rbias ? rbias + (size_t)b * Nq : nullptr;

#pragma unroll
  for (int c = 0; c < S::NC; ++c)
    load_tile(sm.Qs + c * TILE * LD, LD, q + bh * Nq * D, q0, Nq, D, c * HD,
              scale);
  float acc[4][S::NJ] = {};
  attend_keys<SHIFT, D>(sm, k + bh * Nk * D, v + bh * Nk * D, bias, Nk,
                        shift2, acc);
  const bool empty = !SHIFT && zero_empty && bias && *sm.any_valid == 0;
  float* ob = o + bh * Nq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Nq) continue;
    const bool zero = empty || (SHIFT && rb && rb[row] < 0.f);
    const float l = fmaxf(sm.row_a[ty + 16 * i], 1e-30f);
#pragma unroll
    for (int j = 0; j < S::NJ; ++j)
      ob[(size_t)row * D + tx + 16 * j] = zero ? 0.f : acc[i][j] / l;
  }
  if (!SHIFT && tile_max && t == 0) {
    float mx = -INFINITY;
    for (int rr = 0; rr < TILE && q0 + rr < Nq; ++rr)
      if (!rb || rb[q0 + rr] >= 0.f) mx = fmaxf(mx, sm.row_m[rr]);
    tile_max[bh * n_tiles + tile] = mx;
  }
}

// attend_tile for the block's own tile: grid (cdiv(Nq, 64), H, B).
template <bool SHIFT, int D = HD>
__device__ __forceinline__ void row_softmax_attention(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ kbias,
    const float* __restrict__ rbias, float* __restrict__ o,
    float* __restrict__ tile_max, int H, int Nq, int Nk, float scale,
    bool zero_empty, float shift2) {
  attend_tile<SHIFT, D>(q, k, v, kbias, rbias, o, tile_max, H, Nq, Nk, scale,
                        zero_empty, shift2, blockIdx.z, blockIdx.y,
                        blockIdx.x, gridDim.x);
}

// Bytes of dynamic shared memory attend_tile carves at head_dim D.
template <int D>
constexpr size_t row_attn_smem() {
  return AttnShape<D>::kFloats * sizeof(float);
}
constexpr size_t kRowAttnSmem = row_attn_smem<HD>();

}  // namespace lg
