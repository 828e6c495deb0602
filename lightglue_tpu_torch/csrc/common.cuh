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
constexpr int HD = 64;        // depth of one tile product (= attention head_dim)
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

// acc[i][j] += sum_k P[ty + 16i][k] * V[k][tx + 16j] (P with LD, V with HD).
__device__ __forceinline__ void tile_pv(const float* P, const float* V,
                                        float acc[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    float p[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * LD + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = V[k * HD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
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

// Shared-memory carve of the row attention below.
struct AttnTile {
  float* Qs;     // 64 x LD, pre-scaled queries
  float* Ks;     // 64 x LD
  float* Vs;     // 64 x HD
  float* Ss;     // 64 x LD, scores then weights
  float* row_a;  // 64: per-row rescale, then the row sum
  float* row_m;  // 64: per-row max
  int* any_valid;
};

__device__ __forceinline__ AttnTile carve_attn(float* base) {
  AttnTile sm;
  sm.Qs = base;
  sm.Ks = sm.Qs + TILE * LD;
  sm.Vs = sm.Ks + TILE * LD;
  sm.Ss = sm.Vs + TILE * HD;
  sm.row_a = sm.Ss + TILE * LD;
  sm.row_m = sm.row_a + TILE;
  sm.any_valid = reinterpret_cast<int*>(sm.row_m + TILE);
  return sm;
}

// Floats of shared memory carve_attn takes (the last one holds the flag).
constexpr int kAttnFloats = 3 * TILE * LD + TILE * HD + 2 * TILE + 4;

// The key loop of one 64-row query tile, already in sm.Qs (pre-scaled),
// against all Nk keys of one (batch, head), in 64-key tiles, with
//   s_rj = q_r . k_j + kbias[j]   (kbias: 0 valid / -1e30 masked, or null).
// Exact (!SHIFT): an online softmax, weights exp(s_rj - max_j s_rj) with a
// running max and sum. SHIFT: weights exp2(min(s_rj - shift2, 100)) with no
// max (q in the log2 domain); a masked key's weight is exactly 0.
// On return (synchronised) acc[i][j] holds sum_j w_rj v_j for row ty + 16i
// and channel tx + 16j, sm.row_a[r] the row sum, sm.row_m[r] the row max
// (exact), *sm.any_valid whether some key has kbias >= 0.
template <bool SHIFT>
__device__ __forceinline__ void attend_keys(const AttnTile& sm,
                                            const float* __restrict__ kb,
                                            const float* __restrict__ vb,
                                            const float* __restrict__ bias,
                                            int Nk, float shift2,
                                            float acc[4][4]) {
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int r = t >> 2, seg = t & 3;
  if (t == 0) *sm.any_valid = 0;
  float m_run = -INFINITY, l_run = 0.f;  // this row's, same in its 4 threads

  for (int k0 = 0; k0 < Nk; k0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(sm.Ks, LD, kb, k0, Nk, HD, 0, 1.f);
    load_tile(sm.Vs, HD, vb, k0, Nk, HD, 0, 1.f);
    __syncthreads();
    float s[4][4] = {};
    tile_abt(sm.Qs, sm.Ks, s);
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
    __syncthreads();

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
        for (int j = 0; j < 4; ++j) acc[i][j] *= a;
      }
    }
    tile_pv(sm.Ss, sm.Vs, acc);
  }

  __syncthreads();  // the last tile's reads of Ss and row_a are done
  if (seg == 0) {
    sm.row_a[r] = l_run;
    sm.row_m[r] = m_run;
  }
  __syncthreads();
}

// Row attention of one 64-row query tile, written to o:
//   o[r] = sum_j w_rj v_j / max(sum_j w_rj, 1e-30)   (attend_keys' weights)
// with the queries scaled by `scale` as they are loaded.
// zero_empty (exact): rows of a batch whose keys are all masked come out 0.
// rbias (B, Nq) (0 valid / -1e30 masked, or null): with SHIFT, masked query
// rows come out 0, as the weights of a row with a -1e30 bias all are; exact,
// tile_max skips them.
// tile_max (exact, optional): writes the max over this tile's (unmasked)
// rows of the row max to tile_max[(b * H + h) * gridDim.x + blockIdx.x].
// Grid (cdiv(Nq, 64), H, B); q, o (B, H, Nq, 64); k, v (B, H, Nk, 64).
template <bool SHIFT>
__device__ __forceinline__ void row_softmax_attention(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ kbias,
    const float* __restrict__ rbias, float* __restrict__ o,
    float* __restrict__ tile_max, int H, int Nq, int Nk, float scale,
    bool zero_empty, float shift2) {
  extern __shared__ __align__(16) float lg_smem[];
  const AttnTile sm = carve_attn(lg_smem);
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TILE;
  const size_t bh = (size_t)b * H + h;
  const float* bias = kbias ? kbias + (size_t)b * Nk : nullptr;
  const float* rb = rbias ? rbias + (size_t)b * Nq : nullptr;

  load_tile(sm.Qs, LD, q + bh * Nq * HD, q0, Nq, HD, 0, scale);
  float acc[4][4] = {};
  attend_keys<SHIFT>(sm, k + bh * Nk * HD, v + bh * Nk * HD, bias, Nk, shift2,
                     acc);
  const bool empty = !SHIFT && zero_empty && bias && *sm.any_valid == 0;
  float* ob = o + bh * Nq * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Nq) continue;
    const bool zero = empty || (SHIFT && rb && rb[row] < 0.f);
    const float l = fmaxf(sm.row_a[ty + 16 * i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ob[(size_t)row * HD + tx + 16 * j] = zero ? 0.f : acc[i][j] / l;
  }
  if (!SHIFT && tile_max && t == 0) {
    float mx = -INFINITY;
    for (int rr = 0; rr < TILE && q0 + rr < Nq; ++rr)
      if (!rb || rb[q0 + rr] >= 0.f) mx = fmaxf(mx, sm.row_m[rr]);
    tile_max[bh * gridDim.x + blockIdx.x] = mx;
  }
}

// Bytes of dynamic shared memory row_softmax_attention carves.
constexpr size_t kRowAttnSmem = kAttnFloats * sizeof(float);

}  // namespace lg
