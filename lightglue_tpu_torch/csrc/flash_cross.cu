// K2: bidirectional shared-QK cross attention, fp32: exact, and the
// single-pass constant-shift variant (B3s).
//
// Replaces the TPU kernels lightglue_tpu/ops/flash_cross.py::
// _fused_cross_kernel (the exact variant of fused_cross_attention) and
// ::_single_pass_cross_kernel (its shift variant). With
// s_ij = (scale qk0_i) . qk1_j:
//   exact (mode 0):
//     m0_i = sum_j exp(s'_ij - max_j s'_ij) v1_j / sum_j (...), s' = s + bias1
//     m1_j = sum_i exp(s'_ij - S) valid0_i v0_i / sum_i exp(s'_ij - S) valid0_i
//   where S = max_{i,j} s'_ij over the whole (batch, head): the TPU kernel's
//   per-(b, h) global shift for the column direction. As on the TPU, m0 is
//   not zeroed on invalid query rows; callers read valid rows only.
//   mode 1, the attention of the whole-CrossBlock kernel (B6, flash_cross_
//   block.py:127-157): the same, except that S is the maximum over valid
//   rows only and m0 is 0 in a batch entry whose image 1 is all masked.
//   shift (mode 2): e_ij = exp2(min(s_ij + bias0_i + bias1_j - shift2, 100))
//   serves both directions (scale * log2(e) folded in),
//     m0_i = sum_j e_ij v1_j / max(sum_j e_ij, 1e-30),
//     m1_j = sum_i e_ij v0_i / max(sum_i e_ij, 1e-30),
//   and invalid rows and columns come out 0; no global max, no rescale.
//
// What bounds it on an H100: arithmetic, as K1 (6.4 GFLOP at B 4, H 4,
// M 1024, N 768: four 2 M N 64 products per (batch, head), two for each
// direction).
//
// Design: the TPU grid runs in order on one core and carries the column
// accumulator and the running strip max across query blocks in VMEM scratch.
// Blocks on the card run in no order, so the column direction becomes its
// own launch. Launch 1 runs over (batch, head, 64-row tile of image 0): an
// online row softmax (exact) or the exp2 walk (shift) gives m0, and, exact,
// each block writes its tile's score max. Launch 2 runs over (batch, head,
// 64-column tile of image 1): exact, it reduces the tile maxima to S; then
// it walks all rows of image 0, accumulating the weighted v0 and the column
// sum in registers. S is known before the walk, so launch 2 needs no
// rescaling, and no block writes what another block reads in the same
// launch: no atomics, same bits on every run. The sums are explicit; the
// TPU's ones-column in V is an MXU trick.
#include "common.cuh"

namespace {

// mode 0 exact (K2), 1 exact as the CrossBlock kernel; SHIFT for mode 2.
template <bool SHIFT>
__global__ void __launch_bounds__(lg::THREADS)
    cross_rows_kernel(const float* __restrict__ qk0,
                      const float* __restrict__ qk1,
                      const float* __restrict__ v1,
                      const float* __restrict__ bias0,
                      const float* __restrict__ bias1, float* __restrict__ m0,
                      float* __restrict__ tile_max, int H, int M, int N,
                      float scale, int mode, float shift2) {
  lg::row_softmax_attention<SHIFT>(qk0, qk1, v1, bias1,
                                   mode == 0 ? nullptr : bias0, m0, tile_max,
                                   H, M, N, scale, /*zero_empty=*/mode == 1,
                                   shift2);
}

// Grid (cdiv(N, 64), H, B).
template <bool SHIFT>
__global__ void __launch_bounds__(lg::THREADS)
    cross_cols_kernel(const float* __restrict__ qk0,
                      const float* __restrict__ qk1,
                      const float* __restrict__ v0,
                      const float* __restrict__ bias0,
                      const float* __restrict__ bias1,
                      const float* __restrict__ tile_max, int n_tiles,
                      float* __restrict__ m1, int H, int M, int N,
                      float scale, float shift2) {
  using namespace lg;
  extern __shared__ __align__(16) float lg_smem[];
  float* Cs = lg_smem;         // 64 x LD: qk1 rows of this column tile
  float* Rs = Cs + TILE * LD;  // 64 x LD: scaled qk0 rows
  float* Vs = Rs + TILE * LD;  // 64 x HD: v0 rows
  float* Es = Vs + TILE * HD;  // 64 x LD: weights, [column][row]
  float* col_l = Es + TILE * LD;  // 64

  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int r = t >> 2, seg = t & 3;
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * TILE;
  const size_t bh = (size_t)b * H + h;
  const float* q0b = qk0 + bh * M * HD;
  const float* q1b = qk1 + bh * N * HD;
  const float* v0b = v0 + bh * M * HD;
  const float* b0 = bias0 ? bias0 + (size_t)b * M : nullptr;
  const float* b1 = bias1 ? bias1 + (size_t)b * N : nullptr;

  // exact: subtract the global max S; shift: the constant shift2
  float sub = shift2;
  if (!SHIFT) {
    sub = -INFINITY;
    for (int i = 0; i < n_tiles; ++i)
      sub = fmaxf(sub, tile_max[bh * n_tiles + i]);
  }

  load_tile(Cs, LD, q1b, j0, N, HD, 0, 1.f);
  float cbias[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = j0 + ty + 16 * i;
    cbias[i] = (b1 && col < N) ? b1[col] : 0.f;
  }
  float l_run = 0.f;  // this column's sum, same in its 4 threads
  float acc[4][4] = {};

  for (int i0 = 0; i0 < M; i0 += TILE) {
    __syncthreads();
    load_tile(Rs, LD, q0b, i0, M, HD, 0, scale);
    load_tile(Vs, HD, v0b, i0, M, HD, 0, 1.f);
    __syncthreads();
    float s[4][4] = {};
    tile_abt(Cs, Rs, s);  // s[j][i] = qk1_j . (scale qk0_i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i0 + tx + 16 * i;
        const bool ok = row < M && (!b0 || b0[row] >= 0.f);
        const float x = s[j][i] + cbias[j] - sub;
        Es[(ty + 16 * j) * LD + tx + 16 * i] =
            !ok ? 0.f : SHIFT ? exp2f(fminf(x, 100.f)) : expf(x);
      }
    __syncthreads();
    const float* erow = Es + r * LD + seg * 16;
    float ps = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) ps += erow[c];
    l_run += group4_sum(ps);
    tile_pv(Es, Vs, acc);
  }

  __syncthreads();
  if (seg == 0) col_l[r] = l_run;
  __syncthreads();
  float* mb = m1 + bh * N * HD;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = j0 + ty + 16 * j;
    if (col >= N) continue;
    const float l = fmaxf(col_l[ty + 16 * j], 1e-30f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mb[(size_t)col * HD + tx + 16 * i] = acc[j][i] / l;
  }
}

constexpr size_t kColSmem = (3 * lg::TILE * lg::LD + lg::TILE * lg::HD +
                             lg::TILE) * sizeof(float);

template <bool SHIFT>
cudaError_t launch(const float* qk0, const float* qk1, const float* v0,
                   const float* v1, const float* bias0, const float* bias1,
                   float* m0, float* m1, float* tile_max, int B, int H, int M,
                   int N, int mode, float scale, float shift2,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cross_rows_kernel<SHIFT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lg::kRowAttnSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(cross_cols_kernel<SHIFT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kColSmem);
  if (err != cudaSuccess) return err;
  const int n_tiles = lg::cdiv(M, lg::TILE);
  const dim3 rows(n_tiles, H, B), cols(lg::cdiv(N, lg::TILE), H, B);
  cross_rows_kernel<SHIFT><<<rows, lg::THREADS, lg::kRowAttnSmem, stream>>>(qk0, qk1, v1, bias0, bias1, m0, tile_max, H, M, N, scale, mode, shift2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cross_cols_kernel<SHIFT><<<cols, lg::THREADS, kColSmem, stream>>>(qk0, qk1, v0, bias0, bias1, tile_max, n_tiles, m1, H, M, N, scale, shift2);
  return cudaGetLastError();
}

}  // namespace

// qk0, v0, m0: (B, H, M, 64); qk1, v1, m1: (B, H, N, 64); bias0 (B, M) and
// bias1 (B, N) or null; tile_max: scratch of B * H * cdiv(M, 64) floats.
// mode: 0 exact, 1 exact as the CrossBlock kernel, 2 shift. scale
// multiplies qk0; shift2 = shift * log2(e) (mode 2).
extern "C" cudaError_t lg_fused_cross(const float* qk0, const float* qk1,
                                      const float* v0, const float* v1,
                                      const float* bias0, const float* bias1,
                                      float* m0, float* m1, float* tile_max,
                                      int B, int H, int M, int N, int mode,
                                      float scale, float shift2,
                                      cudaStream_t stream) {
  if (mode < 0 || mode > 2) return cudaErrorInvalidValue;
  return mode == 2
             ? launch<true>(qk0, qk1, v0, v1, bias0, bias1, m0, m1, tile_max, B,
                            H, M, N, mode, scale, shift2, stream)
             : launch<false>(qk0, qk1, v0, v1, bias0, bias1, m0, m1, tile_max,
                             B, H, M, N, mode, scale, shift2, stream);
}
