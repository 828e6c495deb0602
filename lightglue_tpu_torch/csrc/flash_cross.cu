// K2: bidirectional shared-QK cross attention, fp32: exact, and the
// single-pass constant-shift variant (B3s); head_dim 64.
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
//   not zeroed on invalid query rows (callers read valid rows only), and a
//   batch entry whose image 1 is all masked gets the mean of v1 (every
//   score there is -1e30).
//   mode 1, the attention of the whole-CrossBlock kernel (B6, flash_cross_
//   block.py:127-157): the same, except that S is the maximum over valid
//   rows only and m0 is 0 in a batch entry whose image 1 is all masked.
//   shift (mode 2): e_ij = exp2(min(s_ij + bias0_i + bias1_j - shift2, 100))
//   serves both directions (scale * log2(e) folded in),
//     m0_i = sum_j e_ij v1_j / max(sum_j e_ij, 1e-30),
//     m1_j = sum_i e_ij v0_i / max(sum_i e_ij, 1e-30),
//   so invalid rows and columns come out 0; no global max, no rescale.
//
// What bounds it on an H100: arithmetic, as K1 (4.8 GFLOP at B 4, H 4,
// M 1024, N 768: the function needs three 2 M N 64 products per (batch,
// head), the scores once, then P V1 and P^T V0): 0.072 ms in fp32 on the
// CUDA cores, 0.029 ms as 3xTF32 on the tensor cores. Each direction's
// walk computes the scores itself (four products): the exact column walk
// needs S before it starts, and a block of one direction does not hold the
// other direction's accumulators.
//
// Design: both directions are the attention walk of attn_tc.cuh (3xTF32
// mma.sync tiles, cp.async K/V ring, key split), once with image 0's rows
// as queries and once with image 1's. The TPU grid runs in order on one
// core and carries the column accumulator across query blocks in VMEM;
// blocks on the card run in no order, so the exact column direction is a
// launch of its own after the rows: the row launch (exact walk, keys
// valid1) writes m0 and each row's score max, its split merge (if any)
// combines them; the column launch (queries qk1 with bias1, keys qk0 with
// valid0, values v0) first reduces the row maxima of its (batch, head) to
// S (over valid rows in mode 1; 0 where there is none, when every key of
// the column walk is masked anyway), then walks with the fixed shift S: no
// running max, no rescale, and its split merge is a plain sum in split
// order. The shift variant's directions do not depend on each other: one
// launch over grid z = 2 B. No block writes what another block of the same
// launch reads, no atomics: the same bits on every run.
//
// The bf16 form (lg_fused_cross_bf16): the TPU kernels fed bf16 under mp,
// on attn_wgmma.cuh's walk (wgmma fed by TMA, 128 query rows a block, the
// same three launches): qk, v and the messages bf16, fp32 scores and
// softmax, the weights rounded to bf16 before each P V and the row sums
// adding those rounded weights (kRoundedSums: the TPU kernels sum through a
// ones column of the bf16 V). The TPU wrapper scales qk0 in bf16 before the
// kernel and both directions read that product; the caller does the same
// (qk0 scaled and rounded, scale 1 here).
#include "attn_tc.cuh"
#include "attn_wgmma.cuh"

namespace {

using lg::tc::bf16;
using lg::tc::THREADS;
using lg::wg::WalkShape;
constexpr int D = 64;  // head_dim, as the TPU kernels (the ones column of V)
using Sh = lg::tc::Shape<D>;
using Wk = WalkShape<D>;

// The column launch's shift S: the largest row max of this (batch, head)'s
// M rows rm (over the valid rows only when `only` is given), -inf when there
// is none. Every thread of the block calls it.
template <int kThreads>
__device__ float column_shift(const float* rm, const bool* only, int M) {
  __shared__ float warp_max[kThreads / 32];
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < M; i += kThreads)
    if (only == nullptr || only[i]) mx = fmaxf(mx, rm[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) mx = fmaxf(mx, warp_max[w]);
  return mx;
}

// --- fp32 (attn_tc.cuh) -----------------------------------------------------

// Exact messages into image 0. Grid (cdiv(M, 64) splits, H, B).
__global__ void __launch_bounds__(THREADS, Sh::kBlocksPerSM)
    cross_rows_kernel(const float* __restrict__ qk0,
                      const float* __restrict__ qk1,
                      const float* __restrict__ v1,
                      const bool* __restrict__ valid1, float* __restrict__ m0,
                      float* __restrict__ part, float* __restrict__ ml,
                      float* __restrict__ rmax, int H, int M, int N,
                      int splits, float scale, bool zero_empty) {
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  lg::tc::attend_block<lg::tc::kExact, D>(
      qk0 + bh * M * D, qk1 + bh * N * D, v1 + bh * N * D,
      valid1 ? valid1 + (size_t)b * N : nullptr, nullptr, m0 + bh * M * D,
      part, ml, rmax, (int)gridDim.z * H * M, (int)bh * M, M, N,
      blockIdx.x / splits, blockIdx.x % splits, splits, scale, 0.f,
      zero_empty);
}

// Exact messages into image 1, shifted by S. Grid (cdiv(N, 64) splits, H,
// B); rmax (B H M): the row launch's row maxima.
__global__ void __launch_bounds__(THREADS, Sh::kBlocksPerSM)
    cross_cols_kernel(const float* __restrict__ qk0,
                      const float* __restrict__ qk1,
                      const float* __restrict__ v0,
                      const bool* __restrict__ valid0,
                      const bool* __restrict__ valid1,
                      const float* __restrict__ rmax, float* __restrict__ m1,
                      float* __restrict__ part, float* __restrict__ ml, int H,
                      int M, int N, int splits, float scale,
                      bool valid_rows_only) {
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const bool* va0 = valid0 ? valid0 + (size_t)b * M : nullptr;
  const float mx =
      column_shift<THREADS>(rmax + bh * M, valid_rows_only ? va0 : nullptr, M);
  lg::tc::attend_block<lg::tc::kFixed, D>(
      qk1 + bh * N * D, qk0 + bh * M * D, v0 + bh * M * D, va0,
      valid1 ? valid1 + (size_t)b * N : nullptr, m1 + bh * N * D, part, ml,
      nullptr, (int)gridDim.z * H * N, (int)bh * N, N, M, blockIdx.x / splits,
      blockIdx.x % splits, splits, scale, mx == -INFINITY ? 0.f : mx, false);
}

// Both directions of the shift variant. Grid (max over directions of
// cdiv(nq, 64) splits, H, 2 B); z = 2 b + direction, as B1'.
__global__ void __launch_bounds__(THREADS, Sh::kBlocksPerSM)
    cross_shift_kernel(const float* __restrict__ qk0,
                       const float* __restrict__ qk1,
                       const float* __restrict__ v0,
                       const float* __restrict__ v1,
                       const bool* __restrict__ valid0,
                       const bool* __restrict__ valid1,
                       float* __restrict__ m0, float* __restrict__ m1,
                       float* __restrict__ part0, float* __restrict__ ml0,
                       float* __restrict__ part1, float* __restrict__ ml1,
                       int H, int M, int N, int splits0, int splits1,
                       float scale, float shift2) {
  const int b = blockIdx.z >> 1, h = blockIdx.y;
  const bool dir1 = blockIdx.z & 1;  // messages into image 1
  const int nq = dir1 ? N : M, nk = dir1 ? M : N;
  const int splits = dir1 ? splits1 : splits0;
  if ((int)blockIdx.x >= lg::tc::cdiv(nq, lg::tc::BQ) * splits) return;
  const size_t bh = (size_t)b * H + h;
  const bool* kvalid = dir1 ? valid0 : valid1;
  const bool* qvalid = dir1 ? valid1 : valid0;
  lg::tc::attend_block<lg::tc::kShift, D>(
      (dir1 ? qk1 : qk0) + bh * nq * D, (dir1 ? qk0 : qk1) + bh * nk * D,
      (dir1 ? v0 : v1) + bh * nk * D, kvalid ? kvalid + (size_t)b * nk : nullptr,
      qvalid ? qvalid + (size_t)b * nq : nullptr, (dir1 ? m1 : m0) + bh * nq * D,
      dir1 ? part1 : part0, dir1 ? ml1 : ml0, nullptr,
      (int)(gridDim.z >> 1) * H * nq, (int)bh * nq, nq, nk,
      blockIdx.x / splits, blockIdx.x % splits, splits, scale, shift2, false);
}

// --- bf16 (attn_wgmma.cuh) --------------------------------------------------
// The same three kernels on the wgmma walk; k0map, v0map: qk0 and v0 as
// (B H, M, 64), k1map, v1map: qk1 and v1 as (B H, N, 64).

// Grid (cdiv(M, 128) splits, H, B).
__global__ void __launch_bounds__(Wk::THREADS, 1)
    cross_rows_wg_kernel(const __grid_constant__ CUtensorMap k1map,
                         const __grid_constant__ CUtensorMap v1map,
                         const bf16* __restrict__ qk0,
                         const bool* __restrict__ valid1,
                         bf16* __restrict__ m0, float* __restrict__ part,
                         float* __restrict__ ml, float* __restrict__ rmax,
                         int H, int M, int N, int splits, float scale,
                         bool zero_empty) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int bh = b * H + h;
  lg::wg::attend_wg<lg::tc::kExact, D, true>(
      &k1map, &v1map, bh, qk0 + (size_t)bh * M * D,
      valid1 ? valid1 + (size_t)b * N : nullptr, nullptr,
      m0 + (size_t)bh * M * D, part, ml, rmax, (int)gridDim.z * H * M, bh * M,
      M, N, blockIdx.x / splits, blockIdx.x % splits, splits, scale, 0.f,
      zero_empty);
}

// Grid (cdiv(N, 128) splits, H, B).
__global__ void __launch_bounds__(Wk::THREADS, 1)
    cross_cols_wg_kernel(const __grid_constant__ CUtensorMap k0map,
                         const __grid_constant__ CUtensorMap v0map,
                         const bf16* __restrict__ qk1,
                         const bool* __restrict__ valid0,
                         const bool* __restrict__ valid1,
                         const float* __restrict__ rmax, bf16* __restrict__ m1,
                         float* __restrict__ part, float* __restrict__ ml,
                         int H, int M, int N, int splits, float scale,
                         bool valid_rows_only) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int bh = b * H + h;
  const bool* va0 = valid0 ? valid0 + (size_t)b * M : nullptr;
  const float mx = column_shift<Wk::THREADS>(
      rmax + (size_t)bh * M, valid_rows_only ? va0 : nullptr, M);
  lg::wg::attend_wg<lg::tc::kFixed, D, true>(
      &k0map, &v0map, bh, qk1 + (size_t)bh * N * D, va0,
      valid1 ? valid1 + (size_t)b * N : nullptr, m1 + (size_t)bh * N * D,
      part, ml, nullptr, (int)gridDim.z * H * N, bh * N, N, M,
      blockIdx.x / splits, blockIdx.x % splits, splits, scale,
      mx == -INFINITY ? 0.f : mx, false);
}

// Grid (max over directions of cdiv(nq, 128) splits, H, 2 B).
__global__ void __launch_bounds__(Wk::THREADS, 1)
    cross_shift_wg_kernel(const __grid_constant__ CUtensorMap k0map,
                          const __grid_constant__ CUtensorMap k1map,
                          const __grid_constant__ CUtensorMap v0map,
                          const __grid_constant__ CUtensorMap v1map,
                          const bf16* __restrict__ qk0,
                          const bf16* __restrict__ qk1,
                          const bool* __restrict__ valid0,
                          const bool* __restrict__ valid1,
                          bf16* __restrict__ m0, bf16* __restrict__ m1,
                          float* __restrict__ part0, float* __restrict__ ml0,
                          float* __restrict__ part1, float* __restrict__ ml1,
                          int H, int M, int N, int splits0, int splits1,
                          float scale, float shift2) {
  const int b = blockIdx.z >> 1, h = blockIdx.y;
  const bool dir1 = blockIdx.z & 1;  // messages into image 1
  const int nq = dir1 ? N : M, nk = dir1 ? M : N;
  const int splits = dir1 ? splits1 : splits0;
  if ((int)blockIdx.x >= lg::tc::cdiv(nq, Wk::BQ) * splits) return;
  const int bh = b * H + h;
  const bool* kvalid = dir1 ? valid0 : valid1;
  const bool* qvalid = dir1 ? valid1 : valid0;
  lg::wg::attend_wg<lg::tc::kShift, D, true>(
      dir1 ? &k0map : &k1map, dir1 ? &v0map : &v1map, bh,
      (dir1 ? qk1 : qk0) + (size_t)bh * nq * D,
      kvalid ? kvalid + (size_t)b * nk : nullptr,
      qvalid ? qvalid + (size_t)b * nq : nullptr,
      (dir1 ? m1 : m0) + (size_t)bh * nq * D, dir1 ? part1 : part0,
      dir1 ? ml1 : ml0, nullptr, (int)(gridDim.z >> 1) * H * nq, bh * nq, nq,
      nk, blockIdx.x / splits, blockIdx.x % splits, splits, scale, shift2,
      false);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Sh::kBytes);
}

// The merge launch of a split walk (nothing when splits == 1).
template <bool SHIFT, class E>
cudaError_t merge(const float* part, const float* ml, E* o, float* rmax,
                  int rows, int splits, cudaStream_t stream) {
  if (splits == 1) return cudaSuccess;
  const long n = (long)rows * (D / 4);
  lg::tc::merge_splits<SHIFT, E><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, ml, o, rmax, rows, D, splits);
  return cudaGetLastError();
}

// One mode's walk launches and their merges, fp32 (attn_tc.cuh's walk) and
// bf16 (attn_wgmma.cuh's).
cudaError_t walks(const float* qk0, const float* qk1, const float* v0,
                  const float* v1, const bool* valid0, const bool* valid1,
                  float* m0, float* m1, float* part0, float* ml0,
                  float* part1, float* ml1, float* rmax, int B, int H, int M,
                  int N, int mode, int splits0, int splits1, float scale,
                  float shift2, cudaStream_t stream) {
  using lg::tc::BQ;
  using lg::tc::cdiv;
  const size_t smem = Sh::kBytes;
  cudaError_t err;
  if (mode == 2) {
    if ((err = allow_smem(cross_shift_kernel)) != cudaSuccess) return err;
    const int x0 = cdiv(M, BQ) * splits0, x1 = cdiv(N, BQ) * splits1;
    const dim3 grid(x0 > x1 ? x0 : x1, H, 2 * B);
    cross_shift_kernel<<<grid, THREADS, smem, stream>>>(qk0, qk1, v0, v1, valid0, valid1, m0, m1, part0, ml0, part1, ml1, H, M, N, splits0, splits1, scale, shift2);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = merge<true>(part0, ml0, m0, nullptr, B * H * M, splits0,
                           stream)) != cudaSuccess)
      return err;
    return merge<true>(part1, ml1, m1, nullptr, B * H * N, splits1, stream);
  }
  if ((err = allow_smem(cross_rows_kernel)) != cudaSuccess) return err;
  if ((err = allow_smem(cross_cols_kernel)) != cudaSuccess) return err;
  cross_rows_kernel<<<dim3(cdiv(M, BQ) * splits0, H, B), THREADS, smem, stream>>>(qk0, qk1, v1, valid1, m0, part0, ml0, rmax, H, M, N, splits0, scale, mode == 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = merge<false>(part0, ml0, m0, rmax, B * H * M, splits0,
                          stream)) != cudaSuccess)
    return err;
  cross_cols_kernel<<<dim3(cdiv(N, BQ) * splits1, H, B), THREADS, smem, stream>>>(qk0, qk1, v0, valid0, valid1, rmax, m1, part1, ml1, H, M, N, splits1, scale, mode == 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return merge<true>(part1, ml1, m1, nullptr, B * H * N, splits1, stream);
}

cudaError_t walks(const bf16* qk0, const bf16* qk1, const bf16* v0,
                  const bf16* v1, const bool* valid0, const bool* valid1,
                  bf16* m0, bf16* m1, float* part0, float* ml0, float* part1,
                  float* ml1, float* rmax, int B, int H, int M, int N,
                  int mode, int splits0, int splits1, float scale,
                  float shift2, cudaStream_t stream) {
  using lg::tc::cdiv;
  constexpr int BQ = Wk::BQ;
  CUtensorMap k0map, k1map, v0map, v1map;
  cudaError_t err = lg::wg::walk_map(&k0map, qk0, B * H, M, D);
  if (err == cudaSuccess) err = lg::wg::walk_map(&k1map, qk1, B * H, N, D);
  if (err == cudaSuccess) err = lg::wg::walk_map(&v0map, v0, B * H, M, D);
  if (err == cudaSuccess) err = lg::wg::walk_map(&v1map, v1, B * H, N, D);
  if (err != cudaSuccess) return err;
  if (mode == 2) {
    if ((err = lg::wg::allow_walk_smem<D>(cross_shift_wg_kernel)) !=
        cudaSuccess)
      return err;
    const int x0 = cdiv(M, BQ) * splits0, x1 = cdiv(N, BQ) * splits1;
    const dim3 grid(x0 > x1 ? x0 : x1, H, 2 * B);
    cross_shift_wg_kernel<<<grid, Wk::THREADS, Wk::kBytes, stream>>>(k0map, k1map, v0map, v1map, qk0, qk1, valid0, valid1, m0, m1, part0, ml0, part1, ml1, H, M, N, splits0, splits1, scale, shift2);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = merge<true>(part0, ml0, m0, nullptr, B * H * M, splits0,
                           stream)) != cudaSuccess)
      return err;
    return merge<true>(part1, ml1, m1, nullptr, B * H * N, splits1, stream);
  }
  if ((err = lg::wg::allow_walk_smem<D>(cross_rows_wg_kernel)) != cudaSuccess)
    return err;
  if ((err = lg::wg::allow_walk_smem<D>(cross_cols_wg_kernel)) != cudaSuccess)
    return err;
  cross_rows_wg_kernel<<<dim3(cdiv(M, BQ) * splits0, H, B), Wk::THREADS, Wk::kBytes, stream>>>(k1map, v1map, qk0, valid1, m0, part0, ml0, rmax, H, M, N, splits0, scale, mode == 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = merge<false>(part0, ml0, m0, rmax, B * H * M, splits0,
                          stream)) != cudaSuccess)
    return err;
  cross_cols_wg_kernel<<<dim3(cdiv(N, BQ) * splits1, H, B), Wk::THREADS, Wk::kBytes, stream>>>(k0map, v0map, qk1, valid0, valid1, rmax, m1, part1, ml1, H, M, N, splits1, scale, mode == 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return merge<true>(part1, ml1, m1, nullptr, B * H * N, splits1, stream);
}

template <class E>
cudaError_t fused_cross(const E* qk0, const E* qk1, const E* v0, const E* v1,
                        const bool* valid0, const bool* valid1, E* m0, E* m1,
                        float* part0, float* ml0, float* part1, float* ml1,
                        float* rmax, int B, int H, int M, int N, int mode,
                        int splits0, int splits1, float scale, float shift2,
                        cudaStream_t stream) {
  if (mode < 0 || mode > 2 || (mode != 2 && rmax == nullptr))
    return cudaErrorInvalidValue;
  return walks(qk0, qk1, v0, v1, valid0, valid1, m0, m1, part0, ml0, part1,
               ml1, rmax, B, H, M, N, mode, splits0, splits1, scale, shift2,
               stream);
}

}  // namespace
// qk0, v0, m0: (B, H, M, 64); qk1, v1, m1: (B, H, N, 64); valid0 (B, M),
// valid1 (B, N) bool, each or null; qk0, qk1, v0, v1 16-byte aligned.
// mode: 0 exact, 1 exact as the CrossBlock kernel, 2 shift. splits0 splits
// direction 0's N keys (part0 (splits0, B H M, 64), ml0 (splits0, B H M,
// 2)), splits1 direction 1's M keys (part1, ml1 over B H N rows), each
// from 1 to its key tiles; rmax (B H M) scratch of the exact modes. scale
// multiplies the queries of both directions; shift2 = shift * log2(e)
// (mode 2).
extern "C" cudaError_t lg_fused_cross(
    const float* qk0, const float* qk1, const float* v0, const float* v1,
    const bool* valid0, const bool* valid1, float* m0, float* m1,
    float* part0, float* ml0, float* part1, float* ml1, float* rmax, int B,
    int H, int M, int N, int mode, int splits0, int splits1, float scale,
    float shift2, cudaStream_t stream) {
  return fused_cross<float>(qk0, qk1, v0, v1, valid0, valid1, m0, m1, part0,
                            ml0, part1, ml1, rmax, B, H, M, N, mode, splits0,
                            splits1, scale, shift2, stream);
}

// lg_fused_cross's bf16 form (mp): qk0, qk1, v0, v1, m0 and m1 bf16; the
// scratch fp32 as above. The caller hands qk0 scaled (and rounded) and
// scale 1, as the TPU wrapper scales qk0 in bf16 before its kernel. qk0,
// qk1, v0 and v1 are read by TMA: 16-byte aligned (cudaErrorInvalidValue
// otherwise).
extern "C" cudaError_t lg_fused_cross_bf16(
    const bf16* qk0, const bf16* qk1, const bf16* v0, const bf16* v1,
    const bool* valid0, const bool* valid1, bf16* m0, bf16* m1,
    float* part0, float* ml0, float* part1, float* ml1, float* rmax, int B,
    int H, int M, int N, int mode, int splits0, int splits1, float scale,
    float shift2, cudaStream_t stream) {
  return fused_cross<bf16>(qk0, qk1, v0, v1, valid0, valid1, m0, m1, part0,
                           ml0, part1, ml1, rmax, B, H, M, N, mode, splits0,
                           splits1, scale, shift2, stream);
}
