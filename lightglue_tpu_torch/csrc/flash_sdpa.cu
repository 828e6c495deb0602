// K1: masked scaled dot-product attention, fp32, exact or constant-shift,
// head_dim 64 or 128; and B1', both directions of the shared-QK cross
// attention at head_dim 64 or 128 in one launch.
//
// K1 replaces the TPU kernels lightglue_tpu/ops/flash.py::_attn_kernel_4d
// (the exact variant of flash_sdpa): o = softmax(q k^T / sqrt(d) + key
// bias) v, with an fp32 softmax and rows whose keys are all masked set to 0;
// and ::_attn_kernel_shift (the constant-shift variant, B1s): with scale *
// log2(e) folded into q, o = sum_j e_j v_j / max(sum_j e_j, 1e-30) with
// e_j = exp2(min(s_j - shift * log2(e), 100)), no row max, and an
// all-masked row 0 because every e_j is.
//
// B1' replaces lightglue_tpu/ops/flash.py::flash_cross_pair, which runs the
// exact flash_sdpa pallas_call twice with the roles swapped:
//   m0 = attn(qk0, qk1, v1, valid1),  m1 = attn(qk1, qk0, v0, valid0).
// The JAX matcher takes it for the cross blocks at head_dim 128, where the
// ones column of B3's and B6's augmented V does not fit. Here it is one
// launch over both directions (grid z = 2 B, the low bit the direction).
// Rows of masked queries are not zeroed, as in the TPU pair.
//
// What bounds them on an H100: arithmetic. At the main path's shape
// (B 4, H 4, N 1024, head_dim 64, or H 2 at 128) the two products are
// 4.3 GFLOP for 17 MB of q, k, v and o, about 250 flop per byte. In fp32 on
// CUDA cores (67 TFLOP/s) that is 0.064 ms; as 3xTF32 on the tensor cores
// (three tf32 products of 495 TFLOP/s each) 0.026 ms.
//
// Design (attn_tc.cuh): the TPU kernel keeps a whole (256, N) score strip
// in VMEM, over the 227 KB a block can have. Here a block of 4 warps takes
// 64 queries of one (batch, head) and walks the keys in tiles (64 keys at
// head_dim 64, 32 at 128: two blocks an SM either way) with an online
// softmax, both products on the tensor cores in 3xTF32, the tiles
// arriving by cp.async into a two-stage ring. At small batch the blocks
// would not fill the card (32 at B 1 with two heads of 128), so the wrapper
// splits each block's keys over S blocks and a second launch, merge_splits,
// combines their states in a fixed order. An online softmax over
// all-masked keys returns mean(v), so the block tracks whether any key is
// valid and writes 0 when none is, as the TPU kernel does. The shift
// variant is the same walk without the max and the rescale.
//
// The bf16 forms (lg_flash_sdpa_bf16, lg_flash_cross_pair_bf16, head_dim
// 64 or 128): _attn_kernel_4d and _attn_kernel_shift fed bf16 q, k, v
// under mp, and flash_cross_pair's two exact calls of them. q is scaled in
// fp32 and rounded to bf16 (the caller passes the scale rounded to bf16, as
// the TPU wrapper's jnp.asarray(scale, q.dtype)), the weights are rounded
// before P V, l sums them in fp32, the output is bf16: attn_wgmma.cuh's
// walk (wgmma fed by TMA, 128 query rows a block). B1' is two K1 walks, so
// its row sums add the unrounded weights (K2's kRoundedSums is not its).
#include "attn_tc.cuh"
#include "attn_wgmma.cuh"

namespace {

using lg::tc::bf16;
using lg::tc::Shape;
using lg::wg::WalkShape;

// --- fp32 (attn_tc.cuh) -----------------------------------------------------

// Grid (cdiv(Nq, 64) splits, H, B): x = query tile * splits + split.
template <bool SHIFT, int D>
__global__ void __launch_bounds__(lg::tc::THREADS, Shape<D>::kBlocksPerSM)
    flash_sdpa_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const bool* __restrict__ kvalid, float* __restrict__ o,
                      float* __restrict__ part, float* __restrict__ ml, int H,
                      int Nq, int Nk, int splits, float scale, float shift2) {
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  lg::tc::attend_block<SHIFT ? lg::tc::kShift : lg::tc::kExact, D>(
      q + bh * Nq * D, k + bh * Nk * D, v + bh * Nk * D,
      kvalid ? kvalid + (size_t)b * Nk : nullptr, nullptr, o + bh * Nq * D,
      part, ml, nullptr, (int)(gridDim.z * H) * Nq, (int)bh * Nq, Nq, Nk,
      blockIdx.x / splits, blockIdx.x % splits, splits, scale, shift2, true);
}

// Grid (max over directions of cdiv(nq, 64) splits, H, 2 B); z = 2 b +
// direction. Direction 0 (messages into image 0) has M queries, N keys and
// splits0; direction 1 the reverse. A block past its direction's grid
// returns at once.
template <int D>
__global__ void __launch_bounds__(lg::tc::THREADS, Shape<D>::kBlocksPerSM)
    flash_cross_pair_kernel(
        const float* __restrict__ qk0, const float* __restrict__ qk1,
        const float* __restrict__ v0, const float* __restrict__ v1,
        const bool* __restrict__ valid0, const bool* __restrict__ valid1,
        float* __restrict__ m0, float* __restrict__ m1,
        float* __restrict__ part0, float* __restrict__ ml0,
        float* __restrict__ part1, float* __restrict__ ml1, int H, int M,
        int N, int splits0, int splits1, float scale) {
  const int b = blockIdx.z >> 1, h = blockIdx.y;
  const bool dir1 = blockIdx.z & 1;  // messages into image 1
  const int nq = dir1 ? N : M, nk = dir1 ? M : N;
  const int splits = dir1 ? splits1 : splits0;
  if ((int)blockIdx.x >= lg::tc::cdiv(nq, lg::tc::BQ) * splits) return;
  const size_t bh = (size_t)b * H + h;
  const bool* kvalid = dir1 ? valid0 : valid1;
  lg::tc::attend_block<lg::tc::kExact, D>(
      (dir1 ? qk1 : qk0) + bh * nq * D, (dir1 ? qk0 : qk1) + bh * nk * D,
      (dir1 ? v0 : v1) + bh * nk * D, kvalid ? kvalid + (size_t)b * nk : nullptr,
      nullptr, (dir1 ? m1 : m0) + bh * nq * D, dir1 ? part1 : part0,
      dir1 ? ml1 : ml0, nullptr, (int)(gridDim.z >> 1) * H * nq, (int)bh * nq,
      nq, nk, blockIdx.x / splits, blockIdx.x % splits, splits, scale, 0.f,
      true);
}

// --- bf16 (attn_wgmma.cuh) --------------------------------------------------

// Grid (cdiv(Nq, 128) splits, H, B); kmap, vmap: k and v as (B H, Nk, D).
template <bool SHIFT, int D>
__global__ void __launch_bounds__(WalkShape<D>::THREADS, 1)
    flash_sdpa_wg_kernel(const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const bf16* __restrict__ q,
                         const bool* __restrict__ kvalid, bf16* __restrict__ o,
                         float* __restrict__ part, float* __restrict__ ml,
                         int H, int Nq, int Nk, int splits, float scale,
                         float shift2) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int bh = b * H + h;
  lg::wg::attend_wg<SHIFT ? lg::tc::kShift : lg::tc::kExact, D>(
      &kmap, &vmap, bh, q + (size_t)bh * Nq * D,
      kvalid ? kvalid + (size_t)b * Nk : nullptr, nullptr,
      o + (size_t)bh * Nq * D, part, ml, nullptr, (int)(gridDim.z * H) * Nq,
      bh * Nq, Nq, Nk, blockIdx.x / splits, blockIdx.x % splits, splits,
      scale, shift2, true);
}

// Grid (max over directions of cdiv(nq, 128) splits, H, 2 B), as the fp32
// pair; k0map, v0map: qk0 and v0 as (B H, M, D); k1map, v1map: qk1, v1.
template <int D>
__global__ void __launch_bounds__(WalkShape<D>::THREADS, 1)
    flash_cross_pair_wg_kernel(
        const __grid_constant__ CUtensorMap k0map,
        const __grid_constant__ CUtensorMap k1map,
        const __grid_constant__ CUtensorMap v0map,
        const __grid_constant__ CUtensorMap v1map,
        const bf16* __restrict__ qk0, const bf16* __restrict__ qk1,
        const bool* __restrict__ valid0, const bool* __restrict__ valid1,
        bf16* __restrict__ m0, bf16* __restrict__ m1,
        float* __restrict__ part0, float* __restrict__ ml0,
        float* __restrict__ part1, float* __restrict__ ml1, int H, int M,
        int N, int splits0, int splits1, float scale) {
  const int b = blockIdx.z >> 1, h = blockIdx.y;
  const bool dir1 = blockIdx.z & 1;  // messages into image 1
  const int nq = dir1 ? N : M, nk = dir1 ? M : N;
  const int splits = dir1 ? splits1 : splits0;
  if ((int)blockIdx.x >= lg::tc::cdiv(nq, WalkShape<D>::BQ) * splits) return;
  const int bh = b * H + h;
  const bool* kvalid = dir1 ? valid0 : valid1;
  lg::wg::attend_wg<lg::tc::kExact, D>(
      dir1 ? &k0map : &k1map, dir1 ? &v0map : &v1map, bh,
      (dir1 ? qk1 : qk0) + (size_t)bh * nq * D,
      kvalid ? kvalid + (size_t)b * nk : nullptr, nullptr,
      (dir1 ? m1 : m0) + (size_t)bh * nq * D, dir1 ? part1 : part0,
      dir1 ? ml1 : ml0, nullptr, (int)(gridDim.z >> 1) * H * nq, bh * nq, nq,
      nk, blockIdx.x / splits, blockIdx.x % splits, splits, scale, 0.f, true);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The merge launch of a split walk (nothing when splits == 1).
template <bool SHIFT, class E>
cudaError_t merge(const float* part, const float* ml, E* o, int rows,
                  int D, int splits, cudaStream_t stream) {
  if (splits == 1) return cudaSuccess;
  const long n = (long)rows * (D / 4);
  lg::tc::merge_splits<SHIFT, E><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, ml, o, nullptr, rows, D, splits);
  return cudaGetLastError();
}

template <bool SHIFT, int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const bool* kvalid, float* o, float* part, float* ml,
                   int B, int H, int Nq, int Nk, int splits, float scale,
                   float shift2, cudaStream_t stream) {
  constexpr size_t smem = Shape<D>::kBytes;
  cudaError_t err = allow_smem(flash_sdpa_kernel<SHIFT, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lg::tc::cdiv(Nq, lg::tc::BQ) * splits, H, B);
  flash_sdpa_kernel<SHIFT, D><<<grid, lg::tc::THREADS, smem, stream>>>(q, k, v, kvalid, o, part, ml, H, Nq, Nk, splits, scale, shift2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge<SHIFT>(part, ml, o, B * H * Nq, D, splits, stream);
}

template <bool SHIFT, int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const bool* kvalid, bf16* o, float* part, float* ml,
                   int B, int H, int Nq, int Nk, int splits, float scale,
                   float shift2, cudaStream_t stream) {
  using S = WalkShape<D>;
  CUtensorMap kmap, vmap;
  cudaError_t err = lg::wg::walk_map(&kmap, k, B * H, Nk, D);
  if (err == cudaSuccess) err = lg::wg::walk_map(&vmap, v, B * H, Nk, D);
  if (err == cudaSuccess)
    err = lg::wg::allow_walk_smem<D>(flash_sdpa_wg_kernel<SHIFT, D>);
  if (err != cudaSuccess) return err;
  const dim3 grid(lg::tc::cdiv(Nq, S::BQ) * splits, H, B);
  flash_sdpa_wg_kernel<SHIFT, D><<<grid, S::THREADS, S::kBytes, stream>>>(kmap, vmap, q, kvalid, o, part, ml, H, Nq, Nk, splits, scale, shift2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge<SHIFT>(part, ml, o, B * H * Nq, D, splits, stream);
}

// Keys of a tile, blocks an SM holds and query rows of a block of the walk
// at head_dim D in E.
template <int D, class E>
cudaError_t walk_shape(int* key_tile, int* blocks_per_sm, int* query_rows) {
  cudaError_t err;
  if constexpr (std::is_same_v<E, bf16>) {
    using S = WalkShape<D>;
    err = lg::wg::allow_walk_smem<D>(flash_sdpa_wg_kernel<false, D>);
    if (err != cudaSuccess) return err;
    *key_tile = S::BK;
    *query_rows = S::BQ;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_sdpa_wg_kernel<false, D>, S::THREADS,
        S::kBytes);
  } else {
    constexpr size_t smem = Shape<D>::kBytes;
    err = allow_smem(flash_sdpa_kernel<false, D>, smem);
    if (err != cudaSuccess) return err;
    *key_tile = Shape<D>::BK;
    *query_rows = lg::tc::BQ;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_sdpa_kernel<false, D>, lg::tc::THREADS, smem);
  }
}

template <bool SHIFT, class E>
cudaError_t launch_d(int d, const E* q, const E* k, const E* v,
                     const bool* kvalid, E* o, float* part, float* ml,
                     int B, int H, int Nq, int Nk, int splits, float scale,
                     float shift2, cudaStream_t stream) {
  if (d == 64)
    return launch<SHIFT, 64>(q, k, v, kvalid, o, part, ml, B, H, Nq, Nk,
                             splits, scale, shift2, stream);
  if (d == 128)
    return launch<SHIFT, 128>(q, k, v, kvalid, o, part, ml, B, H, Nq, Nk,
                              splits, scale, shift2, stream);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_pair(const float* qk0, const float* qk1, const float* v0,
                        const float* v1, const bool* valid0,
                        const bool* valid1, float* m0, float* m1,
                        float* part0, float* ml0, float* part1, float* ml1,
                        int B, int H, int M, int N, int splits0, int splits1,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = Shape<D>::kBytes;
  cudaError_t err = allow_smem(flash_cross_pair_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int x0 = lg::tc::cdiv(M, lg::tc::BQ) * splits0;
  const int x1 = lg::tc::cdiv(N, lg::tc::BQ) * splits1;
  const dim3 grid(x0 > x1 ? x0 : x1, H, 2 * B);
  flash_cross_pair_kernel<D><<<grid, lg::tc::THREADS, smem, stream>>>(qk0, qk1, v0, v1, valid0, valid1, m0, m1, part0, ml0, part1, ml1, H, M, N, splits0, splits1, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = merge<false>(part0, ml0, m0, B * H * M, D, splits0, stream);
  if (err != cudaSuccess) return err;
  return merge<false>(part1, ml1, m1, B * H * N, D, splits1, stream);
}

template <int D>
cudaError_t launch_pair(const bf16* qk0, const bf16* qk1, const bf16* v0,
                        const bf16* v1, const bool* valid0,
                        const bool* valid1, bf16* m0, bf16* m1, float* part0,
                        float* ml0, float* part1, float* ml1, int B, int H,
                        int M, int N, int splits0, int splits1, float scale,
                        cudaStream_t stream) {
  using S = WalkShape<D>;
  CUtensorMap k0map, k1map, v0map, v1map;
  cudaError_t err = lg::wg::walk_map(&k0map, qk0, B * H, M, D);
  if (err == cudaSuccess) err = lg::wg::walk_map(&k1map, qk1, B * H, N, D);
  if (err == cudaSuccess) err = lg::wg::walk_map(&v0map, v0, B * H, M, D);
  if (err == cudaSuccess) err = lg::wg::walk_map(&v1map, v1, B * H, N, D);
  if (err == cudaSuccess)
    err = lg::wg::allow_walk_smem<D>(flash_cross_pair_wg_kernel<D>);
  if (err != cudaSuccess) return err;
  const int x0 = lg::tc::cdiv(M, S::BQ) * splits0;
  const int x1 = lg::tc::cdiv(N, S::BQ) * splits1;
  const dim3 grid(x0 > x1 ? x0 : x1, H, 2 * B);
  flash_cross_pair_wg_kernel<D><<<grid, S::THREADS, S::kBytes, stream>>>(k0map, k1map, v0map, v1map, qk0, qk1, valid0, valid1, m0, m1, part0, ml0, part1, ml1, H, M, N, splits0, splits1, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = merge<false>(part0, ml0, m0, B * H * M, D, splits0, stream);
  if (err != cudaSuccess) return err;
  return merge<false>(part1, ml1, m1, B * H * N, D, splits1, stream);
}

template <class E>
cudaError_t sdpa(const E* q, const E* k, const E* v, const bool* kvalid,
                 E* o, float* part, float* ml, int B, int H, int Nq, int Nk,
                 int d, int shift, int splits, float scale, float shift2,
                 cudaStream_t stream) {
  return shift ? launch_d<true>(d, q, k, v, kvalid, o, part, ml, B, H, Nq, Nk,
                                splits, scale, shift2, stream)
               : launch_d<false>(d, q, k, v, kvalid, o, part, ml, B, H, Nq,
                                 Nk, splits, scale, shift2, stream);
}

template <class E>
cudaError_t pair(const E* qk0, const E* qk1, const E* v0, const E* v1,
                 const bool* valid0, const bool* valid1, E* m0, E* m1,
                 float* part0, float* ml0, float* part1, float* ml1, int B,
                 int H, int M, int N, int d, int splits0, int splits1,
                 float scale, cudaStream_t stream) {
  if (d == 64)
    return launch_pair<64>(qk0, qk1, v0, v1, valid0, valid1, m0, m1, part0,
                           ml0, part1, ml1, B, H, M, N, splits0, splits1,
                           scale, stream);
  if (d == 128)
    return launch_pair<128>(qk0, qk1, v0, v1, valid0, valid1, m0, m1, part0,
                            ml0, part1, ml1, B, H, M, N, splits0, splits1,
                            scale, stream);
  return cudaErrorInvalidValue;
}

template <class E>
cudaError_t shape(int d, int* key_tile, int* blocks_per_sm, int* query_rows) {
  if (d == 64) return walk_shape<64, E>(key_tile, blocks_per_sm, query_rows);
  if (d == 128) return walk_shape<128, E>(key_tile, blocks_per_sm, query_rows);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: (B, H, Nq, d); k, v: (B, H, Nk, d); kvalid: (B, Nk) bool, true
// for a valid key, or null;
// d 64 or 128; q, k, v 16-byte aligned. splits: key splits per query tile
// (1 <= splits <= the key tiles, lg_attention_shape); with splits > 1,
// part (splits, B H Nq, d) and ml (splits, B H Nq, 2) are scratch. scale
// multiplies q (1/sqrt(d) exact; times log2(e) with a shift); shift2 =
// shift * log2(e).
extern "C" cudaError_t lg_flash_sdpa(const float* q, const float* k,
                                     const float* v, const bool* kvalid,
                                     float* o, float* part, float* ml, int B,
                                     int H, int Nq, int Nk, int d, int shift,
                                     int splits, float scale, float shift2,
                                     cudaStream_t stream) {
  return sdpa<float>(q, k, v, kvalid, o, part, ml, B, H, Nq, Nk, d, shift,
                     splits, scale, shift2, stream);
}

// qk0, v0, m0: (B, H, M, d); qk1, v1, m1: (B, H, N, d); valid0 (B, M),
// valid1 (B, N) bool, each or null; d 64 or 128; inputs 16-byte aligned.
// splits0 splits direction 0's N keys (part0 (splits0, B H M, d), ml0 (splits0,
// B H M, 2)), splits1 direction 1's M keys. scale multiplies the queries
// of both directions (1/sqrt(d)).
extern "C" cudaError_t lg_flash_cross_pair(
    const float* qk0, const float* qk1, const float* v0, const float* v1,
    const bool* valid0, const bool* valid1, float* m0, float* m1,
    float* part0, float* ml0, float* part1, float* ml1, int B, int H, int M,
    int N, int d, int splits0, int splits1, float scale,
    cudaStream_t stream) {
  return pair<float>(qk0, qk1, v0, v1, valid0, valid1, m0, m1, part0, ml0,
                     part1, ml1, B, H, M, N, d, splits0, splits1, scale,
                     stream);
}

// The walk's key tile, the blocks an SM holds of it and the query rows of
// a block at head_dim d (64 or 128), for the wrapper's split plan. The
// stream is not used.
extern "C" cudaError_t lg_attention_shape(int d, int* key_tile,
                                          int* blocks_per_sm, int* query_rows,
                                          cudaStream_t stream) {
  (void)stream;
  return shape<float>(d, key_tile, blocks_per_sm, query_rows);
}

// The bf16 forms (mp) of the three entry points above: q, k, v, o (qk, v,
// m) bf16, d 64 or 128; part and ml fp32 scratch as above; scale the
// query scale rounded to bf16. k and v (qk and v) are read by TMA: their
// addresses must be 16-byte aligned (cudaErrorInvalidValue otherwise).
extern "C" cudaError_t lg_flash_sdpa_bf16(const bf16* q, const bf16* k,
                                          const bf16* v, const bool* kvalid,
                                          bf16* o, float* part, float* ml,
                                          int B, int H, int Nq, int Nk, int d,
                                          int shift, int splits, float scale,
                                          float shift2, cudaStream_t stream) {
  return sdpa<bf16>(q, k, v, kvalid, o, part, ml, B, H, Nq, Nk, d, shift,
                    splits, scale, shift2, stream);
}

extern "C" cudaError_t lg_flash_cross_pair_bf16(
    const bf16* qk0, const bf16* qk1, const bf16* v0, const bf16* v1,
    const bool* valid0, const bool* valid1, bf16* m0, bf16* m1,
    float* part0, float* ml0, float* part1, float* ml1, int B, int H, int M,
    int N, int d, int splits0, int splits1, float scale,
    cudaStream_t stream) {
  return pair<bf16>(qk0, qk1, v0, v1, valid0, valid1, m0, m1, part0, ml0,
                    part1, ml1, B, H, M, N, d, splits0, splits1, scale,
                    stream);
}

extern "C" cudaError_t lg_attention_shape_bf16(int d, int* key_tile,
                                               int* blocks_per_sm,
                                               int* query_rows,
                                               cudaStream_t stream) {
  (void)stream;
  return shape<bf16>(d, key_tile, blocks_per_sm, query_rows);
}
