// K4 (B2): log-assignment reductions for mutual-nearest filtering, fp32,
// without storing the M x N score matrix.
//
// Replaces the TPU kernels lightglue_tpu/ops/assignment_fused.py::_lse_kernel
// and ::_argmax_kernel (fused_filter_matches). With sim = mdesc0 mdesc1^T
// (descriptors already projected and scaled by d^-0.25) and additive
// validity biases (0 valid / -1e30 masked):
//   pass 1: lse_row_i = logsumexp_j (sim_ij + bias1_j + bias0_i), and the
//           same over i for lse_col_j; then rterm = logsigmoid(z0) - lse_row
//           and cterm = logsigmoid(z1) - lse_col (-1e30 where masked);
//   pass 2: m0_i = argmax_j (2 sim_ij + biases + cterm_j), v0_i = max + rterm_i
//           m1_j = argmax_i (2 sim_ij + biases + rterm_i), v1_j = max + cterm_j
// with the lowest index winning ties, as jnp.argmax and the TPU's running
// column argmax (strict >) do.
//
// What bounds it on an H100: arithmetic. The function needs sim once, 2 M N
// D flop (0.54 GFLOP per pair at M = N = 1024, D 256), against 2 MB of
// descriptors: 8.0 us a pair in fp32 on the CUDA cores, 3.3 us as 3xTF32 on
// the tensor cores. Each pass recomputes it (the matrix is never stored), so
// the kernels do twice that.
//
// Design: each pass is one launch of the tile product of gemm_tc.cuh (3xTF32
// mma.sync, cp.async ring) over a (column tile, row tile, batch) grid, A =
// mdesc0 and B = mdesc1, both K-major. Its epilogue stores no score: it
// reduces the tile's accumulator in both directions at once, each row over
// the tile's columns and each column over the tile's rows (quad and warp
// shuffles, then the warps' partials in warp order through shared memory),
// and writes one partial per (row, column tile) and per (column, row tile):
// (max, sum of exp(s - max)) in pass 1, (max, first index) in pass 2. A
// small merge launch combines each row's and column's partials in tile
// order (log-sum-exp by max-rescale; argmax with a strict > in increasing
// tile order, so the lowest index wins), and writes rterm / cterm or the
// argmaxes and maxima. Row and column reductions read the same accumulator
// value, and every partial is written by one block and merged in a fixed
// order: no atomics, the same bits on every run.
#include "gemm_tc.cuh"

namespace {

using lg::gemm::BK;

constexpr float MASKED = -1e30f;  // the score bias of a masked point

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// A = rows of one batch entry's mdesc0 (M, D)
struct RowSrc : lg::gemm::NoTransform {
  const float* x;
  int ld;
  using Cursor = const float*;
  __device__ Cursor at(int r) const { return x + (size_t)r * ld; }
  __device__ const float* src(Cursor c, int k0) const { return c + k0; }
};

__device__ __forceinline__ float bias(const bool* mask, int i) {
  return mask != nullptr && !mask[i] ? MASKED : 0.f;
}

// (v, i) <- (vo, io) when vo is larger, or equal at a lower index
__device__ __forceinline__ void take_better(float& v, int& i, float vo,
                                            int io) {
  if (vo > v || (vo == v && io < i)) {
    v = vo;
    i = io;
  }
}

// A lane's N values reduced together with the lanes its xor masks lo .. hi
// reach (1, 2: the quad that holds a row's column pairs; 4 .. 16: the eight
// lanes that hold a column's rows): lse_lanes to (max, sum of exp(x -
// max)), argmax_lanes to (max, the lowest index that reaches it).
template <int N>
__device__ __forceinline__ float2 lse_lanes(const float (&x)[N], int lo,
                                            int hi) {
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < N; ++k) m = fmaxf(m, x[k]);
  for (int o = lo; o <= hi; o <<= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float ref = m == -INFINITY ? 0.f : m;  // all out of range: sum 0
  float l = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) l += expf(x[k] - ref);
  for (int o = lo; o <= hi; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  return make_float2(m, l);
}

template <int N>
__device__ __forceinline__ float2 argmax_lanes(const float (&x)[N],
                                               const int (&idx)[N], int lo,
                                               int hi) {
  float v = -INFINITY;
  int i = 0x7fffffff;
#pragma unroll
  for (int k = 0; k < N; ++k) take_better(v, i, x[k], idx[k]);
  for (int o = lo; o <= hi; o <<= 1)
    take_better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
                __shfl_xor_sync(0xffffffffu, i, o));
  return make_float2(v, __int_as_float(i));
}

// Partials of warps w = 0 .. n - 1 (stride apart) merged in warp order.
template <bool ARGMAX>
__device__ __forceinline__ float2 merge_warps(const float2* p, int n,
                                              int stride) {
  if (ARGMAX) {
    float v = p[0].x;
    int i = __float_as_int(p[0].y);
    for (int w = 1; w < n; ++w)
      take_better(v, i, p[w * stride].x, __float_as_int(p[w * stride].y));
    return make_float2(v, __int_as_float(i));
  }
  float m = -INFINITY, l = 0.f;
  for (int w = 0; w < n; ++w) m = fmaxf(m, p[w * stride].x);
  for (int w = 0; w < n; ++w) l += p[w * stride].y * expf(p[w * stride].x - m);
  return make_float2(m, l);
}

// One score tile and its partials. Grid (cdiv(N, BN), cdiv(M, BM), B).
// ARGMAX (pass 2): t = 2 sim + bias1 + bias0, rows reduce t + cterm, columns
// t + rterm, to (max, first index); else (pass 1) s = sim + bias1 + bias0,
// both directions to (max, sum of exp(s - max)). rowp (B, CT, M) and colp
// (B, RT, N) float2, CT and RT the column and row tiles.
template <class T, bool ARGMAX>
__global__ void __launch_bounds__(T::THREADS)
    assign_tile_kernel(const float* __restrict__ d0,
                       const float* __restrict__ d1,
                       const bool* __restrict__ mask0,
                       const bool* __restrict__ mask1,
                       const float* __restrict__ rterm,
                       const float* __restrict__ cterm,
                       float2* __restrict__ rowp, float2* __restrict__ colp,
                       int M, int N, int D) {
  constexpr int WARPS_M = T::BM / T::WM;
  const int b = blockIdx.z, m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wmi = warp / T::WARPS_N, wni = warp % T::WARPS_N;
  const int wr = wmi * T::WM, wc = wni * T::WN;  // within the block

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  const RowSrc a{{}, d0 + (size_t)b * M * D, D};
  lg::gemm::mainloop<T, RowSrc, true, true>(a, d1 + (size_t)b * N * D, D, M,
                                            m0, n0, acc, N);

  // the thread's rows (mt, half) and columns (nt, e) of the tile
  const bool* mk0 = mask0 ? mask0 + (size_t)b * M : nullptr;
  const bool* mk1 = mask1 ? mask1 + (size_t)b * N : nullptr;
  float rb[T::MT][2], rt[T::MT][2], cb[T::NT][2], ct[T::NT][2];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wr + 16 * mt + g + 8 * h;
      rb[mt][h] = r < M ? bias(mk0, r) : 0.f;
      rt[mt][h] = ARGMAX && r < M ? rterm[(size_t)b * M + r] : 0.f;
    }
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n0 + wc + 8 * nt + 2 * t + e;
      cb[nt][e] = c < N ? bias(mk1, c) : 0.f;
      ct[nt][e] = ARGMAX && c < N ? cterm[(size_t)b * N + c] : 0.f;
    }
  // s[mt][nt][2 h + e]: the score, -inf outside the M x N matrix
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = k >> 1, e = k & 1;
        const bool in = m0 + wr + 16 * mt + g + 8 * h < M &&
                        n0 + wc + 8 * nt + 2 * t + e < N;
        const float x = ARGMAX ? 2.f * acc[mt][nt][k] : acc[mt][nt][k];
        acc[mt][nt][k] = in ? x + cb[nt][e] + rb[mt][h] : -INFINITY;
      }

  // every warp's reads of the ring are done: its shared memory holds the
  // warps' partials now, rows [WARPS_N][BM], then columns [WARPS_M][BN]
  __syncthreads();
  extern __shared__ __align__(16) float lg_smem[];
  float2* prow = reinterpret_cast<float2*>(lg_smem);
  float2* pcol = prow + T::WARPS_N * T::BM;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[2 * T::NT];
      int idx[2 * T::NT];
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[2 * nt + e] = acc[mt][nt][2 * h + e] + ct[nt][e];
          idx[2 * nt + e] = n0 + wc + 8 * nt + 2 * t + e;
        }
      const float2 p = ARGMAX ? argmax_lanes(x, idx, 1, 2)
                              : lse_lanes(x, 1, 2);
      if (t == 0) prow[wni * T::BM + wr + 16 * mt + g + 8 * h] = p;
    }
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x[2 * T::MT];
      int idx[2 * T::MT];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x[2 * mt + h] = acc[mt][nt][2 * h + e] + rt[mt][h];
          idx[2 * mt + h] = m0 + wr + 16 * mt + g + 8 * h;
        }
      const float2 p = ARGMAX ? argmax_lanes(x, idx, 4, 16)
                              : lse_lanes(x, 4, 16);
      if (g == 0) pcol[wmi * T::BN + wc + 8 * nt + 2 * t + e] = p;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < T::BM + T::BN; i += T::THREADS) {
    if (i < T::BM) {
      if (m0 + i < M)
        rowp[((size_t)b * gridDim.x + blockIdx.x) * M + m0 + i] =
            merge_warps<ARGMAX>(prow + i, T::WARPS_N, T::BM);
    } else if (n0 + i - T::BM < N) {
      colp[((size_t)b * gridDim.y + blockIdx.y) * N + n0 + i - T::BM] =
          merge_warps<ARGMAX>(pcol + i - T::BM, WARPS_M, T::BN);
    }
  }
}

// One thread per row (B M of them, then B N columns): the row's CT
// partials of rowp (the column's RT of colp) merged in tile order.
// ARGMAX: idx = the first index of the max, val = max + the row's rterm
// (the column's cterm), rterm and cterm read; else the row's rterm = ls0 -
// (max + log(max(sum, 1e-30))) (the column's cterm from ls1), -1e30 where
// masked, rterm and cterm written.
template <bool ARGMAX>
__global__ void __launch_bounds__(256)
    assign_merge_kernel(const float2* __restrict__ rowp,
                        const float2* __restrict__ colp,
                        const float* __restrict__ ls0,
                        const float* __restrict__ ls1,
                        const bool* __restrict__ mask0,
                        const bool* __restrict__ mask1,
                        float* __restrict__ rterm, float* __restrict__ cterm,
                        int* __restrict__ idx0, float* __restrict__ val0,
                        int* __restrict__ idx1, float* __restrict__ val1,
                        int B, int M, int N, int RT, int CT) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool col = i >= (long)B * M;
  if (col) i -= (long)B * M;
  const int n = col ? N : M, T = col ? RT : CT;
  if (i >= (long)B * n) return;
  const int b = (int)(i / n), r = (int)(i % n);
  const float2* p = (col ? colp : rowp) + (size_t)b * T * n + r;
  if (ARGMAX) {
    float v = p[0].x;
    int arg = __float_as_int(p[0].y);
    for (int k = 1; k < T; ++k)
      if (p[(size_t)k * n].x > v) {
        v = p[(size_t)k * n].x;
        arg = __float_as_int(p[(size_t)k * n].y);
      }
    (col ? idx1 : idx0)[i] = arg;
    (col ? val1 : val0)[i] = v + (col ? cterm : rterm)[i];
    return;
  }
  float m = -INFINITY, l = 0.f;
  for (int k = 0; k < T; ++k) m = fmaxf(m, p[(size_t)k * n].x);
  for (int k = 0; k < T; ++k)
    l += p[(size_t)k * n].y * expf(p[(size_t)k * n].x - m);
  const float lse = m + logf(fmaxf(l, 1e-30f));
  const bool* mask = col ? mask1 : mask0;
  (col ? cterm : rterm)[i] = mask != nullptr && !mask[i]
                                 ? MASKED
                                 : (col ? ls1 : ls0)[i] - lse;
}

}  // namespace

// mdesc0 (B, M, D), mdesc1 (B, N, D), 16-byte aligned, D a multiple of 32;
// mask0 (B, M), mask1 (B, N) bool or null (all valid). rterm (B, M) and
// cterm (B, N) null: pass 1, else pass 2. rowp (B, CT, M) and colp (B, RT,
// N) float2 partials, RT = cdiv(M, BM) and CT = cdiv(N, BN) of gemm_tc.cuh's
// tile `tile`.
extern "C" cudaError_t lg_assign_tiles(const float* d0, const float* d1,
                                       const bool* mask0, const bool* mask1,
                                       const float* rterm, const float* cterm,
                                       float2* rowp, float2* colp, int B,
                                       int M, int N, int D, int tile,
                                       cudaStream_t stream) {
  if (D % BK != 0 || M < 1 || N < 1 || (rterm == nullptr) != (cterm == nullptr))
    return cudaErrorInvalidValue;
  return lg::gemm::with_tile(tile, [&](auto tl) {
    using T = decltype(tl);
    static_assert(2 * (T::WARPS_N * T::BM + (T::BM / T::WM) * T::BN) <=
                      lg::gemm::STAGES * T::kStage,
                  "the warps' partials fit in the ring");
    auto kernel = rterm ? assign_tile_kernel<T, true>
                        : assign_tile_kernel<T, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(cdiv(N, T::BN), cdiv(M, T::BM), B);
    kernel<<<grid, T::THREADS, T::kBytes, stream>>>(d0, d1, mask0, mask1, rterm, cterm, rowp, colp, M, N, D);
    return cudaGetLastError();
  });
}

// Pass 1's merge: rowp, colp (lg_assign_tiles' pass 1); ls0 (B, M), ls1
// (B, N) the log-sigmoids of the matchability logits; masks as above ->
// rterm (B, M), cterm (B, N).
extern "C" cudaError_t lg_assign_merge_lse(const float2* rowp,
                                           const float2* colp,
                                           const float* ls0, const float* ls1,
                                           const bool* mask0,
                                           const bool* mask1, float* rterm,
                                           float* cterm, int B, int M, int N,
                                           int RT, int CT,
                                           cudaStream_t stream) {
  const long n = (long)B * (M + N);
  assign_merge_kernel<false><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(rowp, colp, ls0, ls1, mask0, mask1, rterm, cterm, nullptr, nullptr, nullptr, nullptr, B, M, N, RT, CT);
  return cudaGetLastError();
}

// Pass 2's merge: rowp, colp (lg_assign_tiles' pass 2) and the terms (read)
// ->
// idx0 (B, M) int32 and val0 (B, M), idx1 (B, N) and val1 (B, N).
extern "C" cudaError_t lg_assign_merge_argmax(
    const float2* rowp, const float2* colp, float* rterm, float* cterm,
    int* idx0, float* val0, int* idx1, float* val1, int B, int M, int N,
    int RT, int CT, cudaStream_t stream) {
  const long n = (long)B * (M + N);
  assign_merge_kernel<true><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(rowp, colp, nullptr, nullptr, nullptr, nullptr, rterm, cterm, idx0, val0, idx1, val1, B, M, N, RT, CT);
  return cudaGetLastError();
}
