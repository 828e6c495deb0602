// K4: log-assignment reductions for mutual-nearest filtering, fp32, without
// storing the M x N score matrix.
//
// Replaces the TPU kernels lightglue_tpu/ops/assignment_fused.py::_lse_kernel
// and ::_argmax_kernel (fused_filter_matches). With sim = mdesc0 mdesc1^T
// (descriptors already projected and scaled by d^-0.25) and additive
// validity biases (0 valid / -1e30 masked):
//   pass 1: lse_row_i = logsumexp_j (sim_ij + bias1_j + bias0_i), and the
//           same over i for lse_col_j;
//   pass 2: m0_i = argmax_j (2 sim_ij + biases + cterm_j), v0_i = max + rterm_i
//           m1_j = argmax_i (2 sim_ij + biases + rterm_i), v1_j = max + cterm_j
// with rterm = logsigmoid(z0) - lse_row and cterm = logsigmoid(z1) - lse_col
// computed between the passes by the caller.
//
// What bounds it on an H100: arithmetic. Each pass is 2 M N D flop
// (0.5 GFLOP per pair at M = N = 1024, D = 256) per direction against
// 2 MB of descriptors.
//
// Design: one kernel per reduction, launched once per direction with the
// two images' roles swapped, over (batch, 64-row tile). A block walks all
// 64-column tiles of the other image, D in 64-deep chunks, with the
// reduction carried in registers: an online log-sum-exp, or a running
// argmax. The TPU carries the column reduction across its sequential grid in
// VMEM scratch; here each direction is a row reduction of its own launch,
// so no block depends on another. Every score is a sum over d in the same
// order from either side, so both directions see the same bits.
// Ties: the TPU's running column argmax keeps the first maximum (strict >)
// and jnp.argmax takes the first index, so the lowest index wins. Each
// thread scans its columns in increasing order with a strict >, and the
// four threads of a row keep the larger value, or the lower index on a tie.
#include "common.cuh"

namespace {

using namespace lg;

// Scores of one 64 x 64 tile into Ss: mult * (Q_r . K_c) + kbias_c +
// qbias_r (+ kterm_c), -inf past Nk. Q (rows q0..) and K (rows c0..) are
// (n, D) row-major; D is a multiple of 64.
__device__ __forceinline__ void score_tile(
    float* Qs, float* Ks, float* Ss, const float* __restrict__ qb,
    const float* __restrict__ kb, const float* __restrict__ qbias,
    const float* __restrict__ kbias, const float* __restrict__ kterm, int q0,
    int c0, int Nq, int Nk, int D, float mult) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4] = {};
  for (int d0 = 0; d0 < D; d0 += HD) {
    __syncthreads();  // previous readers of Qs, Ks and Ss are done
    load_tile(Qs, LD, qb, q0, Nq, D, d0, 1.f);
    load_tile(Ks, LD, kb, c0, Nk, D, d0, 1.f);
    __syncthreads();
    tile_abt(Qs, Ks, s);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float rb = row < Nq ? qbias[row] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      float val = -INFINITY;
      if (col < Nk) {
        val = s[i][j] * mult + kbias[col] + rb;
        if (kterm) val += kterm[col];
      }
      Ss[(ty + 16 * i) * LD + tx + 16 * j] = val;
    }
  }
  __syncthreads();
}

// Grid (cdiv(Nq, 64), B). lse[b, r] = logsumexp over the row's scores.
__global__ void __launch_bounds__(THREADS)
    lse_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ qbias,
               const float* __restrict__ kbias, float* __restrict__ lse,
               int Nq, int Nk, int D) {
  extern __shared__ __align__(16) float lg_smem[];
  float* Qs = lg_smem;
  float* Ks = Qs + TILE * LD;
  float* Ss = Ks + TILE * LD;
  const int t = threadIdx.x, r = t >> 2, seg = t & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * TILE;
  const float* qb = q + (size_t)b * Nq * D;
  const float* kb = k + (size_t)b * Nk * D;
  const float* qbb = qbias + (size_t)b * Nq;
  const float* kbb = kbias + (size_t)b * Nk;

  float m_run = -INFINITY, l_run = 0.f;
  for (int c0 = 0; c0 < Nk; c0 += TILE) {
    score_tile(Qs, Ks, Ss, qb, kb, qbb, kbb, nullptr, q0, c0, Nq, Nk, D, 1.f);
    const float* srow = Ss + r * LD + seg * 16;
    float mt = -INFINITY;
#pragma unroll
    for (int c = 0; c < 16; ++c) mt = fmaxf(mt, srow[c]);
    const float m_new = fmaxf(m_run, group4_max(mt));
    float ps = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) ps += expf(srow[c] - m_new);
    l_run = l_run * expf(m_run - m_new) + group4_sum(ps);
    m_run = m_new;
  }
  if (seg == 0 && q0 + r < Nq)
    lse[(size_t)b * Nq + q0 + r] = m_run + logf(fmaxf(l_run, 1e-30f));
}

// Grid (cdiv(Nq, 64), B). idx[b, r] = first argmax over the row's
// 2 sim + biases + kterm; val[b, r] = that max + qterm[r].
__global__ void __launch_bounds__(THREADS)
    argmax_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ qbias,
                  const float* __restrict__ kbias,
                  const float* __restrict__ qterm,
                  const float* __restrict__ kterm, int* __restrict__ idx,
                  float* __restrict__ val, int Nq, int Nk, int D) {
  extern __shared__ __align__(16) float lg_smem[];
  float* Qs = lg_smem;
  float* Ks = Qs + TILE * LD;
  float* Ss = Ks + TILE * LD;
  const int t = threadIdx.x, r = t >> 2, seg = t & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * TILE;
  const float* qb = q + (size_t)b * Nq * D;
  const float* kb = k + (size_t)b * Nk * D;

  float best = -INFINITY;
  int arg = 0;
  for (int c0 = 0; c0 < Nk; c0 += TILE) {
    score_tile(Qs, Ks, Ss, qb, kb, qbias + (size_t)b * Nq,
               kbias + (size_t)b * Nk, kterm + (size_t)b * Nk, q0, c0, Nq, Nk,
               D, 2.f);
    const float* srow = Ss + r * LD + seg * 16;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = c0 + seg * 16 + c;
      if (col < Nk && srow[c] > best) {
        best = srow[c];
        arg = col;
      }
    }
  }
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, m);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, m);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  const int row = q0 + r;
  if (seg == 0 && row < Nq) {
    idx[(size_t)b * Nq + row] = arg;
    val[(size_t)b * Nq + row] = best + qterm[(size_t)b * Nq + row];
  }
}

// 49,920 bytes: just over the 48 KB static limit.
constexpr size_t kSmem = 3 * TILE * LD * sizeof(float);

}  // namespace

// q (B, Nq, D), k (B, Nk, D), qbias (B, Nq), kbias (B, Nk) -> lse (B, Nq).
extern "C" cudaError_t lg_assign_lse(const float* q, const float* k,
                                     const float* qbias, const float* kbias,
                                     float* lse, int B, int Nq, int Nk, int D,
                                     cudaStream_t stream) {
  if (D % HD != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(Nq, TILE), B);
  lse_kernel<<<grid, THREADS, kSmem, stream>>>(q, k, qbias, kbias, lse, Nq, Nk, D);
  return cudaGetLastError();
}

// As above plus qterm (B, Nq), kterm (B, Nk) -> idx (B, Nq) int32, val (B, Nq).
extern "C" cudaError_t lg_assign_argmax(const float* q, const float* k,
                                        const float* qbias, const float* kbias,
                                        const float* qterm, const float* kterm,
                                        int* idx, float* val, int B, int Nq,
                                        int Nk, int D, cudaStream_t stream) {
  if (D % HD != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(Nq, TILE), B);
  argmax_kernel<<<grid, THREADS, kSmem, stream>>>(q, k, qbias, kbias, qterm, kterm, idx, val, Nq, Nk, D);
  return cudaGetLastError();
}
