// B5 and B6: the whole-block kernels' own launches, fp32 on the tensor
// cores (gemm_tc.cuh). B5 (SelfBlock) and B6 (CrossBlock, both images) run
// as the ops ops/flash_self.py and ops/flash_cross_block.py, each a short
// chain of hand-written launches:
//   B5: project_tc_kernel (q, k, v with rotary), the K1 key walk of
//       flash_sdpa.cu (exact or shift, head_dim 64 or 128) on them, then
//       the tail: out_proj_tc_kernel, lin1_tc_kernel, lin2_tc_kernel;
//   B6: project_tc_kernel over the rows of both images (qk, v), the row
//       and column launches of flash_cross.cu (mode 1 exact, mode 2 shift;
//       head_dim 64, as the TPU kernel), then one tail over the rows of
//       both images.
//
// Replaces the TPU kernels lightglue_tpu/ops/flash_self.py::_kernel
// (fused_self_block) and lightglue_tpu/ops/flash_cross_block.py::_kernel
// (fused_cross_block): for one block,
//   out = x + FFN(cat[x, sum_h ctx_h Wo[h] + bo])
// with the per-head context ctx_h of self attention (rot(q), rot(k), v
// from Wqkv) or of the shared-QK cross attention (to_qk, to_v), the softmax
// scale (times log2(e) with a shift) folded into the projection weights by
// the host (prepare in the ops). Rotary stays in the reference's interleaved
// pair layout; the TPU kernel's deinterleaved layout is a lane trick that
// changes no score.
//
// What bounds them on an H100: arithmetic. B5 per image and layer at N
// 1024, D 256: 2.42 GFLOP (Wqkv 0.40, attention 1.07, out_proj 0.13, FFN
// 0.81) against 1 MB of x, 2.6 MB of weights and 1 MB of output; B6 per
// pair at M = N = 1024: 4.03 GFLOP. On CUDA cores (67 TFLOP/s fp32) that is
// 36 and 60 us; as 3xTF32 on the tensor cores (three tf32 products of 495
// TFLOP/s each) 15 and 24 us. The projection and the tail are 1.35 of B5's
// 2.42 GFLOP and 2.96 of B6's 4.03.
//
// Design: the TPU kernels keep a whole block's activations in VMEM; a
// block's 227 KB cannot, and the card needs many blocks in flight where the
// TPU walks one grid in order. So the block splits at the head boundary and
// at each product: every product is one launch of the tile product, whose
// grid is its own size (64 x 64 or smaller tiles at B 1, so that each SM has
// a block; 64 x 128 at B 16, so that each weight tile serves more rows and
// each row tile more channels: ops/block_tc.py::tile_plan), with the
// weights stored K-major once by the
// host (prepare). The tail is three launches: msg = merge_heads(ctx) Wo +
// bo (the prologue reads ctx head-major); h = [x | msg] W1 + b1 (the concat
// as two K ranges), whose epilogue also writes each row's LayerNorm
// partials over 16 columns (count, mean, M2 about the partial's own mean:
// a trained layer's LN input can have |mean| >> std, where sum and sum of
// squares cancel); out = x + GELU(LN(h)) W2 + b2, whose prologue merges a
// row's partials in order (Chan's formula) and applies LayerNorm (eps 1e-5)
// and the exact erf GELU to each A tile as it lands. The context, msg and h
// go through device memory (h: 64 MB a tail at B 16, about 20 us of HBM
// time).
#include "gemm_tc.cuh"

namespace {

using lg::gemm::BK;
using lg::gemm::LDS;
using lg::gemm::PART;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// The rows of a launch: B n0 rows of segment 0 (image 0), then B n1 of
// segment 1 (image 1 of B6; n1 = 0 for B5), each segment's rows in its own
// (B, n_s, ...) tensors.
struct Rows {
  int rows0;  // B n0
  __device__ bool second(int r) const { return r >= rows0; }
  __device__ int local(int r) const { return r >= rows0 ? r - rows0 : r; }
};

// A = rows of x, (B, n_s, ld) for each segment
struct XSrc : lg::gemm::NoTransform {
  Rows rows;
  const float* x0;
  const float* x1;
  int ld;
  using Cursor = const float*;
  __device__ Cursor at(int r) const {
    return (rows.second(r) ? x1 : x0) + (size_t)rows.local(r) * ld;
  }
  __device__ const float* src(Cursor c, int k0) const { return c + k0; }
};

// A = merge_heads(ctx): channel k = h hd + c of row (b, i) at
// ctx_s[((b H + h) n_s + i) hd + c]; a 32-channel step lies in one head
struct CtxSrc : lg::gemm::NoTransform {
  Rows rows;
  const float* c0;
  const float* c1;
  int n0, n1, H, hd;
  struct Cursor {
    const float* p;  // the row's channels of head 0
    int hs;          // n_s hd: from one head to the next
  };
  __device__ Cursor at(int r) const {
    const bool s = rows.second(r);
    const int loc = rows.local(r), n = s ? n1 : n0;
    const int b = loc / n, i = loc - b * n;
    return {(s ? c1 : c0) + ((size_t)b * H * n + i) * hd, n * hd};
  }
  __device__ const float* src(const Cursor& c, int k0) const {
    const int h = k0 / hd;
    return c.p + (size_t)h * c.hs + (k0 - h * hd);
  }
};

// A = [x | msg]: channels below D from the rows of x, the rest from msg
// (R, D)
struct CatSrc : lg::gemm::NoTransform {
  Rows rows;
  const float* x0;
  const float* x1;
  const float* msg;
  int D;
  struct Cursor {
    const float* x;
    const float* m;
  };
  __device__ Cursor at(int r) const {
    return {(rows.second(r) ? x1 : x0) + (size_t)rows.local(r) * D,
            msg + (size_t)r * D};
  }
  __device__ const float* src(const Cursor& c, int k0) const {
    return k0 < D ? c.x + k0 : c.m + (k0 - D);
  }
};

// A = GELU(LN(h)), h (R, C): begin merges each row's `parts` LayerNorm
// partials (stats (R, parts, 2): mean and M2 of PART columns) in order
// into the row's mean and 1 / sqrt(var + 1e-5); transform applies the
// LayerNorm and the exact erf GELU to a landed A tile. gamma and beta
// 16-byte aligned.
struct LnSrc {
  static constexpr bool kTransform = true;
  const float* h;
  const float* stats;
  const float* gamma;
  const float* beta;
  int C, parts;
  using Cursor = const float*;
  __device__ Cursor at(int r) const { return h + (size_t)r * C; }
  __device__ const float* src(Cursor c, int k0) const { return c + k0; }

  template <class T>
  __device__ void begin(float* extra, int m0, int R) const {
    for (int r = threadIdx.x; r < T::BM; r += T::THREADS) {
      float mean = 0.f, rstd = 0.f;
      if (m0 + r < R) {
        // Chan's merge of (n, mean, M2) with (PART, mb, m2b), in order
        const float* st = stats + (size_t)(m0 + r) * parts * 2;
        float n = PART, m2 = st[1];
        mean = st[0];
        for (int p = 1; p < parts; ++p) {
          const float nn = n + PART, delta = st[2 * p] - mean;
          mean = mean + delta * (PART / nn);
          m2 = m2 + (st[2 * p + 1] + delta * delta * (n * PART / nn));
          n = nn;
        }
        rstd = 1.0f / sqrtf(m2 / n + 1e-5f);
      }
      extra[r] = mean;
      extra[T::BM + r] = rstd;
    }
  }

  // a thread keeps one 4-channel column of the step (its gamma and beta)
  // and walks the tile's rows, 16 bytes at a time
  template <class T>
  __device__ void transform(float* As, const float* extra, int k0) const {
    constexpr int CH = BK / 4;
    static_assert(T::THREADS % CH == 0, "a thread keeps its column");
    const int c = 4 * (threadIdx.x % CH);
    const float4 ga = *reinterpret_cast<const float4*>(gamma + k0 + c);
    const float4 be = *reinterpret_cast<const float4*>(beta + k0 + c);
    for (int r = threadIdx.x / CH; r < T::BM; r += T::THREADS / CH) {
      float4* p = reinterpret_cast<float4*>(As + r * LDS + c);
      const float mean = extra[r], rstd = extra[T::BM + r];
      float4 v = *p;
      v.x = gelu((v.x - mean) * rstd * ga.x + be.x);
      v.y = gelu((v.y - mean) * rstd * ga.y + be.y);
      v.z = gelu((v.z - mean) * rstd * ga.z + be.z);
      v.w = gelu((v.w - mean) * rstd * ga.w + be.w);
      *p = v;
    }
  }

  // the exact erf GELU (nn.gelu)
  __device__ static float gelu(float x) {
    return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
  }
};

// The rows and columns of a thread's accumulators (gemm_tc.cuh::product).
struct Frag {
  int g, t;
  __device__ Frag() : g((threadIdx.x & 31) >> 2), t(threadIdx.x & 3) {}
  __device__ int row(int wr, int mt, int half) const {
    return wr + 16 * mt + g + 8 * half;
  }
  __device__ int col(int wc, int nt) const { return wc + 8 * nt + 2 * t; }
};

// The projection's epilogue: + bias, rotary on the first n_rot groups,
// written as (G, B, H, n_s, hd) for each segment. Channel ch = g D + h hd +
// c; a thread's column pair (c, c + 1) is one rotary pair.
struct HeadsEpi {
  Rows rows;
  float* out0;
  float* out1;
  const float* bias;
  const float* cs;  // (B, n0, hd / 2) cos and sin, or null
  const float* sn;
  int B, n0, n1, H, hd, n_rot;
  template <class T>
  __device__ void store(const float (&acc)[T::MT][T::NT][4], int wr, int wc,
                        int R) const {
    const Frag f;
    const int D = H * hd;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = f.row(wr, mt, half);
        if (r >= R) continue;
        const bool s = rows.second(r);
        const int loc = rows.local(r), n = s ? n1 : n0;
        const int b = loc / n, i = loc - b * n;
        float* ob = s ? out1 : out0;
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const int ch = f.col(wc, nt), grp = ch / D, h = ch % D / hd,
                    c = ch % hd;
          float v0 = acc[mt][nt][2 * half] + bias[ch];
          float v1 = acc[mt][nt][2 * half + 1] + bias[ch + 1];
          if (grp < n_rot) {
            // ops/rotary.py::apply_rotary: o[2p] = t[2p] c - t[2p+1] s,
            // o[2p+1] = t[2p+1] c + t[2p] s
            const size_t at = ((size_t)b * n + i) * (hd / 2) + (c >> 1);
            const float co = cs[at], si = sn[at];
            const float o0 = v0 * co - v1 * si, o1 = v1 * co + v0 * si;
            v0 = o0;
            v1 = o1;
          }
          *reinterpret_cast<float2*>(
              ob + ((((size_t)grp * B + b) * H + h) * n + i) * hd + c) =
              make_float2(v0, v1);
        }
      }
  }
};

// out (R, C) = acc + bias (msg of out_proj)
struct BiasEpi {
  float* out;
  const float* bias;
  int C;
  template <class T>
  __device__ void store(const float (&acc)[T::MT][T::NT][4], int wr, int wc,
                        int R) const {
    const Frag f;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = f.row(wr, mt, half);
        if (r >= R) continue;
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const int c = f.col(wc, nt);
          *reinterpret_cast<float2*>(out + (size_t)r * C + c) =
              make_float2(acc[mt][nt][2 * half] + bias[c],
                          acc[mt][nt][2 * half + 1] + bias[c + 1]);
        }
      }
  }
};

// lin1's epilogue: h (R, C) = acc + b1, and for each row and each PART
// columns of it (n-tiles 2j, 2j + 1 of a warp: a quad's 16 values) the
// partial (mean, M2 about that mean) into stats (R, C / PART, 2). Every
// lane takes part in the quad sums, valid row or not.
struct StatsEpi {
  float* h;
  float* stats;
  const float* bias;
  int C;
  template <class T>
  __device__ void store(const float (&acc)[T::MT][T::NT][4], int wr, int wc,
                        int R) const {
    const Frag f;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = f.row(wr, mt, half);
        float v[T::NT][2];
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const int c = f.col(wc, nt);
          v[nt][0] = acc[mt][nt][2 * half] + bias[c];
          v[nt][1] = acc[mt][nt][2 * half + 1] + bias[c + 1];
          if (r < R)
            *reinterpret_cast<float2*>(h + (size_t)r * C + c) =
                make_float2(v[nt][0], v[nt][1]);
        }
#pragma unroll
        for (int j = 0; j < T::NT / 2; ++j) {
          float s = ((v[2 * j][0] + v[2 * j][1]) + v[2 * j + 1][0]) +
                    v[2 * j + 1][1];
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          const float mean = s * (1.0f / PART);
          float q = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = v[2 * j + (e >> 1)][e & 1] - mean;
            q += d * d;
          }
          q += __shfl_xor_sync(0xffffffffu, q, 1);
          q += __shfl_xor_sync(0xffffffffu, q, 2);
          if (f.t == 0 && r < R)
            *reinterpret_cast<float2*>(
                stats + ((size_t)r * (C / PART) + (wc + 16 * j) / PART) * 2) =
                make_float2(mean, q);
        }
      }
  }
};

// lin2's epilogue: out_s[row] = x_s[row] + (acc + b2), (B, n_s, C) each
struct ResidualEpi {
  Rows rows;
  const float* x0;
  const float* x1;
  float* out0;
  float* out1;
  const float* bias;
  int C;
  template <class T>
  __device__ void store(const float (&acc)[T::MT][T::NT][4], int wr, int wc,
                        int R) const {
    const Frag f;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = f.row(wr, mt, half);
        if (r >= R) continue;
        const bool s = rows.second(r);
        const size_t off = (size_t)rows.local(r) * C;
        const float* xr = (s ? x1 : x0) + off;
        float* orow = (s ? out1 : out0) + off;
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const int c = f.col(wc, nt);
          const float2 xv = *reinterpret_cast<const float2*>(xr + c);
          *reinterpret_cast<float2*>(orow + c) =
              make_float2(xv.x + (acc[mt][nt][2 * half] + bias[c]),
                          xv.y + (acc[mt][nt][2 * half + 1] + bias[c + 1]));
        }
      }
  }
};

template <class T>
__global__ void __launch_bounds__(T::THREADS)
    project_tc_kernel(XSrc a, const float* __restrict__ w, HeadsEpi e, int K,
                      int R) {
  lg::gemm::product<T>(a, w, K, R, e);
}

template <class T>
__global__ void __launch_bounds__(T::THREADS)
    out_proj_tc_kernel(CtxSrc a, const float* __restrict__ w, BiasEpi e,
                       int K, int R) {
  lg::gemm::product<T>(a, w, K, R, e);
}

template <class T>
__global__ void __launch_bounds__(T::THREADS)
    lin1_tc_kernel(CatSrc a, const float* __restrict__ w, StatsEpi e, int K,
                   int R) {
  lg::gemm::product<T>(a, w, K, R, e);
}

template <class T>
__global__ void __launch_bounds__(T::THREADS)
    lin2_tc_kernel(LnSrc a, const float* __restrict__ w, ResidualEpi e,
                   int K, int R) {
  lg::gemm::product<T>(a, w, K, R, e);
}

// One launch of `kernel` with tile T over R rows and C output channels.
template <class T, class Kernel, class ASrc, class Epi>
cudaError_t launch_tc(Kernel kernel, const ASrc& a, const float* w,
                      const Epi& e, int K, int R, int C,
                      cudaStream_t stream) {
  if (R < 1 || K % BK != 0 || C % T::BN != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(C / T::BN, cdiv(R, T::BM));
  kernel<<<grid, T::THREADS, T::kBytes, stream>>>(a, w, e, K, R);
  return cudaGetLastError();
}

}  // namespace

// Rows: B n0 of x0 / out0 (B, n0, ...) then B n1 of x1 / out1 (n1 0: no
// second segment, x1 and out1 unused). All pointers 16-byte aligned; D =
// H hd, hd a multiple of 32; `tile` indexes gemm_tc.cuh's tiles.

// x_s (B, n_s, D); w (G D, D), one row per output channel; bias (G D);
// cos, sin (B, n0, hd / 2) or null; out_s (G, B, H, n_s, hd); the first
// n_rot groups get rotary (one segment only).
extern "C" cudaError_t lg_project_heads(const float* x0, const float* x1,
                                        const float* w, const float* bias,
                                        const float* cs, const float* sn,
                                        float* out0, float* out1, int B,
                                        int n0, int n1, int G, int H, int hd,
                                        int n_rot, int tile,
                                        cudaStream_t stream) {
  if ((n_rot > 0 && (cs == nullptr || sn == nullptr || n1 != 0)) ||
      hd % 32 != 0 || n0 < 1 || n1 < 0)
    return cudaErrorInvalidValue;
  const int D = H * hd, R = B * (n0 + n1);
  const Rows rows{B * n0};
  const XSrc a{{}, rows, x0, x1, D};
  const HeadsEpi e{rows, out0, out1, bias, cs, sn, B, n0, n1, H, hd, n_rot};
  return lg::gemm::with_tile(tile, [&](auto t) {
    using T = decltype(t);
    return launch_tc<T>(project_tc_kernel<T>, a, w, e, D, R, G * D, stream);
  });
}

// msg (R, D) = merge_heads(ctx) Wo + bo: ctx_s (B, H, n_s, hd); woT (D, D)
// with woT[o][k] = Wo[k][o]; bo (D).
extern "C" cudaError_t lg_tail_out_proj(const float* ctx0, const float* ctx1,
                                        const float* woT, const float* bo,
                                        float* msg, int B, int n0, int n1,
                                        int H, int hd, int tile,
                                        cudaStream_t stream) {
  if (hd % 32 != 0 || n0 < 1 || n1 < 0) return cudaErrorInvalidValue;
  const int D = H * hd, R = B * (n0 + n1);
  const CtxSrc a{{}, Rows{B * n0}, ctx0, ctx1, n0, n1, H, hd};
  const BiasEpi e{msg, bo, D};
  return lg::gemm::with_tile(tile, [&](auto t) {
    using T = decltype(t);
    return launch_tc<T>(out_proj_tc_kernel<T>, a, woT, e, D, R, D, stream);
  });
}

// h (R, 2D) = [x | msg] W1 + b1 and its LayerNorm partials stats (R, 2D /
// 16, 2): x_s (B, n_s, D); msg (R, D); w1T (2D, 2D) with w1T[o][k] =
// W1[k][o]; b1 (2D).
extern "C" cudaError_t lg_tail_lin1(const float* x0, const float* x1,
                                    const float* msg, const float* w1T,
                                    const float* b1, float* h, float* stats,
                                    int B, int n0, int n1, int D, int tile,
                                    cudaStream_t stream) {
  if (D % 32 != 0 || n0 < 1 || n1 < 0) return cudaErrorInvalidValue;
  const int R = B * (n0 + n1);
  const CatSrc a{{}, Rows{B * n0}, x0, x1, msg, D};
  const StatsEpi e{h, stats, b1, 2 * D};
  return lg::gemm::with_tile(tile, [&](auto t) {
    using T = decltype(t);
    return launch_tc<T>(lin1_tc_kernel<T>, a, w1T, e, 2 * D, R, 2 * D,
                        stream);
  });
}

// out_s (B, n_s, D) = x_s + GELU(LN(h)) W2 + b2: h (R, 2D) and stats
// (lg_tail_lin1's); gamma, beta (2D); w2T (D, 2D) with w2T[o][k] =
// W2[k][o]; b2 (D).
extern "C" cudaError_t lg_tail_lin2(const float* h, const float* stats,
                                    const float* gamma, const float* beta,
                                    const float* w2T, const float* b2,
                                    const float* x0, const float* x1,
                                    float* out0, float* out1, int B, int n0,
                                    int n1, int D, int tile,
                                    cudaStream_t stream) {
  if (D % 32 != 0 || n0 < 1 || n1 < 0) return cudaErrorInvalidValue;
  const int R = B * (n0 + n1), rows0 = B * n0;
  const LnSrc a{h, stats, gamma, beta, 2 * D, 2 * D / PART};
  const ResidualEpi e{Rows{rows0}, x0, x1, out0, out1, b2, D};
  return lg::gemm::with_tile(tile, [&](auto t) {
    using T = decltype(t);
    return launch_tc<T>(lin2_tc_kernel<T>, a, w2T, e, 2 * D, R, D, stream);
  });
}
