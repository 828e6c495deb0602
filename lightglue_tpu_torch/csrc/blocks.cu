// B5, B6 and B4: the whole-block kernels' own launches and the FFN
// residual, fp32 on the tensor cores (gemm_tc.cuh). B5 (SelfBlock) and B6
// (CrossBlock, both images) run as the ops ops/flash_self.py and
// ops/flash_cross_block.py, B4 as ops/ffn.py, each a short chain of
// hand-written launches:
//   B5: project_tc_kernel (q, k, v with rotary), the K1 key walk of
//       flash_sdpa.cu (exact or shift, head_dim 64 or 128) on them, then
//       the tail: out_proj_tc_kernel, lin1_tc_kernel, lin2_tc_kernel;
//   B6: project_tc_kernel over the rows of both images (qk, v), the row
//       and column launches of flash_cross.cu (mode 1 exact, mode 2 shift;
//       head_dim 64, as the TPU kernel), then one tail over the rows of
//       both images;
//   B4: lin1_tc_kernel and lin2_tc_kernel alone, over the rows of one
//       image or of both (the composed cross block).
//
// Replaces the TPU kernels lightglue_tpu/ops/flash_self.py::_kernel
// (fused_self_block), lightglue_tpu/ops/flash_cross_block.py::_kernel
// (fused_cross_block) and lightglue_tpu/ops/ffn.py::_ffn_kernel
// (fused_ffn_residual, out = x + FFN(cat[x, msg])), each in fp32 and, under
// mp, in bf16 (element type E of the templates below): for one block,
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
// 2.42 GFLOP and 2.96 of B6's 4.03. B4 at 2048 rows of D 256 (one image
// of match_pair's default): 1.61 GFLOP against 6.3 MB of x, msg and out
// and 1.6 MB of weights, 24 us on CUDA cores, 9.8 us as 3xTF32; h and its
// partials go through device memory and back (9.4 MB, 2.8 us).
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
//
// The bf16 form (E = bf16, the TPU kernels fed bf16 under mp): activations
// and weights bf16 in memory, every product a wgmma tile product of
// gemm_wgmma.cuh (TMA weights, cp.async activations through the same A
// hooks, a persistent grid) with fp32 sums, biases, LayerNorm and GELU in
// fp32, rounded to bf16 where the TPU kernels round: q, k and v after bias
// and rotary (the rotary tables rounded to bf16 in the epilogue), the
// message after out_proj, the hidden before lin2 (h and its statistics stay
// fp32; lin2 rounds its A fragments as it reads them), the output after the
// residual.
#include "gemm_tc.cuh"
#include "gemm_wgmma.cuh"

namespace {

using lg::gemm::BK;
using lg::gemm::LDS;
using lg::gemm::PART;
using lg::tc::bf16;

using lg::tc::load2;
using lg::tc::store2;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// The epilogues read biases, rotary tables and the residual's x, which a
// launch never writes. The bf16 form (gemm_wgmma.cuh's tiles, T) reads them
// through the read-only path, so that the compiler may issue them ahead of
// the stores before them: a plain load waits for every store that may
// alias it, one round trip to memory a column tile, most of an epilogue's
// time. The fp32 form reads them as before.
template <class T>
__device__ __forceinline__ float ld_ro(const float* p) {
  if constexpr (lg::wgemm::kIsTile<T>)
    return __ldg(p);
  else
    return *p;
}
template <class T, class E>
__device__ __forceinline__ float2 ld_ro2(const E* p) {
  if constexpr (!lg::wgemm::kIsTile<T>) {
    return load2(p);
  } else if constexpr (std::is_same_v<E, float>) {
    return __ldg(reinterpret_cast<const float2*>(p));
  } else {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
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
template <class E>
struct XSrc : lg::gemm::NoTransform {
  using Elem = E;
  Rows rows;
  const E* x0;
  const E* x1;
  int ld;
  using Cursor = const E*;
  __device__ Cursor at(int r) const {
    return (rows.second(r) ? x1 : x0) + (size_t)rows.local(r) * ld;
  }
  __device__ const E* src(Cursor c, int k0) const { return c + k0; }
};

// A = merge_heads(ctx): channel k = h hd + c of row (b, i) at
// ctx_s[((b H + h) n_s + i) hd + c]; a 32-channel step lies in one head
template <class E>
struct CtxSrc : lg::gemm::NoTransform {
  using Elem = E;
  Rows rows;
  const E* c0;
  const E* c1;
  int n0, n1, H, hd;
  struct Cursor {
    const E* p;  // the row's channels of head 0
    int hs;          // n_s hd: from one head to the next
  };
  __device__ Cursor at(int r) const {
    const bool s = rows.second(r);
    const int loc = rows.local(r), n = s ? n1 : n0;
    const int b = loc / n, i = loc - b * n;
    return {(s ? c1 : c0) + ((size_t)b * H * n + i) * hd, n * hd};
  }
  __device__ const E* src(const Cursor& c, int k0) const {
    const int h = k0 / hd;
    return c.p + (size_t)h * c.hs + (k0 - h * hd);
  }
};

// A = [x | msg]: channels below D from the rows of x, the rest from the
// rows of msg, (B, n_s, D) for each segment
template <class E>
struct CatSrc : lg::gemm::NoTransform {
  using Elem = E;
  Rows rows;
  const E* x0;
  const E* x1;
  const E* m0;
  const E* m1;
  int D;
  struct Cursor {
    const E* x;
    const E* m;
  };
  __device__ Cursor at(int r) const {
    const bool s = rows.second(r);
    const size_t off = (size_t)rows.local(r) * D;
    return {(s ? x1 : x0) + off, (s ? m1 : m0) + off};
  }
  __device__ const E* src(const Cursor& c, int k0) const {
    return k0 < D ? c.x + k0 : c.m + (k0 - D);
  }
};

// A = GELU(LN(h)), h (R, C) fp32 in either form: begin merges each row's
// `parts` LayerNorm partials (stats (R, parts, 2): mean and M2 of PART
// columns) in order into the row's mean and 1 / sqrt(var + 1e-5); transform
// applies the LayerNorm and the exact erf GELU to a landed A tile. gamma and
// beta 16-byte aligned.
struct LnSrc {
  using Elem = float;
  static constexpr bool kTransform = true;
  const float* h;
  const float* stats;
  const float* gamma;
  const float* beta;
  int C, parts;
  using Cursor = const float*;
  __device__ Cursor at(int r) const { return h + (size_t)r * C; }
  __device__ const float* src(Cursor c, int k0) const { return c + k0; }

  // Chan's merge of (n, mean, M2) with (PART, mb, m2b), in order, of row
  // `row`'s partials: its mean and 1 / sqrt(var + 1e-5)
  __device__ void row_stats(int row, float& mean, float& rstd) const {
    const float* st = stats + (size_t)row * parts * 2;
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

  template <class T>
  __device__ void begin(float* extra, int m0, int R) const {
    for (int r = threadIdx.x; r < T::BM; r += T::THREADS) {
      float mean = 0.f, rstd = 0.f;
      if (m0 + r < R) row_stats(m0 + r, mean, rstd);
      extra[r] = mean;
      extra[T::BM + r] = rstd;
    }
  }

  // GELU(LN(h)) of channels k, k + 1 of a row (the wgmma product's A from
  // registers), as transform computes it
  __device__ float2 ln_gelu(float2 v, int k, float mean, float rstd) const {
    const float2 ga = *reinterpret_cast<const float2*>(gamma + k);
    const float2 be = *reinterpret_cast<const float2*>(beta + k);
    return make_float2(gelu((v.x - mean) * rstd * ga.x + be.x),
                       gelu((v.y - mean) * rstd * ga.y + be.y));
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
// written as (G, B, H, n_s, hd) for each segment (in E, rounded once after
// rotary; the bf16 form rounds the fp32 tables to bf16 first). Channel ch =
// g D + h hd + c; a thread's column pair (c, c + 1) is one rotary pair.
template <class E>
struct HeadsEpi {
  Rows rows;
  E* out0;
  E* out1;
  const float* bias;
  const float* cs;  // (B, n0, hd / 2) cos and sin, or null
  const float* sn;
  int B, n0, n1, H, hd, n_rot;
  template <class T>
  __device__ void store(const float (&acc)[T::MT][T::NT][4], int wr, int wc,
                        int R) const {
    const Frag f;
    const int D = H * hd;
    // the bf16 form (gemm_wgmma.cuh's tiles): the warp's columns lie in one
    // group (its tile's channels divide D) and hd is 64 or 128, so the
    // group is the warp's and a head and channel take a shift and a mask
    constexpr bool kFast = std::is_same_v<E, bf16>;
    const int grp0 = kFast ? wc / D : 0, hd_shift = __ffs(hd) - 1;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = f.row(wr, mt, half);
        if (r >= R) continue;
        const bool s = rows.second(r);
        const int loc = rows.local(r), n = s ? n1 : n0;
        const int b = loc / n, i = loc - b * n;
        E* ob = s ? out1 : out0;
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const int ch = f.col(wc, nt);
          const int grp = kFast ? grp0 : ch / D;
          const int h = kFast ? (ch - grp0 * D) >> hd_shift : ch % D / hd;
          const int c = kFast ? ch & (hd - 1) : ch % hd;
          float v0 = acc[mt][nt][2 * half] + ld_ro<T>(bias + ch);
          float v1 = acc[mt][nt][2 * half + 1] + ld_ro<T>(bias + ch + 1);
          if (grp < n_rot) {
            // ops/rotary.py::apply_rotary: o[2p] = t[2p] c - t[2p+1] s,
            // o[2p+1] = t[2p+1] c + t[2p] s
            const size_t at = ((size_t)b * n + i) * (hd / 2) + (c >> 1);
            float co = ld_ro<T>(cs + at), si = ld_ro<T>(sn + at);
            if constexpr (std::is_same_v<E, bf16>) {  // the TPU's bf16 tables
              co = lg::tc::round_bf16(co);
              si = lg::tc::round_bf16(si);
            }
            const float o0 = v0 * co - v1 * si, o1 = v1 * co + v0 * si;
            v0 = o0;
            v1 = o1;
          }
          store2(ob + ((((size_t)grp * B + b) * H + h) * n + i) * hd + c, v0,
                 v1);
        }
      }
  }
};

// out (R, C) = acc + bias (msg of out_proj), in E
template <class E>
struct BiasEpi {
  E* out;
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
          store2(out + (size_t)r * C + c,
                 acc[mt][nt][2 * half] + ld_ro<T>(bias + c),
                 acc[mt][nt][2 * half + 1] + ld_ro<T>(bias + c + 1));
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
        if constexpr (lg::wgemm::kIsTile<T>) {
          // the bf16 form: a partial's 16 columns at a time, so that only
          // their values stay live (its read-only bias loads may be issued
          // early; the values of a whole row would spill)
#pragma unroll
          for (int j = 0; j < T::NT / 2; ++j) {
            float v[2][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = f.col(wc, 2 * j + e);
              v[e][0] = acc[mt][2 * j + e][2 * half] + ld_ro<T>(bias + c);
              v[e][1] =
                  acc[mt][2 * j + e][2 * half + 1] + ld_ro<T>(bias + c + 1);
              if (r < R)
                *reinterpret_cast<float2*>(h + (size_t)r * C + c) =
                    make_float2(v[e][0], v[e][1]);
            }
            partial(&v[0][0], r, wc + 16 * j, R, f.t);
          }
        } else {
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
          for (int j = 0; j < T::NT / 2; ++j)
            partial(&v[2 * j][0], r, wc + 16 * j, R, f.t);
        }
      }
  }

  // The partial of row r's 16 columns from c0 (a quad's four pairs v[0..3]
  // of channels c0 + 2t, +1, c0 + 8 + 2t, +1), written by lane t 0.
  __device__ __forceinline__ void partial(const float* v, int r, int c0,
                                          int R, int t) const {
    float s = ((v[0] + v[1]) + v[2]) + v[3];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mean = s * (1.0f / PART);
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = v[e] - mean;
      q += d * d;
    }
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    if (t == 0 && r < R)
      *reinterpret_cast<float2*>(
          stats + ((size_t)r * (C / PART) + c0 / PART) * 2) =
          make_float2(mean, q);
  }
};

// lin2's epilogue: out_s[row] = x_s[row] + (acc + b2), (B, n_s, C) each,
// in E (the sum in fp32, rounded once)
template <class E>
struct ResidualEpi {
  Rows rows;
  const E* x0;
  const E* x1;
  E* out0;
  E* out1;
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
        const E* xr = (s ? x1 : x0) + off;
        E* orow = (s ? out1 : out0) + off;
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const int c = f.col(wc, nt);
          const float2 xv = ld_ro2<T>(xr + c);
          const float b0 = ld_ro<T>(bias + c), b1 = ld_ro<T>(bias + c + 1);
          store2(orow + c, xv.x + (acc[mt][nt][2 * half] + b0),
                 xv.y + (acc[mt][nt][2 * half + 1] + b1));
        }
      }
  }
};

template <class T, class E>
__global__ void __launch_bounds__(T::THREADS)
    project_tc_kernel(XSrc<E> a, const E* __restrict__ w, HeadsEpi<E> e,
                      int K, int R) {
  lg::gemm::product<T>(a, w, K, R, e);
}

template <class T, class E>
__global__ void __launch_bounds__(T::THREADS)
    out_proj_tc_kernel(CtxSrc<E> a, const E* __restrict__ w, BiasEpi<E> e,
                       int K, int R) {
  lg::gemm::product<T>(a, w, K, R, e);
}

template <class T, class E>
__global__ void __launch_bounds__(T::THREADS)
    lin1_tc_kernel(CatSrc<E> a, const E* __restrict__ w, StatsEpi e, int K,
                   int R) {
  lg::gemm::product<T>(a, w, K, R, e);
}

template <class T, class E>
__global__ void __launch_bounds__(T::THREADS)
    lin2_tc_kernel(LnSrc a, const E* __restrict__ w, ResidualEpi<E> e,
                   int K, int R) {
  lg::gemm::product<T>(a, w, K, R, e);
}

// The bf16 form of any of the four: the wgmma product with tile T over the
// weights' map.
template <class T, class ASrc, class Epi>
__global__ void __launch_bounds__(T::THREADS, T::BLOCKS)
    product_wg_kernel(const __grid_constant__ CUtensorMap wmap, ASrc a,
                      Epi e, int K, int R, int C) {
  lg::wgemm::product<T>(&wmap, a, e, K, R, C);
}

// One launch of `kernel` with tile T over R rows and C output channels.
template <class T, class Kernel, class ASrc, class Epi>
cudaError_t launch_tc(Kernel kernel, const ASrc& a, const float* w,
                      const Epi& e, int K, int R, int C,
                      cudaStream_t stream) {
  if (R < 1 || K % BK != 0 || C % T::BN != 0) return cudaErrorInvalidValue;
  constexpr size_t smem = T::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(C / T::BN, cdiv(R, T::BM));
  kernel<<<grid, T::THREADS, smem, stream>>>(a, w, e, K, R);
  return cudaGetLastError();
}

// One launch of the wgmma product with tile T (bf16 weights w (C, K)): a
// persistent grid of `grid` blocks (ops/block_tc.py::bf16_plan: at most
// T::BLOCKS an SM, no more than the tiles).
template <class T, class ASrc, class Epi>
cudaError_t launch_wg(const ASrc& a, const bf16* w, const Epi& e, int K,
                      int R, int C, int grid, cudaStream_t stream) {
  if (R < 1 || K % lg::wgemm::BK != 0 || K < T::KS * lg::wgemm::BK ||
      C % T::BN != 0 || grid < 1)
    return cudaErrorInvalidValue;
  CUtensorMap wmap;
  cudaError_t err = lg::wgemm::weight_map(&wmap, w, C, K, T::BN);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = T::template bytes<typename ASrc::Elem>();
  auto kernel = product_wg_kernel<T, ASrc, Epi>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, T::THREADS, smem, stream>>>(wmap, a, e, K, R, C);
  return cudaGetLastError();
}

// `tile`'s launch of a product in E: gemm_tc.cuh's (fp32, `kernel32`<T>
// for its tile T) or gemm_wgmma.cuh's (bf16, `grid` blocks).
template <class E, class K32, class ASrc, class Epi>
cudaError_t launch_any(int tile, int grid, K32 kernel32, const ASrc& a,
                       const E* w, const Epi& e, int K, int R, int C,
                       cudaStream_t stream) {
  if constexpr (std::is_same_v<E, bf16>) {
    return lg::wgemm::with_tile(tile, [&](auto t) {
      return launch_wg<decltype(t)>(a, w, e, K, R, C, grid, stream);
    });
  } else {
    return lg::gemm::with_tile(tile, [&](auto t) {
      using T = decltype(t);
      return launch_tc<T>(kernel32(t), a, w, e, K, R, C, stream);
    });
  }
}

// The four launches in E (float: 3xTF32; bf16: the mp form), as the C entry
// points below describe them.
template <class E>
cudaError_t project_heads(const E* x0, const E* x1, const E* w,
                          const float* bias, const float* cs, const float* sn,
                          E* out0, E* out1, int B, int n0, int n1, int G,
                          int H, int hd, int n_rot, int tile, int grid,
                          cudaStream_t stream) {
  if ((n_rot > 0 && (cs == nullptr || sn == nullptr || n1 != 0)) ||
      hd % 32 != 0 || n0 < 1 || n1 < 0 ||
      (std::is_same_v<E, bf16> && (hd & (hd - 1)) != 0))
    return cudaErrorInvalidValue;
  const int D = H * hd, R = B * (n0 + n1);
  const Rows rows{B * n0};
  const XSrc<E> a{{}, rows, x0, x1, D};
  const HeadsEpi<E> e{rows, out0, out1, bias, cs, sn, B, n0, n1, H, hd, n_rot};
  return launch_any<E>(
      tile, grid,
      [](auto t) { return project_tc_kernel<decltype(t), float>; }, a, w, e,
      D, R, G * D, stream);
}

template <class E>
cudaError_t tail_out_proj(const E* ctx0, const E* ctx1, const E* woT,
                          const float* bo, E* msg, int B, int n0, int n1,
                          int H, int hd, int tile, int grid,
                          cudaStream_t stream) {
  if (hd % 32 != 0 || n0 < 1 || n1 < 0) return cudaErrorInvalidValue;
  const int D = H * hd, R = B * (n0 + n1);
  const CtxSrc<E> a{{}, Rows{B * n0}, ctx0, ctx1, n0, n1, H, hd};
  const BiasEpi<E> e{msg, bo, D};
  return launch_any<E>(
      tile, grid,
      [](auto t) { return out_proj_tc_kernel<decltype(t), float>; }, a, woT,
      e, D, R, D, stream);
}

template <class E>
cudaError_t tail_lin1(const E* x0, const E* x1, const E* m0, const E* m1,
                      const E* w1T, const float* b1, float* h, float* stats,
                      int B, int n0, int n1, int D, int tile, int grid,
                      cudaStream_t stream) {
  if (D % 32 != 0 || n0 < 1 || n1 < 0) return cudaErrorInvalidValue;
  const int R = B * (n0 + n1);
  const CatSrc<E> a{{}, Rows{B * n0}, x0, x1, m0, m1, D};
  const StatsEpi e{h, stats, b1, 2 * D};
  return launch_any<E>(
      tile, grid, [](auto t) { return lin1_tc_kernel<decltype(t), float>; },
      a, w1T, e, 2 * D, R, 2 * D, stream);
}

template <class E>
cudaError_t tail_lin2(const float* h, const float* stats, const float* gamma,
                      const float* beta, const E* w2T, const float* b2,
                      const E* x0, const E* x1, E* out0, E* out1, int B,
                      int n0, int n1, int D, int tile, int grid,
                      cudaStream_t stream) {
  if (D % 32 != 0 || n0 < 1 || n1 < 0) return cudaErrorInvalidValue;
  const int R = B * (n0 + n1), rows0 = B * n0;
  const LnSrc a{h, stats, gamma, beta, 2 * D, 2 * D / PART};
  const ResidualEpi<E> e{Rows{rows0}, x0, x1, out0, out1, b2, D};
  return launch_any<E>(
      tile, grid, [](auto t) { return lin2_tc_kernel<decltype(t), float>; },
      a, w2T, e, 2 * D, R, D, stream);
}

}  // namespace

// Rows: B n0 of x0 / out0 (B, n0, ...) then B n1 of x1 / out1 (n1 0: no
// second segment, x1 and out1 unused). All pointers 16-byte aligned; D =
// H hd, hd a multiple of 32; `tile` indexes gemm_tc.cuh's tiles. Each entry
// point has a bf16 twin (suffix _bf16, the mp form) that takes the
// activations, weights and outputs named below in bf16; biases, the rotary
// tables, gamma, beta, h and its statistics stay fp32; its `tile` indexes
// gemm_wgmma.cuh's tiles, one more argument after it, `grid`, is the
// persistent grid's blocks (ops/block_tc.py::bf16_plan), and the weights
// are read by TMA (16-byte aligned, cudaErrorInvalidValue otherwise).

// x_s (B, n_s, D); w (G D, D), one row per output channel; bias (G D);
// cos, sin (B, n0, hd / 2) or null; out_s (G, B, H, n_s, hd); the first
// n_rot groups get rotary (one segment only). bf16: x, w, out.
extern "C" cudaError_t lg_project_heads(const float* x0, const float* x1,
                                        const float* w, const float* bias,
                                        const float* cs, const float* sn,
                                        float* out0, float* out1, int B,
                                        int n0, int n1, int G, int H, int hd,
                                        int n_rot, int tile,
                                        cudaStream_t stream) {
  return project_heads<float>(x0, x1, w, bias, cs, sn, out0, out1, B, n0, n1,
                              G, H, hd, n_rot, tile, 0, stream);
}
extern "C" cudaError_t lg_project_heads_bf16(const bf16* x0, const bf16* x1,
                                             const bf16* w, const float* bias,
                                             const float* cs, const float* sn,
                                             bf16* out0, bf16* out1, int B,
                                             int n0, int n1, int G, int H,
                                             int hd, int n_rot, int tile,
                                             int grid, cudaStream_t stream) {
  return project_heads<bf16>(x0, x1, w, bias, cs, sn, out0, out1, B, n0, n1,
                             G, H, hd, n_rot, tile, grid, stream);
}

// msg (R, D) = merge_heads(ctx) Wo + bo: ctx_s (B, H, n_s, hd); woT (D, D)
// with woT[o][k] = Wo[k][o]; bo (D). bf16: ctx, woT, msg.
extern "C" cudaError_t lg_tail_out_proj(const float* ctx0, const float* ctx1,
                                        const float* woT, const float* bo,
                                        float* msg, int B, int n0, int n1,
                                        int H, int hd, int tile,
                                        cudaStream_t stream) {
  return tail_out_proj<float>(ctx0, ctx1, woT, bo, msg, B, n0, n1, H, hd,
                              tile, 0, stream);
}
extern "C" cudaError_t lg_tail_out_proj_bf16(const bf16* ctx0,
                                             const bf16* ctx1,
                                             const bf16* woT, const float* bo,
                                             bf16* msg, int B, int n0, int n1,
                                             int H, int hd, int tile,
                                             int grid, cudaStream_t stream) {
  return tail_out_proj<bf16>(ctx0, ctx1, woT, bo, msg, B, n0, n1, H, hd, tile,
                             grid, stream);
}

// h (R, 2D) = [x | msg] W1 + b1 and its LayerNorm partials stats (R, 2D /
// 16, 2): x_s, m_s (B, n_s, D) (B5's and B6's m_s: rows of out_proj's msg;
// B4's: the message it is given); w1T (2D, 2D) with w1T[o][k] = W1[k][o];
// b1 (2D). bf16: x, m, w1T (h and stats fp32).
extern "C" cudaError_t lg_tail_lin1(const float* x0, const float* x1,
                                    const float* m0, const float* m1,
                                    const float* w1T, const float* b1,
                                    float* h, float* stats, int B, int n0,
                                    int n1, int D, int tile,
                                    cudaStream_t stream) {
  return tail_lin1<float>(x0, x1, m0, m1, w1T, b1, h, stats, B, n0, n1, D,
                          tile, 0, stream);
}
extern "C" cudaError_t lg_tail_lin1_bf16(const bf16* x0, const bf16* x1,
                                         const bf16* m0, const bf16* m1,
                                         const bf16* w1T, const float* b1,
                                         float* h, float* stats, int B,
                                         int n0, int n1, int D, int tile,
                                         int grid, cudaStream_t stream) {
  return tail_lin1<bf16>(x0, x1, m0, m1, w1T, b1, h, stats, B, n0, n1, D,
                         tile, grid, stream);
}

// out_s (B, n_s, D) = x_s + GELU(LN(h)) W2 + b2: h (R, 2D) and stats
// (lg_tail_lin1's); gamma, beta (2D); w2T (D, 2D) with w2T[o][k] =
// W2[k][o]; b2 (D). bf16: w2T, x, out (h and stats fp32).
extern "C" cudaError_t lg_tail_lin2(const float* h, const float* stats,
                                    const float* gamma, const float* beta,
                                    const float* w2T, const float* b2,
                                    const float* x0, const float* x1,
                                    float* out0, float* out1, int B, int n0,
                                    int n1, int D, int tile,
                                    cudaStream_t stream) {
  return tail_lin2<float>(h, stats, gamma, beta, w2T, b2, x0, x1, out0, out1,
                          B, n0, n1, D, tile, 0, stream);
}
extern "C" cudaError_t lg_tail_lin2_bf16(const float* h, const float* stats,
                                         const float* gamma,
                                         const float* beta, const bf16* w2T,
                                         const float* b2, const bf16* x0,
                                         const bf16* x1, bf16* out0,
                                         bf16* out1, int B, int n0, int n1,
                                         int D, int tile, int grid,
                                         cudaStream_t stream) {
  return tail_lin2<bf16>(h, stats, gamma, beta, w2T, b2, x0, x1, out0, out1,
                         B, n0, n1, D, tile, grid, stream);
}
