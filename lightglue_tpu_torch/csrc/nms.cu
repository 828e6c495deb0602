// B9: SuperPoint's and ALIKED's iterative non-maximum suppression, fp32,
// bitwise.
//
// Replaces the TPU kernel lightglue_tpu/ops/nms.py::_nms_kernel
// (simple_nms_pallas). With W(x) the (2r+1) x (2r+1) sliding max, -inf
// outside the map:
//   m  = s == W(s)
//   twice: supp = W(m) > 0; ss = supp ? 0 : s; m |= (ss == W(ss)) & !supp
//   out = m ? s : 0
// Max and compare only, so the result equals the plain PyTorch version
// (F.max_pool2d with its implicit -inf padding) bit for bit.
//
// What bounds it on an H100: not the bytes (6.3 MB each way at 768 x 1024
// B 2, 4 us at 3.35 TB/s) but the work around them: the halo each sliding
// max makes inexact, shared-memory traffic and barriers; it runs at about
// 8x the bytes' time.
//
// Design. The radius is a template parameter (0-8, picked from the runtime
// value), so every window loop unrolls. The masks are bits: one 32-bit word
// for 32 pixels of a row, written by __ballot_sync of a warp's compares.
// The dilation W(m) > 0 of a 0/1 mask is a window OR: the words of 2r + 1
// rows OR'd, then each word with its neighbours' bits shifted in by up to
// r (funnel shifts); bits outside the image are 0, as the plain version's
// -inf padding followed by > 0 gives. So only the three float sliding maxes
// remain, W(s) and W(ss) twice, ss recomputed from s and the suppression
// bits where it is read. Each is a row pass into one float buffer (Tmp),
// each thread sliding over SEG outputs from registers, then a column pass
// whose compares go straight into the mask bits.
//
// The thread layout is fixed at compile time (no division by a runtime
// value in any pass): the row pass gives a warp 8 rows x 4 segments of 8
// columns (lane & 7, lane >> 3); with the float row stride SP = 1 mod 32
// its 32 lanes read 32 distinct banks. The column pass gives a warp one
// bit word (32 columns, a lane each) x SEG rows.
//
// Two plans, one template (scripts/extract_study.py builds and times both):
//  - passes (kFusedPlan false): three launches over the whole batch that
//    keep only bit masks between them (a few hundred KB, in L2): m (halo
//    r), one round (halo 2 r) into a second mask, the last round (halo 2 r)
//    writing the output. On an H100 0.031 ms at r 4 and 0.026 at r 2, B 2;
//  - fused: one launch, each block an output tile with a halo of 5 r (every
//    sliding max or dilation widens the inexact ring by r), all five steps
//    in shared memory, the buffer 128 columns wide (four bit words) and the
//    tile 128 - 10 r of them: 0.049 and 0.026 ms there, and slower at B 16
//    too (the halo recomputes 2.4x the pixels at r 4).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int NT = 256, NWARPS = NT / 32;
constexpr int SEG = 8;  // outputs one thread slides over in a pass

enum Mode { kFused, kFirst, kRound, kLast };

template <int R_, int TH_, int TW_, int MODE_>
struct Geo {
  static constexpr int R = R_, TH = TH_, TW = TW_, MODE = MODE_;
  static constexpr bool FIRST = MODE == kFused || MODE == kFirst;
  static constexpr int ROUNDS = MODE == kFused ? 2 : MODE == kFirst ? 0 : 1;
  static constexpr bool FLOATS_OUT = MODE == kFused || MODE == kLast;
  static constexpr int HALO = (FIRST ? R : 0) + 2 * R * ROUNDS;
  static constexpr int BH = TH + 2 * HALO, BW = TW + 2 * HALO;
  static constexpr int BWW = (BW + 31) / 32;  // bit words a buffer row
  static constexpr int BWP = 32 * BWW;        // columns the passes cover
  static constexpr int SP = BWP + 1;          // float row stride, 1 mod 32
  static constexpr int NYS = (BH + SEG - 1) / SEG;
  static constexpr size_t bytes() {
    return (size_t)2 * BH * SP * sizeof(float) + 2 * BH * BWW * sizeof(uint32_t);
  }
  static_assert(FLOATS_OUT || TW % 32 == 0, "bit tiles are whole words");
  static_assert(SEG + 2 * R <= 32, "a segment's window in one bit word pair");
};

// The plan and the tiles (scripts/extract_study.py): the passes on 32 rows x
// 128 columns; the fused plan on 64 x 128 - 10 r (a 128-column buffer).
constexpr bool kFusedPlan = false;
template <int R> using FusedTile = Geo<R, 64, 128 - 10 * R, kFused>;
template <int R, int MODE> using PassTile = Geo<R, 32, 128, MODE>;

// bits [lo, hi) of a word, lo and hi clamped to 0..32
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 32);
  if (hi <= lo) return 0u;
  const uint32_t upto = hi == 32 ? 0xffffffffu : (1u << hi) - 1u;
  return upto & ~((1u << lo) - 1u);
}

// (2r+1)-wide sliding max of v[0 .. SEG + 2R) into w[0 .. SEG): log-doubling
// spans, then the overlap of two spans (exact: max is order-free)
template <int R>
__device__ __forceinline__ void slide(const float (&v)[SEG + 2 * R], float (&w)[SEG]) {
  constexpr int K = 2 * R + 1, N = SEG + 2 * R;
  float a[N];
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = v[i];
  int span = 1;  // a[i] = max v[i .. i + span)
#pragma unroll
  for (int s = 1; 2 * s <= K; s *= 2) {
#pragma unroll
    for (int i = 0; i + s < N; ++i) a[i] = fmaxf(a[i], a[i + s]);
    span = 2 * s;
  }
#pragma unroll
  for (int i = 0; i < SEG; ++i) w[i] = fmaxf(a[i], a[i + K - span]);
}

template <class G>
struct Block {
  float* S;       // [BH][SP] scores, -inf outside the image and past BW
  float* Tmp;     // [BH][SP] the row pass's maxima
  uint32_t* M;    // [BH][BWW] maxima
  uint32_t* SUP;  // [BH][BWW] suppressed
  int gy0, gx0, H, W;

  // the bits of word k (columns 32 k ..) inside the image and the buffer
  __device__ __forceinline__ uint32_t cols_in(int k) const {
    const int c0 = 32 * k;
    return bit_range(-gx0 - c0, min(W - gx0, G::BW) - c0);
  }
  __device__ __forceinline__ bool row_in(int y) const {
    return (unsigned)(gy0 + y) < (unsigned)H;
  }
  // the bits of (buffer row y, word k) inside the image and the buffer
  __device__ __forceinline__ uint32_t inside(int y, int k) const {
    return row_in(y) ? cols_in(k) : 0u;
  }

  // Tmp = row window max of S, or of ss = SUP ? 0 : S
  template <bool kSupp>
  __device__ __forceinline__ void row_pass() const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ry = lane & 7, rs = lane >> 3;
    for (int it = warp; it < G::NYS * G::BWW; it += NWARPS) {
      const int yg = it / G::BWW, k = it - yg * G::BWW;  // compile-time divisor
      const int y = SEG * yg + ry;
      if (y >= G::BH) continue;
      const int x0 = 32 * k + SEG * rs;  // first output column
      const float* row = S + y * G::SP;
      float v[SEG + 2 * G::R];
      if (x0 >= G::R && x0 + SEG + G::R <= G::BWP) {  // no edge: no checks
#pragma unroll
        for (int j = 0; j < SEG + 2 * G::R; ++j) v[j] = row[x0 - G::R + j];
      } else {
#pragma unroll
        for (int j = 0; j < SEG + 2 * G::R; ++j) {
          const int c = x0 - G::R + j;
          v[j] = (c >= 0 && c < G::BWP) ? row[c] : -INFINITY;
        }
      }
      if constexpr (kSupp) {
        const uint32_t* sr = SUP + y * G::BWW;
        const uint32_t lo = k > 0 ? sr[k - 1] : 0u, mid = sr[k];
        const uint32_t hi = k + 1 < G::BWW ? sr[k + 1] : 0u;
        const int off = SEG * rs - G::R + 32;  // column x0 - R in lo:mid:hi
        const uint32_t b = off < 32 ? __funnelshift_r(lo, mid, off)
                                    : __funnelshift_r(mid, hi, off - 32);
#pragma unroll
        for (int j = 0; j < SEG + 2 * G::R; ++j)
          if ((b >> j) & 1u) v[j] = 0.f;
      }
      float w[SEG];
      slide<G::R>(v, w);
      float* out = Tmp + y * G::SP + x0;
#pragma unroll
      for (int i = 0; i < SEG; ++i) out[i] = w[i];
    }
  }

  // column window max of Tmp, compared with S (first) or with ss (a round):
  // M = the first maxima, or M |= the round's new maxima outside SUP
  template <bool kRoundStep>
  __device__ __forceinline__ void col_pass() const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int it = warp; it < G::NYS * G::BWW; it += NWARPS) {
      const int k = it / G::NYS, ys = SEG * (it - k * G::NYS);
      const int c = 32 * k + lane;
      float v[SEG + 2 * G::R];
      if (ys >= G::R && ys + SEG + G::R <= G::BH) {  // warp-uniform
#pragma unroll
        for (int j = 0; j < SEG + 2 * G::R; ++j) v[j] = Tmp[(ys - G::R + j) * G::SP + c];
      } else {
#pragma unroll
        for (int j = 0; j < SEG + 2 * G::R; ++j) {
          const int y = ys - G::R + j;
          v[j] = (y >= 0 && y < G::BH) ? Tmp[y * G::SP + c] : -INFINITY;
        }
      }
      float w[SEG];
      slide<G::R>(v, w);
      const bool col_in = (cols_in(k) >> lane) & 1u;
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const int y = ys + i;
        if (y >= G::BH) break;  // warp-uniform
        const bool in = col_in && row_in(y);
        const float s = S[y * G::SP + c];
        bool hit;
        if constexpr (kRoundStep) {  // ss = s where not suppressed
          const bool sup = (SUP[y * G::BWW + k] >> lane) & 1u;
          hit = in && !sup && s == w[i];
        } else {
          hit = in && s == w[i];
        }
        const uint32_t word = __ballot_sync(0xffffffffu, hit);
        if (lane == i) {
          if constexpr (kRoundStep) M[y * G::BWW + k] |= word;
          else M[y * G::BWW + k] = word;
        }
      }
    }
  }

  // SUP = (window OR of M) & inside
  __device__ __forceinline__ void dilate() const {
    for (int y = threadIdx.x; y < G::BH; y += NT) {
      uint32_t v[G::BWW];
#pragma unroll
      for (int k = 0; k < G::BWW; ++k) v[k] = 0u;
#pragma unroll
      for (int dy = -G::R; dy <= G::R; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= G::BH) continue;
#pragma unroll
        for (int k = 0; k < G::BWW; ++k) v[k] |= M[yy * G::BWW + k];
      }
#pragma unroll
      for (int k = 0; k < G::BWW; ++k) {
        const uint32_t left = k > 0 ? v[k - 1] : 0u;
        const uint32_t right = k + 1 < G::BWW ? v[k + 1] : 0u;
        uint32_t h = v[k];
#pragma unroll
        for (int d = 1; d <= G::R; ++d)  // bit j gets bits j + d and j - d
          h |= __funnelshift_r(v[k], right, d) | __funnelshift_l(left, v[k], d);
        SUP[y * G::BWW + k] = h & inside(y, k);
      }
    }
  }

  // dilate, then the round's row and column passes
  __device__ __forceinline__ void round() const {
    dilate();
    __syncthreads();
    row_pass<true>();
    __syncthreads();
    col_pass<true>();
    __syncthreads();
  }
};

// 32 bits of a global mask row from column x on (any x; 0 outside the row)
__device__ __forceinline__ uint32_t load_bits(const uint32_t* row, int WW, int x) {
  const int k = x >> 5, s = x & 31;  // floor division, also for x < 0
  const uint32_t lo = (k >= 0 && k < WW) ? row[k] : 0u;
  const uint32_t hi = (k + 1 >= 0 && k + 1 < WW) ? row[k + 1] : 0u;
  return __funnelshift_r(lo, hi, s);
}

// One launch of a plan step on one block: grid (cdiv(W, TW), cdiv(H, TH), B).
// bits_in: the mask from the last step (kRound, kLast); bits_out: kFirst,
// kRound; out: kFused, kLast. Masks are (B, H, cdiv(W, 32)) words.
template <class G>
__global__ void __launch_bounds__(NT)
    nms_kernel(const float* __restrict__ scores, const uint32_t* __restrict__ bits_in,
               uint32_t* __restrict__ bits_out, float* __restrict__ out, int H,
               int W) {
  extern __shared__ __align__(16) float lg_smem[];
  const int b = blockIdx.z, ty0 = blockIdx.y * G::TH, tx0 = blockIdx.x * G::TW;
  Block<G> blk;
  blk.S = lg_smem;
  blk.Tmp = blk.S + G::BH * G::SP;
  blk.M = reinterpret_cast<uint32_t*>(blk.Tmp + G::BH * G::SP);
  blk.SUP = blk.M + G::BH * G::BWW;
  blk.gy0 = ty0 - G::HALO, blk.gx0 = tx0 - G::HALO, blk.H = H, blk.W = W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int WW = (W + 31) >> 5;
  const float* src = scores + (size_t)b * H * W;

  for (int y = warp; y < G::BH; y += NWARPS) {
    const int gy = blk.gy0 + y;
    const bool rin = gy >= 0 && gy < H;
    for (int c = lane; c < G::BWP; c += 32) {
      const int gx = blk.gx0 + c;
      float* dst = blk.S + y * G::SP + c;
      *dst = (rin && c < G::BW && gx >= 0 && gx < W)
                 ? src[(size_t)gy * W + gx] : -INFINITY;
    }
  }
  if constexpr (!G::FIRST) {
    for (int y = threadIdx.x; y < G::BH; y += NT) {
      const int gy = blk.gy0 + y;
      const bool rin = gy >= 0 && gy < H;
      const uint32_t* row = bits_in + ((size_t)b * H + (rin ? gy : 0)) * WW;
#pragma unroll
      for (int k = 0; k < G::BWW; ++k)
        blk.M[y * G::BWW + k] =
            rin ? load_bits(row, WW, blk.gx0 + 32 * k) & blk.inside(y, k) : 0u;
    }
  }
  __syncthreads();
  if constexpr (G::FIRST) {
    blk.template row_pass<false>();
    __syncthreads();
    blk.template col_pass<false>();
    __syncthreads();
  }
#pragma unroll 1
  for (int rd = 0; rd < G::ROUNDS; ++rd) blk.round();

  if constexpr (G::FLOATS_OUT) {
    float* dst = out + (size_t)b * H * W;
    for (int y = warp; y < G::TH; y += NWARPS) {
      const int gy = ty0 + y;
      if (gy >= H) break;
      const int by = G::HALO + y;
      for (int c = lane; c < G::TW; c += 32) {
        const int gx = tx0 + c, bc = G::HALO + c;
        if (gx < W)
          dst[(size_t)gy * W + gx] =
              (blk.M[by * G::BWW + (bc >> 5)] >> (bc & 31)) & 1u
                  ? blk.S[by * G::SP + bc] : 0.f;
      }
    }
  } else {
    constexpr int QW = G::TW / 32;  // words of an output row
    for (int i = threadIdx.x; i < G::TH * QW; i += NT) {
      const int y = i / QW, q = i - y * QW;  // compile-time divisor
      const int gy = ty0 + y, gq = (tx0 >> 5) + q;
      if (gy >= H || gq >= WW) continue;
      const uint32_t* mr = blk.M + (G::HALO + y) * G::BWW;
      const int c = G::HALO + 32 * q, k = c >> 5, s = c & 31;
      const uint32_t hi = k + 1 < G::BWW ? mr[k + 1] : 0u;
      bits_out[((size_t)b * H + gy) * WW + gq] = __funnelshift_r(mr[k], hi, s);
    }
  }
}

template <class G>
cudaError_t launch_step(const float* scores, const uint32_t* bits_in,
                        uint32_t* bits_out, float* out, int B, int H, int W,
                        cudaStream_t stream) {
  auto* kern = nms_kernel<G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::bytes());
  if (err != cudaSuccess) return err;
  const dim3 grid((W + G::TW - 1) / G::TW, (H + G::TH - 1) / G::TH, B);
  kern<<<grid, NT, G::bytes(), stream>>>(scores, bits_in, bits_out, out, H, W);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_r(const float* scores, float* out, uint32_t* bits, int B,
                     int H, int W, cudaStream_t stream) {
  if constexpr (kFusedPlan)
    return launch_step<FusedTile<R>>(scores, nullptr, nullptr, out, B, H, W,
                                     stream);
  // passes: m into bits, round 1 into the second mask, round 2 to out
  uint32_t* m1 = bits + (size_t)B * H * ((W + 31) / 32);
  cudaError_t err = launch_step<PassTile<R, kFirst>>(scores, nullptr, bits,
                                                     nullptr, B, H, W, stream);
  if (err != cudaSuccess) return err;
  err = launch_step<PassTile<R, kRound>>(scores, bits, m1, nullptr, B, H, W,
                                         stream);
  if (err != cudaSuccess) return err;
  return launch_step<PassTile<R, kLast>>(scores, m1, nullptr, out, B, H, W,
                                         stream);
}

template <int... Rs>
cudaError_t dispatch(int r, const float* scores, float* out, uint32_t* bits,
                     int B, int H, int W, cudaStream_t stream,
                     std::integer_sequence<int, Rs...>) {
  cudaError_t err = cudaErrorInvalidValue;
  ((r == Rs ? (err = launch_r<Rs>(scores, out, bits, B, H, W, stream), 0)
            : 0), ...);
  return err;
}

}  // namespace

// scores, out: (B, H, W); bits: 2 B H cdiv(W, 32) words of scratch (the
// passes' two masks); 0 <= r <= 8.
extern "C" cudaError_t lg_simple_nms(const float* scores, float* out,
                                     uint32_t* bits, int B, int H, int W,
                                     int r, cudaStream_t stream) {
  return dispatch(r, scores, out, bits, B, H, W, stream,
                  std::make_integer_sequence<int, 9>{});
}
