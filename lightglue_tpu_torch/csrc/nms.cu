// B9: SuperPoint's iterative non-maximum suppression, fp32, bitwise.
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
// What bounds it on an H100: memory and latency. The plain chain makes ten
// full-map passes through device memory (five pools, each a read and a
// write, plus the masks); the kernel reads the map once and writes it once.
// At 768 x 1024 B 2 that is 6.3 MB each way, ~4 us at 3.35 TB/s, so the
// launch and the tile's halo work set its time.
//
// Design: one block per (image, 32 x 32 output tile). Each of the five
// sliding maxes makes the ring of width r at the tile's edge inexact, so
// the block loads the tile with a halo of 5 r (72 x 72 floats at r = 4)
// into shared memory and evaluates every stage on the whole buffer; the
// central 32 x 32 stay exact. Pixels outside the image read as -inf for
// every max and are never maxima themselves, as with the plain version's
// padding. A sliding max is separable: a row pass into one buffer, then a
// column pass into another. The mask and the suppression flags are bytes;
// the suppressed scores ss are recomputed from s and the flags where they
// are read, so shared memory holds three float buffers and two byte buffers
// (at r = 8, 112 x 112: 176 KB, above 48 KB, so the launcher raises the
// kernel's limit).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int T = 32;  // output tile edge
constexpr int NT = 256;

__device__ __forceinline__ float ss_at(const float* S, const unsigned char* SUP,
                                       int i) {
  // suppressed score: 0 where suppressed, -inf outside the image (S holds
  // -inf there and SUP is 0), else the score
  return SUP[i] ? 0.f : S[i];
}

// Tmp = row max of X over [x - r, x + r] (clipped to the buffer), then
// Out = column max of Tmp. X(i) is given by the functor.
template <class Get>
__device__ __forceinline__ void winmax(Get X, float* Tmp, float* Out, int P,
                                       int r) {
  for (int i = threadIdx.x; i < P * P; i += NT) {
    const int y = i / P, x = i % P;
    const int x0 = max(x - r, 0), x1 = min(x + r, P - 1);
    float m = -INFINITY;
    for (int xx = x0; xx <= x1; ++xx) m = fmaxf(m, X(y * P + xx));
    Tmp[i] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P * P; i += NT) {
    const int y = i / P, x = i % P;
    const int y0 = max(y - r, 0), y1 = min(y + r, P - 1);
    float m = -INFINITY;
    for (int yy = y0; yy <= y1; ++yy) m = fmaxf(m, Tmp[yy * P + x]);
    Out[i] = m;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT)
    simple_nms_kernel(const float* __restrict__ scores, float* __restrict__ out,
                      int H, int W, int r) {
  extern __shared__ __align__(16) unsigned char nms_smem[];
  const int halo = 5 * r, P = T + 2 * halo, PP = P * P;
  float* S = reinterpret_cast<float*>(nms_smem);
  float* Tmp = S + PP;
  float* Wm = Tmp + PP;
  unsigned char* M = reinterpret_cast<unsigned char*>(Wm + PP);
  unsigned char* SUP = M + PP;

  const int b = blockIdx.z;
  const int gy0 = blockIdx.y * T - halo, gx0 = blockIdx.x * T - halo;
  const float* src = scores + (size_t)b * H * W;

  for (int i = threadIdx.x; i < PP; i += NT) {
    const int gy = gy0 + i / P, gx = gx0 + i % P;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    S[i] = in ? src[(size_t)gy * W + gx] : -INFINITY;
    SUP[i] = 0;
  }
  __syncthreads();

  auto inside = [&](int i) {
    const int gy = gy0 + i / P, gx = gx0 + i % P;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };

  winmax([&](int i) { return S[i]; }, Tmp, Wm, P, r);
  for (int i = threadIdx.x; i < PP; i += NT) M[i] = inside(i) && S[i] == Wm[i];
  __syncthreads();

  for (int round = 0; round < 2; ++round) {
    winmax([&](int i) { return M[i] ? 1.f : 0.f; }, Tmp, Wm, P, r);
    for (int i = threadIdx.x; i < PP; i += NT) SUP[i] = inside(i) && Wm[i] > 0.f;
    __syncthreads();
    winmax([&](int i) { return ss_at(S, SUP, i); }, Tmp, Wm, P, r);
    for (int i = threadIdx.x; i < PP; i += NT) {
      const bool nm = inside(i) && ss_at(S, SUP, i) == Wm[i];
      M[i] = M[i] || (nm && !SUP[i]);
    }
    __syncthreads();
  }

  float* dst = out + (size_t)b * H * W;
  for (int i = threadIdx.x; i < T * T; i += NT) {
    const int ly = halo + i / T, lx = halo + i % T;
    const int gy = gy0 + ly, gx = gx0 + lx;
    if (gy < H && gx < W) {
      const int j = ly * P + lx;
      dst[(size_t)gy * W + gx] = M[j] ? S[j] : 0.f;
    }
  }
}

}  // namespace

// scores, out: (B, H, W); 0 <= r <= 8.
extern "C" cudaError_t lg_simple_nms(const float* scores, float* out, int B,
                                     int H, int W, int r,
                                     cudaStream_t stream) {
  const int P = T + 10 * r;
  const size_t smem = (size_t)P * P * (3 * sizeof(float) + 2);
  cudaError_t err = cudaFuncSetAttribute(
      simple_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + T - 1) / T, (H + T - 1) / T, B);
  simple_nms_kernel<<<grid, NT, smem, stream>>>(scores, out, H, W, r);
  return cudaGetLastError();
}
