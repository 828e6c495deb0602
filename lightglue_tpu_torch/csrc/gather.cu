// S1: row gather, out[i, :] = tbl[idx[i], :].
//
// Replaces the two TPU kernels of scripts/micro_gather2.py (a study of
// gathers at the shapes of a (12288, 256) bf16 table and 110592 int32
// indices): the row loop with the table resident in VMEM
// (pallas_gather_kernel, :64-82) and the one-hot matrix product
// (pallas_onehot_kernel, :94-115). The one-hot product is a TPU trick that
// turns a gather into MXU work; on this card the row copy is the direct
// form of the same function.
//
// What bounds it on an H100: bytes. At the study's shapes it moves 56.6 MB
// of output, reads the 6.3 MB table and 0.44 MB of indices, about 19 us at
// 3.35 TB/s, and computes nothing. The table stays in the 50 MB L2, so the
// writes set the pace.
//
// Design: one warp per output row, each lane moving 16-byte words (a
// 256-wide bf16 row is 512 B, one uint4 a lane), the index read once a warp
// and the row's words read and written as whole 512 B runs. A row whose
// bytes are not a multiple of 16 (or a table not 16-byte aligned) moves as
// 4- or 2-byte words; the host picks the widest that fits. Indices are not
// checked here, as the TPU kernel checks none: the wrapper checks them on
// the host once per call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename W>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const W* __restrict__ tbl, const int* __restrict__ idx,
                       W* __restrict__ out, int n, int words) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const W* src = tbl + (size_t)idx[row] * words;
  W* dst = out + (size_t)row * words;
  for (int c = lane; c < words; c += 32) dst[c] = src[c];
}

template <typename W>
cudaError_t launch(const void* tbl, const int* idx, void* out, int n,
                   int words, cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  gather_rows_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const W*>(tbl), idx, static_cast<W*>(out), n, words);
  return cudaGetLastError();
}

}  // namespace

// tbl: rows of row_bytes bytes; idx: n int32 row indices, each in range;
// out: n rows. word_bytes (16, 4 or 2) divides row_bytes and the alignment
// of tbl and out.
extern "C" cudaError_t lg_gather_rows(const void* tbl, const int* idx,
                                      void* out, int n, int row_bytes,
                                      int word_bytes, cudaStream_t stream) {
  if (n < 1) return cudaSuccess;
  if (word_bytes <= 0 || row_bytes % word_bytes != 0)
    return cudaErrorInvalidValue;
  const int words = row_bytes / word_bytes;
  switch (word_bytes) {
    case 16: return launch<uint4>(tbl, idx, out, n, words, stream);
    case 4: return launch<uint32_t>(tbl, idx, out, n, words, stream);
    case 2: return launch<uint16_t>(tbl, idx, out, n, words, stream);
    default: return cudaErrorInvalidValue;
  }
}
