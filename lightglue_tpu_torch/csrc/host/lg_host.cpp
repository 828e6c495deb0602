// Host-side postprocessing runtime of lightglue_tpu_torch (the same
// functions as the JAX package's native/lg_host.cpp).
//
// The matcher emits static-shape outputs (matches0 (B, M) with -1 for
// unmatched, scores, validity masks). Turning them into the ragged forms
// users consume (per-pair (K, 2) match lists, padded batches) is
// pointer-chasing work that the Python interpreter does slowly at serving
// rates. lightglue_tpu_torch/native.py builds this file at first use
// (g++ -O3 -fPIC -shared) and binds these C functions with ctypes, each
// beside its numpy form.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>

extern "C" {

// Compact one batch of matches: for each b, write pairs (i, matches0[b,i])
// for every i with matches0[b,i] >= 0 into out_pairs, their scores into
// out_scores, and per-batch counts into out_counts. Returns total pairs.
// out_pairs must hold 2*B*M int32; out_scores B*M floats; out_counts B.
int64_t compact_matches(
    const int32_t* matches0,     // (B, M)
    const float* mscores0,       // (B, M)
    int64_t B, int64_t M,
    int32_t* out_pairs,          // (B*M, 2) worst case
    float* out_scores,           // (B*M)
    int64_t* out_counts          // (B)
) {
    int64_t total = 0;
    for (int64_t b = 0; b < B; ++b) {
        const int32_t* m0 = matches0 + b * M;
        const float* s0 = mscores0 + b * M;
        int64_t count = 0;
        for (int64_t i = 0; i < M; ++i) {
            int32_t j = m0[i];
            if (j >= 0) {
                out_pairs[2 * total] = static_cast<int32_t>(i);
                out_pairs[2 * total + 1] = j;
                out_scores[total] = s0[i];
                ++total;
                ++count;
            }
        }
        out_counts[b] = count;
    }
    return total;
}

// Pack B ragged float feature arrays (concatenated rows, row-major, each
// n_i x D) into one padded (B, K, D) buffer with pad_value, and write the
// validity mask. offsets has B+1 entries into `rows`.
void pack_ragged(
    const float* rows,           // (sum n_i, D)
    const int64_t* offsets,      // (B+1)
    int64_t B, int64_t K, int64_t D,
    float pad_value,
    float* out,                  // (B, K, D)
    uint8_t* out_valid           // (B, K)
) {
    for (int64_t b = 0; b < B; ++b) {
        int64_t n = offsets[b + 1] - offsets[b];
        int64_t n_copy = std::min(n, K);
        const float* src = rows + offsets[b] * D;
        float* dst = out + b * K * D;
        std::memcpy(dst, src, sizeof(float) * n_copy * D);
        for (int64_t i = n_copy * D; i < K * D; ++i) dst[i] = pad_value;
        uint8_t* v = out_valid + b * K;
        for (int64_t i = 0; i < K; ++i) v[i] = i < n_copy ? 1 : 0;
    }
}

// Mutual-nearest-neighbor filtering on the host (small-N fallback / CPU
// serving path): given a (M, N) score matrix, emit matches0 like the device
// filter_matches (reference lightglue.py:302-318).
void filter_matches_host(
    const float* scores,         // (M, N) log-assignment inner block
    int64_t M, int64_t N,
    float threshold,
    int32_t* matches0,           // (M)
    float* mscores0              // (M)
) {
    // argmax over rows and columns
    for (int64_t i = 0; i < M; ++i) {
        const float* row = scores + i * N;
        int64_t best = 0;
        for (int64_t j = 1; j < N; ++j) if (row[j] > row[best]) best = j;
        // mutual check: is i the argmax of column `best`?
        float colmax = scores[best];
        int64_t colarg = 0;
        for (int64_t k = 1; k < M; ++k) {
            float v = scores[k * N + best];
            if (v > colmax) { colmax = v; colarg = k; }
        }
        float sc = std::exp(row[best]);
        bool mutual = (colarg == i);
        // reference semantics (lightglue.py:312-316): mutual pairs keep
        // their score even below threshold; only matches are gated.
        matches0[i] = (mutual && sc > threshold) ? static_cast<int32_t>(best) : -1;
        mscores0[i] = mutual ? sc : 0.0f;
    }
}

}  // extern "C"
