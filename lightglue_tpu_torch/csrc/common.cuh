// Shared pieces of the SIMT matcher kernels (K3's FFN, ffn.cuh): the block
// size and a ceiling division.
//
// Shared memory is always the one dynamic buffer `lg_smem`, carved by each
// kernel; above 48 KB the launcher raises the kernel's limit first.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lg {

constexpr int THREADS = 256;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace lg
