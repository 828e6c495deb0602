// The 3xTF32 tensor-core primitives that the attention walk (attn_tc.cuh)
// and the tile product (gemm_tc.cuh) share: the operand split, one
// m16n8k8 tf32 mma.sync, the three-product sum, and 16-byte cp.async.
//
// 3xTF32: each fp32 operand x is split into big = tf32(x) and small =
// tf32(x - big) (split_tf32), and a product sums small*big + big*small +
// big*big in fp32; the small*small term (2^-21 of the product at most) is
// dropped. That keeps a product within about 1e-6 relative of fp32, where
// one tf32 pass (10-bit mantissa) is about 5e-4 off.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lg {
namespace tc {

// x = big + small as two tf32 operands (a tensor core reads the top 19
// bits of each): big = x with its low 13 bits cleared, small = x - big
// (exact in fp32) plus half a tf32 unit, so that the hardware's truncation
// rounds it to nearest. Three integer or fp32 operations and no cvt: the
// split of CUTLASS's OpMultiplyAddFastF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// c += a b for one m16n8k8 tile (a: 4 tf32, b: 2 tf32, c: 4 fp32)
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32 from split operands
__device__ __forceinline__ void mma3(float c[4], const uint32_t ab[4],
                                     const uint32_t as[4], const uint32_t bb[2],
                                     const uint32_t bs[2]) {
  mma(c, as, bb);
  mma(c, ab, bs);
  mma(c, ab, bb);
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tc
}  // namespace lg
