// Warp-level TF32 tensor-core helpers for sm_80 and later (mma.sync
// m16n8k8, fp32 accumulators) and the 3xTF32 split that keeps float32
// accuracy on them, shared by csrc/masked_attention.cu and
// csrc/grouped_conv.cu.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8", .tf32),
// for lane l of the warp, g = l / 4, t = l % 4:
//   A (16 x 8, row-major): a0 (row g, column t), a1 (g + 8, t),
//     a2 (g, t + 4), a3 (g + 8, t + 4).
//   B (8 x 8, k x n): b0 (k t, n g), b1 (k t + 4, n g).
//   C (16 x 8): rows g (c0, c1) and g + 8 (c2, c3), columns 2 t + {0, 1}.
// The k order inside a step is free as long as A and B agree on it: a
// caller may give column t and t + 4 any two k of the step.
//
// 3xTF32: each float32 operand x is split as hi = x rounded to TF32 and
// lo = x - hi; A B is formed as A_lo B_hi + A_hi B_lo + A_hi B_hi in fp32
// sums. A_lo B_lo (at most 2^-22 of the product) is left out, and lo is
// itself read to 19 bits, so a product keeps about 20 bits (float32 has
// 24), where one TF32 product alone keeps about 11 (3 digits).

#pragma once

#include <cstdint>

// x as a TF32 part (round to nearest) and the rest (the mma reads its top
// 19 bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8, fp32) += a (16 x 8, tf32) @ b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B from split parts, A's (ah, al) and B's (bh0, bh1), (bl0, bl1):
// A_lo B_hi + A_hi B_lo + A_hi B_hi
__device__ __forceinline__ void mma_3xtf32_parts(float (&d)[4], const uint32_t (&ah)[4],
                                                 const uint32_t (&al)[4], uint32_t bh0,
                                                 uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// d += A B in about fp32 accuracy, A split, B's two values split here
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_3xtf32_parts(d, ah, al, bh0, bh1, bl0, bl1);
}
