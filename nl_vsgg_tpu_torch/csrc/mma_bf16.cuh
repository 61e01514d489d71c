// Warp-level bf16 tensor-core helpers for sm_80 and later (mma.sync
// m16n8k16 with fp32 accumulators, fed from shared memory by ldmatrix),
// shared by csrc/probe_matmul.cu and csrc/grouped_conv_ablate.cu.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), for
// lane l of the warp:
//   A (16 x 16, row-major): rows l/4 and l/4 + 8, columns 2(l%4) + {0, 1}
//     and + 8; ldmatrix.x4 with lane l pointing at row l%16, column
//     8(l/16) gives exactly the four A registers.
//   B (16 x 8, k x n): k = 2(l%4) + {0, 1} and + 8, n = l/4. B is stored
//     K x N row-major in shared memory (an HWIO weight: input channels by
//     output channels), so ldmatrix.x4.trans with lane l pointing at row
//     k = l%8 + 8((l/8)%2), column 8(l/16) gives the B registers of two
//     neighbouring 8-column tiles.
//   C (16 x 8): rows l/4 (c0, c1) and l/4 + 8 (c2, c3), columns
//     2(l%4) + {0, 1}.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16 x 16) @ b (16 x 8), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-slice of 16 for a 32 x 64 warp tile: acc[mi][ni] (m-tile mi of 16
// rows, n-tile ni of 8 columns) += A[32 x 16] @ B[16 x 64].
//   a0, a1: this lane's ldmatrix address for the two m-tiles (row l%16 of
//           the m-tile, column 8(l/16) of the k-slice);
//   b:      this lane's ldmatrix.trans address (row l%8 + 8((l/8)%2) of the
//           k-slice, column 8(l/16) of the warp's 64), the next 16 columns
//           16 elements further.
__device__ __forceinline__ void warp_mma_32x64(float (&acc)[2][8][4], const __nv_bfloat16* a0,
                                               const __nv_bfloat16* a1,
                                               const __nv_bfloat16* b) {
  uint32_t a[2][4];
  ldmatrix_x4(a[0], a0);
  ldmatrix_x4(a[1], a1);
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, b + np * 16);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma_bf16_16816(acc[mi][2 * np], a[mi], bf[0], bf[1]);
      mma_bf16_16816(acc[mi][2 * np + 1], a[mi], bf[2], bf[3]);
    }
  }
}
