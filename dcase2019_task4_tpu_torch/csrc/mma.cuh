// bfloat16 products on the tensor cores (mma.sync m16n8k16, bf16 x bf16 ->
// f32, HMMA), shared by the kernels that multiply bfloat16 operands staged in
// shared memory: K3's bfloat16 conv and weight gradient (packed_conv.cu) and
// K2's bfloat16 forward and reduce pass (fused_block.cu).
//
// Operand layouts (ldmatrix m8n8, four matrices, lane l giving the row
// address of matrix l / 8):
//   A [m][k] row-major:       ldmatrix_x4, lane -> row l % 16, column 8 (l / 16)
//   A [k][m] (A transposed):  ldmatrix_x4_trans, lane -> k row l % 8 + 8 (l / 16),
//                             m column 8 ((l / 8) % 2)
//   B [k][n] row-major:       ldmatrix_x4_trans, lane -> k row l % 8 + 8 ((l / 8) % 2),
//                             n column 8 (l / 16); r[0], r[1] feed n-fragment 0,
//                             r[2], r[3] n-fragment 1
//   B [n][k] (B transposed):  ldmatrix_x4, lane -> n row l % 8 + 8 (l / 16),
//                             k column 8 ((l / 8) % 2); the same fragments
// Shared rows of an odd number of 16-byte units keep every ldmatrix
// conflict-free.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) . b (16 x 8, col), bfloat16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
