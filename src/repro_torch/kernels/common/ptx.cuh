// Inline-PTX helpers shared by the port's kernels (tiled_mm.cu,
// flash_attention.cu, qmm.cu and, for cp.async, ffma_gemm.cuh): cp.async
// staging, ldmatrix fragment loads, the mma.sync m16n8k16 bf16 product with
// an fp32 accumulator and the m16n8k32 int8 product with an int32
// accumulator, for sm_90a (all of them exist since sm_80).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4), each
// 32-bit register holding two bf16 with the lower column in the low half:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, "col"):      b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C/D (16 x 8, fp32):     c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
//
// mma.m16n8k32 with s8 operands has the same layout in 32-bit words, each
// word holding four int8 of neighbouring k (the lowest k in the low byte):
//   A (16 x 32, row-major): a0 (g, 4t..4t+3), a1 (g+8, 4t..), a2 (g, 4t+16..),
//                           a3 (g+8, 4t+16..)
//   B (32 x 8, "col"):      b0 (k 4t..4t+3, n g), b1 (k 4t+16..4t+19, n g)
//   C/D (16 x 8, int32):    as the fp32 C/D above
// So both operands must be k-major in shared memory: ldmatrix (which moves
// 16-bit elements and cannot transpose bytes) then gives the fragments.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace synergy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes < 16 fills the rest with zeros (0:
// nothing is read, but src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// the same, and the L2 fetches the source's whole 128-byte line from device
// memory: for a row read 64 bytes per k step, the next step hits in L2
__device__ __forceinline__ void cp_async16_line(void* dst, const void* src,
                                                int src_bytes) {
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(src_bytes)
      : "memory");
}

// 4 bytes global -> shared, zero-filled when src_bytes == 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives (row l / 4, cols 2 (l % 4), +1) of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, transposed: lane l receives (rows 2 (l % 4), +1; col l / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += A (16 x 16 bf16) * B (16 x 8 bf16), fp32 accumulator
__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A (16 x 32 int8) * B (32 x 8 int8), exact int32 accumulator (IMMA)
__device__ __forceinline__ void mma_s8_16832(int d[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 values read from memory as one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace synergy
