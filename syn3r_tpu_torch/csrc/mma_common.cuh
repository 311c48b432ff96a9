// Warp-level tensor-core helpers shared by the hand-written Hopper kernels.
//
// bf16 mma.sync m16n8k16 with f32 accumulation, ldmatrix fragment loads and
// cp.async global->shared copies (zero-filled when the source row is out of
// range). Fragment layouts (PTX ISA, "mma.m16n8k16"), with g = lane / 4 and
// q = lane % 4:
//   A (16x16, row-major): a0 (g, 2q..2q+1), a1 (g+8, 2q..), a2 (g, 2q+8..),
//                         a3 (g+8, 2q+8..)
//   B (16x8, "col"):      b0 (k 2q..2q+1, n g), b1 (k 2q+8.., n g)
//   C (16x8):             c0,c1 (g, 2q..2q+1), c2,c3 (g+8, 2q..2q+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace syn3r {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(smem)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(smem)));
}

// d += a * b for one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 and packed as one 32-bit A/B operand word.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Round an f32 value to bf16 and back: the cast a bf16 tensor op applies.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace syn3r
