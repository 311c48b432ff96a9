// Shared pieces of the normalization kernels (group_norm.cu, layer_norm.cu):
// 16-byte vector loads and stores of float32 (4 values) or bf16 (8 values),
// widened to float32 in registers, and the widening of 16 bytes held as
// loaded (Raw).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace syn3r {

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// A bf16 pair's low and high halves as float (exact). The asm is
// volatile so that the compiler keeps each widening where it is used: in
// layer_norm.cu it would otherwise hoist the parameters' widening out of
// the row loop (80 float registers instead of 40 packed ones) or keep a
// widened row alive from the statistics to the output pass, and spill.
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  uint32_t r;
  asm volatile("shl.b32 %0, %1, 16;" : "=r"(r) : "r"(u));
  return __uint_as_float(r);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  uint32_t r;
  asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(r) : "r"(u));
  return __uint_as_float(r);
}

// 16 bytes as loaded, widened to float.
template <typename T>
struct Raw;

template <>
struct Raw<float> {
  __device__ __forceinline__ static void widen(const uint4& q, float (&v)[4]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
};

template <>
struct Raw<__nv_bfloat16> {
  __device__ __forceinline__ static void widen(const uint4& q, float (&v)[8]) {
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf16_lo(u[i]);
      v[2 * i + 1] = bf16_hi(u[i]);
    }
  }
};

}  // namespace syn3r
