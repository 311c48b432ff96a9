// Row LayerNorm over (R, C), written by hand for Hopper (sm_90a).
//
// Replaces: syn3r_tpu/ops/pallas_norm.py `_ln_kernel` (launched by
// `layer_norm_pallas`): per row, float32 mean and var = E[x^2] - mean^2
// (not Welford, as the reference), y = (x - mean) rstd w + b, rounded to
// x's type.
//
// Bound on the H100: about ten operations per element against 2 (bf16)
// bytes read and 2 written, so device memory bounds it: the main path's
// largest call (3 x 25 x 9216 rows x 320 bf16) moves 885 MB, 0.26 ms at
// 3.35 TB/s.
//
// Design: one warp a row, eight rows a 256-thread block. A lane loads its
// 16-byte vectors of the row (8 bf16 or 4 float32 values; C is 320 to 1280
// in the UNet and 1280 in CLIP, at most 5 vectors a lane) into registers,
// the warp sums x and x^2 with butterfly shuffles, and the lane writes its
// normalized values from the same registers: x is read once and y written
// once.

#include "norm_common.cuh"

using namespace syn3r;
using bf16 = __nv_bfloat16;

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
    layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ y,
                      long long R, int C, float eps) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp leaves together
  const int ncv = C / V;
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float v[NV][V];
  float s = 0.0f, q = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int cv = lane + 32 * j;
    if (cv < ncv) {
      Vec<T>::load(xr + cv * V, v[j]);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s += v[j][i];
        q = fmaf(v[j][i], v[j][i], q);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(FULL, s, off);
    q += __shfl_xor_sync(FULL, q, off);
  }
  const float cf = (float)C;
  const float mean = s / cf;
  const float var = q / cf - mean * mean;
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int cv = lane + 32 * j;
    if (cv < ncv) {
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = cv * V + i;
        o[i] = (v[j][i] - mean) * rstd * __ldg(w + c) + __ldg(bias + c);
      }
      Vec<T>::store(yr + cv * V, o);
    }
  }
}

template <typename T>
int layer_norm(const void* x, const void* w, const void* b, void* y,
               long long R, int C, float eps, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (C % V != 0) return (int)cudaErrorInvalidValue;
  // vectors a lane, rounded up to a compiled case (C <= 4096 bf16 or
  // 2048 float32)
  int nv = (C / V + 31) / 32;
  if (nv > 8 && nv <= 16) nv = 16;
  const long long blocks = (R + ROWS - 1) / ROWS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  const dim3 grid((unsigned)blocks);
#define SYN3R_LN_CASE(N)                                         \
  case N:                                                        \
    layer_norm_kernel<T, N><<<grid, THREADS, 0, stream>>>(       \
        xt, wt, bt, yt, R, C, eps);                              \
    break;
  switch (nv) {
    SYN3R_LN_CASE(1)
    SYN3R_LN_CASE(2)
    SYN3R_LN_CASE(3)
    SYN3R_LN_CASE(4)
    SYN3R_LN_CASE(5)
    SYN3R_LN_CASE(6)
    SYN3R_LN_CASE(7)
    SYN3R_LN_CASE(8)
    SYN3R_LN_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SYN3R_LN_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// LayerNorm of each row of x (R, C); weight and bias float32 (C,).
extern "C" int syn3r_layer_norm(const void* x, const void* w, const void* b,
                                void* y, long long R, int C, float eps,
                                int is_bf16, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? layer_norm<bf16>(x, w, b, y, R, C, eps, s)
                 : layer_norm<float>(x, w, b, y, R, C, eps, s);
}
