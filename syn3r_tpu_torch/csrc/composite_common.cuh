// Shared pieces of the tile-composite kernels (composite_fwd.cu,
// composite_bwd.cu).
//
// Layouts are those of syn3r_tpu/ops/pallas_rasterize.py, float32,
// Gaussian-minor: P (6, px) tile-local pixel features [x^2, xy, y^2, x, y, 1];
// G (T, 6, cap) packed quadratic Gaussian features; C (T, 5, cap)
// [r, g, b, depth, 1]; O (T, 1, cap) opacities; per tile the entries are in
// depth order and cap is a multiple of the chunk K.
#pragma once

#include <cuda_runtime.h>

namespace syn3r {

constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;

// Stage entries j0 .. j0+K-1 of tile t into shared memory as 12 rows of K:
// rows 0-5 G, rows 6-10 C, row 11 O. Consecutive threads read consecutive
// entries of one row (coalesced); every thread of a pixel block later reads
// the same address (a broadcast, no bank conflict). Synchronizes before
// (the previous chunk's readers) and after.
__device__ __forceinline__ void stage_chunk(float* sh, const float* G,
                                            const float* C, const float* O,
                                            int t, int cap, int j0, int K) {
  __syncthreads();
  for (int i = threadIdx.x; i < 12 * K; i += blockDim.x) {
    const int f = i / K;
    const int j = i - f * K;
    const float* row =
        f < 6 ? G + ((size_t)t * 6 + f) * cap
              : (f < 11 ? C + ((size_t)t * 5 + (f - 6)) * cap
                        : O + (size_t)t * cap);
    sh[i] = row[j0 + j];
  }
  __syncthreads();
}

// G_j . P_p, in the TPU kernel's term order.
__device__ __forceinline__ float gaussian_power(const float* sh, int K, int j,
                                                const float (&pf)[6]) {
  float acc = sh[j] * pf[0];
#pragma unroll
  for (int f = 1; f < 6; ++f) acc = fmaf(sh[f * K + j], pf[f], acc);
  return acc;
}

}  // namespace syn3r
