// Per-tile alpha compositing, forward, written by hand for Hopper (sm_90a).
//
// Replaces: syn3r_tpu/ops/pallas_rasterize.py `_fwd_kernel` (launched by
// `_composite_fwd_impl`). Per tile t and pixel p, over the tile's
// depth-ordered list in chunks of K:
//   power = min(G_j . P_p, 0); alpha = min(O_j e^power, 0.99), 0 below 1/255
//   w = alpha exp(logT + excl);  accum += C_j w;  excl += log1p(-alpha)
// with logT the chunk-start log-transmittance (written to ltc at each
// K-boundary, from where the backward restarts a chunk) and excl the sum of
// log1p(-alpha) of the chunk's earlier entries. Outputs out (T, 6, px): rows
// 0-4 the accumulated [r, g, b, depth, alpha], row 5 the final logT; and
// ltc (T, cap / K, px).
//
// Bound on the H100: at the main path's size (T 96, px 2048, cap 1024,
// K 128) there are 2.0e8 (entry, pixel) pairs; each costs about 15 float32
// operations to reach alpha (two of them exp and a compare) and 15 more
// where alpha passes 1/255 (log1p, exp, five multiply-adds), while the
// inputs and outputs are about 16 MB (5 us at 3.35 TB/s). So operations,
// not bytes, bound it (chip_smoke.py computes the bound from the run's
// data).
//
// Design: pixels are independent. One thread a pixel, one block a slice of
// 256 pixels of one tile (grid: px / 256 x T). The block stages each chunk
// of the tile's G/C/O list (12 x K floats) in shared memory and every
// thread walks it front to back. The transmittance stays in the log domain
// as in JAX (no running product). Entries whose opacity is below 1/255
// (list padding) are skipped for the whole block and pairs whose alpha is
// cut to 0 per thread: both contribute exactly nothing. No early stop at
// low transmittance: JAX composites every entry. expf/log1pf are the
// accurate library functions (no fast-math).

#include "composite_common.cuh"

using namespace syn3r;

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    composite_fwd_kernel(const float* __restrict__ P,
                         const float* __restrict__ G,
                         const float* __restrict__ C,
                         const float* __restrict__ O, float* __restrict__ out,
                         float* __restrict__ ltc, int px, int cap, int K) {
  extern __shared__ float sh[];  // 12 x K: G rows 0-5, C rows 6-10, O row 11
  const int t = blockIdx.y;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const bool live = p < px;
  float pf[6];
#pragma unroll
  for (int f = 0; f < 6; ++f) pf[f] = live ? P[(size_t)f * px + p] : 0.0f;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float logT = 0.0f;
  const int n_chunks = cap / K;

  for (int c = 0; c < n_chunks; ++c) {
    stage_chunk(sh, G, C, O, t, cap, c * K, K);
    if (!live) continue;
    ltc[((size_t)t * n_chunks + c) * px + p] = logT;
    float excl = 0.0f;
    for (int j = 0; j < K; ++j) {
      const float o = sh[11 * K + j];
      if (o < kAlphaMin) continue;  // alpha <= o: cut to 0, block-uniform
      const float praw = gaussian_power(sh, K, j, pf);
      const float power = praw > 0.0f ? 0.0f : praw;
      float alpha = o * expf(power);
      alpha = alpha > kAlphaMax ? kAlphaMax : alpha;
      if (alpha < kAlphaMin) continue;
      const float w = alpha * expf(logT + excl);
#pragma unroll
      for (int r = 0; r < 5; ++r) acc[r] = fmaf(sh[(6 + r) * K + j], w, acc[r]);
      excl += log1pf(-alpha);
    }
    logT += excl;
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < 5; ++r) out[((size_t)t * 6 + r) * px + p] = acc[r];
    out[((size_t)t * 6 + 5) * px + p] = logT;
  }
}

}  // namespace

extern "C" int syn3r_composite_fwd(const void* P, const void* G, const void* C,
                                   const void* O, void* out, void* ltc, int T,
                                   int px, int cap, int K, void* stream) {
  if (T <= 0 || T > 65535 || px <= 0 || cap <= 0 || K <= 0 || K > 1024 ||
      cap % K != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)12 * K * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      composite_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((px + THREADS - 1) / THREADS, T);
  composite_fwd_kernel<<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(P), static_cast<const float*>(G),
      static_cast<const float*>(C), static_cast<const float*>(O),
      static_cast<float*>(out), static_cast<float*>(ltc), px, cap, K);
  return (int)cudaGetLastError();
}
