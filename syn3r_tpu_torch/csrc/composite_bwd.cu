// Per-tile alpha compositing, backward, written by hand for Hopper (sm_90a).
//
// Replaces: syn3r_tpu/ops/pallas_rasterize.py `_bwd_kernel` (launched by
// `_composite_bwd_impl` from the custom VJP of `composite_tiles`). From the
// output cotangent dout (T, 6, px) (rows 0-4 d accum = gacc, row 5 d logT)
// and the chunk-start logT ltc (T, cap / K, px) it walks the chunks in
// reverse and, per chunk and pixel, follows the TPU kernel line by line:
//   T_in = exp(logT0 + excl_j), w_j = alpha_j T_in, gC_j = C_j . gacc
//   tot = sum_j w_j gC_j;  suffix_j = tot - cumsum_j(w gC) + s
//   dalpha_j = T_in gC_j - suffix_j / (1 - alpha_j), 0 where alpha was cut
//              below 1/255 or clamped at 0.99
//   dpower_j = 0 where G_j . P > 0, else dalpha_j alpha_raw_j
//   dG_j += P dpower_j;  dC_j += gacc w_j;  dO_j += dalpha_j e^power
// and carries s += tot to the previous chunk (s starts at d logT). dP is 0.
//
// Bound on the H100: the same 2.0e8 (entry, pixel) pairs as the forward at
// the main path's size, each about 15 operations to reach alpha and about 45
// more where alpha passes 1/255 (the transmittance, suffix, dalpha and the
// twelve products summed over pixels); under 20 MB of traffic. Operations
// bound it (chip_smoke.py computes the bound from the run's data).
//
// Design: one thread a pixel, one block 256 pixels of one tile, chunks
// staged in shared memory as in the forward. Per chunk two forward passes
// over its entries: the first sums tot, the second forms each entry's
// suffix from tot and the running inclusive sum, exactly as JAX does (no
// reverse subtraction of log1p terms). Each entry's twelve gradient terms
// (dG 6, dC 5, dO 1) are sums over the tile's pixels: a warp folds its 32
// lanes' 16-slot vectors with a reduce-scatter (16 shuffles instead of
// 12 x 5), a warp whose lanes all contribute nothing skips it, and every 32
// entries the block sums its 8 warps through shared memory and writes one
// partial per (block, term, entry) to scratch. A second kernel sums the
// px / 256 partials of each (tile, term, entry) in a fixed order. No
// atomics: the result is deterministic.

#include "composite_common.cuh"

using namespace syn3r;

namespace {

constexpr int THREADS = 256;  // = BWD_BLOCK_PIXELS in ops/composite.py
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 32;       // entries between block reductions
constexpr unsigned FULL = 0xffffffffu;

// One halving step of the warp reduce-scatter: lanes with bit OFF set keep
// the upper N slots, the others the lower N, each adding its partner's.
template <int N, int OFF>
__device__ __forceinline__ void fold(float (&v)[16], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float keep = upper ? v[i + N] : v[i];
    const float send = upper ? v[i] : v[i + N];
    v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// After it, lane l holds the warp sum of slot (l >> 1) & 15.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[16],
                                                     int lane) {
  fold<8, 16>(v, lane);
  fold<4, 8>(v, lane);
  fold<2, 4>(v, lane);
  fold<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

__global__ void __launch_bounds__(THREADS)
    composite_bwd_kernel(const float* __restrict__ P,
                         const float* __restrict__ G,
                         const float* __restrict__ C,
                         const float* __restrict__ O,
                         const float* __restrict__ ltc,
                         const float* __restrict__ dout,
                         float* __restrict__ part, int px, int cap, int K) {
  extern __shared__ float sh[];            // 12 x K staged chunk
  __shared__ float wp[SUB][WARPS][16];     // warp partials of SUB entries
  const int t = blockIdx.y;
  const int blk = blockIdx.x;
  const int n_blk = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blk * THREADS + threadIdx.x;
  const bool live = p < px;

  float pf[6], gacc[5];
#pragma unroll
  for (int f = 0; f < 6; ++f) pf[f] = live ? P[(size_t)f * px + p] : 0.0f;
#pragma unroll
  for (int r = 0; r < 5; ++r)
    gacc[r] = live ? dout[((size_t)t * 6 + r) * px + p] : 0.0f;
  float s = live ? dout[((size_t)t * 6 + 5) * px + p] : 0.0f;
  const int n_chunks = cap / K;

  for (int c = n_chunks - 1; c >= 0; --c) {
    stage_chunk(sh, G, C, O, t, cap, c * K, K);
    const float logT0 = live ? ltc[((size_t)t * n_chunks + c) * px + p] : 0.0f;

    // pass 1: tot = sum_j w_j gC_j over the chunk
    float tot = 0.0f;
    if (live) {
      float excl = 0.0f;
      for (int j = 0; j < K; ++j) {
        const float o = sh[11 * K + j];
        if (o < kAlphaMin) continue;
        const float praw = gaussian_power(sh, K, j, pf);
        const float power = praw > 0.0f ? 0.0f : praw;
        float alpha = o * expf(power);
        alpha = alpha > kAlphaMax ? kAlphaMax : alpha;
        if (alpha < kAlphaMin) continue;
        const float w = alpha * expf(logT0 + excl);
        float gc = 0.0f;
#pragma unroll
        for (int r = 0; r < 5; ++r) gc = fmaf(sh[(6 + r) * K + j], gacc[r], gc);
        tot = fmaf(w, gc, tot);
        excl += log1pf(-alpha);
      }
    }

    // pass 2: per-entry gradient terms, summed over the block's pixels
    float excl = 0.0f, cum = 0.0f;
    for (int j0 = 0; j0 < K; j0 += SUB) {
      const int nsub = min(SUB, K - j0);
      for (int jj = 0; jj < nsub; ++jj) {
        const int j = j0 + jj;
        float v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = 0.0f;
        bool nz = false;
        const float o = sh[11 * K + j];
        if (live && !(o < kAlphaMin)) {
          const float praw = gaussian_power(sh, K, j, pf);
          const float power = praw > 0.0f ? 0.0f : praw;
          const float epow = expf(power);
          const float alpha_raw = o * epow;
          const bool hi = alpha_raw > kAlphaMax;
          const float alpha = hi ? kAlphaMax : alpha_raw;
          if (!(alpha < kAlphaMin)) {
            const float t_in = expf(logT0 + excl);
            const float w = alpha * t_in;
            float gc = 0.0f;
#pragma unroll
            for (int r = 0; r < 5; ++r)
              gc = fmaf(sh[(6 + r) * K + j], gacc[r], gc);
            cum = fmaf(w, gc, cum);
            const float suffix = (tot - cum) + s;
            const float dalpha = hi ? 0.0f : t_in * gc - suffix / (1.0f - alpha);
            const float dpower = praw > 0.0f ? 0.0f : dalpha * alpha_raw;
#pragma unroll
            for (int f = 0; f < 6; ++f) v[f] = pf[f] * dpower;
#pragma unroll
            for (int r = 0; r < 5; ++r) v[6 + r] = gacc[r] * w;
            v[11] = dalpha * epow;
            excl += log1pf(-alpha);
            nz = true;
          }
        }
        if (__any_sync(FULL, nz)) {
          const float sum = warp_reduce_scatter(v, lane);
          if ((lane & 1) == 0) wp[jj][warp][(lane >> 1) & 15] = sum;
        } else if (lane < 16) {
          wp[jj][warp][lane] = 0.0f;
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < 12 * nsub; i += THREADS) {
        const int term = i / nsub;
        const int jj = i - term * nsub;
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) acc += wp[jj][w][term];
        part[(((size_t)t * n_blk + blk) * 12 + term) * cap + c * K + j0 + jj] =
            acc;
      }
      __syncthreads();
    }
    s += tot;
  }
}

// Sums the n_blk partials of each (tile, term, entry) in block order and
// scatters the terms into dG (T, 6, cap), dC (T, 5, cap), dO (T, 1, cap).
__global__ void composite_bwd_reduce(const float* __restrict__ part,
                                     float* __restrict__ dG,
                                     float* __restrict__ dC,
                                     float* __restrict__ dO, int T, int n_blk,
                                     int cap) {
  const size_t n = (size_t)T * 12 * cap;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(i % cap);
    const size_t tv = i / cap;
    const int term = (int)(tv % 12);
    const int t = (int)(tv / 12);
    float acc = 0.0f;
    for (int b = 0; b < n_blk; ++b)
      acc += part[(((size_t)t * n_blk + b) * 12 + term) * cap + j];
    if (term < 6)
      dG[((size_t)t * 6 + term) * cap + j] = acc;
    else if (term < 11)
      dC[((size_t)t * 5 + (term - 6)) * cap + j] = acc;
    else
      dO[(size_t)t * cap + j] = acc;
  }
}

}  // namespace

extern "C" int syn3r_composite_bwd(const void* P, const void* G, const void* C,
                                   const void* O, const void* ltc,
                                   const void* dout, void* part, void* dG,
                                   void* dC, void* dO, int T, int px, int cap,
                                   int K, void* stream) {
  if (T <= 0 || T > 65535 || px <= 0 || cap <= 0 || K <= 0 || K > 1024 ||
      cap % K != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)12 * K * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_blk = (px + THREADS - 1) / THREADS;
  composite_bwd_kernel<<<dim3(n_blk, T), THREADS, smem, s>>>(
      static_cast<const float*>(P), static_cast<const float*>(G),
      static_cast<const float*>(C), static_cast<const float*>(O),
      static_cast<const float*>(ltc), static_cast<const float*>(dout),
      static_cast<float*>(part), px, cap, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)T * 12 * cap;
  const int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256
                                                       : 132 * 16);
  composite_bwd_reduce<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dG),
      static_cast<float*>(dC), static_cast<float*>(dO), T, n_blk, cap);
  return (int)cudaGetLastError();
}
