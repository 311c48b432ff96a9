// Per-tile alpha compositing, backward, written by hand for Hopper (sm_90a).
//
// Replaces: syn3r_tpu/ops/pallas_rasterize.py `_bwd_kernel` (launched by
// `_composite_bwd_impl` from the custom VJP of `composite_tiles`). From the
// output cotangent dout (T, 6, px) (rows 0-4 d accum = gacc, row 5 d logT)
// and the chunk-start logT ltc (T, cap / K, px) it follows the TPU kernel
// line by line, per chunk c and pixel:
//   T_in = exp(logT0 + excl_j), w_j = alpha_j T_in, gC_j = C_j . gacc
//   tot_c = sum_j w_j gC_j;  suffix_j = tot_c - cumsum_j(w gC) + s_c
//   dalpha_j = T_in gC_j - suffix_j / (1 - alpha_j), 0 where alpha was cut
//              below 1/255 or clamped at 0.99
//   dpower_j = 0 where G_j . P > 0, else dalpha_j alpha_raw_j
//   dG_j += P dpower_j;  dC_j += gacc w_j;  dO_j += dalpha_j e^power
// with excl the forward-order exclusive sum of log1p(-alpha) inside the
// chunk and the carry s_c = d logT + tot_{n-1} + ... + tot_{c+1}, added in
// that order (the order of the TPU kernel's reverse walk). dP is 0.
//
// Bound on the H100: the main path's size (T 96, px 2048, cap 1024, K 128)
// has 2.0e8 (entry, pixel) pairs with opacity >= 1/255; each costs about 15
// operations to reach alpha and about 45 more where alpha passes 1/255.
// About 16 MB of inputs and outputs, so operations bound it (chip_smoke.py
// computes the bound from the run's data). Every such pair needs an exp and
// every hit pair an exp, a log1p and a divide: the special-function units
// come within ~7% of the same bound.
//
// Design (three launches on one stream, no atomics, deterministic):
//  * Chunks in parallel. Chunk c needs only ltc[:, c] and its carry, and
//    the carry is a sum of later chunks' tot. A first kernel computes
//    tot (T, n_chunks, px) for every (tile, chunk, pixel) at once; the
//    gradient kernel runs each (pixel block, chunk, tile) as its own block
//    and forms s_c from those tots in the order above, so it carries the
//    bits of a sequential walk. Grid (px / 1024, n_chunks, T): 1536 blocks
//    of 256 threads at the main path's size.
//  * Four pixels a thread, a warp a 4 x 32 pixel rectangle, entries staged
//    entry-major (composite_common.cuh). The thread sums its four pixels'
//    twelve gradient terms in registers, and the warp folds its lanes with
//    one 16-slot reduce-scatter (15 shuffles) per entry: a quarter of the
//    shuffles of one pixel a thread. The gradient loop is branch-free over
//    the four pixels (a pair below 1/255 computes with alpha 0 and adds
//    exact zeros), so their chains interleave.
//  * The exact skip of entries that cannot reach a warp's pixels, the
//    rectangle test of composite_common.cuh (the forward takes the same
//    one). The tot kernel runs it when it stages its chunk and writes its
//    keep bits (T, n_chunks, n_blocks, 8 warps, 4 words of 32 entries); the
//    gradient kernel reads them. On the gs cell it keeps 34.9% of the
//    (entry, rectangle) pairs with opacity >= 1/255 (chip_smoke.py reports
//    the fraction).
//  * Staging: each block stages one chunk once (12 x K floats, coalesced
//    global reads), so there is no chunk stream to double-buffer; blocks
//    resident beside it (three a SM for the tot kernel, two for the
//    gradient kernel, whose partials take 68 KB of shared memory) hide its
//    latency.
//  * Sums in a fixed order: per (warp, entry) one partial a term in shared
//    memory (rows padded to 17 floats: no bank conflicts), the block sums
//    its 8 warps in order and writes part (T, n_blocks, 12, cap); a third
//    kernel sums the n_blocks partials in block order into dG, dC, dO.
//    Scratch at the main path's size: tot 6.3 MB, part 9.4 MB, keep bits
//    0.2 MB (a pixel a thread and the chunks in sequence wrote 37.7 MB).
//  * Numerics: the special functions are the hardware-approximate
//    intrinsics (they took a quarter of the time as the accurate library
//    functions), with the maximum errors the CUDA C++ Programming Guide
//    documents (intrinsic functions table):
//      __expf(x)        2 + floor(|1.173 x|) ulp; for alpha (power in
//                       [-5.6, 0] wherever alpha can reach 1/255) <= 8 ulp,
//                       5e-7 relative, inside the skip test's margin
//      __logf(1 - a)    2^-21.41 absolute for 1 - a in [0.5, 2], else 3 ulp
//                       (replaces log1pf(-a); 1 - a rounds by <= 2^-25)
//      __fdividef(x, y) 2 ulp for |y| in [2^-126, 2^126] (y = 1 - alpha is
//                       in [0.01, 1])
//    Both passes use the same functions, so tot and the running sum in
//    suffix agree. chip_smoke.py holds the result to the plain version
//    (accurate torch functions) under COMPOSITE_TOL at the main path's
//    shapes and the kernel route's gradients to autograd.

#include "composite_common.cuh"

using namespace syn3r;

namespace {

constexpr int THREADS = 256;  // = ops/composite.py BWD_THREADS
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK_PX = THREADS * PXT;     // 1024: 16 rows of 64
constexpr int WSTRIDE = 17;                 // floats a warp-partial row

// Entry-major staged chunk, the warps' pixel rectangles and keep bits.
struct Stage {
  float ent[KMAX * ESTRIDE];  // G0-5, C0-4, O, 4 unused
  float rect[WARPS][4];       // x0, x1, y0, y1 of the warp's live pixels
  int state[WARPS];           // 0 no live pixel, 1 exact P, 2 any other P
  uint32_t keep[WARPS][WORDS];
};

// Stages entries j0 .. j0+K-1 of tile t entry-major into ent (KMAX x
// ESTRIDE floats). Consecutive threads read consecutive entries of one row
// (coalesced); every thread of a pixel block later reads the same address
// (a broadcast, no bank conflict). No synchronization.
template <int THREADS>
__device__ __forceinline__ void stage_entries(float* ent, const float* G,
                                              const float* C, const float* O,
                                              int t, int cap, int j0, int K) {
  for (int i = threadIdx.x; i < 12 * K; i += THREADS) {
    const int f = i / K;
    const int j = i - f * K;
    ent[j * ESTRIDE + f] = entry_feature(G, C, O, t, cap, f)[j0 + j];
  }
}

// Threads 0 .. K-1 make the entries' quadratics; after a barrier thread i
// tests entry i % 128 against the rectangles of warps 4 (i / 128) .. +3
// and lane 0 of each warp stores the ballots. Needs the staged entries and
// rectangles visible (a barrier before); ends with the keep bits visible.
__device__ __forceinline__ void keep_bits(Stage& sh, Quad* qs, int K) {
  static_assert(KMAX == THREADS / 2, "keep test: two threads an entry");
  const int j = threadIdx.x & (KMAX - 1);
  if (threadIdx.x < K)
    make_quad(qs[threadIdx.x], sh.ent + threadIdx.x * ESTRIDE);
  __syncthreads();
  const int w0 = (threadIdx.x / KMAX) * 4;
  const int word = (threadIdx.x >> 5) & (WORDS - 1);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int w = w0 + r;
    const int st = sh.state[w];
    bool keep = false;
    if (j < K && st != 0)
      keep = st == 1 ? may_reach(qs[j], sh.rect[w]) : qs[j].kind != 0;
    const uint32_t bits = __ballot_sync(FULL, keep);
    if ((threadIdx.x & 31) == 0) sh.keep[w][word] = bits;
  }
  __syncthreads();
}

// power, e^power, alpha before and after the clamps of entry e at pixel
// features p, in the TPU kernel's term order.
struct Alpha {
  float praw, epow, raw, alpha;
};

__device__ __forceinline__ Alpha alpha_at(const float4& g03,
                                          const float4& g45c01, float o,
                                          const float (&p)[6]) {
  Alpha a;
  float acc = g03.x * p[0];
  acc = fmaf(g03.y, p[1], acc);
  acc = fmaf(g03.z, p[2], acc);
  acc = fmaf(g03.w, p[3], acc);
  acc = fmaf(g45c01.x, p[4], acc);
  acc = fmaf(g45c01.y, p[5], acc);
  a.praw = acc;
  a.epow = __expf(acc > 0.0f ? 0.0f : acc);
  a.raw = o * a.epow;
  a.alpha = a.raw > kAlphaMax ? kAlphaMax : a.raw;
  return a;
}

// tot (T, n_chunks, px) = sum_j w_j gC_j per (tile, chunk, pixel), in
// entry order; also the keep bits (T, n_chunks, n_blocks, WARPS, WORDS).
__global__ void __launch_bounds__(THREADS, 3)
    composite_bwd_tot(const float* __restrict__ P, const float* __restrict__ G,
                      const float* __restrict__ C, const float* __restrict__ O,
                      const float* __restrict__ ltc,
                      const float* __restrict__ dout, float* __restrict__ tot,
                      uint32_t* __restrict__ keep, int px, int cap, int K) {
  __shared__ __align__(16) Stage sh;
  __shared__ Quad qs[KMAX];
  const int pb = blockIdx.x, c = blockIdx.y, t = blockIdx.z;
  const int n_chunks = gridDim.y, n_pb = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float pf[PXT][6];
  int pix[PXT];
  load_pixels<WARPS>(P, px, pb, warp, lane, pf, pix);
  stage_entries<THREADS>(sh.ent, G, C, O, t, cap, c * K, K);
  warp_rect(sh.rect[warp], &sh.state[warp], pf, pix, lane);
  float gacc[PXT][5], logT0[PXT], excl[PXT], acc[PXT];
#pragma unroll
  for (int k = 0; k < PXT; ++k) {
    const int p = pix[k] < 0 ? 0 : pix[k];
#pragma unroll
    for (int r = 0; r < 5; ++r)
      gacc[k][r] = pix[k] < 0 ? 0.0f : dout[((size_t)t * 6 + r) * px + p];
    logT0[k] =
        pix[k] < 0 ? 0.0f : ltc[((size_t)t * n_chunks + c) * px + p];
    excl[k] = 0.0f;
    acc[k] = 0.0f;
  }
  __syncthreads();
  keep_bits(sh, qs, K);
  if (threadIdx.x < WARPS * WORDS) {
    const int w = threadIdx.x / WORDS, wd = threadIdx.x % WORDS;
    keep[((((size_t)t * n_chunks + c) * n_pb + pb) * WARPS + w) * WORDS +
         wd] = sh.keep[w][wd];
  }

  const float4* ent = reinterpret_cast<const float4*>(sh.ent);
  for (int wd = 0; wd < WORDS; ++wd) {
    uint32_t bits = sh.keep[warp][wd];
    while (bits) {
      const int j = wd * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      const float4 e0 = ent[j * 4], e1 = ent[j * 4 + 1], e2 = ent[j * 4 + 2];
#pragma unroll
      for (int k = 0; k < PXT; ++k) {
        if (pix[k] < 0) continue;
        const Alpha a = alpha_at(e0, e1, e2.w, pf[k]);
        if (a.alpha < kAlphaMin) continue;
        const float w = a.alpha * __expf(logT0[k] + excl[k]);
        float gc = e1.z * gacc[k][0];
        gc = fmaf(e1.w, gacc[k][1], gc);
        gc = fmaf(e2.x, gacc[k][2], gc);
        gc = fmaf(e2.y, gacc[k][3], gc);
        gc = fmaf(e2.z, gacc[k][4], gc);
        acc[k] = fmaf(w, gc, acc[k]);
        excl[k] += __logf(1.0f - a.alpha);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PXT; ++k)
    if (pix[k] >= 0) tot[((size_t)t * n_chunks + c) * px + pix[k]] = acc[k];
}

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

// The twelve gradient terms of chunk c, summed over the block's pixels:
// part (T, n_blocks, 12, cap).
__global__ void __launch_bounds__(THREADS, 2)
    composite_bwd_grad(const float* __restrict__ P,
                       const float* __restrict__ G,
                       const float* __restrict__ C,
                       const float* __restrict__ O,
                       const float* __restrict__ ltc,
                       const float* __restrict__ dout,
                       const float* __restrict__ tot,
                       const uint32_t* __restrict__ keep,
                       float* __restrict__ part, int px, int cap, int K) {
  __shared__ __align__(16) Stage sh;
  extern __shared__ float wp[];  // [WARPS][KMAX][WSTRIDE]
  const int pb = blockIdx.x, c = blockIdx.y, t = blockIdx.z;
  const int n_chunks = gridDim.y, n_pb = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float pf[PXT][6];
  int pix[PXT];
  load_pixels<WARPS>(P, px, pb, warp, lane, pf, pix);
  stage_entries<THREADS>(sh.ent, G, C, O, t, cap, c * K, K);
  if (threadIdx.x < WARPS * WORDS) {
    const int w = threadIdx.x / WORDS, wd = threadIdx.x % WORDS;
    sh.keep[w][wd] = keep[((((size_t)t * n_chunks + c) * n_pb + pb) * WARPS +
                           w) * WORDS + wd];
  }
  for (int i = threadIdx.x; i < WARPS * KMAX * WSTRIDE; i += THREADS)
    wp[i] = 0.0f;

  float gacc[PXT][5], logT0[PXT], excl[PXT], cum[PXT], s[PXT], totc[PXT];
#pragma unroll
  for (int k = 0; k < PXT; ++k) {
    const int p = pix[k] < 0 ? 0 : pix[k];
    const bool live = pix[k] >= 0;
#pragma unroll
    for (int r = 0; r < 5; ++r)
      gacc[k][r] = live ? dout[((size_t)t * 6 + r) * px + p] : 0.0f;
    logT0[k] = live ? ltc[((size_t)t * n_chunks + c) * px + p] : 0.0f;
    // the carry in the sequential walk's order: d logT, then the later
    // chunks' tot from the last one down
    float sk = live ? dout[((size_t)t * 6 + 5) * px + p] : 0.0f;
    for (int cc = n_chunks - 1; cc > c; --cc)
      sk += live ? tot[((size_t)t * n_chunks + cc) * px + p] : 0.0f;
    s[k] = sk;
    totc[k] = live ? tot[((size_t)t * n_chunks + c) * px + p] : 0.0f;
    excl[k] = 0.0f;
    cum[k] = 0.0f;
  }
  __syncthreads();

  const float4* ent = reinterpret_cast<const float4*>(sh.ent);
  for (int wd = 0; wd < WORDS; ++wd) {
    uint32_t bits = sh.keep[warp][wd];
    while (bits) {
      const int j = wd * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      const float4 e0 = ent[j * 4], e1 = ent[j * 4 + 1], e2 = ent[j * 4 + 2];
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = 0.0f;
      bool nz = false;
      // branch-free over the thread's pixels (their chains interleave):
      // a pair below 1/255 (or a dead pixel) computes with alpha 0, adds
      // P 0, gacc 0 and 0 to the sums and leaves cum and excl as they were
#pragma unroll
      for (int k = 0; k < PXT; ++k) {
        const Alpha a = alpha_at(e0, e1, e2.w, pf[k]);
        const bool hit = pix[k] >= 0 && !(a.alpha < kAlphaMin);
        const float alpha = hit ? a.alpha : 0.0f;
        const bool hi = a.raw > kAlphaMax;
        const float t_in = __expf(logT0[k] + excl[k]);
        const float w = alpha * t_in;
        float gc = e1.z * gacc[k][0];
        gc = fmaf(e1.w, gacc[k][1], gc);
        gc = fmaf(e2.x, gacc[k][2], gc);
        gc = fmaf(e2.y, gacc[k][3], gc);
        gc = fmaf(e2.z, gacc[k][4], gc);
        const float cum_k = fmaf(w, gc, cum[k]);
        const float suffix = (totc[k] - cum_k) + s[k];
        const float dalpha =
            hi || !hit ? 0.0f : t_in * gc - __fdividef(suffix, 1.0f - alpha);
        const float dpower = a.praw > 0.0f ? 0.0f : dalpha * a.raw;
        const float l1ma = __logf(1.0f - alpha);
#pragma unroll
        for (int f = 0; f < 6; ++f) v[f] = fmaf(pf[k][f], dpower, v[f]);
#pragma unroll
        for (int r = 0; r < 5; ++r) v[6 + r] = fmaf(gacc[k][r], w, v[6 + r]);
        v[11] = fmaf(dalpha, a.epow, v[11]);
        cum[k] = hit ? cum_k : cum[k];
        excl[k] = hit ? excl[k] + l1ma : excl[k];
        nz = nz || hit;
      }
      if (__any_sync(FULL, nz)) {
        const float sum = warp_reduce_scatter(v, lane);
        const int slot = (lane >> 1) & 15;
        if ((lane & 1) == 0 && slot < 12)
          wp[(warp * KMAX + j) * WSTRIDE + slot] = sum;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 12 * K; i += THREADS) {
    const int term = i / K;
    const int j = i - term * K;
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += wp[(w * KMAX + j) * WSTRIDE + term];
    part[(((size_t)t * n_pb + pb) * 12 + term) * cap + c * K + j] = acc;
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

// Scratch from the wrapper (ops/composite.py composite_bwd_plan): tot
// (T, cap / K, px) and part (T, n_blk, 12, cap) float32, keep
// (T, cap / K, n_blk, 8, 4) 32-bit words, n_blk = ceil(px / 1024).
extern "C" int syn3r_composite_bwd(const void* P, const void* G, const void* C,
                                   const void* O, const void* ltc,
                                   const void* dout, void* tot, void* keep,
                                   void* part, void* dG, void* dC, void* dO,
                                   int T, int px, int cap, int K,
                                   void* stream) {
  if (T <= 0 || T > 65535 || px <= 0 || cap <= 0 || K <= 0 || K > KMAX ||
      cap % K != 0 || cap / K > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blk = (px + BLOCK_PX - 1) / BLOCK_PX;
  const dim3 grid(n_blk, cap / K, T);
  const auto* Pf = static_cast<const float*>(P);
  const auto* Gf = static_cast<const float*>(G);
  const auto* Cf = static_cast<const float*>(C);
  const auto* Of = static_cast<const float*>(O);
  const auto* ltcf = static_cast<const float*>(ltc);
  const auto* doutf = static_cast<const float*>(dout);
  composite_bwd_tot<<<grid, THREADS, 0, s>>>(
      Pf, Gf, Cf, Of, ltcf, doutf, static_cast<float*>(tot),
      static_cast<uint32_t*>(keep), px, cap, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)WARPS * KMAX * WSTRIDE * sizeof(float);
  err = cudaFuncSetAttribute(composite_bwd_grad,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  composite_bwd_grad<<<grid, THREADS, smem, s>>>(
      Pf, Gf, Cf, Of, ltcf, doutf, static_cast<const float*>(tot),
      static_cast<const uint32_t*>(keep), static_cast<float*>(part), px, cap,
      K);
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
