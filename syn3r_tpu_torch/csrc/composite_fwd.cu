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
// ltc (T, cap / K, px). No early stop at low transmittance: JAX composites
// every entry.
//
// Bound on the H100: at the main path's size (T 96, px 2048, cap 1024,
// K 128) there are 2.0e8 (entry, pixel) pairs with opacity >= 1/255; each
// costs about 15 float32 operations to reach alpha and 15 more where alpha
// passes 1/255 (4.4e7 pairs), while the inputs and outputs are about 16 MB
// (5 us at 3.35 TB/s). So operations, not bytes, bound it (chip_smoke.py
// computes the bound from the run's data). The skip below removes ~65% of
// the pairs the bound counts, so the kernel may run under it.
//
// Design (one launch, no atomics, deterministic):
//  * Four pixels a thread, a warp a 4 x 32 pixel rectangle, entries staged
//    entry-major and read once per thread for its four pixels
//    (composite_common.cuh). Blocks of 128 threads, 512 pixels (8 rows of
//    64): thread j stages and tests entry j of a chunk. The four pixels'
//    chains are branch-free: a pair below 1/255 computes with alpha 0 and
//    leaves the sums and excl as they were, so the chains interleave.
//  * The exact skip of composite_common.cuh, the backward's test: per
//    chunk, each entry once per warp rectangle; a warp walks only the set
//    bits of its keep words (warp-uniform, no divergence). The keep bits
//    go to keep (T, n_chunks, rectangles, 4 words), the backward's layout,
//    so the chip check can hold the forward's own decisions to the plain
//    mirror reach_mask. At the main path's size they keep 34.9% of the
//    (entry, rectangle) pairs with opacity >= 1/255.
//  * The test costs double-precision work and its latency (make_quad's
//    log and divides, four rectangles a thread). A block runs it for chunk
//    c + 1 after compositing chunk c, on the entry the thread staged itself
//    (cp.async, a second buffer, its own copy visible after its own wait):
//    no barrier between, so a warp's test overlaps slower warps'
//    compositing; one barrier a chunk.
//  * Chunks of a (pixel block, tile): one block walks them in sequence,
//    logT carried in registers (in base 2, see Numerics) and written to
//    ltc at each chunk's start and to out at the end, with no scratch and
//    no limit on the chunks. Grid (px / 512, T): 384 blocks at the main
//    path's size, at most 128 registers a thread (the launch bounds), four
//    blocks a SM resident (528 on the card): one wave, no block waits for
//    another. The grid is the work (a block a pixel block and tile), not a
//    query of the card's residency: it fits the resident slots in one
//    wave. Chunks in parallel instead (a cluster of 8 blocks a tile's
//    pixel block, each chunk from logT = 0, folded through distributed
//    shared memory) measured slower at the main path's size (0.142-0.149
//    against 0.121-0.126 ms for a walk in sequence, on an H100 80GB HBM3
//    at 700 W, scripts/time_kernels.py and chip_smoke.py): it pays for its
//    fold, its cluster barriers and eight times the pixel loads and
//    rectangle set-up.
//  * Numerics: the special functions are the hardware-approximate
//    instructions, with the maximum errors the CUDA C++ Programming Guide
//    documents (intrinsic functions table):
//      ex2.approx.ftz   alpha = O 2^(power log2 e): __expf's instruction,
//                       equal to __expf wherever that is a normal float,
//                       2 + floor(|1.173 x|) ulp (power in [-5.6, 0]
//                       wherever alpha can reach 1/255: <= 8 ulp, 5e-7
//                       relative, inside the skip test's margin); 0 where
//                       __expf is subnormal (alpha < 1e-38, cut to 0 either
//                       way), which saves __expf's three instructions of
//                       range fix-up a pair. w = alpha 2^(logT2 + excl2),
//                       the transmittance in base 2 inside a block (one
//                       below 2^-126 flushes to 0: a weight under 1e-38)
//      lg2.approx.ftz   log2(1 - a), __log2f's 2^-22 absolute on [0.5, 2],
//                       else 2 ulp (1 - a rounds by <= 2^-25): at most
//                       6e-5 of |log1p(-a)| for a >= 1/255, so the summed
//                       logT errs by at most 6e-5 of |logT|
//    logT2 becomes a natural log (ln 2 logT2) where it is written, to ltc
//    and to row 5. chip_smoke.py holds out and ltc to the plain version
//    (accurate torch functions) under COMPOSITE_TOL["fwd"] at the main
//    path's shapes.

#include "composite_common.cuh"

using namespace syn3r;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;  // = KMAX: a thread an entry
constexpr int BP = THREADS * PXT;    // 512 pixels a block: 8 rows of 64
constexpr float kLn2 = 0.693147180559945309f;
static_assert(THREADS == KMAX, "thread j stages and tests entry j");

// 2^x and log2(x), one special-function instruction each (see Numerics).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// alpha = min(O e^min(G . P, 0), 0.99) of the staged entry (g03 = G0-3,
// g45 = G4, G5; o its opacity) at pixel features p, the power in the TPU
// kernel's term order; not yet cut below 1/255.
__device__ __forceinline__ float alpha_of(const float4& g03, const float4& g45,
                                          float o, const float (&p)[6]) {
  float power = g03.x * p[0];
  power = fmaf(g03.y, p[1], power);
  power = fmaf(g03.z, p[2], power);
  power = fmaf(g03.w, p[3], power);
  power = fmaf(g45.x, p[4], power);
  power = fmaf(g45.y, p[5], power);
  power = power > 0.0f ? 0.0f : power;
  const float a = o * ex2(power * 1.44269504088896341f);
  return a > kAlphaMax ? kAlphaMax : a;
}

// Stages entries j0 .. j0+K-1 of tile t entry-major into ent (KMAX x
// ESTRIDE floats) with cp.async, thread j copying entry j (K <= THREADS):
// after cp_async_wait() a thread sees its own entry; a barrier makes the
// others visible.
__device__ __forceinline__ void stage_entries_async(float* ent, const float* G,
                                                    const float* C,
                                                    const float* O, int t,
                                                    int cap, int j0, int K) {
  const int j = threadIdx.x;
  if (j < K) {
#pragma unroll
    for (int f = 0; f < 12; ++f) {
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(ent + j * ESTRIDE + f));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(entry_feature(G, C, O, t, cap, f) + j0 + j));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Two chunks in flight: entries and keep bits of chunk c and c + 1.
struct Stage {
  float ent[2][KMAX * ESTRIDE];  // G0-5, C0-4, O, 4 unused
  float rect[WARPS][4];          // x0, x1, y0, y1 of the warp's live pixels
  int state[WARPS];              // 0 no live pixel, 1 exact P, 2 other P
  uint32_t keep[2][WARPS][WORDS];
};

// Thread j tests entry j of ent, its own staged copy, against the warp
// rectangles; lane 0 of each warp stores the ballot of its 32 entries. No
// barrier: the caller's next one makes the bits visible.
__device__ __forceinline__ void test_chunk(const Stage& sh, const float* ent,
                                           uint32_t (*keep)[WORDS], int K) {
  const int j = threadIdx.x;
  Quad q;
  q.kind = 0;
  if (j < K) make_quad(q, ent + j * ESTRIDE);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int st = sh.state[w];
    const bool kept =
        st != 0 && (st == 1 ? may_reach(q, sh.rect[w]) : q.kind != 0);
    const uint32_t bits = __ballot_sync(FULL, kept);
    if ((j & 31) == 0) keep[w][j / 32] = bits;
  }
}

// keep: the skip test's bits, or null to not store them.
__global__ void __launch_bounds__(THREADS, 4)
    composite_fwd_kernel(const float* __restrict__ P,
                         const float* __restrict__ G,
                         const float* __restrict__ C,
                         const float* __restrict__ O, float* __restrict__ out,
                         float* __restrict__ ltc, uint32_t* __restrict__ keep,
                         int px, int cap, int K) {
  __shared__ __align__(16) Stage sh;
  const int pb = blockIdx.x, t = blockIdx.y;
  const int n_chunks = cap / K;
  const int n_rect = (px + 1023) / 1024 * 8;  // the backward's rectangles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float pf[PXT][6];
  int pix[PXT];
  load_pixels<WARPS>(P, px, pb, warp, lane, pf, pix);
  warp_rect(sh.rect[warp], &sh.state[warp], pf, pix, lane);
  stage_entries_async(sh.ent[0], G, C, O, t, cap, 0, K);
  __syncthreads();  // the rectangles
  cp_async_wait();  // this thread's entry of chunk 0
  test_chunk(sh, sh.ent[0], sh.keep[0], K);
  if (n_chunks > 1) stage_entries_async(sh.ent[1], G, C, O, t, cap, K, K);
  __syncthreads();  // chunk 0 and its keep bits

  // log2 units: logT2 of the earlier chunks, excl of the chunk's earlier
  // entries
  float acc[PXT][5], logT2[PXT];
#pragma unroll
  for (int k = 0; k < PXT; ++k) {
    logT2[k] = 0.0f;
#pragma unroll
    for (int r = 0; r < 5; ++r) acc[k][r] = 0.0f;
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int b = c & 1;
    if (keep != nullptr && threadIdx.x < WARPS * WORDS)
      keep[(((size_t)t * n_chunks + c) * n_rect + pb * WARPS) * WORDS +
           threadIdx.x] = sh.keep[b][threadIdx.x / WORDS][threadIdx.x % WORDS];
#pragma unroll
    for (int k = 0; k < PXT; ++k)
      if (pix[k] >= 0)
        ltc[((size_t)t * n_chunks + c) * px + pix[k]] = logT2[k] * kLn2;

    float excl[PXT] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float4* e4 = reinterpret_cast<const float4*>(sh.ent[b]);
    for (int wd = 0; wd < WORDS; ++wd) {
      uint32_t bits = sh.keep[b][warp][wd];
      while (bits) {
        const int j = wd * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        const float4 e0 = e4[j * 4], e1 = e4[j * 4 + 1], e2 = e4[j * 4 + 2];
#pragma unroll
        for (int k = 0; k < PXT; ++k) {
          const float a = alpha_of(e0, e1, e2.w, pf[k]);
          const bool hit = !(a < kAlphaMin);
          const float alpha = hit ? a : 0.0f;
          const float w = alpha * ex2(logT2[k] + excl[k]);
          acc[k][0] = fmaf(e1.z, w, acc[k][0]);
          acc[k][1] = fmaf(e1.w, w, acc[k][1]);
          acc[k][2] = fmaf(e2.x, w, acc[k][2]);
          acc[k][3] = fmaf(e2.y, w, acc[k][3]);
          acc[k][4] = fmaf(e2.z, w, acc[k][4]);
          const float l1ma = lg2(1.0f - alpha);
          excl[k] = hit ? excl[k] + l1ma : excl[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PXT; ++k) logT2[k] += excl[k];
    // the next chunk's keep bits, while slower warps still composite
    if (c + 1 < n_chunks) {
      cp_async_wait();
      test_chunk(sh, sh.ent[b ^ 1], sh.keep[b ^ 1], K);
    }
    __syncthreads();  // chunk c done; chunk c + 1 and its keep bits visible
    if (c + 2 < n_chunks)
      stage_entries_async(sh.ent[b], G, C, O, t, cap, (c + 2) * K, K);
  }
#pragma unroll
  for (int k = 0; k < PXT; ++k) {
    if (pix[k] < 0) continue;
#pragma unroll
    for (int r = 0; r < 5; ++r)
      out[((size_t)t * 6 + r) * px + pix[k]] = acc[k][r];
    out[((size_t)t * 6 + 5) * px + pix[k]] = logT2[k] * kLn2;
  }
}

}  // namespace

// keep (T, cap / K, ceil(px / 1024) x 8, 4) 32-bit words, the backward's
// layout, or null: the kernel writes its first ceil(px / 512) x 4
// rectangles (the others have no pixel).
extern "C" int syn3r_composite_fwd(const void* P, const void* G, const void* C,
                                   const void* O, void* out, void* ltc,
                                   void* keep, int T, int px, int cap, int K,
                                   void* stream) {
  if (T <= 0 || T > 65535 || px <= 0 || cap <= 0 || K <= 0 || K > KMAX ||
      cap % K != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((px + BP - 1) / BP, T);
  composite_fwd_kernel<<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(P), static_cast<const float*>(G),
      static_cast<const float*>(C), static_cast<const float*>(O),
      static_cast<float*>(out), static_cast<float*>(ltc),
      static_cast<uint32_t*>(keep), px, cap, K);
  return (int)cudaGetLastError();
}
