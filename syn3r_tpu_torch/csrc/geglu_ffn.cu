// GEGLU feed-forward of the SVD transformer blocks, written by hand for
// Hopper (sm_90a).
//
// Replaces: syn3r_tpu/ops/pallas_ffn.py `_ffn_kernel` (launched by
// `geglu_ffn_pallas`): [a|g] = x W1 + b1 (C -> 8C), y = (a * gelu(g)) W2 + b2.
//
// Bound on the H100: at the UNet's row counts (3*25*{9216..144} rows) and
// C = 320..1280 the two products do 24*R*C^2 operations on about
// 4*R*C + 24*C^2 bytes, hundreds of operations per byte, so the tensor
// cores bound it. The TPU kernel kept W1 and W2 resident in VMEM; here W1
// alone is 26 MB at C = 1280, far beyond a block's 227 KB of shared memory,
// so both weight matrices stream through shared memory tile by tile and
// stay hot in the 50 MB L2 (tiles walk the output columns fastest, so the
// blocks that run together share row tiles of x).
//
// Design: two launches of one warp-specialised, persistent wgmma GEMM.
//   - One block per SM (the grid is min(tiles, SMs)); each walks the output
//     tiles t = blockIdx.x, + gridDim.x, ... A tile is 256 rows by TN
//     output columns.
//   - Warpgroup 0 is the producer: one thread keeps TMA loads of the x (or
//     h) tile and the W tile, 64 deep in K, in flight in a ring of 4
//     stages, each guarded by a full and an empty mbarrier; the loads of
//     the next tile run under the current tile's epilogue.
//   - Warpgroups 1 and 2 are consumers and share every tile: each computes
//     128 of its rows as two m64 wgmma halves, bf16 from the swizzled
//     shared tiles, f32 accumulators in registers, so four accumulator
//     chains keep the tensor cores fed. Consumers that took whole tiles in
//     turns, one's epilogue under the other's wgmmas, were slower: two
//     chains did not fill the tensor cores (182.8 against 142.7 ms a
//     batch-3 UNet forward for the whole FF; PERF.md).
//   GEMM-1 (GEGLU) loads the a rows n0.. and the g rows N+n0.. of W1 as two
//   TMA boxes of 64 rows, stacked into one 128-row B tile, so one m64n128
//   wgmma yields a (chunks 0-7) and g (chunks 8-15) of the same output
//   elements in the same thread (4C = 1280, 2560, 5120 and their
//   tensor-parallel halves and quarters are multiples of 64); it writes the
//   4C-wide gated product h, never the 8C pre-activation. Its epilogue (per
//   output an erf-GELU, the product and a store) ran after each tile's
//   main loop with the tensor cores idle, and weighed most at C = 320,
//   where a tile has only five k-steps. It is software-pipelined across
//   tiles inside each consumer: after a tile's last wgmma_wait a thread
//   only packs its accumulators into bf16 pairs (bias added) and goes on to
//   the next tile; the GELU, the product and the writes to a shared
//   staging tile run in five slices, one between the commit and the
//   wgmma_wait<1> of each of the next tile's first k-steps, and each warp
//   then stores its 2 x 16 rows of h by TMA, where the epilogue used to
//   store scattered 4-byte pairs. On the H100 (PERF.md) those stores were
//   most of the exposed epilogue; the GELU's f32 arithmetic costs about as
//   much under the wgmmas as after them (as much again when a separate
//   warpgroup runs it), so the overlap itself hides little more than the
//   epilogue's latency. The 128-column B tile makes room in the registers
//   for 128 accumulators and the previous tile's 64 packed pairs (the
//   former 160 columns would need 160 + 80, more than the consumers' 232).
//   GEMM-2 multiplies h by W2 with an N tile of 160 or 128 columns that
//   divides C (320, 640, 1280: no column is computed in vain) and adds b2
//   after its main loop, four times longer than GEMM-1's.
// Numerics follow `_ffn_kernel`: each product is rounded to bf16, the bias
// is added in bf16 (add.rn.bf16x2), gelu(erf) is evaluated in f32 with the
// same Abramowitz-Stegun 7.1.26 erf and rounded to bf16, and a * gelu(g)
// is rounded to bf16 (mul.rn.bf16x2) before the second product. No
// split-K: deterministic.
//
// Weights use torch's Linear layout: W1 (8C, C), W2 (C, 4C), row-major, so
// every operand is K-major and no transpose is needed. A tensor-parallel
// shard of the FF (parallel/tensor_parallel.py) passes its own inner width:
// W1 (2 inner, C) (its value rows, then its gate rows), W2 (C, inner); a
// ragged last column tile of either GEMM is masked as a ragged row tile is
// (GEMM-1's TMA stores write nothing past h's edge).

#include "hopper_common.cuh"

using namespace syn3r;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 128;       // rows of a consumer (two m64 wgmma halves)
constexpr int BMT = 2 * BM;   // rows of a block tile, shared by both
constexpr int BK = 64;        // K per stage: one 128-byte swizzle row
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int A_BYTES = BMT * BK * 2;
constexpr int GEGLU_BN = 128;  // GEMM-1 B tile: 64 a rows + 64 g rows
// GEMM-1's deferred epilogue is cut into this many slices, one after each
// of the first k-steps of the next tile: C = 320, the narrowest width and
// the one where the epilogue weighs most, has five k-steps of 64.
constexpr int SLICES = 5;

// Shared memory: the ring of STAGES (A, B) tile pairs, GEMM-1's staging
// tile of h (256 rows x 64 columns, 128-byte swizzled rows, 2 KB for each
// 16 rows of a warp), a full and an empty mbarrier a stage, then GEMM-1's
// order words (one a consumer warp, see after_issue).
template <bool GEGLU, int BN>
struct Cfg {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = (220 * 1024) / STAGE_BYTES;  // 4
  static constexpr int STAGING = GEGLU ? BMT * (BN / 2) * 2 : 0;
  static constexpr int ORDER = GEGLU ? 8 * 4 : 0;
  static constexpr int SMEM =
      1024 + STAGES * STAGE_BYTES + STAGING + 2 * STAGES * 8 + ORDER;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

template <int BN>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (BN == 128) {
    wgmma_m64n128k16_ss(d, a, b, scale_d);
  } else {
    static_assert(BN == 160, "N tile of 128 or 160");
    wgmma_m64n160k16_ss(d, a, b, scale_d);
  }
}

// 1 / d for d >= 1: the approximate reciprocal refined by one Newton step,
// within an ulp of the correctly rounded quotient and without the slow path
// of IEEE division, whose branch would split the epilogue's basic block.
__device__ __forceinline__ float recip(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(d));
  return fmaf(r, fmaf(-d, r, 1.0f), r);
}

__device__ __forceinline__ float gelu_erf(float x) {
  float z = x * 0.70710678118654752f;
  float az = fabsf(z);
  float t = recip(1.0f + 0.3275911f * az);
  float poly = t * (0.254829592f +
                    t * (-0.284496736f +
                         t * (1.421413741f +
                              t * (-1.453152027f + t * 1.061405429f))));
  float erf = copysignf(1.0f - poly * expf(-az * az), z);
  return 0.5f * x * (1.0f + erf);
}

// A zero the compiler cannot see through, read after the wgmmas issued
// before it: ptxas keeps the shared store behind those wgmmas (they read
// shared memory it cannot tell apart) and the volatile load behind the
// store, so the GELU arithmetic that takes the zero in stays behind them
// too. Without it ptxas hoists that arithmetic, which reads registers
// only, to the top of the tile loop, ahead of every wgmma of the tile.
__device__ __forceinline__ uint32_t after_issue(uint32_t word) {
  uint32_t z;
  asm volatile(
      "st.volatile.shared.u32 [%1], %2;\n"
      "ld.volatile.shared.u32 %0, [%1];\n"
      : "=r"(z)
      : "r"(word), "r"(0u)
      : "memory");
  return z;
}

// The consumer side of one k-step: waits for stage idx's tiles, then
// issues this consumer's wgmmas on them (its 128 rows of the A tile as two
// m64 halves) and commits them as one group.
template <bool GEGLU, int BN>
__device__ __forceinline__ void issue_kstep(float (&acc)[2][BN / 2],
                                            uint64_t* full,
                                            uint32_t smem_base, int idx,
                                            int cw, bool first) {
  using Cf = Cfg<GEGLU, BN>;
  const int s = idx % Cf::STAGES;
  mbar_wait(&full[s], (idx / Cf::STAGES) & 1);
  const uint32_t sa = smem_base + s * Cf::STAGE_BYTES;
  const uint64_t da = desc_kmajor(sa + cw * BM * BK * 2);
  const uint64_t db = desc_kmajor(sa + A_BYTES);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const int sc = (!first || kk > 0) ? 1 : 0;
    wgmma_ss<BN>(acc[0], da + 2 * kk, db + 2 * kk, sc);
    // rows 64..127 start 64 * 128 bytes further
    wgmma_ss<BN>(acc[1], da + 512 + 2 * kk, db + 2 * kk, sc);
  }
  wgmma_commit();
}

// Slice `sl` of GEMM-1's deferred epilogue: of a thread's 32 output pairs
// p = 4c + 2h + e (chunk c, half h, row group e) those with p * SLICES / 32
// == sl (7, 6, 7, 6 and 6 pairs; callers pass sl from unrolled loops, so
// the test folds away and every index is a register). pa and pg hold the
// pairs bf16(bf16(acc) + b) of a and g, each taken in XORed with z (0,
// from after_issue under the wgmmas); the pair bf16(a * bf16(gelu(g)))
// goes to the warp's staging rows: row 8e + g of its block h, at 16-byte
// chunk c ^ g (the 128-byte swizzle TMA reads), `stg` being the thread's
// address in block 0 at chunk 0 (so a warp's 32 stores of one pair hit 32
// banks).
__device__ __forceinline__ void geglu_slice(int sl, const uint32_t (&pa)[32],
                                            const uint32_t (&pg)[32],
                                            uint32_t stg, int g,
                                            uint32_t z) {
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    if (p * SLICES / 32 != sl) continue;
    const int c = p / 4, h = (p / 2) % 2, e = p % 2;
    const uint32_t av = pa[p] ^ z, gv = pg[p] ^ z;
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&av);
    const float2 gf =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv));
    // bf16(a * bf16(gelu(g))): the exact product, rounded once
    const __nv_bfloat162 res =
        __hmul2(a, __floats2bfloat162_rn(gelu_erf(gf.x), gelu_erf(gf.y)));
    st_shared_u32(stg + h * 4 * 2048 + e * 1024 + ((c ^ g) << 4),
                  *reinterpret_cast<const uint32_t*>(&res));
  }
}

// A warp's part of a finished tile of h: its two blocks of 16 rows (rows
// row and row + 64), 64 columns from col, stored by one TMA store each
// (rows and columns past h's edge are not written).
__device__ __forceinline__ void store_h(const CUtensorMap* tm_out,
                                        uint32_t stg_warp, int col, int row,
                                        int lane) {
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) {
    tma_store_2d(tm_out, stg_warp, col, row);
    tma_store_2d(tm_out, stg_warp + 4 * 2048, col, row + 64);
    bulk_commit();
  }
}

// The staging rows may be written again once the warp's last TMA store
// has read them.
__device__ __forceinline__ void staging_free(int lane) {
  if (lane == 0) bulk_wait_read<0>();
  __syncwarp();
}

// GEMM-2's consumer: out (M, N) = bf16(bf16(A . B^T) + b[n]), a tile's
// epilogue after its main loop (one bias add after a main loop 4x longer
// than GEMM-1's).
template <int BN>
__device__ __forceinline__ void plain_consumer(
    uint8_t* smem, uint64_t* full, uint64_t* empty,
    const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int N,
    int n_tiles, int tiles, int kt_n, int cw, int tid) {
  constexpr int STAGES = Cfg<false, BN>::STAGES;
  constexpr int TN = BN;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const uint32_t smem_base = smem_u32(smem);
  float acc[2][BN / 2];

  for (int j = 0; j < mine; ++j) {
    const int t = blockIdx.x + j * gridDim.x;
    const int m0 = (t / n_tiles) * BMT + BM * cw + warp * 16 + g;
    const int n0 = (t % n_tiles) * TN + 2 * q;
    for (int kt = 0; kt < kt_n; ++kt) {
      const int idx = j * kt_n + kt;
      issue_kstep<false, BN>(acc, full, smem_base, idx, cw, kt == 0);
      if (kt > 0) {
        wgmma_wait<1>();  // the previous stage's wgmmas are done
        mbar_arrive(&empty[(idx - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc[0]);
    fence_regs<BN / 2>(acc[1]);
    mbar_arrive(&empty[(j * kt_n + kt_n - 1) % STAGES]);

    // ---- epilogue: the values of a column chunk carry no branch, so the
    // compiler interleaves the independent chains; the stores are
    // predicated on the ragged row and column edges.
    bool row_ok[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) row_ok[h][e] = m0 + 64 * h + 8 * e < M;
#pragma unroll
    for (int c = 0; c < TN / 8; ++c) {
      const int col = n0 + 8 * c;
      // the products are rounded to bf16 pairs and the bias added with
      // add.rn.bf16x2: one rounding, as bf16(bf16(acc) + b)
      const __nv_bfloat162 ba =
          *reinterpret_cast<const __nv_bfloat162*>(bias + min(col, N - 2));
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const __nv_bfloat162 res = __hadd2(
              __floats2bfloat162_rn(acc[h][4 * c + 2 * e],
                                    acc[h][4 * c + 2 * e + 1]),
              ba);
          const uint32_t packed = *reinterpret_cast<const uint32_t*>(&res);
          // N is even, so a pair that starts inside the row ends inside it
          if (row_ok[h][e] && col < N)
            *reinterpret_cast<uint32_t*>(
                out + (size_t)(m0 + 64 * h + 8 * e) * N + col) = packed;
        }
    }
  }
}

// GEMM-1's consumer: h (M, N) = bf16(a + b[n]) * bf16(gelu(bf16(g +
// b[N+n]))), a tile's output columns n0..n0+63 taking B rows n0.. (a) and
// N+n0.. (g). A tile's epilogue is deferred: after its last wgmma_wait the
// thread only packs its 128 accumulators into 64 bf16 pairs (bias added);
// the GELU, the product and the staging writes of those pairs run in
// SLICES slices, each between the commit of one of the next tile's k-steps
// and its wgmma_wait<1>, so the tensor cores work on the next tile
// meanwhile; then each warp stores its rows by TMA. Slices past the last
// k-step of a short K run before the pack, still under that k-step's
// wgmmas; the block's last tile drains alone.
__device__ __forceinline__ void geglu_consumer(
    uint8_t* smem, uint64_t* full, uint64_t* empty,
    const CUtensorMap* tm_out, const bf16* __restrict__ bias, int N,
    int n_tiles, int tiles, int kt_n, int cw, int tid) {
  using Cf = Cfg<true, GEGLU_BN>;
  constexpr int BN = GEGLU_BN;
  constexpr int TN = BN / 2;   // output columns of a tile
  constexpr int GC = TN / 8;   // g's chunk is a's + GC
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const uint32_t smem_base = smem_u32(smem);
  // this warp's staging blocks 8 cw + warp (rows 16 warp ..) and + 4
  // (rows 64 + 16 warp ..), and this thread's place in them
  const uint32_t stg_warp =
      smem_base + Cf::STAGES * Cf::STAGE_BYTES + (cw * 8 + warp) * 2048;
  const uint32_t stg = stg_warp + g * 128 + 4 * q;
  const uint32_t order = smem_base + Cf::STAGES * Cf::STAGE_BYTES +
                         Cf::STAGING + 2 * Cf::STAGES * 8 +
                         (cw * 4 + warp) * 4;
  float acc[2][BN / 2];
  // the previous tile's pairs, p = 4c + 2h + e, and where its rows go
  uint32_t pa[32], pg[32];
#pragma unroll
  for (int p = 0; p < 32; ++p) pa[p] = pg[p] = 0u;
  int prev_col = 0, prev_row = 0;

  for (int j = 0; j < mine; ++j) {
    const int t = blockIdx.x + j * gridDim.x;
    const int row = (t / n_tiles) * BMT + BM * cw + warp * 16;
    const int col = (t % n_tiles) * TN;
    const int idx0 = j * kt_n;
    // k-steps 0..SLICES-1, each followed by a slice of the previous tile's
    // epilogue while its wgmmas run; the slices past a short K drain here
#pragma unroll
    for (int sl = 0; sl < SLICES; ++sl) {
      if (sl < kt_n)
        issue_kstep<true, BN>(acc, full, smem_base, idx0 + sl, cw, sl == 0);
      if (sl == 0) staging_free(lane);
      geglu_slice(sl, pa, pg, stg, g, after_issue(order));
      if (sl > 0 && sl < kt_n) {
        wgmma_wait<1>();  // the previous stage's wgmmas are done
        mbar_arrive(&empty[(idx0 + sl - 1) % Cf::STAGES]);
      }
    }
    if (j > 0) store_h(tm_out, stg_warp, prev_col, prev_row, lane);
    for (int kt = SLICES; kt < kt_n; ++kt) {
      issue_kstep<true, BN>(acc, full, smem_base, idx0 + kt, cw, false);
      wgmma_wait<1>();
      mbar_arrive(&empty[(idx0 + kt - 1) % Cf::STAGES]);
    }
    // this tile's bias pairs, loaded while its last wgmmas run (a ragged
    // column reads a valid pair; TMA does not store it)
    __nv_bfloat162 b_a[GC], b_g[GC];
#pragma unroll
    for (int c = 0; c < GC; ++c) {
      const int bc = min(col + 2 * q + 8 * c, N - 2);
      b_a[c] = *reinterpret_cast<const __nv_bfloat162*>(bias + bc);
      b_g[c] = *reinterpret_cast<const __nv_bfloat162*>(bias + N + bc);
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc[0]);
    fence_regs<BN / 2>(acc[1]);
    mbar_arrive(&empty[(idx0 + kt_n - 1) % Cf::STAGES]);

    // pack: the products rounded to bf16 pairs and the bias added with
    // add.rn.bf16x2, one rounding, as bf16(bf16(acc) + b)
#pragma unroll
    for (int p = 0; p < 32; ++p) {
      const int c = p / 4, h = (p / 2) % 2, e = p % 2;
      const __nv_bfloat162 va = __hadd2(
          __floats2bfloat162_rn(acc[h][4 * c + 2 * e],
                                acc[h][4 * c + 2 * e + 1]),
          b_a[c]);
      const __nv_bfloat162 vg = __hadd2(
          __floats2bfloat162_rn(acc[h][4 * (c + GC) + 2 * e],
                                acc[h][4 * (c + GC) + 2 * e + 1]),
          b_g[c]);
      pa[p] = *reinterpret_cast<const uint32_t*>(&va);
      pg[p] = *reinterpret_cast<const uint32_t*>(&vg);
    }
    prev_col = col;
    prev_row = row;
  }
  // the last tile's epilogue, with no wgmma to hide under
  if (mine > 0) {
    staging_free(lane);
#pragma unroll
    for (int sl = 0; sl < SLICES; ++sl) geglu_slice(sl, pa, pg, stg, g, 0u);
    store_h(tm_out, stg_warp, prev_col, prev_row, lane);
    if (lane == 0) bulk_wait<0>();
  }
}

// out = epilogue(A (M, K) . B^T), B's rows are output columns.
// GEGLU: B is W1 (2N, K), BN = GEGLU_BN (geglu_consumer), out is written
// through tm_out (boxes of 64 columns x 16 rows). Plain: B is (N, K)
// (plain_consumer), tm_out unused.
template <bool GEGLU, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_out,
                     const bf16* __restrict__ bias, bf16* __restrict__ out,
                     int M, int N, int K) {
  using Cf = Cfg<GEGLU, BN>;
  constexpr int STAGES = Cf::STAGES;
  constexpr int TN = GEGLU ? BN / 2 : BN;  // output columns of a tile
  static_assert(!GEGLU || BN == GEGLU_BN, "GEMM-1 takes GEGLU_BN");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + STAGES * Cf::STAGE_BYTES + Cf::STAGING);
  uint64_t* empty = full + STAGES;
  const int n_tiles = (N + TN - 1) / TN;
  const int tiles = n_tiles * ((M + BMT - 1) / BMT);
  const int kt_n = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every thread of both consumers
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load of the block
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_a);
      tma_prefetch_map(&tm_b);
      if constexpr (GEGLU) tma_prefetch_map(&tm_out);
      int idx = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * BMT;
        const int n0 = (t % n_tiles) * TN;
        for (int kt = 0; kt < kt_n; ++kt, ++idx) {
          const int s = idx % STAGES;
          mbar_wait(&empty[s], ((idx / STAGES) & 1) ^ 1);
          uint8_t* sa = smem + s * Cf::STAGE_BYTES;
          uint8_t* sb = sa + A_BYTES;
          mbar_arrive_expect_tx(&full[s], Cf::STAGE_BYTES);
          tma_load_2d(sa, &tm_a, &full[s], kt * BK, m0);
          if constexpr (GEGLU) {
            tma_load_2d(sb, &tm_b, &full[s], kt * BK, n0);
            tma_load_2d(sb + Cf::B_BYTES / 2, &tm_b, &full[s], kt * BK,
                        N + n0);
          } else {
            tma_load_2d(sb, &tm_b, &full[s], kt * BK, n0);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw takes rows 128 cw .. of every tile
    reg_alloc<232>();
    const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
    if constexpr (GEGLU)
      geglu_consumer(smem, full, empty, &tm_out, bias, N, n_tiles, tiles,
                     kt_n, cw, tid);
    else
      plain_consumer<BN>(smem, full, empty, bias, out, M, N, n_tiles, tiles,
                         kt_n, cw, tid);
  }
}

template <bool GEGLU, int BN>
cudaError_t launch_gemm(const CUtensorMap& tm_a, const CUtensorMap& tm_b,
                        const CUtensorMap& tm_out, const bf16* bias,
                        bf16* out, int M, int N, int K, int grid,
                        cudaStream_t stream) {
  static unsigned long long attr_set = 0;  // a bit per device
  constexpr int smem = Cfg<GEGLU, BN>::SMEM;
  cudaError_t err = allow_smem_per_device(ffn_wgmma_kernel<GEGLU, BN>, smem,
                                          attr_set);
  if (err != cudaSuccess) return err;
  ffn_wgmma_kernel<GEGLU, BN><<<grid, THREADS, smem, stream>>>(
      tm_a, tm_b, tm_out, bias, out, M, N, K);
  return cudaGetLastError();
}

// A 2-D map over a row-major bf16 (rows, cols) matrix, box (64, box_rows).
cudaError_t map_2d(CUtensorMap* map, const void* base, uint64_t rows,
                   uint64_t cols, uint32_t box_rows) {
  const uint64_t dims[2] = {cols, rows};
  const uint64_t strides[1] = {cols * 2};
  const uint32_t box[2] = {(uint32_t)BK, box_rows};
  return make_map_bf16(map, base, 2, dims, strides, box);
}

}  // namespace

// x (rows, c), w1 (2 inner, c), b1 (2 inner), w2 (c, inner), b2 (c), all
// bf16, contiguous and 16-byte aligned; h (rows, inner) is scratch for the
// gated product, y (rows, c) the output. inner is 4c for a whole FF and
// less for a tensor-parallel shard of its GEGLU units (w1's value rows then
// its gate rows, w2's matching columns); c and inner are multiples of 8
// (16-byte rows for TMA). bn2 is GEMM-2's N tile (128 or 160), grid1 and
// grid2 the persistent grids of the two GEMMs (see ops/geglu_ffn.py
// geglu_plan). Returns a cudaError_t (0 on success).
extern "C" int syn3r_geglu_ffn(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* h,
                               void* y, long long rows, int c, int inner,
                               int bn2, int grid1, int grid2, void* stream) {
  if (c <= 0 || c % 8 != 0 || inner <= 0 || inner % 8 != 0 || rows <= 0 ||
      rows >= (1ll << 31) || (bn2 != 128 && bn2 != 160) || grid1 <= 0 ||
      grid2 <= 0)
    return (int)cudaErrorInvalidValue;
  const int m = (int)rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tm_x, tm_w1, tm_hs, tm_h, tm_w2;
  cudaError_t err;
  if ((err = map_2d(&tm_x, x, rows, c, BMT)) != cudaSuccess ||
      (err = map_2d(&tm_w1, w1, 2ull * inner, c, GEGLU_BN / 2)) !=
          cudaSuccess ||
      (err = map_2d(&tm_hs, h, rows, inner, 16)) != cudaSuccess ||
      (err = map_2d(&tm_h, h, rows, inner, BMT)) != cudaSuccess ||
      (err = map_2d(&tm_w2, w2, c, inner, bn2)) != cudaSuccess)
    return (int)err;
  err = launch_gemm<true, GEGLU_BN>(tm_x, tm_w1, tm_hs,
                                    static_cast<const bf16*>(b1),
                                    static_cast<bf16*>(h), m, inner, c, grid1,
                                    s);
  if (err != cudaSuccess) return (int)err;
  if (bn2 == 160)
    err = launch_gemm<false, 160>(tm_h, tm_w2, tm_w2,
                                  static_cast<const bf16*>(b2),
                                  static_cast<bf16*>(y), m, c, inner, grid2,
                                  s);
  else
    err = launch_gemm<false, 128>(tm_h, tm_w2, tm_w2,
                                  static_cast<const bf16*>(b2),
                                  static_cast<bf16*>(y), m, c, inner, grid2,
                                  s);
  return (int)err;
}
