// Backward of exact softmax attention for the SVD UNet's spatial
// self-attention, written by hand for Hopper (sm_90a): two kernels, dQ and
// dK/dV, as the library splits it.
//
// Replaces: the Pallas TPU flash-attention backward that
// syn3r_tpu/models/layers.py `_attention` reaches when a gradient goes
// through the UNet (jax/experimental/pallas/ops/tpu/flash_attention.py,
// `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`).
//
// With P = exp(scale Q K^T - lse) (lse from the forward kernel, one f32 per
// query row) and D = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dK = scale dS^T Q,  dQ = scale dS K.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): the dkv kernel does four
// products of BH*S^2*64 (S^T, dP^T, dV, dK), the dq kernel three (S, dP,
// dQ), on six to eight bf16 (B, H, S, 64) tensors: S/3 operations a byte
// or more, so the tensor cores bound both (5.49 and 4.12 ms at B 25, H 5,
// S 9216). Each kernel also takes BH*S^2 exponentials, 2.7 ms at that
// shape on the special-function units (~3.9e12/s): half the dkv bound, two
// thirds of the dq bound. They and the dS arithmetic run on other units
// than the products, so one warpgroup's must run while another's products
// run.
//
// Design (the shape of the forward kernel, flash_attention.cu):
//   - Persistent blocks, one per SM, walk the work items (a 128-row tile of
//     one batch*head), the tiles of one batch*head fastest, so that the
//     blocks running together share that head's streamed tiles in L2.
//   - Warpgroup 0 is the producer: one thread TMA-loads the item's
//     resident tiles (128 rows) and streams 64-row stages through a ring of
//     STAGES buffers guarded by full/empty mbarriers. Every bf16 tile lands
//     under the 128-byte swizzle, so one tile serves as a K-major operand
//     and as an MN-major one: no transposed copy.
//   - Warpgroups 1 and 2 are consumers of 64 rows of the item each. Each
//     reads its rows of the resident tiles once an item into registers
//     (ldmatrix), where they stay as the A operand of the products that
//     start from them: every wgmma then reads only its B operand from
//     shared memory. At 64-wide products (m64n64k16) an A operand from
//     shared memory would double the shared-memory reads of those
//     products, and shared memory, not the tensor cores, would set the pace.
//   - dkv: an item is 128 keys (K, V resident); a stage is 64 queries (Q,
//     dO and their lse and D rows). Per stage a consumer forms S^T = K Q^T
//     and dP^T = V dO^T (wgmma RS, Q and dO K-major), P^T = exp2(S^T scale
//     log2e - lse log2e) and dS^T = P^T o (dP^T - D), and adds dV += P^T dO
//     and dK += dS^T Q (P^T and dS^T packed to bf16 in registers, dO and Q
//     MN-major).
//   - dq: an item is 128 queries (Q, dO and O resident); a stage is 64 keys
//     (K, V). A consumer first forms D = rowsum(dO o O) of its rows in f32
//     and stores it for the dkv kernel, which runs after this one (so D
//     costs no pass of its own); then per stage S = Q K^T, dP = dO V^T, P,
//     dS and dQ += dS K (K MN-major).
//   - Within a consumer, stage j's first two products are issued together
//     with stage j-1's accumulating ones, and the exponentials of stage j
//     run while the latter are on the tensor cores. The two consumers issue
//     in turns on two named barriers (ping-pong), so one's exponentials
//     also overlap the other's products.
//   - Tiles from registers (setmaxnreg: 240 a consumer thread, 24 the
//     producer's): at 64-row stages a dkv consumer thread holds K and V (16
//     words each), dV and dK (32 f32 each), S^T and dP^T (32 each), and P^T
//     and dS^T packed (16 each), ~190 before addresses and lse/D; 128-row
//     stages would double S^T and dP^T and pass 240. dq holds less.
//   - Every row of dQ, dK and dV has one owner and there are no atomics:
//     two calls agree bit for bit.
// Ragged S (576 = 4.5 x 128): TMA zero-fills rows >= S (so lse and D read
// as 0 there); P is set to 0 for queries >= S (dkv) and keys >= S (dq)
// explicitly, since a zero row still gives exp(0 - lse); rows >= S are
// never stored.
//
// Layout: q, k, v, dO and O each have their own 4-D tensor map (64, S, H,
// B) or (64, H, S, B) over a (B, H, S, 64) view, as the forward's, so the
// UNet's (B, S, H, 64) projections need no copy. lse and D are f32 rows of
// (B*H, ld), ld = S rounded up to 4 (a 2-D map each). The outputs are
// written through element strides.

#include <math.h>

#include "hopper_common.cuh"

using namespace syn3r;
using bf16 = __nv_bfloat16;

namespace {

constexpr int HD = 64;
constexpr int BR = 128;     // rows of a work item (64 a consumer)
constexpr int BS = 64;      // rows of a streamed stage
constexpr int STAGES = 6;
constexpr int THREADS = 384;
constexpr int TILE_R = BR * HD * 2;  // a resident bf16 tile
constexpr int TILE_S = BS * HD * 2;  // a streamed bf16 tile
constexpr int ROW_F32 = BS * 4;      // the lse or D values of a stage
// dkv: K and V resident; a stage holds Q, dO, lse and D (1024-byte steps)
constexpr int DKV_STAGE = 2 * TILE_S + 1024;
constexpr int DKV_TX = 2 * TILE_S + 2 * ROW_F32;
constexpr int DKV_SMEM =
    1024 + 2 * TILE_R + STAGES * DKV_STAGE + (2 + 2 * STAGES) * 8;
// dq: Q, dO and O resident; a stage holds K and V
constexpr int DQ_STAGE = 2 * TILE_S;
constexpr int DQ_SMEM =
    1024 + 3 * TILE_R + STAGES * DQ_STAGE + (2 + 2 * STAGES) * 8;
constexpr float LOG2E = 1.4426950408889634f;

struct Out {
  bf16* p;
  long long sb, sh, ss;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A box of rows of the (B, H, S, 64) view from row `row` of head h, batch b.
// s_dim is the map axis (1 or 2) that holds S.
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int s_dim, int row,
                                          int h, int b) {
  if (s_dim == 1)
    tma_load_4d(dst, map, bar, 0, row, h, b);
  else
    tma_load_4d(dst, map, bar, 0, h, row, b);
}

// A 64 x 64 accumulator as bf16 A fragments: chunks 2kk and 2kk + 1 form
// k16 step kk.
__device__ __forceinline__ void pack_a(const float (&c)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// d (64 x 64) = A (registers, 64 x 64) * T^T, T a K-major stage tile.
__device__ __forceinline__ void mma_rt(float (&d)[32], const uint32_t (&a)[4][4],
                                       uint32_t tile) {
  const uint64_t desc = desc_kmajor(tile);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_m64n64k16_rs(d, a[kk], desc + 2 * kk, kk > 0 ? 1 : 0);
}

// d (64 x 64) += A (registers, 64 x 64 over the stage's rows) * T, T the
// stage tile read MN-major.
__device__ __forceinline__ void mma_acc(float (&d)[32], const uint32_t (&a)[4][4],
                                        uint32_t tile) {
  const uint64_t desc = desc_mnmajor(tile);
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk)
    wgmma_m64n64k16_rs_mn(d, a[kk], desc + 128 * kk, 1);
}

// Rows row0 + g (+ 8) of a 64 x 64 accumulator, times `mul`, as bf16.
__device__ __forceinline__ void store_rows(const Out& o, int b, int h,
                                           int row0, int S, int g, int q,
                                           const float (&c)[32], float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
    bf16* p = o.p + b * o.sb + h * o.sh + (long long)row * o.ss;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j + 2 * q) =
          __floats2bfloat162_rn(c[4 * j + 2 * r] * mul,
                                c[4 * j + 2 * r + 1] * mul);
  }
}

// dkv, one stage in place: st (S^T, the consumer's 64 keys x 64 queries)
// becomes P^T and dp (dP^T) becomes dS^T; lse and D of the stage's queries
// from shared memory. Queries q0 + col >= S get P = 0.
__device__ __forceinline__ void dkv_probs(float (&st)[32], float (&dp)[32],
                                          const float* s_lse,
                                          const float* s_d, int q0, int S,
                                          int q, float scale_log2) {
  const bool ragged = q0 + BS > S;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 l = *reinterpret_cast<const float2*>(s_lse + 8 * c + 2 * q);
    const float2 d = *reinterpret_cast<const float2*>(s_d + 8 * c + 2 * q);
    const float nl[2] = {-l.x * LOG2E, -l.y * LOG2E};
    const float dd[2] = {d.x, d.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(st[4 * c + e], scale_log2, nl[e & 1]));
      if (ragged && q0 + 8 * c + 2 * q + (e & 1) >= S) p = 0.0f;
      st[4 * c + e] = p;
      dp[4 * c + e] = p * (dp[4 * c + e] - dd[e & 1]);
    }
  }
}

// dq, one stage in place: s (S, the consumer's 64 queries x 64 keys)
// becomes P and dp (dP) becomes dS; nl2 = -lse log2e of the thread's two
// rows (-inf past S), dd their D. Keys k0 + col >= S get P = 0.
__device__ __forceinline__ void dq_probs(float (&s)[32], float (&dp)[32],
                                         const float (&nl2)[2],
                                         const float (&dd)[2], int k0, int S,
                                         int q, float scale_log2) {
  const bool ragged = k0 + BS > S;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(s[4 * c + e], scale_log2, nl2[e >> 1]));
      if (ragged && k0 + 8 * c + 2 * q + (e & 1) >= S) p = 0.0f;
      dp[4 * c + e] = p * (dp[4 * c + e] - dd[e >> 1]);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_lse,
                         const __grid_constant__ CUtensorMap tm_d, int sd_q,
                         int sd_k, int sd_v, int sd_do, Out dk, Out dv, int H,
                         int S, int BH, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* s_k = smem;
  uint8_t* s_v = smem + TILE_R;
  uint8_t* s_st = smem + 2 * TILE_R;
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_st + STAGES * DKV_STAGE);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = full + STAGES;
  const int n_kt = (S + BR - 1) / BR;
  const int n_qs = (S + BS - 1) / BS;
  const int items = n_kt * BH;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 256);  // both consumers, once K and V are read
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // both consumers, after their dV and dK
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      tma_prefetch_map(&tm_do);
      tma_prefetch_map(&tm_lse);
      tma_prefetch_map(&tm_d);
      int st = 0, it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int bh = item / n_kt;
        const int kt = item - bh * n_kt;
        const int b = bh / H, h = bh - (bh / H) * H;
        mbar_wait(kv_empty, (it & 1) ^ 1);
        mbar_arrive_expect_tx(kv_full, 2 * TILE_R);
        load_rows(s_k, &tm_k, kv_full, sd_k, kt * BR, h, b);
        load_rows(s_v, &tm_v, kv_full, sd_v, kt * BR, h, b);
        for (int j = 0; j < n_qs; ++j, ++st) {
          const int s = st % STAGES;
          mbar_wait(&empty[s], ((st / STAGES) & 1) ^ 1);
          uint8_t* p = s_st + s * DKV_STAGE;
          mbar_arrive_expect_tx(&full[s], DKV_TX);
          load_rows(p, &tm_q, &full[s], sd_q, j * BS, h, b);
          load_rows(p + TILE_S, &tm_do, &full[s], sd_do, j * BS, h, b);
          tma_load_2d(p + 2 * TILE_S, &tm_lse, &full[s], j * BS, bh);
          tma_load_2d(p + 2 * TILE_S + ROW_F32, &tm_d, &full[s], j * BS, bh);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns keys 64 cw .. 64 cw + 63 of an item
    reg_alloc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, q = lane % 4;
    const float scale_log2 = scale * LOG2E;
    const uint32_t st_base = smem_u32(s_st);
    int st = 0, it = 0;

    // Barrier 1 + cw: "consumer cw may issue its products".
    if (cw == 1) named_bar_arrive(1, 256);
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int bh = item / n_kt;
      const int kt = item - bh * n_kt;
      const int b = bh / H, h = bh - (bh / H) * H;
      uint32_t ka[4][4], va[4][4];
      mbar_wait(kv_full, it & 1);
      ldsm_a_sw128(ka, smem_u32(s_k), cw * 64 + warp * 16, lane);
      ldsm_a_sw128(va, smem_u32(s_v), cw * 64 + warp * 16, lane);
      mbar_arrive(kv_empty);
      float dk_acc[32], dv_acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

      uint32_t pa[4][4], dsa[4][4];  // P^T and dS^T of the previous stage
      // the first stage: S^T and dP^T alone
      int s_prev = st % STAGES;
      mbar_wait(&full[s_prev], (st / STAGES) & 1);
      uint32_t t_prev = st_base + s_prev * DKV_STAGE;
      {
        float sacc[32], dpacc[32];
        named_bar_sync(1 + cw, 256);
        wgmma_fence();
        mma_rt(sacc, ka, t_prev);
        mma_rt(dpacc, va, t_prev + TILE_S);
        wgmma_commit();
        named_bar_arrive(2 - cw, 256);
        wgmma_wait<0>();
        fence_regs<32>(sacc);
        fence_regs<32>(dpacc);
        const float* f = reinterpret_cast<const float*>(
            s_st + s_prev * DKV_STAGE + 2 * TILE_S);
        dkv_probs(sacc, dpacc, f, f + BS, 0, S, q, scale_log2);
        pack_a(sacc, pa);
        pack_a(dpacc, dsa);
      }
      ++st;
      for (int j = 1; j < n_qs; ++j, ++st) {
        const int s = st % STAGES;
        mbar_wait(&full[s], (st / STAGES) & 1);
        const uint32_t t = st_base + s * DKV_STAGE;

        // S^T = K Q^T and dP^T = V dO^T of this stage and, behind them, dV
        // and dK of the previous one: this stage's exponentials overlap the
        // latter.
        float sacc[32], dpacc[32];
        named_bar_sync(1 + cw, 256);
        wgmma_fence();
        mma_rt(sacc, ka, t);
        mma_rt(dpacc, va, t + TILE_S);
        wgmma_commit();
        mma_acc(dv_acc, pa, t_prev + TILE_S);  // dV += P^T dO
        mma_acc(dk_acc, dsa, t_prev);          // dK += dS^T Q
        wgmma_commit();
        named_bar_arrive(2 - cw, 256);
        wgmma_wait<1>();  // S^T and dP^T are done; dV and dK may still run
        fence_regs<32>(sacc);
        fence_regs<32>(dpacc);
        const float* f =
            reinterpret_cast<const float*>(s_st + s * DKV_STAGE + 2 * TILE_S);
        dkv_probs(sacc, dpacc, f, f + BS, j * BS, S, q, scale_log2);
        wgmma_wait<0>();
        fence_regs<32>(dv_acc);
        fence_regs<32>(dk_acc);
        fence_regs_u32<16>(&pa[0][0]);  // P^T and dS^T stay put until then
        fence_regs_u32<16>(&dsa[0][0]);
        mbar_arrive(&empty[s_prev]);
        pack_a(sacc, pa);
        pack_a(dpacc, dsa);
        s_prev = s;
        t_prev = t;
      }
      // dV and dK of the last stage
      named_bar_sync(1 + cw, 256);
      wgmma_fence();
      mma_acc(dv_acc, pa, t_prev + TILE_S);
      mma_acc(dk_acc, dsa, t_prev);
      wgmma_commit();
      named_bar_arrive(2 - cw, 256);
      wgmma_wait<0>();
      fence_regs<32>(dv_acc);
      fence_regs<32>(dk_acc);
      fence_regs_u32<16>(&pa[0][0]);
      fence_regs_u32<16>(&dsa[0][0]);
      mbar_arrive(&empty[s_prev]);

      const int row0 = kt * BR + cw * 64 + warp * 16;
      store_rows(dk, b, h, row0, S, g, q, dk_acc, scale);
      store_rows(dv, b, h, row0, S, g, q, dv_acc, 1.0f);
    }
    if (cw == 0) named_bar_sync(1, 256);  // consumer 1's last hand-over
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_o, int sd_q,
                        int sd_k, int sd_v, int sd_do, int sd_o,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, int ld, Out dq, int H,
                        int S, int BH, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* s_q = smem;
  uint8_t* s_do = smem + TILE_R;
  uint8_t* s_o = smem + 2 * TILE_R;
  uint8_t* s_st = smem + 3 * TILE_R;
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_st + STAGES * DQ_STAGE);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = full + STAGES;
  const int n_qt = (S + BR - 1) / BR;
  const int n_ks = (S + BS - 1) / BS;
  const int items = n_qt * BH;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);  // both consumers, once Q, dO and O are read
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // both consumers, after their dQ
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      tma_prefetch_map(&tm_do);
      tma_prefetch_map(&tm_o);
      int st = 0, it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int bh = item / n_qt;
        const int qt = item - bh * n_qt;
        const int b = bh / H, h = bh - (bh / H) * H;
        mbar_wait(q_empty, (it & 1) ^ 1);
        mbar_arrive_expect_tx(q_full, 3 * TILE_R);
        load_rows(s_q, &tm_q, q_full, sd_q, qt * BR, h, b);
        load_rows(s_do, &tm_do, q_full, sd_do, qt * BR, h, b);
        load_rows(s_o, &tm_o, q_full, sd_o, qt * BR, h, b);
        for (int j = 0; j < n_ks; ++j, ++st) {
          const int s = st % STAGES;
          mbar_wait(&empty[s], ((st / STAGES) & 1) ^ 1);
          uint8_t* p = s_st + s * DQ_STAGE;
          mbar_arrive_expect_tx(&full[s], DQ_STAGE);
          load_rows(p, &tm_k, &full[s], sd_k, j * BS, h, b);
          load_rows(p + TILE_S, &tm_v, &full[s], sd_v, j * BS, h, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns queries 64 cw .. 64 cw + 63
    reg_alloc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, q = lane % 4;
    const float scale_log2 = scale * LOG2E;
    const uint32_t st_base = smem_u32(s_st);
    int st = 0, it = 0;

    if (cw == 1) named_bar_arrive(1, 256);
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int bh = item / n_qt;
      const int qt = item - bh * n_qt;
      const int b = bh / H, h = bh - (bh / H) * H;
      const int row0 = qt * BR + cw * 64 + warp * 16;
      uint32_t qa[4][4], doa[4][4];
      float dd[2] = {0.0f, 0.0f}, nl2[2];
      mbar_wait(q_full, it & 1);
      ldsm_a_sw128(qa, smem_u32(s_q), cw * 64 + warp * 16, lane);
      ldsm_a_sw128(doa, smem_u32(s_do), cw * 64 + warp * 16, lane);
      {
        // D = rowsum(dO o O) of rows g and g + 8: a[kk][i] holds row
        // g + 8 (i % 2); the quad's four threads hold the 64 columns.
        uint32_t oa[4][4];
        ldsm_a_sw128(oa, smem_u32(s_o), cw * 64 + warp * 16, lane);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&doa[kk][i]));
            const float2 y = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&oa[kk][i]));
            dd[i & 1] = fmaf(x.x, y.x, fmaf(x.y, y.y, dd[i & 1]));
          }
      }
      mbar_arrive(q_empty);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 1);
        dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 2);
        const int row = row0 + g + 8 * r;
        const long long at = (long long)bh * ld + row;
        nl2[r] = row < S ? -lse[at] * LOG2E : -INFINITY;
        if (row < S && q == 0) delta[at] = dd[r];
      }
      float dq_acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq_acc[i] = 0.0f;

      uint32_t dsa[4][4];  // dS of the previous stage
      int s_prev = st % STAGES;
      mbar_wait(&full[s_prev], (st / STAGES) & 1);
      uint32_t t_prev = st_base + s_prev * DQ_STAGE;
      {
        float sacc[32], dpacc[32];
        named_bar_sync(1 + cw, 256);
        wgmma_fence();
        mma_rt(sacc, qa, t_prev);
        mma_rt(dpacc, doa, t_prev + TILE_S);
        wgmma_commit();
        named_bar_arrive(2 - cw, 256);
        wgmma_wait<0>();
        fence_regs<32>(sacc);
        fence_regs<32>(dpacc);
        dq_probs(sacc, dpacc, nl2, dd, 0, S, q, scale_log2);
        pack_a(dpacc, dsa);
      }
      ++st;
      for (int j = 1; j < n_ks; ++j, ++st) {
        const int s = st % STAGES;
        mbar_wait(&full[s], (st / STAGES) & 1);
        const uint32_t t = st_base + s * DQ_STAGE;

        // S = Q K^T and dP = dO V^T of this stage and, behind them, dQ of
        // the previous one.
        float sacc[32], dpacc[32];
        named_bar_sync(1 + cw, 256);
        wgmma_fence();
        mma_rt(sacc, qa, t);
        mma_rt(dpacc, doa, t + TILE_S);
        wgmma_commit();
        mma_acc(dq_acc, dsa, t_prev);  // dQ += dS K
        wgmma_commit();
        named_bar_arrive(2 - cw, 256);
        wgmma_wait<1>();
        fence_regs<32>(sacc);
        fence_regs<32>(dpacc);
        dq_probs(sacc, dpacc, nl2, dd, j * BS, S, q, scale_log2);
        wgmma_wait<0>();
        fence_regs<32>(dq_acc);
        fence_regs_u32<16>(&dsa[0][0]);
        mbar_arrive(&empty[s_prev]);
        pack_a(dpacc, dsa);
        s_prev = s;
        t_prev = t;
      }
      named_bar_sync(1 + cw, 256);
      wgmma_fence();
      mma_acc(dq_acc, dsa, t_prev);
      wgmma_commit();
      named_bar_arrive(2 - cw, 256);
      wgmma_wait<0>();
      fence_regs<32>(dq_acc);
      fence_regs_u32<16>(&dsa[0][0]);
      mbar_arrive(&empty[s_prev]);

      store_rows(dq, b, h, row0, S, g, q, dq_acc, scale);
    }
    if (cw == 0) named_bar_sync(1, 256);
  }
}

// The tensor maps of n (B, H, S, 64) views from 12 values each of `geom`
// (ops/attention.py flash_tensor_map): dims (64, X, Y, B), byte strides of
// X, Y, B, the box (64 and rows[i] rows of S), the axis that holds S.
cudaError_t read_maps(CUtensorMap* maps, int* s_dims, const void* const* bases,
                      const long long* geom, const int* rows, int n) {
  for (int i = 0; i < n; ++i) {
    const long long* gm = geom + 12 * i;
    const int sd = (int)gm[11];
    if (gm[0] != HD || (sd != 1 && sd != 2) || gm[7] != HD ||
        gm[7 + sd] != rows[i] || gm[10 - sd] != 1 || gm[10] != 1)
      return cudaErrorInvalidValue;
    const uint64_t dims[4] = {(uint64_t)gm[0], (uint64_t)gm[1],
                              (uint64_t)gm[2], (uint64_t)gm[3]};
    const uint64_t strides[3] = {(uint64_t)gm[4], (uint64_t)gm[5],
                                 (uint64_t)gm[6]};
    const uint32_t box[4] = {(uint32_t)gm[7], (uint32_t)gm[8],
                             (uint32_t)gm[9], (uint32_t)gm[10]};
    cudaError_t err = make_map_bf16(&maps[i], bases[i], 4, dims, strides, box);
    if (err != cudaSuccess) return err;
    s_dims[i] = sd;
  }
  return cudaSuccess;
}

bool bad_args(int B, int H, int S, int ld, int grid) {
  return B <= 0 || H <= 0 || S <= 0 || grid <= 0 || ld < S || ld % 4 != 0 ||
         (long long)B * H * ((S + BS - 1) / BS) >= (1ll << 31);
}

Out out_of(void* p, const long long* s) {
  return Out{static_cast<bf16*>(p), s[0], s[1], s[2]};
}

}  // namespace

// dK and dV. q, k, v, dout: bf16 (B, H, S, 64) views, each described by 12
// values of `geom` (boxes of 64 rows for q and dout, 128 for k and v); lse
// and delta: f32 (B*H, ld), delta as the dq kernel wrote it; dk, dv: bf16
// outputs through element strides `ostr` (sb, sh, ss of dk, then of dv);
// grid: the persistent grid. Returns a cudaError_t (0 on success).
extern "C" int syn3r_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv,
                                   const long long* geom,
                                   const long long* ostr, int B, int H, int S,
                                   int ld, float scale, int grid,
                                   void* stream) {
  if (bad_args(B, H, S, ld, grid)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[6];
  int s_dims[4];
  const void* bases[4] = {q, k, v, dout};
  const int rows[4] = {BS, BR, BR, BS};
  cudaError_t err = read_maps(maps, s_dims, bases, geom, rows, 4);
  if (err == cudaSuccess)
    err = make_map_f32_rows(&maps[4], lse, S, (uint64_t)B * H, ld, BS);
  if (err == cudaSuccess)
    err = make_map_f32_rows(&maps[5], delta, S, (uint64_t)B * H, ld, BS);
  static unsigned long long attr_set = 0;  // a bit per device
  if (err == cudaSuccess)
    err = allow_smem_per_device(flash_bwd_dkv_kernel, DKV_SMEM, attr_set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<<<grid, THREADS, DKV_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], s_dims[0],
      s_dims[1], s_dims[2], s_dims[3], out_of(dk, ostr), out_of(dv, ostr + 3),
      H, S, B * H, scale);
  return (int)cudaGetLastError();
}

// dQ, and D = rowsum(dout o out) into delta. q, k, v, dout, out: bf16
// (B, H, S, 64) views, each described by 12 values of `geom` (boxes of 128
// rows for q, dout and out, 64 for k and v); lse and delta: f32 (B*H, ld);
// dq: bf16 output through element strides `ostr` (sb, sh, ss). Returns a
// cudaError_t (0 on success).
extern "C" int syn3r_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* out,
                                  const float* lse, float* delta, void* dq,
                                  const long long* geom,
                                  const long long* ostr, int B, int H, int S,
                                  int ld, float scale, int grid,
                                  void* stream) {
  if (bad_args(B, H, S, ld, grid)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[5];
  int s_dims[5];
  const void* bases[5] = {q, k, v, dout, out};
  const int rows[5] = {BR, BS, BS, BR, BR};
  cudaError_t err = read_maps(maps, s_dims, bases, geom, rows, 5);
  static unsigned long long attr_set = 0;  // a bit per device
  if (err == cudaSuccess)
    err = allow_smem_per_device(flash_bwd_dq_kernel, DQ_SMEM, attr_set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<<<grid, THREADS, DQ_SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], s_dims[0], s_dims[1],
      s_dims[2], s_dims[3], s_dims[4], lse, delta, ld, out_of(dq, ostr), H, S,
      B * H, scale);
  return (int)cudaGetLastError();
}
