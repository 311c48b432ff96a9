// Exact softmax attention for the SVD UNet's spatial self-attention,
// written by hand for Hopper (sm_90a).
//
// Replaces: the Pallas TPU flash attention that syn3r_tpu/models/layers.py
// `_attention` calls (`jax.experimental.pallas.ops.tpu.flash_attention`,
// layers.py:185-206 with tuned blocks, and layers.py:207-232 where the
// 576-token level is zero-padded to 640 and masked with segment ids).
//
// Bound on the H100: at the main path's shapes (B*H = 75*{5,10,20},
// S = {9216, 2304, 576}, d = 64, bf16) the two products do 4*BH*S^2*d
// operations on 8*BH*S*d bytes, i.e. S/2 operations per byte, so the tensor
// cores bound it (47 ms a UNet forward). At d = 64 the BH*S^2 exponentials
// take about as long on the special-function units (~3.9 TFLOP/s), so the
// softmax of one warpgroup has to run while the other's products run. The
// S x S logits (42 GB at the top level) never reach device memory.
//
// Design (FlashAttention-3 order, Shah et al. 2024):
//   - Persistent blocks, one per SM, walk the work items (128-row query
//     tile, batch*head), query tiles fastest so that the blocks running
//     together share K and V in L2.
//   - Warpgroup 0 is the producer: one thread TMA-loads the item's Q tile
//     (128 x 64) and its K and V tiles (192 keys x 64 each: 576, 2304 and
//     9216 are multiples of 192) into a ring of 3 stages, guarded by
//     full/empty mbarriers (Q has its own pair).
//   - Warpgroups 1 and 2 are consumers of 64 query rows each: S = Q K^T
//     with wgmma m64n192k16 (Q and K from the swizzled shared tiles),
//     online softmax in f32 with exp2 and the scale folded into one FMA,
//     P packed to bf16 in registers, and O += P V with wgmma m64n64k16
//     taking P from registers and V as the MN-major B operand.
//   - Within a consumer, tile j's S = Q K^T is issued together with tile
//     j-1's O += P V, and the softmax of tile j runs while P V is still on
//     the tensor cores (P stays in registers until it is done).
//   - Ping-pong on two named barriers: the consumers issue their products
//     in turns, handing the turn over as soon as their wgmmas are issued,
//     so one warpgroup's softmax overlaps the other's products.
// Keys >= S of a ragged last tile get -inf in the kernel (TMA zero-fills
// them, and a zero key would still get logit 0); query rows >= S are
// zero-filled on load and never stored.
//
// Where a gradient will be taken the kernel also writes each query row's
// log-sum-exp, lse = scale * max + ln(sum), as f32 (B, H, S): the backward
// kernels (flash_attention_bwd.cu) recompute P = exp(scale q k - lse) from
// it, as the library's backward does from the forward's residuals l and m.
// Without a gradient lse is null and nothing more is written.
//
// Layout: each of q, k, v has its own 4-D tensor map (64, S, H, B) or
// (64, H, S, B), the two middle axes in order of their strides, over a
// (B, H, S, 64) view with a contiguous head dimension, so the UNet's
// (B, S, H, 64) projections need no transpose copy. o has its own element
// strides.

#include <math.h>

#include "hopper_common.cuh"

using namespace syn3r;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 128;   // query rows of a work item (64 a consumer)
constexpr int BKV = 192;  // keys of a K/V stage
constexpr int HD = 64;
constexpr int STAGES = 3;
constexpr int THREADS = 384;
constexpr int Q_BYTES = BQ * HD * 2;
constexpr int KV_BYTES = BKV * HD * 2;
constexpr int STAGE_BYTES = 2 * KV_BYTES;
constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + (2 + 2 * STAGES) * 8;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one S tile in place (scores -> unnormalised P):
// updates the running row max m_i and sum l_i and returns in alpha the
// factors that rescale O. Keys >= S get -inf. Rows: r = 0 is row g
// (e = 0, 1), r = 1 is row g + 8; every key tile holds a valid key, so the
// new max is finite.
__device__ __forceinline__ void online_softmax(float (&sacc)[96],
                                               float (&m_i)[2],
                                               float (&l_i)[2],
                                               float (&alpha)[2], int kbase,
                                               int S, int q,
                                               float scale_log2) {
  if (kbase + BKV > S) {
#pragma unroll
    for (int c = 0; c < 24; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kbase + 8 * c + 2 * q + (e & 1) >= S) sacc[4 * c + e] = -INFINITY;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m_i[r];
#pragma unroll
    for (int c = 0; c < 24; ++c)
      mx = fmaxf(mx, fmaxf(sacc[4 * c + 2 * r], sacc[4 * c + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float ms = mx * scale_log2;
    alpha[r] = ex2(m_i[r] * scale_log2 - ms);
    m_i[r] = mx;
    float rs = 0.0f;
#pragma unroll
    for (int c = 0; c < 24; ++c) {
      const float p0 = ex2(fmaf(sacc[4 * c + 2 * r], scale_log2, -ms));
      const float p1 = ex2(fmaf(sacc[4 * c + 2 * r + 1], scale_log2, -ms));
      sacc[4 * c + 2 * r] = p0;
      sacc[4 * c + 2 * r + 1] = p1;
      rs += p0 + p1;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_i[r] = l_i[r] * alpha[r] + rs;
  }
}

// P as bf16 A fragments: key chunks 2kk and 2kk + 1 form k16 step kk.
__device__ __forceinline__ void pack_p(const float (&p)[96],
                                       uint32_t (&pa)[12][4]) {
#pragma unroll
  for (int kk = 0; kk < 12; ++kk) {
    pa[kk][0] = pack_bf16x2(p[8 * kk + 0], p[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(p[8 * kk + 2], p[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(p[8 * kk + 4], p[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(p[8 * kk + 6], p[8 * kk + 7]);
  }
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

__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, int sd_q,
                       int sd_k, int sd_v, bf16* __restrict__ o,
                       float* __restrict__ lse, int H, int S,
                       int BH, long long osb, long long osh, long long oss,
                       float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* s_q = smem;
  uint8_t* s_kv = smem + Q_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_kv + STAGES * STAGE_BYTES);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = full + STAGES;
  const int n_qt = (S + BQ - 1) / BQ;
  const int nkv = (S + BKV - 1) / BKV;
  const int items = n_qt * BH;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);  // both consumers, after their last Q K^T
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // both consumers, after their P V
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      int kv = 0, it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int bh = item / n_qt;
        const int qt = item - bh * n_qt;
        const int b = bh / H, h = bh - (bh / H) * H;
        mbar_wait(q_empty, (it & 1) ^ 1);
        mbar_arrive_expect_tx(q_full, Q_BYTES);
        load_rows(s_q, &tm_q, q_full, sd_q, qt * BQ, h, b);
        for (int j = 0; j < nkv; ++j, ++kv) {
          const int s = kv % STAGES;
          mbar_wait(&empty[s], ((kv / STAGES) & 1) ^ 1);
          uint8_t* sk = s_kv + s * STAGE_BYTES;
          mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          load_rows(sk, &tm_k, &full[s], sd_k, j * BKV, h, b);
          load_rows(sk + KV_BYTES, &tm_v, &full[s], sd_v, j * BKV, h, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows 64 cw .. 64 cw + 63
    reg_alloc<232>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, q = lane % 4;
    const uint64_t dq = desc_kmajor(smem_u32(s_q) + cw * (64 * 128));
    const uint32_t kv_base = smem_u32(s_kv);
    int kv = 0, it = 0;

    // Barrier 1 + cw: "consumer cw may issue its products".
    if (cw == 1) named_bar_arrive(1, 256);
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int bh = item / n_qt;
      const int qt = item - bh * n_qt;
      const int b = bh / H, h = bh - (bh / H) * H;
      float o_acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[i] = 0.0f;
      float m_i[2] = {-INFINITY, -INFINITY};
      float l_i[2] = {0.0f, 0.0f};
      mbar_wait(q_full, it & 1);

      uint32_t pa[12][4];  // P of the previous tile, as bf16 A fragments
      float alpha[2];
      // the first tile: S = Q K^T alone
      int s_prev = kv % STAGES;
      mbar_wait(&full[s_prev], (kv / STAGES) & 1);
      uint32_t sk = kv_base + s_prev * STAGE_BYTES;
      {
        float sacc[96];
        named_bar_sync(1 + cw, 256);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_m64n192k16_ss(sacc, dq + 2 * kk, desc_kmajor(sk) + 2 * kk,
                              kk > 0 ? 1 : 0);
        wgmma_commit();
        named_bar_arrive(2 - cw, 256);
        wgmma_wait<0>();
        fence_regs<96>(sacc);
        if (nkv == 1) mbar_arrive(q_empty);
        online_softmax(sacc, m_i, l_i, alpha, 0, S, q, scale_log2);
        pack_p(sacc, pa);
      }
      uint64_t dv_prev = desc_mnmajor(sk + KV_BYTES);
      ++kv;
      for (int j = 1; j < nkv; ++j, ++kv) {
        const int s = kv % STAGES;
        mbar_wait(&full[s], (kv / STAGES) & 1);
        sk = kv_base + s * STAGE_BYTES;
        const uint64_t dk = desc_kmajor(sk);

        // S = Q K^T (64 query rows x 192 keys) and, behind it, O += P V of
        // the previous tile: the softmax of this tile overlaps the latter.
        float sacc[96];
        named_bar_sync(1 + cw, 256);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_m64n192k16_ss(sacc, dq + 2 * kk, dk + 2 * kk, kk > 0 ? 1 : 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_m64n64k16_rs_mn(o_acc, pa[kk], dv_prev + 128 * kk, 1);
        wgmma_commit();
        named_bar_arrive(2 - cw, 256);
        wgmma_wait<1>();  // S is done; P V may still run
        fence_regs<96>(sacc);
        if (j == nkv - 1) mbar_arrive(q_empty);
        online_softmax(sacc, m_i, l_i, alpha, j * BKV, S, q, scale_log2);
        wgmma_wait<0>();
        fence_regs<32>(o_acc);
        fence_regs_u32<48>(&pa[0][0]);  // P stays put until P V is done
        mbar_arrive(&empty[s_prev]);
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o_acc[4 * c + e] *= alpha[e / 2];
        pack_p(sacc, pa);
        s_prev = s;
        dv_prev = desc_mnmajor(sk + KV_BYTES);
      }
      // O += P V of the last tile
      named_bar_sync(1 + cw, 256);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_m64n64k16_rs_mn(o_acc, pa[kk], dv_prev + 128 * kk, 1);
      wgmma_commit();
      named_bar_arrive(2 - cw, 256);
      wgmma_wait<0>();
      fence_regs<32>(o_acc);
      fence_regs_u32<48>(&pa[0][0]);
      mbar_arrive(&empty[s_prev]);

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qt * BQ + cw * 64 + warp * 16 + g + 8 * r;
        if (row >= S) continue;
        const float inv = 1.0f / l_i[r];
        if (lse != nullptr && q == 0)
          lse[(size_t)bh * S + row] =
              (m_i[r] * scale_log2 + log2f(l_i[r])) * 0.6931471805599453f;
        bf16* orow = o + (size_t)b * osb + (size_t)h * osh + (size_t)row * oss;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + 2 * q) =
              __floats2bfloat162_rn(o_acc[4 * c + 2 * r] * inv,
                                    o_acc[4 * c + 2 * r + 1] * inv);
      }
    }
    if (cw == 0) named_bar_sync(1, 256);  // consumer 1's last hand-over
  }
}

}  // namespace

// q, k, v: bf16 (B, H, S, 64) views, each described by 12 values of `geom`
// (see ops/attention.py flash_tensor_map): the map's dims (64, X, Y, B),
// its byte strides of X, Y and B, its box (64 and BQ rows of S for q, BKV
// for k and v) and the axis (1 or 2) that holds S. o is
// written through element strides (osb, osh, oss) with a contiguous last
// axis. lse, if not null, receives the f32 (B, H, S) log-sum-exp of each
// row. grid is the persistent grid (min(items, SMs)). Returns a
// cudaError_t (0 on success).
extern "C" int syn3r_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     const long long* geom, int B, int H,
                                     int S, long long osb, long long osh,
                                     long long oss, float scale, int grid,
                                     void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || grid <= 0 ||
      (long long)B * H * ((S + BQ - 1) / BQ) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  int s_dims[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const long long* gm = geom + 12 * i;
    const int sd = (int)gm[11];
    if (gm[0] != HD || (sd != 1 && sd != 2) || gm[7] != HD ||
        gm[7 + sd] != (i == 0 ? BQ : BKV) || gm[10 - sd] != 1 || gm[10] != 1)
      return (int)cudaErrorInvalidValue;
    const uint64_t dims[4] = {(uint64_t)gm[0], (uint64_t)gm[1],
                              (uint64_t)gm[2], (uint64_t)gm[3]};
    const uint64_t strides[3] = {(uint64_t)gm[4], (uint64_t)gm[5],
                                 (uint64_t)gm[6]};
    const uint32_t box[4] = {(uint32_t)gm[7], (uint32_t)gm[8],
                             (uint32_t)gm[9], (uint32_t)gm[10]};
    cudaError_t err = make_map_bf16(&maps[i], bases[i], 4, dims, strides, box);
    if (err != cudaSuccess) return (int)err;
    s_dims[i] = sd;
  }
  static unsigned long long attr_set = 0;  // a bit per device
  cudaError_t err = allow_smem_per_device(flash_wgmma_kernel, SMEM, attr_set);
  if (err != cudaSuccess) return (int)err;
  flash_wgmma_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], s_dims[0], s_dims[1], s_dims[2],
      static_cast<bf16*>(o), lse, H, S, B * H, osb, osh, oss,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
