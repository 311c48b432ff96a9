// Exact softmax attention over the frames of the SVD UNet's temporal
// self-attention (attn1 of each TemporalBasicTransformerBlock), written by
// hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this path to XLA
// (syn3r_tpu/models/layers.py `_attention_packed_heads`, all heads packed
// into one sequence under a block-diagonal -inf mask). On the card that
// plain path multiplied out H times the products it needs and passed its
// float32 logits through memory four times (~150 ms a batch-3 forward).
//
// Bound on the H100: per (pixel row, head) pair the S x S logits of S <= 32
// frames at d = 64 are 4 S^2 d operations on 8 S d bytes (q, k, v read, o
// written, bf16): S/2 = 12.5 operations a byte at S = 25, far below the
// ~295 where the tensor cores would bound it. Memory bounds it: 15.6 GB,
// 4.66 ms, the 16 calls of a batch-3 forward. So each byte moves once, the
// logits never leave registers, and the loads of the next work item are in
// flight while the current one computes.
//
// Design:
//   - A work item is PAIRS consecutive (row, head) pairs of the flattened
//     (B, H) axes (any H: a pair needs no other head), one a consumer warp.
//   - Persistent blocks, one per SM; the last warp is the producer: one
//     thread TMA-loads each pair's q, k and v (S rows x 128 bytes each, a
//     box of ROWS rows; rows >= S are zero-filled by TMA and never read
//     from memory) into a ring of STAGES stages, guarded by full/empty
//     mbarriers.
//   - A consumer warp reads its pair's tiles into mma.sync m16n8k16
//     fragments (ldmatrix from the 128-byte-swizzled tiles, conflict-free),
//     releases the stage, and computes S = Q K^T (bf16 products, f32 sums),
//     the softmax in f32 registers (keys >= S at -inf, exp2 with the scale
//     folded in, normalised before rounding to bf16 as the plain path's
//     attn.to(v.dtype)), and O = P V (f32 sums). wgmma's 64-row tiles do
//     not fit a 25-row head, and the tensor rate does not matter here.
//   - O is rounded to bf16 into the warp's own swizzled tile and written
//     with 16-byte stores, rows >= S never.
//
// Layout: each of q, k, v has its own 4-D tensor map (64, S, H, B) or
// (64, H, S, B), the two middle axes in order of their strides, over a
// (B, H, S, 64) view with a contiguous head dimension (ops/attention.py
// flash_tensor_map), so the UNet's (B * pixels, F, C) projections are read
// in place. o has its own element strides (multiples of 8: 16-byte rows).

#include <math.h>

#include "hopper_common.cuh"

using namespace syn3r;
using bf16 = __nv_bfloat16;

namespace {

constexpr int HD = 64;
constexpr int ROWS = 32;    // frames of a tile: S <= 32, padded
constexpr int PAIRS = 8;    // (row, head) pairs of a work item
constexpr int STAGES = 2;
constexpr int THREADS = 32 * (PAIRS + 1);
constexpr int TILE_BYTES = ROWS * HD * 2;
constexpr int STAGE_BYTES = 3 * PAIRS * TILE_BYTES;
constexpr int OUT_BYTES = PAIRS * TILE_BYTES;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + OUT_BYTES + 2 * STAGES * 8;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte chunk c of row r of a 128-byte-swizzled tile at `tile`.
__device__ __forceinline__ uint32_t sw128(uint32_t tile, int r, int c) {
  return tile + r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16) * b (16 x 8, bf16).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The ROWS-row box of head h, batch row b; s_dim is the map axis (1 or 2)
// that holds S.
__device__ __forceinline__ void load_tile(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int s_dim, int h,
                                          int b) {
  if (s_dim == 1)
    tma_load_4d(dst, map, bar, 0, 0, h, b);
  else
    tma_load_4d(dst, map, bar, 0, h, 0, b);
}

__global__ void __launch_bounds__(THREADS, 1)
    frame_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           int sd_q, int sd_k, int sd_v,
                           bf16* __restrict__ o, int H, int S, int pairs,
                           long long osb, long long osh, long long oss,
                           float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ring = smem;
  uint8_t* outs = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + OUT_BYTES);
  uint64_t* empty = full + STAGES;
  const int items = (pairs + PAIRS - 1) / PAIRS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 32 * PAIRS);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == PAIRS) {
    // ---- producer
    if (lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int p0 = item * PAIRS;
        const int n = min(PAIRS, pairs - p0);
        mbar_arrive_expect_tx(&full[s], n * 3 * TILE_BYTES);
        uint8_t* st = ring + s * STAGE_BYTES;
        for (int w = 0; w < n; ++w) {
          const int p = p0 + w, b = p / H, h = p - (p / H) * H;
          load_tile(st + w * TILE_BYTES, &tm_q, &full[s], sd_q, h, b);
          load_tile(st + (PAIRS + w) * TILE_BYTES, &tm_k, &full[s], sd_k, h,
                    b);
          load_tile(st + (2 * PAIRS + w) * TILE_BYTES, &tm_v, &full[s], sd_v,
                    h, b);
        }
      }
    }
    return;
  }

  // ---- consumer warp `warp`: pair item * PAIRS + warp of each item.
  // Fragment rows: g = lane / 4 (and g + 8), columns 2 q, 2 q + 1.
  const int g = lane / 4, q = lane % 4;
  const uint32_t out_tile = smem_u32(outs + warp * TILE_BYTES);
  const uint32_t ring_u32 = smem_u32(ring);
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int s = it % STAGES;
    const int p = item * PAIRS + warp;
    mbar_wait(&full[s], (it / STAGES) & 1);
    if (p >= pairs) {
      mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t tq = ring_u32 + s * STAGE_BYTES + warp * TILE_BYTES;
    const uint32_t tk = tq + PAIRS * TILE_BYTES;
    const uint32_t tv = tk + PAIRS * TILE_BYTES;

    // Q as A fragments: row tile mt (rows 16 mt ..), k16 step kk.
    uint32_t qa[2][4][4];
    ldsm_a_sw128(qa[0], tq, 0, lane);
    ldsm_a_sw128(qa[1], tq, 16, lane);
    // K as B fragments of S = Q K^T: key tile j (keys 8 j ..), step kk.
    // Lanes 8m .. 8m + 7 address keys 8 j + (lane & 7), chunk 4 kp + m.
    uint32_t kb[4][4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t t[4];
        ldsm_x4(t, sw128(tk, 8 * j + (lane & 7), 4 * kp + (lane >> 3)));
        kb[j][2 * kp][0] = t[0];
        kb[j][2 * kp][1] = t[1];
        kb[j][2 * kp + 1][0] = t[2];
        kb[j][2 * kp + 1][1] = t[3];
      }
    // V as B fragments of O = P V (transposed loads): column tile j (dims
    // 8 j ..), key step kk (keys 16 kk ..). Lanes address key
    // 16 kk + (lane & 7) + 8 ((lane >> 3) & 1), chunk 2 jp + (lane >> 4).
    uint32_t vb[8][2][2];
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t t[4];
        ldsm_x4_t(t, sw128(tv, 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                           2 * jp + (lane >> 4)));
        vb[2 * jp][kk][0] = t[0];
        vb[2 * jp][kk][1] = t[1];
        vb[2 * jp + 1][kk][0] = t[2];
        vb[2 * jp + 1][kk][1] = t[3];
      }
    mbar_arrive(&empty[s]);  // the tiles are in registers

    // S = Q K^T: sc[mt][j] is the C fragment of rows 16 mt .., keys 8 j ..
    float sc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma16816(sc[mt][j], qa[mt][kk], kb[j][kk][0], kb[j][kk][1]);
      }

    // Softmax of each row in f32: keys >= S at -inf (key 0 is always a
    // key, so the max is finite); P normalised, then rounded to bf16 as the
    // A fragments of O = P V (key tiles 2 kk and 2 kk + 1 form step kk).
    uint32_t pa[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * q + (e & 1) >= S) sc[mt][j][e] = -INFINITY;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mx = fmaxf(mx, fmaxf(sc[mt][j][2 * r], sc[mt][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float ms = mx * scale_log2;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float pe = ex2(fmaf(sc[mt][j][e], scale_log2, -ms));
            sc[mt][j][e] = pe;
            sum += pe;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.0f / sum;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[mt][j][2 * r] *= inv;
          sc[mt][j][2 * r + 1] *= inv;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        pa[mt][kk][0] = pack_bf16x2(sc[mt][2 * kk][0], sc[mt][2 * kk][1]);
        pa[mt][kk][1] = pack_bf16x2(sc[mt][2 * kk][2], sc[mt][2 * kk][3]);
        pa[mt][kk][2] =
            pack_bf16x2(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1]);
        pa[mt][kk][3] =
            pack_bf16x2(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3]);
      }
    }

    // O = P V, rounded to bf16 into the warp's tile (same swizzle).
    __syncwarp();  // the previous pair's stores have read the tile
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float oc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          mma16816(oc, pa[mt][kk], vb[j][kk][0], vb[j][kk][1]);
        const int r0 = 16 * mt + g;
        const uint32_t w0 = pack_bf16x2(oc[0], oc[1]);
        const uint32_t w1 = pack_bf16x2(oc[2], oc[3]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         sw128(out_tile, r0, j) + 4 * q),
                     "r"(w0)
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         sw128(out_tile, r0 + 8, j) + 4 * q),
                     "r"(w1)
                     : "memory");
      }
    __syncwarp();

    // rows < S of the tile, 16 bytes a lane: 4 rows of 128 bytes a step
    const int b = p / H, h = p - (p / H) * H;
    bf16* ob = o + (long long)b * osb + (long long)h * osh;
    for (int idx = lane; idx < S * 8; idx += 32) {
      const int r = idx >> 3, c = idx & 7;
      uint4 val;
      asm volatile("ld.shared.v4.b32 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                   : "r"(sw128(out_tile, r, c))
                   : "memory");
      *reinterpret_cast<uint4*>(ob + (long long)r * oss + 8 * c) = val;
    }
  }
}

}  // namespace

// q, k, v: bf16 (B, H, S, 64) views, each described by 12 values of `geom`
// (see ops/attention.py flash_tensor_map): the map's dims (64, X, Y, B),
// its byte strides of X, Y and B, its box (64 and ROWS rows of S) and the
// axis (1 or 2) that holds S. o is written through element strides (osb,
// osh, oss), each a multiple of 8, with a contiguous last axis and a
// 16-byte aligned start. 1 <= S <= 32. grid is the persistent grid
// (min(work items, SMs)). Returns a cudaError_t (0 on success).
extern "C" int syn3r_frame_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* geom, int B, int H,
                                     int S, long long osb, long long osh,
                                     long long oss, float scale, int grid,
                                     void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S > ROWS || grid <= 0 ||
      (long long)B * H >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(o) % 16 || osb % 8 || osh % 8 || oss % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  int s_dims[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const long long* gm = geom + 12 * i;
    const int sd = (int)gm[11];
    if (gm[0] != HD || (sd != 1 && sd != 2) || gm[7] != HD ||
        gm[7 + sd] != ROWS || gm[10 - sd] != 1 || gm[10] != 1)
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
  cudaError_t err =
      allow_smem_per_device(frame_attention_kernel, SMEM, attr_set);
  if (err != cudaSuccess) return (int)err;
  frame_attention_kernel<<<grid, THREADS, SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], s_dims[0], s_dims[1], s_dims[2],
      static_cast<bf16*>(o), H, S, B * H, osb, osh, oss,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
