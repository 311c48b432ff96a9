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
// cores bound it at every level. The S x S logits (42 GB at the top level)
// must never reach device memory.
//
// Design (FlashAttention-2 order): one block of 4 warps per (batch*head,
// 64-row query tile); each warp owns 16 query rows and keeps them as
// mma.sync A fragments. The block loops over 64-row key/value tiles, double
// buffered with cp.async, computes S = Q K^T with bf16 mma.sync into f32,
// keeps a running row max and row sum in f32 (online softmax, exp2 with the
// scale folded in), rounds P to bf16 in registers and accumulates P V in
// f32. The ragged last key tile is masked in the kernel (keys >= S get -inf),
// which takes the place of the TPU path's segment-id padding; ragged query
// rows are zero-filled on load and not stored.
//
// Layout: q, k, v share one set of element strides (batch, head, row) and
// have a contiguous head dimension of 64; o has its own strides. That lets
// the caller pass (B, S, H, D) projections without a transpose copy.

#include <math.h>

#include "mma_common.cuh"

using namespace syn3r;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int HD = 64;
constexpr int LDK = HD + 8;  // padded row: conflict-free ldmatrix
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                     int S, long long sb, long long sh, long long ss,
                     long long osb, long long osh, long long oss,
                     float scale_log2) {
  __shared__ __align__(16) bf16 sQ[BQ * LDK];
  __shared__ __align__(16) bf16 sK[2][BKV * LDK];
  __shared__ __align__(16) bf16 sV[2][BKV * LDK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  // 64 rows x 64 columns = 512 chunks of 8 bf16; 4 per thread.
  auto load_rows = [&](bf16* dst, const bf16* src, int row0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int c = tid + i * THREADS;
      int r = c >> 3, col = (c & 7) * 8;
      bool ok = row0 + r < S;
      cp_async16(dst + r * LDK + col,
                 src + (size_t)(ok ? row0 + r : 0) * ss + col, ok);
    }
  };

  const int nkv = (S + BKV - 1) / BKV;
  load_rows(sQ, qb, q0);
  load_rows(sK[0], kb, 0);
  load_rows(sV[0], vb, 0);
  cp_async_commit();

  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.0f, 0.0f};
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  uint32_t qf[4][4];
  const int q_ = lane & 3;

  for (int t = 0; t < nkv; ++t) {
    if (t + 1 < nkv) {
      load_rows(sK[(t + 1) & 1], kb, (t + 1) * BKV);
      load_rows(sV[(t + 1) & 1], vb, (t + 1) * BKV);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        int r = warp * 16 + (lane & 15);
        int c = kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                    sQ + r * LDK + c);
      }
    }
    const bf16* cK = sK[t & 1];
    const bf16* cV = sV[t & 1];

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b0, b1, b2, b3;
        int r = p * 16 + (lane & 7) + ((lane >> 4) << 3);
        int c = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b0, b1, b2, b3, cK + r * LDK + c);
        mma_bf16_16816(s[2 * p], qf[kk], b0, b1);
        mma_bf16_16816(s[2 * p + 1], qf[kk], b2, b3);
      }
    }

    const int kbase = t * BKV;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int key = kbase + j * 8 + 2 * q_ + (e & 1);
        s[j][e] = key < S ? s[j][e] * scale_log2 : -INFINITY;
      }

    // Online softmax; r = 0 is row g (c0, c1), r = 1 is row g + 8 (c2, c3).
    // Every tile holds at least one valid key, so the new max is finite.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_i[r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m_i[r] - mx);
      m_i[r] = mx;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p0 = exp2f(s[j][2 * r] - mx);
        float p1 = exp2f(s[j][2 * r + 1] - mx);
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
        rs += p0 + p1;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_i[r] = l_i[r] * alpha + rs;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V: the C fragments of two adjacent key n-tiles are the A
    // fragment of one 16-key step.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b0, b1, b2, b3;
        int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        int c = dp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b0, b1, b2, b3, cV + r * LDK + c);
        mma_bf16_16816(acc[2 * dp], pa, b0, b1);
        mma_bf16_16816(acc[2 * dp + 1], pa, b2, b3);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  const int g = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= S) continue;
    const float inv = 1.0f / l_i[r];
    bf16* orow = o + (size_t)b * osb + (size_t)h * osh + (size_t)row * oss;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * q_) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
  }
}

}  // namespace

// q, k, v: bf16 (B, H, S, 64) addressed through element strides
// (sb, sh, ss) with a contiguous last axis; o likewise through
// (osb, osh, oss). Returns a cudaError_t (0 on success).
extern "C" int syn3r_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int S, int D, long long sb, long long sh,
                                     long long ss, long long osb,
                                     long long osh, long long oss, float scale,
                                     void* stream) {
  if (D != HD || B <= 0 || H <= 0 || S <= 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, S, sb, sh, ss,
      osb, osh, oss, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
