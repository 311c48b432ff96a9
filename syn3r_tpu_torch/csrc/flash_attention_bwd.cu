// Backward of exact softmax attention for the SVD UNet's spatial
// self-attention, written by hand for Hopper (sm_90a): two kernels, dK/dV
// and dQ, as the library splits it.
//
// Replaces: the Pallas TPU flash-attention backward that
// syn3r_tpu/models/layers.py `_attention` reaches when a gradient goes
// through the UNet (jax/experimental/pallas/ops/tpu/flash_attention.py,
// `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`).
//
// With P = exp(scale Q K^T - lse) (lse from the forward kernel, one f32 per
// query row) and D = rowsum(dO o O) (one torch reduction, as the library
// computes `di` outside its kernels):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dK = scale dS^T Q,  dQ = scale dS K.
// Five products of BH*S^2*64, against the forward's two: the tensor cores
// bound it at d = 64, and P is recomputed once in each kernel.
//
// Design (a plain FlashAttention-2 backward; the redesign is later work):
//   - dkv kernel: one block per (64-key tile, batch*head), 4 warps of 16
//     keys. K and V of the warp's keys stay in registers as mma A
//     fragments; the block walks the query tiles, Q, dO, lse and D of each
//     staged in shared memory by cp.async two tiles deep. Per tile a warp
//     forms S^T = K Q^T, P^T, dV += P^T dO, dP^T = V dO^T, dS^T and
//     dK += dS^T Q, all with mma.sync m16n8k16 (bf16 in, f32 accumulate),
//     P^T and dS^T repacked from accumulators to bf16 A fragments.
//   - dq kernel: one block per (64-query tile, batch*head), 4 warps of 16
//     queries. Q and dO in registers, the block walks the key tiles (K and
//     V staged the same way): S = Q K^T, P, dP = dO V^T, dS, dQ += dS K.
//   - Every row of dQ, dK and dV has one owner, so there are no atomics:
//     two calls agree bit for bit.
//   - Shared tiles have rows of 72 bf16 (144 bytes), so the 8 row
//     addresses of an ldmatrix fall in distinct banks.
// Ragged S (the UNet's 9216, 2304 and 576 fill 64-row tiles, but any S is
// taken): rows >= S are zero-filled on load and never stored; P is set to
// 0 for queries >= S (dkv) and for keys >= S (dq) explicitly, since a
// zero-filled row still gives exp(0 - lse) and its lse is not defined.
//
// Layout: q, k, v, dO and the outputs are (B, H, S, 64) views with element
// strides (sb, sh, ss) and a contiguous head dimension, rows 16-byte
// aligned; lse and D are contiguous f32 (B, H, S).

#include <math.h>

#include "hopper_common.cuh"

using namespace syn3r;
using bf16 = __nv_bfloat16;

namespace {

constexpr int HD = 64;
constexpr int BT = 64;       // rows of the block's own tile and of a walked tile
constexpr int THREADS = 128; // 4 warps, 16 of the block's rows each
constexpr int LD = HD + 8;   // shared row stride in elements
constexpr float LOG2E = 1.4426950408889634f;

struct View {
  const bf16* p;
  long long sb, sh, ss;
};

struct OutView {
  bf16* p;
  long long sb, sh, ss;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + 63 of head (b, h) of `v` into a (64 x LD) shared
// tile by cp.async, rows >= S zero.
__device__ __forceinline__ void load_tile(bf16* tile, const View& v, int b,
                                          int h, int row0, int S) {
  const bf16* base = v.p + b * v.sb + h * v.sh;
  for (int i = threadIdx.x; i < BT * (HD / 8); i += THREADS) {
    const int r = i >> 3, c = (i & 7) * 8;
    const int row = row0 + r;
    const bool ok = row < S;
    cp_async16(tile + r * LD + c, base + (long long)(ok ? row : 0) * v.ss + c,
               ok);
  }
}

// lse (as log2) and D of rows row0 .. row0 + 63 into shared memory; rows
// >= S get lse = +inf and D = 0.
__device__ __forceinline__ void load_rows_f32(float* s_l, float* s_d,
                                              const float* lse,
                                              const float* delta, int row0,
                                              int S) {
  if (threadIdx.x < BT) {
    const int row = row0 + threadIdx.x;
    s_l[threadIdx.x] = row < S ? lse[row] * LOG2E : INFINITY;
    s_d[threadIdx.x] = row < S ? delta[row] : 0.0f;
  }
}

// The mma A fragments (16 rows x 64, 4 k16 steps) of rows rw0 .. rw0 + 15
// of head (b, h), read from global memory; rows >= S zero.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4], const View& v,
                                            int b, int h, int rw0, int S,
                                            int g, int q) {
  const bf16* base = v.p + b * v.sb + h * v.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw0 + g + 8 * r;
    const bf16* p = base + (long long)(row < S ? row : 0) * v.ss;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t lo = 0, hi = 0;
      if (row < S) {
        lo = *reinterpret_cast<const uint32_t*>(p + 16 * kk + 2 * q);
        hi = *reinterpret_cast<const uint32_t*>(p + 16 * kk + 8 + 2 * q);
      }
      a[kk][r] = lo;
      a[kk][2 + r] = hi;
    }
  }
}

// acc (16 x 64) += A (16 x 64) * T^T, T a (64 x LD) shared tile: the B
// operand B[k][n] = T[n][k] (n over the tile's rows, k over the head dim).
__device__ __forceinline__ void mma_a_tt(float (&acc)[8][4],
                                         const uint32_t (&a)[4][4],
                                         const bf16* tile, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t r[4];
      ldsm_x4(r, smem_u32(tile + (8 * j + (lane & 7)) * LD + 32 * half +
                          8 * (lane >> 3)));
      mma16816(acc[j], a[2 * half], r[0], r[1]);
      mma16816(acc[j], a[2 * half + 1], r[2], r[3]);
    }
  }
}

// acc (16 x 64 over the head dim) += A (16 x 64 over the tile's rows) * T,
// T a (64 x LD) shared tile: B[k][n] = T[k][n].
__device__ __forceinline__ void mma_a_t(float (&acc)[8][4],
                                        const uint32_t (&a)[4][4],
                                        const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t r[4];
      ldsm_x4_trans(r, smem_u32(tile +
                                (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                    LD +
                                16 * jp + 8 * (lane >> 4)));
      mma16816(acc[2 * jp], a[kk], r[0], r[1]);
      mma16816(acc[2 * jp + 1], a[kk], r[2], r[3]);
    }
  }
}

// Accumulator (16 x 64) to bf16 A fragments: chunks 2kk and 2kk + 1 form
// k16 step kk.
__device__ __forceinline__ void pack_a(const float (&c)[8][4],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
}

// Rows rw0 + g (+ 8) of an accumulator (16 x 64), times `mul`, as bf16.
__device__ __forceinline__ void store_rows(const OutView& o, int b, int h,
                                           int rw0, int S, int g, int q,
                                           const float (&c)[8][4], float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw0 + g + 8 * r;
    if (row >= S) continue;
    bf16* p = o.p + b * o.sb + h * o.sh + (long long)row * o.ss;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j + 2 * q) =
          __floats2bfloat162_rn(c[j][2 * r] * mul, c[j][2 * r + 1] * mul);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dkv_kernel(View q, View k, View v, View dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, OutView dk,
                         OutView dv, int H, int S, float scale) {
  __shared__ __align__(128) bf16 s_q[2][BT * LD];
  __shared__ __align__(128) bf16 s_do[2][BT * LD];
  __shared__ float s_l[2][BT], s_d[2][BT];
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int kw0 = blockIdx.x * BT + 16 * warp;
  const float scale_log2 = scale * LOG2E;
  const float* lse_bh = lse + (long long)bh * S;
  const float* d_bh = delta + (long long)bh * S;

  uint32_t ka[4][4], va[4][4];
  load_a_rows(ka, k, b, h, kw0, S, g, q4);
  load_a_rows(va, v, b, h, kw0, S, g, q4);
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);

  const int n_t = (S + BT - 1) / BT;
  load_tile(s_q[0], q, b, h, 0, S);
  load_tile(s_do[0], dout, b, h, 0, S);
  load_rows_f32(s_l[0], s_d[0], lse_bh, d_bh, 0, S);
  cp_async_commit();
  for (int t = 0; t < n_t; ++t) {
    const int st = t & 1;
    if (t + 1 < n_t) {
      load_tile(s_q[st ^ 1], q, b, h, (t + 1) * BT, S);
      load_tile(s_do[st ^ 1], dout, b, h, (t + 1) * BT, S);
      load_rows_f32(s_l[st ^ 1], s_d[st ^ 1], lse_bh, d_bh, (t + 1) * BT, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S^T = K Q^T (the warp's 16 keys x 64 queries), then P^T in place
    float p[8][4];
    zero(p);
    mma_a_tt(p, ka, s_q[st], lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * q4 + (e & 1);
        p[j][e] = t * BT + col < S
                      ? ex2(fmaf(p[j][e], scale_log2, -s_l[st][col]))
                      : 0.0f;
      }
    uint32_t pa[4][4];
    pack_a(p, pa);
    mma_a_t(dv_acc, pa, s_do[st], lane);  // dV += P^T dO

    float ds[8][4];
    zero(ds);
    mma_a_tt(ds, va, s_do[st], lane);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - s_d[st][8 * j + 2 * q4 + (e & 1)]);
    pack_a(ds, pa);
    mma_a_t(dk_acc, pa, s_q[st], lane);  // dK += dS^T Q (scale at the end)
    __syncthreads();  // the next iteration's loads overwrite stage st ^ 1
  }
  cp_async_wait<0>();
  store_rows(dk, b, h, kw0, S, g, q4, dk_acc, scale);
  store_rows(dv, b, h, kw0, S, g, q4, dv_acc, 1.0f);
}

__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dq_kernel(View q, View k, View v, View dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, OutView dq, int H,
                        int S, float scale) {
  __shared__ __align__(128) bf16 s_k[2][BT * LD];
  __shared__ __align__(128) bf16 s_v[2][BT * LD];
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int qw0 = blockIdx.x * BT + 16 * warp;
  const float scale_log2 = scale * LOG2E;

  uint32_t qa[4][4], doa[4][4];
  load_a_rows(qa, q, b, h, qw0, S, g, q4);
  load_a_rows(doa, dout, b, h, qw0, S, g, q4);
  float l2[2], dd[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw0 + g + 8 * r;
    live[r] = row < S;
    l2[r] = live[r] ? lse[(long long)bh * S + row] * LOG2E : INFINITY;
    dd[r] = live[r] ? delta[(long long)bh * S + row] : 0.0f;
  }
  float dq_acc[8][4];
  zero(dq_acc);

  const int n_t = (S + BT - 1) / BT;
  load_tile(s_k[0], k, b, h, 0, S);
  load_tile(s_v[0], v, b, h, 0, S);
  cp_async_commit();
  for (int t = 0; t < n_t; ++t) {
    const int st = t & 1;
    if (t + 1 < n_t) {
      load_tile(s_k[st ^ 1], k, b, h, (t + 1) * BT, S);
      load_tile(s_v[st ^ 1], v, b, h, (t + 1) * BT, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S = Q K^T (the warp's 16 queries x 64 keys), then P in place
    float p[8][4];
    zero(p);
    mma_a_tt(p, qa, s_k[st], lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool key_in = t * BT + 8 * j + 2 * q4 + (e & 1) < S;
        p[j][e] = key_in && live[r]
                      ? ex2(fmaf(p[j][e], scale_log2, -l2[r]))
                      : 0.0f;
      }
    float ds[8][4];
    zero(ds);
    mma_a_tt(ds, doa, s_v[st], lane);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - dd[e >> 1]);
    uint32_t dsa[4][4];
    pack_a(ds, dsa);
    mma_a_t(dq_acc, dsa, s_k[st], lane);  // dQ += dS K (scale at the end)
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows(dq, b, h, qw0, S, g, q4, dq_acc, scale);
}

// (sb, sh, ss) triples of `strides` into views.
View view_of(const void* p, const long long* s) {
  return View{static_cast<const bf16*>(p), s[0], s[1], s[2]};
}

OutView out_of(void* p, const long long* s) {
  return OutView{static_cast<bf16*>(p), s[0], s[1], s[2]};
}

bool bad_args(int B, int H, int S) {
  return B <= 0 || H <= 0 || S <= 0 || (long long)B * H > 65535 ||
         (long long)B * H * S >= (1ll << 31);
}

}  // namespace

// dK and dV. q, k, v, dout: bf16 (B, H, S, 64) views; lse, delta: f32
// (B, H, S) contiguous; dk, dv: bf16 outputs. strides: (sb, sh, ss) in
// elements of q, k, v, dout, dk, dv (18 values). Returns a cudaError_t.
extern "C" int syn3r_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv,
                                   const long long* strides, int B, int H,
                                   int S, float scale, void* stream) {
  if (bad_args(B, H, S)) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + BT - 1) / BT, B * H);
  flash_bwd_dkv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      view_of(q, strides), view_of(k, strides + 3), view_of(v, strides + 6),
      view_of(dout, strides + 9), lse, delta, out_of(dk, strides + 12),
      out_of(dv, strides + 15), H, S, scale);
  return (int)cudaGetLastError();
}

// dQ. As above; strides: q, k, v, dout, dq (15 values).
extern "C" int syn3r_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq,
                                  const long long* strides, int B, int H,
                                  int S, float scale, void* stream) {
  if (bad_args(B, H, S)) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + BT - 1) / BT, B * H);
  flash_bwd_dq_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      view_of(q, strides), view_of(k, strides + 3), view_of(v, strides + 6),
      view_of(dout, strides + 9), lse, delta, out_of(dq, strides + 12), H, S,
      scale);
  return (int)cudaGetLastError();
}
