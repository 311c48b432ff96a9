// Row LayerNorm over (R, C), written by hand for Hopper (sm_90a).
//
// Replaces: syn3r_tpu/ops/pallas_norm.py `_ln_kernel` (launched by
// `layer_norm_pallas`): per row, float32 mean and var = E[x^2] - mean^2
// (not Welford, as the reference), y = (x - mean) rstd w + b, rounded to
// x's type.
//
// Bound on the H100: about six operations per element against 2 (bf16)
// bytes read and 2 written, so device memory bounds it: the main path's
// largest call (3 x 25 x 9216 rows x 320 bf16) moves 885 MB, 0.26 ms at
// 3.35 TB/s; the 112 calls of a batch-3 UNet forward move 54.6 GB,
// 16.3 ms (chip_smoke.py sums the bound over the census).
//
// Design, from the launch plan of ops/norm.py `layer_norm_plan`:
//  * No idle lane. A lane holds NV 16-byte vectors (8 bf16 or 4 float32)
//    of a row; `lanes` (a power of two) lanes share a row and a warp holds
//    32 / lanes rows, with lanes the largest power of two that divides the
//    row's vectors. At the UNet's bf16 widths every lane holds 5 vectors:
//    C = 320 four rows a warp (8 lanes a row), 640 two (16), 1280 one; float32
//    C = 1280 one row of 10 vectors a lane. Other widths fall back to 32
//    lanes a row with the tail masked.
//  * A persistent grid (two 256-thread blocks a SM for bf16 rows, one for
//    float32); each warp strides over its groups of rows.
//  * Weight and bias read once, before the row loop, into registers for
//    the lane's columns: bf16 parameters stay packed (two a register) and
//    widen on use (exact), float32 stay float. The wrapper hands them in
//    their own dtype, so a bf16 module launches no cast.
//  * The next group's 16-byte loads are issued before the current group's
//    reduction and stores (two groups in flight a warp) where the registers
//    allow it (parameters plus two groups within 96 registers: every bf16
//    row with bf16 parameters at the census widths).
//  * x is read once and y written once; the sums of x and x^2 are reduced
//    over the row's lanes with butterfly shuffles.

#include "norm_common.cuh"

using namespace syn3r;
using bf16 = __nv_bfloat16;

namespace {

constexpr int THREADS = 256;  // = ops/norm.py LN_THREADS
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// N per-lane columns of a parameter vector, in registers.
template <typename T, int N>
struct Params;

template <int N>
struct Params<float, N> {
  float v[N];
  __device__ __forceinline__ void set(int i, const float* p, int c, bool ok) {
    v[i] = ok ? p[c] : 0.0f;
    v[i + 1] = ok ? p[c + 1] : 0.0f;
  }
  __device__ __forceinline__ float get(int i) const { return v[i]; }
};

template <int N>
struct Params<bf16, N> {
  uint32_t v[N / 2];  // bf16 pairs, low half first
  __device__ __forceinline__ void set(int i, const bf16* p, int c, bool ok) {
    const uint32_t lo = ok ? __bfloat16_as_ushort(p[c]) : 0u;
    const uint32_t hi = ok ? __bfloat16_as_ushort(p[c + 1]) : 0u;
    v[i / 2] = lo | (hi << 16);
  }
  __device__ __forceinline__ float get(int i) const {
    return (i & 1) ? bf16_hi(v[i / 2]) : bf16_lo(v[i / 2]);
  }
};

template <typename TX, typename TW, int NV>
__global__ void __launch_bounds__(THREADS, sizeof(TX) == 2 ? 2 : 1)
    layer_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      const TW* __restrict__ bias, TX* __restrict__ y,
                      long long R, int C, float eps, int lanes) {
  constexpr int V = Vec<TX>::N;
  constexpr int N = NV * V;  // columns a lane
  constexpr int kParamRegs = 2 * N * (int)sizeof(TW) / 4;
  constexpr int kRowRegs = N * (int)sizeof(TX) / 4;
  constexpr bool kPrefetch = kParamRegs + 2 * kRowRegs <= 96;
  const int lane = threadIdx.x & 31;
  const int slot = lane & (lanes - 1);
  const int rpg = 32 / lanes;  // rows a warp group
  const int sub = lane / lanes;
  const int ncv = C / V;

  Params<TW, N> pw, pb;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int cv = slot + lanes * j;
#pragma unroll
    for (int i = 0; i < V; i += 2) {
      pw.set(j * V + i, w, cv * V + i, cv < ncv);
      pb.set(j * V + i, bias, cv * V + i, cv < ncv);
    }
  }

  const long long groups = (R + rpg - 1) / rpg;
  const long long stride = (long long)gridDim.x * WARPS;
  long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  uint4 cur[NV], nxt[NV];
  auto load = [&](uint4 (&dst)[NV], long long grp) {
    const long long row = grp * rpg + sub;
    const TX* xr = x + row * C;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int cv = slot + lanes * j;
      dst[j] = (row < R && cv < ncv)
                   ? __ldg(reinterpret_cast<const uint4*>(xr + cv * V))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if (g < groups) load(cur, g);
  for (; g < groups; g += stride) {
    const long long gn = g + stride;
    if (kPrefetch && gn < groups) load(nxt, gn);
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float v[V];
      Raw<TX>::widen(cur[j], v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s += v[i];
        q = fmaf(v[i], v[i], q);
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      s += __shfl_xor_sync(FULL, s, off);
      q += __shfl_xor_sync(FULL, q, off);
    }
    const float cf = (float)C;
    const float mean = s / cf;
    const float var = q / cf - mean * mean;
    const float rstd = rsqrtf(var + eps);
    const long long row = g * rpg + sub;
    if (row < R) {
      TX* yr = y + row * C;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int cv = slot + lanes * j;
        if (cv < ncv) {
          float v[V], o[V];
          Raw<TX>::widen(cur[j], v);
#pragma unroll
          for (int i = 0; i < V; ++i)
            o[i] = (v[i] - mean) * rstd * pw.get(j * V + i) +
                   pb.get(j * V + i);
          Vec<TX>::store(yr + cv * V, o);
        }
      }
    }
    if (gn < groups) {
      if (kPrefetch) {
#pragma unroll
        for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
      } else {
        load(cur, gn);
      }
    }
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, const void* b, void* y, long long R,
           int C, float eps, int lanes, int nv, int grid,
           cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  const TW* wt = static_cast<const TW*>(w);
  const TW* bt = static_cast<const TW*>(b);
  TX* yt = static_cast<TX*>(y);
#define SYN3R_LN_CASE(N)                                            \
  case N:                                                           \
    layer_norm_kernel<TX, TW, N><<<grid, THREADS, 0, stream>>>(     \
        xt, wt, bt, yt, R, C, eps, lanes);                          \
    break;
  switch (nv) {
    SYN3R_LN_CASE(1)
    SYN3R_LN_CASE(2)
    SYN3R_LN_CASE(3)
    SYN3R_LN_CASE(4)
    SYN3R_LN_CASE(5)
    SYN3R_LN_CASE(6)
    SYN3R_LN_CASE(7)
    SYN3R_LN_CASE(8)
    SYN3R_LN_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SYN3R_LN_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// LayerNorm of each row of x (R, C) with the plan's lanes a row, nv vectors
// a lane and grid; weight and bias (C,) in x's type or float32 (a float32
// x takes float32 parameters).
extern "C" int syn3r_layer_norm(const void* x, const void* w, const void* b,
                                void* y, long long R, int C, float eps,
                                int x_bf16, int w_bf16, int lanes, int nv,
                                int grid, void* stream) {
  const int vec = x_bf16 ? 8 : 4;
  if (R <= 0 || C <= 0 || C % vec != 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || (long long)lanes * nv * vec < C ||
      grid <= 0 || (w_bf16 && !x_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16) return launch<float, float>(x, w, b, y, R, C, eps, lanes, nv,
                                           grid, s);
  return w_bf16 ? launch<bf16, bf16>(x, w, b, y, R, C, eps, lanes, nv, grid, s)
                : launch<bf16, float>(x, w, b, y, R, C, eps, lanes, nv, grid,
                                      s);
}
