// GroupNorm over channel-last (B, S, C), written by hand for Hopper (sm_90a).
//
// Replaces: syn3r_tpu/ops/pallas_norm.py `_gn_stats_kernel` (per-(B, C) sums
// of x and x^2 over S) and `_gn_apply_kernel` (y = x a + b, optional SiLU,
// cast to x's type), both launched by `group_norm_pallas`. The group fold
// that JAX runs between its two kernels (pallas_norm.py:147-156) is done
// here by the stats kernel itself: a GroupNorm call is two launches.
//
// Bound on the H100: a few operations per element against 2 (bf16) or 4
// (float32) bytes, so device memory bounds both: the stats read x once,
// the apply reads it again and writes y (3 x the tensor in all). At the
// main path's largest call (3 x 25 x 9216 x 320 bf16, 442 MB) that is
// 0.13 + 0.26 ms at 3.35 TB/s; the 105 calls of a batch-3 UNet forward
// 6.97 + 13.93 ms. At 4 bytes an element (bf16 read and write) the card
// moves ~15 bytes a SM clock, so the apply has ~30 thread instructions an
// element before issue, not memory, sets its pace.
//
// Design, from the launch plan of ops/norm.py `group_norm_plan`:
//  * Work cut into equal items on a grid sized to residency. An item is
//    one pass of the block over `rows` rows of one batch element (the last
//    of a batch element may be short); there are B x ceil(S / rows) items
//    and a 1-D grid of at most the card's resident blocks (occupancy x
//    SMs), at least four items a block. Block k takes the contiguous items
//    [k items / grid, (k + 1) items / grid), walked as segments of one
//    batch element each: every block does the same work to one item, at
//    B = 75 and at B = 3 alike, and no second wave runs.
//  * A fixed channel window a thread, no idle lane. A block has a multiple
//    of lcm(C / V, 32) threads (V = 8 bf16 or 4 float32 values a 16-byte
//    vector): thread t holds the V channels (t mod C/V) V.. of row
//    t / (C/V) of each pass, the same for the whole launch. The stats keep
//    V running float32 sums of x and x^2; the apply holds its V values of
//    a and b in registers (no modulo, no per-element load of them). The
//    stats take the most such threads up to 512: fewer blocks write fewer
//    partials, and at B = 3 one block sums a batch element's partials
//    alone at the end of the launch. The apply takes the fewest from 128:
//    more resident blocks, the finer grain at the small shapes.
//  * UNROLL 16-byte loads in flight a thread before their arithmetic.
//  * Stats in one launch, deterministic. At the end of a segment the block
//    folds its rows of threads through shared memory in a fixed order and
//    writes one float32 (2, C) partial to slot k + b (the slots of batch
//    element b are those of the blocks that touch it, in block order; at
//    most grid + B - 1 slots). It then arrives on b's counter; the block
//    that arrives last sums b's partials in slot order, folds each group
//    (mean = s1 / n, var = s2 / n - mean^2, not Welford, as the
//    reference), writes the per-(B, C) affine a = rstd w, b = bias - mean
//    a, and resets the counter to 0. No atomic touches a sum, so the
//    result is the same bit for bit from run to run. The counters (one
//    int32 a batch element, zero between calls) are kept by the wrapper
//    per device and assume one stream, as the whole port does.
//  * Weight and bias in their own dtype (bf16 or float32), widened in the
//    fold: no cast launch.
//  * The apply's SiLU with fast intrinsics, o / (1 + exp(-o)) as
//    __fdividef(o, 1 + __expf(-o)). CUDA Programming Guide, intrinsic
//    functions: __expf's maximum error is 2 + floor(|1.16 x|) ulp;
//    __fdividef's 2 ulp for 2^-126 <= |y| <= 2^126, and 0 for larger y
//    (o < -87, where the SiLU is below 1e-36 in magnitude). The output
//    rounds to x's type; chip_smoke.py holds it to NORM_TOL.

#include "norm_common.cuh"

using namespace syn3r;
using bf16 = __nv_bfloat16;

namespace {

constexpr int MAX_THREADS = 512;  // = ops/norm.py GN_MAX_THREADS
constexpr int MAX_GROUPS = 128;   // = ops/norm.py GN_MAX_GROUPS
constexpr int UNROLL = 4;  // 16-byte loads in flight a thread

// The launch's partition of the rows (group_norm_plan).
struct Plan {
  long long S;      // rows a batch element
  long long ipb;    // items a batch element, ceil(S / rows)
  long long items;  // B x ipb
  int C;
  int rows;         // rows an item = threads / (C / V)
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

// The block that takes item i.
__device__ __forceinline__ long long item_block(long long i, long long items,
                                                long long grid) {
  return ((i + 1) * grid - 1) / items;
}

// Calls seg(b, s0, s1) for each batch element b whose rows [s0, s1) are
// in this block's items, in order (ops/norm.py group_norm_segments).
template <typename F>
__device__ __forceinline__ void walk(const Plan& p, F&& seg) {
  const long long k = blockIdx.x, grid = gridDim.x;
  long long i = k * p.items / grid;
  const long long i1 = (k + 1) * p.items / grid;
  while (i < i1) {
    const long long b = i / p.ipb;
    const long long e = min(i1, (b + 1) * p.ipb);
    seg(b, (i - b * p.ipb) * p.rows, min(p.S, (e - b * p.ipb) * p.rows));
    i = e;
  }
}

// Loads this thread makes in rows [s0, s1): rows s0 + r, s0 + r + rows...
__device__ __forceinline__ long long row_count(long long s0, long long s1,
                                               int r, int rows) {
  const long long n = s1 - s0 - r;
  return n > 0 ? (n + rows - 1) / rows : 0;
}

template <typename T>
__device__ __forceinline__ void accumulate(const uint4& raw,
                                           float (&s)[Vec<T>::N],
                                           float (&q)[Vec<T>::N]) {
  float v[Vec<T>::N];
  Raw<T>::widen(raw, v);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) {
    s[i] += v[i];
    q[i] = fmaf(v[i], v[i], q[i]);
  }
}

// s += u, q += z: one partial's V sums of x and of x^2.
template <int V>
__device__ __forceinline__ void add_partial(const float4 (&u)[V / 4],
                                            const float4 (&z)[V / 4],
                                            float (&s)[V], float (&q)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    s[4 * i] += u[i].x;
    s[4 * i + 1] += u[i].y;
    s[4 * i + 2] += u[i].z;
    s[4 * i + 3] += u[i].w;
    q[4 * i] += z[i].x;
    q[4 * i + 1] += z[i].y;
    q[4 * i + 2] += z[i].z;
    q[4 * i + 3] += z[i].w;
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(MAX_THREADS)
    gn_stats_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                    const TW* __restrict__ bias, float* __restrict__ part,
                    int* __restrict__ arrivals, float* __restrict__ a,
                    float* __restrict__ bb, Plan p, int G, float eps) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float sh[];  // (rows, 2, C) float32
  __shared__ float gmean[MAX_GROUPS], grstd[MAX_GROUPS];
  __shared__ int folds;
  const int C = p.C;
  const int ncv = C / V;
  const int r = threadIdx.x / ncv;
  const int cv = threadIdx.x - r * ncv;
  float* mine = sh + (size_t)r * 2 * C + cv * V;
  const long long grid = gridDim.x;

  walk(p, [&](long long b, long long s0, long long s1) {
    float s[V], q[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0f;
    const long long step = (long long)p.rows * C;
    const T* xp = x + (b * p.S + s0 + r) * C + cv * V;
    long long cnt = row_count(s0, s1, r, p.rows);
    for (; cnt >= UNROLL; cnt -= UNROLL) {
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(xp + u * step));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) accumulate<T>(raw[u], s, q);
      xp += UNROLL * step;
    }
    for (; cnt > 0; --cnt) {
      accumulate<T>(__ldg(reinterpret_cast<const uint4*>(xp)), s, q);
      xp += step;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mine[i] = s[i];
      mine[C + i] = q[i];
    }
    __syncthreads();
    // the block's rows in a fixed order: one (2, C) partial, slot k + b
    float* out = part + (blockIdx.x + b) * 2 * (long long)C;
    for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
      float t = 0.0f;
      for (int j = 0; j < p.rows; ++j) t += sh[(size_t)j * 2 * C + c];
      out[c] = t;
    }
    // the partial is visible to the folding block before the arrival
    __threadfence();
    __syncthreads();
    const long long first = item_block(b * p.ipb, p.items, grid);
    const int nparts =
        (int)(item_block((b + 1) * p.ipb - 1, p.items, grid) - first + 1);
    if (threadIdx.x == 0) folds = atomicAdd(arrivals + b, 1) == nparts - 1;
    __syncthreads();
    if (folds) {
      __threadfence();
      // b's partials, in slot order (read through L2: other SMs wrote them)
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0f;
      const float* pb = part + (first + b) * 2 * (long long)C + cv * V;
      for (int j = r; j < nparts; j += p.rows) {
        const float* pp = pb + (long long)j * 2 * C;
        float4 u[V / 4], z[V / 4];
#pragma unroll
        for (int i = 0; i < V / 4; ++i) {
          u[i] = __ldcg(reinterpret_cast<const float4*>(pp) + i);
          z[i] = __ldcg(reinterpret_cast<const float4*>(pp + C) + i);
        }
        add_partial<V>(u, z, s, q);
      }
      __syncthreads();  // every thread has read sh's partial rows
#pragma unroll
      for (int i = 0; i < V; ++i) {
        mine[i] = s[i];
        mine[C + i] = q[i];
      }
      __syncthreads();
      // row 0 in place: column c is this thread's alone
      for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
        float t = 0.0f;
        for (int j = 0; j < p.rows; ++j) t += sh[(size_t)j * 2 * C + c];
        sh[c] = t;
      }
      __syncthreads();
      const int cg = C / G;
      const float n = (float)(p.S * cg);
      for (int g = threadIdx.x; g < G; g += blockDim.x) {
        float g1 = 0.0f, g2 = 0.0f;
        for (int j = 0; j < cg; ++j) {
          g1 += sh[g * cg + j];
          g2 += sh[C + g * cg + j];
        }
        const float mean = g1 / n;
        const float var = g2 / n - mean * mean;
        gmean[g] = mean;
        grstd[g] = rsqrtf(var + eps);
      }
      __syncthreads();
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const int g = c / cg;
        const float av = grstd[g] * to_float(w[c]);
        a[b * C + c] = av;
        bb[b * C + c] = to_float(bias[c]) - gmean[g] * av;
      }
      if (threadIdx.x == 0) arrivals[b] = 0;
    }
    __syncthreads();  // sh and folds are reused by the next segment
  });
}

template <bool SILU>
__device__ __forceinline__ float affine(float v, float a, float b) {
  const float o = fmaf(v, a, b);
  return SILU ? __fdividef(o, 1.0f + __expf(-o)) : o;
}

template <typename T, bool SILU>
__device__ __forceinline__ void apply_vec(const uint4& raw, T* yp,
                                          const float (&av)[Vec<T>::N],
                                          const float (&bv)[Vec<T>::N]) {
  float v[Vec<T>::N];
  Raw<T>::widen(raw, v);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) v[i] = affine<SILU>(v[i], av[i], bv[i]);
  Vec<T>::store(yp, v);
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(MAX_THREADS)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ bb, T* __restrict__ y, Plan p) {
  constexpr int V = Vec<T>::N;
  const int C = p.C;
  const int ncv = C / V;
  const int r = threadIdx.x / ncv;
  const int cv = threadIdx.x - r * ncv;

  walk(p, [&](long long b, long long s0, long long s1) {
    float av[V], bv[V];
    const float* ap = a + b * C + cv * V;
    const float* bp = bb + b * C + cv * V;
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(ap + i));
      const float4 z = __ldg(reinterpret_cast<const float4*>(bp + i));
      av[i] = u.x;
      av[i + 1] = u.y;
      av[i + 2] = u.z;
      av[i + 3] = u.w;
      bv[i] = z.x;
      bv[i + 1] = z.y;
      bv[i + 2] = z.z;
      bv[i + 3] = z.w;
    }
    const long long step = (long long)p.rows * C;
    const long long off = (b * p.S + s0 + r) * C + cv * V;
    const T* xp = x + off;
    T* yp = y + off;
    long long cnt = row_count(s0, s1, r, p.rows);
    for (; cnt >= UNROLL; cnt -= UNROLL) {
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(xp + u * step));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        apply_vec<T, SILU>(raw[u], yp + u * step, av, bv);
      xp += UNROLL * step;
      yp += UNROLL * step;
    }
    for (; cnt > 0; --cnt) {
      apply_vec<T, SILU>(__ldg(reinterpret_cast<const uint4*>(xp)), yp, av,
                         bv);
      xp += step;
      yp += step;
    }
  });
}

// The plan of (B, S, C) at `threads` and `grid`, or false where the
// kernels do not take it.
bool make_plan(int B, long long S, int C, int V, int threads, int grid,
               Plan* p) {
  if (B <= 0 || S <= 0 || C <= 0 || C % V != 0 || threads <= 0 ||
      threads > MAX_THREADS || threads % 32 != 0 || threads % (C / V) != 0)
    return false;
  p->S = S;
  p->C = C;
  p->rows = threads / (C / V);
  p->ipb = (S + p->rows - 1) / p->rows;
  p->items = (long long)B * p->ipb;
  return grid >= 1 && grid <= p->items;
}

size_t stats_smem(int threads, int V) { return (size_t)threads * V * 8; }

template <typename K>
int blocks_per_sm(K kernel, int threads, size_t smem) {
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

// Per-(B, C) affine of GroupNorm: a = rstd w, b = bias - mean a (float32,
// (B, C) each), with weight and bias (C,) in float32 or bf16. part is
// float32 scratch of (grid + B - 1) x 2 x C values, arrivals B int32
// counters that are 0 (and are 0 again after the launch).
extern "C" int syn3r_gn_stats(const void* x, const void* weight,
                              const void* bias, void* part, void* arrivals,
                              void* a, void* b, int B, long long S, int C,
                              int G, float eps, int x_bf16, int w_bf16,
                              int threads, int grid, void* stream) {
  const int V = x_bf16 ? 8 : 4;
  Plan p;
  if (!make_plan(B, S, C, V, threads, grid, &p) || G <= 0 ||
      G > MAX_GROUPS || C % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = stats_smem(threads, V);
  float* pt = static_cast<float*>(part);
  int* ar = static_cast<int*>(arrivals);
  float* at = static_cast<float*>(a);
  float* bt = static_cast<float*>(b);
#define SYN3R_GN_STATS(T, TW)                                              \
  gn_stats_kernel<T, TW><<<grid, threads, smem, s>>>(                      \
      static_cast<const T*>(x), static_cast<const TW*>(weight),            \
      static_cast<const TW*>(bias), pt, ar, at, bt, p, G, eps)
  if (x_bf16) {
    if (w_bf16) SYN3R_GN_STATS(bf16, bf16);
    else SYN3R_GN_STATS(bf16, float);
  } else {
    if (w_bf16) SYN3R_GN_STATS(float, bf16);
    else SYN3R_GN_STATS(float, float);
  }
#undef SYN3R_GN_STATS
  return (int)cudaGetLastError();
}

// y = x a + b per (batch, channel), optionally SiLU, in x's type.
extern "C" int syn3r_gn_apply(const void* x, const void* a, const void* b,
                              void* y, int B, long long S, int C, int silu,
                              int x_bf16, int threads, int grid,
                              void* stream) {
  Plan p;
  if (!make_plan(B, S, C, x_bf16 ? 8 : 4, threads, grid, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* at = static_cast<const float*>(a);
  const float* bt = static_cast<const float*>(b);
#define SYN3R_GN_APPLY(T, SILU)                                            \
  gn_apply_kernel<T, SILU><<<grid, threads, 0, s>>>(                       \
      static_cast<const T*>(x), at, bt, static_cast<T*>(y), p)
  if (x_bf16) {
    if (silu) SYN3R_GN_APPLY(bf16, true);
    else SYN3R_GN_APPLY(bf16, false);
  } else {
    if (silu) SYN3R_GN_APPLY(float, true);
    else SYN3R_GN_APPLY(float, false);
  }
#undef SYN3R_GN_APPLY
  return (int)cudaGetLastError();
}

// Resident blocks a SM of the stats kernel (which = 0; variant = weight
// in bf16) or the apply kernel (which = 1; variant = SiLU) at `threads`
// threads a block; a negative cudaError where the query fails.
extern "C" int syn3r_gn_blocks_per_sm(int which, int x_bf16, int variant,
                                      int threads) {
  if (threads <= 0 || threads > MAX_THREADS)
    return -(int)cudaErrorInvalidValue;
  const size_t smem = stats_smem(threads, x_bf16 ? 8 : 4);
  if (which == 0) {
    if (x_bf16)
      return variant
                 ? blocks_per_sm(gn_stats_kernel<bf16, bf16>, threads, smem)
                 : blocks_per_sm(gn_stats_kernel<bf16, float>, threads, smem);
    return variant
               ? blocks_per_sm(gn_stats_kernel<float, bf16>, threads, smem)
               : blocks_per_sm(gn_stats_kernel<float, float>, threads, smem);
  }
  if (x_bf16)
    return variant ? blocks_per_sm(gn_apply_kernel<bf16, true>, threads, 0)
                   : blocks_per_sm(gn_apply_kernel<bf16, false>, threads, 0);
  return variant ? blocks_per_sm(gn_apply_kernel<float, true>, threads, 0)
                 : blocks_per_sm(gn_apply_kernel<float, false>, threads, 0);
}
