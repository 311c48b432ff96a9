// GroupNorm over channel-last (B, S, C), written by hand for Hopper (sm_90a).
//
// Replaces: syn3r_tpu/ops/pallas_norm.py `_gn_stats_kernel` (per-(B, C) sums
// of x and x^2 over S) and `_gn_apply_kernel` (y = x a + b, optional SiLU,
// cast to x's type), both launched by `group_norm_pallas`. The group fold
// that JAX runs between its two kernels (pallas_norm.py:147-156) is the
// second kernel of the stats entry point here.
//
// Bound on the H100: a few operations per element against 2 (bf16) or 4
// (float32) bytes, so device memory bounds both passes: the stats read x
// once, the apply reads it again and writes y (3 x the tensor in all). At
// the main path's largest call (3 x 25 x 9216 x 320 bf16, 442 MB) that is
// 0.40 ms at 3.35 TB/s.
//
// Design (a simple, correct first kernel; no tuning yet):
//   gn_partial: grid (nsplit, B). A block sums a slice of the S rows of one
//     batch element. Its threads tile the rows as (rows_par, C / V) with V
//     elements (16 bytes) a thread, so a warp reads contiguous memory, and
//     each thread keeps V running float32 sums of x and of x^2. The block
//     folds its rows_par partial rows through shared memory in a fixed order
//     and writes one (2, C) partial. Splitting S matters: the temporal
//     resnet's norm is (3, 230400, C), three blocks with a grid over B alone.
//   gn_fold: grid (group blocks, B). Each thread sums the nsplit partials of
//     one channel in split order (no atomics: the result is deterministic),
//     each group folds its channels, mean = s1 / n, var = s2 / n - mean^2
//     (not Welford, as the reference), rstd = rsqrt(var + eps), and the
//     block writes the per-(B, C) affine a = rstd w, b = bias - mean a.
//   gn_apply: grid (blocks, B), one read-write pass, V elements a thread:
//     y = x a + b, then y / (1 + exp(-y)) for the fused SiLU, rounded to
//     x's type.

#include "norm_common.cuh"

using namespace syn3r;
using bf16 = __nv_bfloat16;

namespace {

constexpr int FOLD_THREADS = 256;
constexpr int APPLY_THREADS = 256;

template <typename T>
__global__ void gn_partial_kernel(const T* __restrict__ x,
                                  float* __restrict__ part, long long S, int C,
                                  long long rows_per_split) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float sh[];  // (2, rows_par, C)
  const int ncv = C / V;
  const int rows_par = blockDim.x / ncv;
  const int r = threadIdx.x / ncv;
  const int cv = threadIdx.x - r * ncv;
  const int b = blockIdx.y;
  const int k = blockIdx.x;
  const long long s0 = (long long)k * rows_per_split;
  const long long s1 = min(S, s0 + rows_per_split);

  if (r < rows_par) {
    float a1[V], a2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) a1[i] = a2[i] = 0.0f;
    const T* base = x + (long long)b * S * C + (long long)cv * V;
#pragma unroll 4
    for (long long s = s0 + r; s < s1; s += rows_par) {
      float v[V];
      Vec<T>::load(base + s * C, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        a1[i] += v[i];
        a2[i] = fmaf(v[i], v[i], a2[i]);
      }
    }
    float* p1 = sh + (size_t)r * C + cv * V;
    float* p2 = sh + (size_t)(rows_par + r) * C + cv * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      p1[i] = a1[i];
      p2[i] = a2[i];
    }
  }
  __syncthreads();
  float* out = part + ((size_t)b * gridDim.x + k) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int q = 0; q < rows_par; ++q) {
      t1 += sh[(size_t)q * C + c];
      t2 += sh[(size_t)(rows_par + q) * C + c];
    }
    out[c] = t1;
    out[C + c] = t2;
  }
}

__global__ void __launch_bounds__(FOLD_THREADS)
    gn_fold_kernel(const float* __restrict__ part,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ a,
                   float* __restrict__ bb, int nsplit, int C, int G,
                   int groups_per_block, float n, float eps) {
  __shared__ float s1[FOLD_THREADS], s2[FOLD_THREADS];
  __shared__ float mean_s[FOLD_THREADS], rstd_s[FOLD_THREADS];
  const int cg = C / G;
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * groups_per_block;
  const int ng = min(groups_per_block, G - g0);
  const int c0 = g0 * cg;
  const int nch = ng * cg;
  const float* pb = part + (size_t)b * nsplit * 2 * C;

  for (int i = threadIdx.x; i < nch; i += blockDim.x) {
    float t1 = 0.0f, t2 = 0.0f;
#pragma unroll 8
    for (int k = 0; k < nsplit; ++k) {
      t1 += pb[(size_t)k * 2 * C + c0 + i];
      t2 += pb[(size_t)k * 2 * C + C + c0 + i];
    }
    s1[i] = t1;
    s2[i] = t2;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < ng; g += blockDim.x) {
    float g1 = 0.0f, g2 = 0.0f;
    for (int j = 0; j < cg; ++j) {
      g1 += s1[g * cg + j];
      g2 += s2[g * cg + j];
    }
    const float mean = g1 / n;
    const float var = g2 / n - mean * mean;
    mean_s[g] = mean;
    rstd_s[g] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nch; i += blockDim.x) {
    const int g = i / cg;
    const int c = c0 + i;
    const float av = rstd_s[g] * weight[c];
    a[(size_t)b * C + c] = av;
    bb[(size_t)b * C + c] = bias[c] - mean_s[g] * av;
  }
}

template <typename T>
__global__ void __launch_bounds__(APPLY_THREADS)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ bb, T* __restrict__ y,
                    long long S, int C, int silu) {
  constexpr int V = Vec<T>::N;
  const int b = blockIdx.y;
  const long long nvec = S * C / V;
  const T* xb = x + (long long)b * S * C;
  T* yb = y + (long long)b * S * C;
  const float* ab = a + (size_t)b * C;
  const float* bbb = bb + (size_t)b * C;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < nvec; e += (long long)gridDim.x * blockDim.x) {
    const int c = (int)((e * V) % C);
    float v[V];
    Vec<T>::load(xb + e * V, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float o = fmaf(v[i], __ldg(ab + c + i), __ldg(bbb + c + i));
      if (silu) o = o / (1.0f + expf(-o));
      v[i] = o;
    }
    Vec<T>::store(yb + e * V, v);
  }
}

template <typename T>
int gn_stats(const void* x, const void* weight, const void* bias, void* part,
             void* a, void* bb, int B, long long S, int C, int G, float eps,
             int nsplit, int threads, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int ncv = C / V;
  const int cg = C / G;
  if (C % V != 0 || C % G != 0 || cg > FOLD_THREADS || threads % 32 != 0 ||
      threads < ncv || threads > 512 || nsplit < 1 || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  const int rows_par = threads / ncv;
  const long long rows_per_split = (S + nsplit - 1) / nsplit;
  const size_t smem = (size_t)2 * rows_par * C * sizeof(float);
  gn_partial_kernel<T><<<dim3(nsplit, B), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), S, C,
      rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int gpb = FOLD_THREADS / cg;
  const float n = (float)(S * (long long)cg);
  gn_fold_kernel<<<dim3((G + gpb - 1) / gpb, B), FOLD_THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(a),
      static_cast<float*>(bb), nsplit, C, G, gpb, n, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int gn_apply(const void* x, const void* a, const void* bb, void* y, int B,
             long long S, int C, int silu, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (C % V != 0) return (int)cudaErrorInvalidValue;
  const long long nvec = S * C / V;
  // about eight resident 256-thread blocks a SM over the whole grid
  long long per_b = (132LL * 8 + B - 1) / B;
  const long long need = (nvec + APPLY_THREADS - 1) / APPLY_THREADS;
  if (per_b > need) per_b = need;
  if (per_b < 1) per_b = 1;
  gn_apply_kernel<T><<<dim3((unsigned)per_b, B), APPLY_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const float*>(bb), static_cast<T*>(y), S, C, silu);
  return (int)cudaGetLastError();
}

}  // namespace

// Per-(B, C) affine of GroupNorm: a = rstd w, b = bias - mean a (float32,
// (B, C) each). part is float32 scratch of nsplit * B * 2 * C values.
extern "C" int syn3r_gn_stats(const void* x, const void* weight,
                              const void* bias, void* part, void* a, void* b,
                              int B, long long S, int C, int G, float eps,
                              int nsplit, int threads, int is_bf16,
                              void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || C <= 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? gn_stats<bf16>(x, weight, bias, part, a, b, B, S, C, G,
                                  eps, nsplit, threads, s)
                 : gn_stats<float>(x, weight, bias, part, a, b, B, S, C, G,
                                   eps, nsplit, threads, s);
}

// y = x a + b per (batch, channel), optionally SiLU, in x's type.
extern "C" int syn3r_gn_apply(const void* x, const void* a, const void* b,
                              void* y, int B, long long S, int C, int silu,
                              int is_bf16, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? gn_apply<bf16>(x, a, b, y, B, S, C, silu, s)
                 : gn_apply<float>(x, a, b, y, B, S, C, silu, s);
}
