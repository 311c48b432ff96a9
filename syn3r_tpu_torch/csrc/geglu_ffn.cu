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
// stay hot in the 50 MB L2 (block x walks the output columns fastest, so
// blocks that run together share one row tile of x).
//
// Design: two tensor-core GEMMs (bf16 mma.sync m16n8k16, f32 accumulate,
// 3-stage cp.async pipeline, 128x128x32 block tiles, 8 warps of 64x32).
//   GEMM-1 computes matching column tiles of a and g in one block (64 of
//   each) and applies the GEGLU epilogue in registers, so only the 4C-wide
//   gated product reaches device memory, never the 8C pre-activation.
//   GEMM-2 multiplies that product by W2 and adds b2.
// Numerics follow `_ffn_kernel`: each product is rounded to bf16, the bias
// is added in bf16, gelu(erf) is evaluated in f32 with the same
// Abramowitz-Stegun 7.1.26 erf and rounded to bf16, and a * gelu(g) is
// rounded to bf16 before the second product.
//
// Weights use torch's Linear layout: W1 (8C, C), W2 (C, 4C), row-major, so
// both operands of each product are K-contiguous.

#include "mma_common.cuh"

using namespace syn3r;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 128;        // rows of x per block
constexpr int BNT = 128;       // columns of W per block (GEGLU: 64 a + 64 g)
constexpr int BK = 32;         // reduction slice per pipeline stage
constexpr int STAGES = 3;
constexpr int LDS = BK + 8;    // padded row: conflict-free ldmatrix
constexpr int THREADS = 256;
constexpr int STAGE_ELEMS = (BM + BNT) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(bf16);

__device__ __forceinline__ float gelu_erf(float x) {
  float z = x * 0.70710678118654752f;
  float az = fabsf(z);
  float t = 1.0f / (1.0f + 0.3275911f * az);
  float poly = t * (0.254829592f +
                    t * (-0.284496736f +
                         t * (1.421413741f +
                              t * (-1.453152027f + t * 1.061405429f))));
  float erf = copysignf(1.0f - poly * expf(-az * az), z);
  return 0.5f * x * (1.0f + erf);
}

// out = epilogue(A (M, K) . W^T); W rows are output columns.
// GEGLU: W is (2N, K); block column tile n0..n0+63 takes W rows n0.. (a) and
// N+n0.. (g); out (M, N) = bf16(a + b[n]) * bf16(gelu(bf16(g + b[N+n]))).
// Plain: W is (N, K); out (M, N) = bf16(bf16(acc) + b[n]).
template <bool GEGLU>
__global__ void __launch_bounds__(THREADS)
    ffn_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                    const bf16* __restrict__ bias, bf16* __restrict__ out,
                    int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps along rows, 64 rows each
  const int wn = warp & 3;   // 4 warps along columns
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * (GEGLU ? BNT / 2 : BNT);
  const int KT = K / BK;

  auto load_stage = [&](int stage, int kt) {
    bf16* sA = smem + stage * STAGE_ELEMS;
    bf16* sB = sA + BM * LDS;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int c = tid + i * THREADS;  // 512 chunks of 8 bf16
      int r = c >> 2, col = (c & 3) * 8;
      int gr = m0 + r;
      bool ok = gr < M;
      cp_async16(sA + r * LDS + col, A + (size_t)(ok ? gr : 0) * K + k0 + col,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int c = tid + i * THREADS;
      int r = c >> 2, col = (c & 3) * 8;
      int gn;
      bool ok;
      if (GEGLU) {
        int nn = n0 + (r & 63);
        ok = nn < N;
        gn = nn + (r >> 6) * N;
      } else {
        gn = n0 + r;
        ok = gn < N;
      }
      cp_async16(sB + r * LDS + col, W + (size_t)(ok ? gn : 0) * K + k0 + col,
                 ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    cp_async_commit();

    const bf16* sA = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* sB = sA + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int r = wm * 64 + i * 16 + (lane & 15);
        int c = kk + (lane >> 4) * 8;
        ldmatrix_x4(a[i][0], a[i][1], a[i][2], a[i][3], sA + r * LDS + c);
      }
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // GEGLU: n-tiles 0,1 are a columns, 2,3 the matching g columns, so
        // each thread holds a and g of the same output element.
        int nb = GEGLU ? p * 64 + wn * 16 : wn * 32 + p * 16;
        int r = nb + (lane & 7) + ((lane >> 4) << 3);
        int c = kk + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b[2 * p][0], b[2 * p][1], b[2 * p + 1][0],
                    b[2 * p + 1][1], sB + r * LDS + c);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + i * 16 + g + half * 8;
      if (row >= M) continue;
      bf16* orow = out + (size_t)row * N;
      if (GEGLU) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 16 + j * 8 + 2 * q;
          if (col >= N) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float ha = round_bf16(round_bf16(acc[i][j][half * 2 + e]) +
                                  __bfloat162float(bias[col + e]));
            float hg = round_bf16(round_bf16(acc[i][j + 2][half * 2 + e]) +
                                  __bfloat162float(bias[N + col + e]));
            v[e] = ha * round_bf16(gelu_erf(hg));
          }
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + wn * 32 + j * 8 + 2 * q;
          if (col >= N) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = round_bf16(acc[i][j][half * 2 + e]) +
                   __bfloat162float(bias[col + e]);
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
  }
}

template <bool GEGLU>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const bf16* bias,
                        bf16* out, int M, int N, int K, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ffn_gemm_kernel<GEGLU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int bn = GEGLU ? BNT / 2 : BNT;
  dim3 grid((N + bn - 1) / bn, (M + BM - 1) / BM);
  ffn_gemm_kernel<GEGLU><<<grid, THREADS, SMEM_BYTES, stream>>>(A, W, bias,
                                                                out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x (rows, c), w1 (8c, c), b1 (8c), w2 (c, 4c), b2 (c), all bf16 and
// contiguous; h (rows, 4c) is scratch for the gated product, y (rows, c)
// the output. Returns a cudaError_t (0 on success).
extern "C" int syn3r_geglu_ffn(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* h,
                               void* y, long long rows, int c, void* stream) {
  if (c <= 0 || c % BK != 0 || rows <= 0 || (rows + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const int m = (int)rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_gemm<true>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<bf16*>(h), m, 4 * c, c, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<false>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(y), m, c, 4 * c, s);
  return (int)err;
}
