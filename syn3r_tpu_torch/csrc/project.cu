// EWA projection and SH colour of every Gaussian slot for one camera,
// forward and backward, written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package leaves `project_gaussians`
// (syn3r_tpu/ops/rasterize.py:55) to XLA, which fuses its elementwise work
// and its 2x3 and 3x3 products into a few loops over the slots. Written in
// PyTorch it ran as batched float32 GEMMs with 32x32 tiles for 2x3 and 3x3
// products (3 bmm + 3 mm forward, 6 bmm + 2 mm backward) and ~650
// elementwise launches over (N,) tensors a train step. Here one thread
// takes one slot, forward and backward, and keeps every intermediate in
// registers. The forward, per slot n (`ops/rasterize.py`'s plain version,
// line by line):
//   t = R m + tv; tz_safe = tz, or 1e-6 where |tz| < 1e-6
//   centre = (fx tx / tz_safe + cx, fy ty / tz_safe + cy) (+ offset)
//   J = [fx/tz, 0, -fx txz/tz^2; 0, fy/tz, -fy tyz/tz^2] with tx/tz and
//       ty/tz clamped to 1.3x the half frustum; T = J R
//   Sigma = R_q diag(exp(2 log_s)) R_q^T, q normalised by rsqrt(|q|^2+1e-12)
//   (a, b, c) = T Sigma T^T + 0.3 I; det = ac - b^2; conic = (c, -b, a) /
//       det (det 1 where det <= 0); radius = ceil(3 sqrt(lambda_max))
//   rgb = max(SH(d / |d|) + 0.5, 0), d = m - camera position
//   valid = active & tz > near & det > 0; opacity = sigmoid(logit) or 0
// The backward takes the gradients of centre, conic, rgb, depth and
// opacity, recomputes the forward's intermediates from the parameters (so
// nothing but the inputs is saved) and writes the gradients of every
// parameter in its own layout, by the rules of autograd through the plain
// version: the clamps pass the gradient on their inclusive bounds, the
// `where` branches of tz_safe, det_safe and valid pass none to the side
// not taken, radius takes none, and the view direction carries the SH
// colour's gradient into the means. Its plain mirror, line by line, is
// `project_bwd_reference` in ops/rasterize.py.
//
// Bound on the H100: bytes. A slot costs ~60 float32 operations forward and
// ~250 backward, ~0.04 GFLOP at 131,072 slots; it moves ~237 B forward
// (means 12, quaternion 16, log-scales 12, opacity logit 4, SH 192, active
// flag 1) and writes ~45 B (centre 8, conic 12, rgb 12, depth, opacity,
// radius 4 each, valid 1); the backward reads ~275 B (the inputs and the 36
// B of output gradients) and writes ~244 B (the parameter gradients). About
// 100 MB a train step at 131,072 slots: ~31 us at 3.35 TB/s, three orders
// of magnitude above the operations' time at 67 TFLOP/s.
//
// Design:
//  * The SH rows are 80% of the bytes: sh_rest (N, 3 (K - 1)), 180 B a slot
//    at degree 3. A thread reading its own row would touch 45 words 180 B
//    apart in a warp, one sector per lane per load. Instead each block of
//    128 slots stages its 128 contiguous rows through shared memory with
//    16-byte loads from consecutive addresses (`stage`), and the backward
//    writes the rows of d sh_rest back the same way, zeros beyond the
//    degree included, so every SH byte moves in full sectors.
//    A thread then reads its row in shared memory at a stride of 45 words,
//    which is odd: no bank conflicts.
//  * The SH degree is a template parameter (0 to 3): DTU, DL3DV and LLFF
//    take the same kernel, and a lower degree reads and computes only its
//    coefficients (degree 0 stages nothing in the forward).
//  * The smaller rows (12 or 16 B a slot) are read and written by each
//    thread; a warp's accesses cover whole lines, which L1 and L2 merge.
//  * No atomics: every output belongs to one thread, so two calls give the
//    same bits. The kernels launch on the caller's stream and synchronise
//    nothing, so the train step still captures as one CUDA graph.
//  * Numerics: float32 with nvcc's IEEE division and square root (no
//    fast-math, no __expf or __fdividef); 1/sqrt is written as a division
//    by sqrtf (IEEE), not rsqrtf (approximate). nvcc contracts products and
//    sums into FMAs, so sums round differently from the plain version:
//    chip_smoke.py and tests/test_torch_project.py hold both kernels to the
//    plain versions at the gs cell's shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_REST = 45;     // 3 x 15: SH degree 3

constexpr float SH_C0 = 0.28209479177387814f;
constexpr float SH_C1 = 0.4886025119029199f;
constexpr float SH_C2_0 = 1.0925484305920792f;
constexpr float SH_C2_1 = -1.0925484305920792f;
constexpr float SH_C2_2 = 0.31539156525252005f;
constexpr float SH_C2_3 = -1.0925484305920792f;
constexpr float SH_C2_4 = 0.5462742152960396f;
constexpr float SH_C3_0 = -0.5900435899266435f;
constexpr float SH_C3_1 = 2.890611442640554f;
constexpr float SH_C3_2 = -0.4570457994644658f;
constexpr float SH_C3_3 = 0.3731763325901154f;
constexpr float SH_C3_4 = -0.4570457994644658f;
constexpr float SH_C3_5 = 1.445305721320277f;
constexpr float SH_C3_6 = -0.5900435899266435f;

struct Camera {
  float r[9];      // world-to-camera rotation, row-major
  float t[3];
  float fx, fy, cx, cy;
  float pos[3];    // camera centre in world coordinates
  float lim_x, lim_y;
};

// w2c (4, 4) and K (3, 3), row-major float32 on the device: every thread
// reads the same words (one broadcast each a warp).
__device__ __forceinline__ Camera load_camera(const float* __restrict__ w2c,
                                              const float* __restrict__ K,
                                              float lim_num_x,
                                              float lim_num_y) {
  Camera c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.r[3 * i + j] = w2c[4 * i + j];
    c.t[i] = w2c[4 * i + 3];
  }
  c.fx = K[0];
  c.fy = K[4];
  c.cx = K[2];
  c.cy = K[5];
  // -(R^T t), as utils/se3.se3_inverse
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c.pos[i] = -(c.r[i] * c.t[0] + c.r[3 + i] * c.t[1] + c.r[6 + i] * c.t[2]);
  // the plain version's `1.3 * 0.5 * width / fx`: a host float over a
  // tensor, which torch computes as reciprocal(fx) * scalar
  c.lim_x = (1.0f / c.fx) * lim_num_x;
  c.lim_y = (1.0f / c.fy) * lim_num_y;
  return c;
}

// Everything the forward computes of one slot, and what the backward needs
// again. The forward's compiler drops what it does not use.
struct Slot {
  float m[3], t[3], tz, tzs;
  bool tz_kept;                  // |tz| >= 1e-6: tz_safe is tz
  float crx, cry;                // tx / tz_safe and ty / tz_safe, clamped
  bool rx_in, ry_in;             // inside the clamp's bounds (inclusive)
  float j02, j12;                // the Jacobian's tz entries
  float T[6];                    // J R, rows 0 and 1
  float qr, qn[4];               // 1/|q|, the normalised quaternion
  float rq[9];                   // its rotation, row-major
  float s2[3];                   // exp(2 log_s)
  float sig[9];                  // Sigma, full
  float M[6];                    // T Sigma
  float a, b, c, det, ds;
};

__device__ __forceinline__ Slot geometry(const Camera& cam,
                                         const float* __restrict__ means,
                                         const float* __restrict__ quats,
                                         const float* __restrict__ log_scales,
                                         int64_t i) {
  Slot s;
#pragma unroll
  for (int k = 0; k < 3; ++k) s.m[k] = means[3 * i + k];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    s.t[k] = cam.r[3 * k] * s.m[0] + cam.r[3 * k + 1] * s.m[1] +
             cam.r[3 * k + 2] * s.m[2] + cam.t[k];
  s.tz = s.t[2];
  s.tz_kept = !(fabsf(s.tz) < 1e-6f);
  s.tzs = s.tz_kept ? s.tz : 1e-6f;

  const float rx = s.t[0] / s.tzs, ry = s.t[1] / s.tzs;
  s.rx_in = rx >= -cam.lim_x && rx <= cam.lim_x;
  s.ry_in = ry >= -cam.lim_y && ry <= cam.lim_y;
  s.crx = fminf(fmaxf(rx, -cam.lim_x), cam.lim_x);
  s.cry = fminf(fmaxf(ry, -cam.lim_y), cam.lim_y);
  const float tz2 = s.tzs * s.tzs;
  const float j00 = cam.fx / s.tzs, j11 = cam.fy / s.tzs;
  s.j02 = -cam.fx * (s.crx * s.tzs) / tz2;
  s.j12 = -cam.fy * (s.cry * s.tzs) / tz2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.T[k] = j00 * cam.r[k] + s.j02 * cam.r[6 + k];
    s.T[3 + k] = j11 * cam.r[3 + k] + s.j12 * cam.r[6 + k];
  }

  const float4 q = reinterpret_cast<const float4*>(quats)[i];
  s.qr = 1.0f / sqrtf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w + 1e-12f);
  const float w = q.x * s.qr, x = q.y * s.qr, y = q.z * s.qr, z = q.w * s.qr;
  s.qn[0] = w; s.qn[1] = x; s.qn[2] = y; s.qn[3] = z;
  s.rq[0] = 1.0f - 2.0f * (y * y + z * z);
  s.rq[1] = 2.0f * (x * y - w * z);
  s.rq[2] = 2.0f * (x * z + w * y);
  s.rq[3] = 2.0f * (x * y + w * z);
  s.rq[4] = 1.0f - 2.0f * (x * x + z * z);
  s.rq[5] = 2.0f * (y * z - w * x);
  s.rq[6] = 2.0f * (x * z - w * y);
  s.rq[7] = 2.0f * (y * z + w * x);
  s.rq[8] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int k = 0; k < 3; ++k) s.s2[k] = expf(2.0f * log_scales[3 * i + k]);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      s.sig[3 * a + b] = s.rq[3 * a] * s.s2[0] * s.rq[3 * b] +
                         s.rq[3 * a + 1] * s.s2[1] * s.rq[3 * b + 1] +
                         s.rq[3 * a + 2] * s.s2[2] * s.rq[3 * b + 2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      s.M[3 * r + k] = s.T[3 * r] * s.sig[k] + s.T[3 * r + 1] * s.sig[3 + k] +
                       s.T[3 * r + 2] * s.sig[6 + k];
  s.a = s.M[0] * s.T[0] + s.M[1] * s.T[1] + s.M[2] * s.T[2] + 0.3f;
  s.b = s.M[0] * s.T[3] + s.M[1] * s.T[4] + s.M[2] * s.T[5];
  s.c = s.M[3] * s.T[3] + s.M[4] * s.T[4] + s.M[5] * s.T[5] + 0.3f;
  s.det = s.a * s.c - s.b * s.b;
  s.ds = s.det <= 0.0f ? 1.0f : s.det;
  return s;
}

// The unit view direction of slot position m from the camera, and
// 1/sqrt(|d|^2 + 1e-12).
__device__ __forceinline__ void view_dir(const Camera& cam, const float* m,
                                         float* d, float* dn, float* r) {
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = m[k] - cam.pos[k];
  *r = 1.0f / sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) dn[k] = d[k] * *r;
}

// The real SH basis b_k(x, y, z), k < (D + 1)^2, with its constants
// (models/gaussians.eval_sh's terms).
template <int D>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  b[0] = SH_C0;
  if (D >= 1) {
    b[1] = -(SH_C1 * y);
    b[2] = SH_C1 * z;
    b[3] = -(SH_C1 * x);
  }
  if (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = SH_C2_0 * xy;
    b[5] = SH_C2_1 * yz;
    b[6] = SH_C2_2 * (2.0f * zz - xx - yy);
    b[7] = SH_C2_3 * xz;
    b[8] = SH_C2_4 * (xx - yy);
    if (D >= 3) {
      b[9] = SH_C3_0 * y * (3.0f * xx - yy);
      b[10] = SH_C3_1 * xy * z;
      b[11] = SH_C3_2 * y * (4.0f * zz - xx - yy);
      b[12] = SH_C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = SH_C3_4 * x * (4.0f * zz - xx - yy);
      b[14] = SH_C3_5 * z * (xx - yy);
      b[15] = SH_C3_6 * x * (xx - 3.0f * yy);
    }
  }
}

// g += sum_k w_k grad b_k(x, y, z), k from 1 to (D + 1)^2 - 1.
template <int D>
__device__ __forceinline__ void sh_basis_grad(float x, float y, float z,
                                              const float* w, float* g) {
  if (D >= 1) {
    g[0] -= SH_C1 * w[3];
    g[1] -= SH_C1 * w[1];
    g[2] += SH_C1 * w[2];
  }
  if (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    g[0] += SH_C2_0 * y * w[4] - 2.0f * SH_C2_2 * x * w[6] +
            SH_C2_3 * z * w[7] + 2.0f * SH_C2_4 * x * w[8];
    g[1] += SH_C2_0 * x * w[4] + SH_C2_1 * z * w[5] -
            2.0f * SH_C2_2 * y * w[6] - 2.0f * SH_C2_4 * y * w[8];
    g[2] += SH_C2_1 * y * w[5] + 4.0f * SH_C2_2 * z * w[6] +
            SH_C2_3 * x * w[7];
    if (D >= 3) {
      g[0] += SH_C3_0 * 6.0f * x * y * w[9] + SH_C3_1 * y * z * w[10] -
              SH_C3_2 * 2.0f * x * y * w[11] -
              SH_C3_3 * 6.0f * x * z * w[12] +
              SH_C3_4 * (4.0f * zz - 3.0f * xx - yy) * w[13] +
              SH_C3_5 * 2.0f * x * z * w[14] +
              SH_C3_6 * (3.0f * xx - 3.0f * yy) * w[15];
      g[1] += SH_C3_0 * (3.0f * xx - 3.0f * yy) * w[9] +
              SH_C3_1 * x * z * w[10] +
              SH_C3_2 * (4.0f * zz - xx - 3.0f * yy) * w[11] -
              SH_C3_3 * 6.0f * y * z * w[12] -
              SH_C3_4 * 2.0f * x * y * w[13] -
              SH_C3_5 * 2.0f * y * z * w[14] -
              SH_C3_6 * 6.0f * x * y * w[15];
      g[2] += SH_C3_1 * x * y * w[10] + SH_C3_2 * 8.0f * y * z * w[11] +
              SH_C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * w[12] +
              SH_C3_4 * 8.0f * x * z * w[13] + SH_C3_5 * (xx - yy) * w[14];
    }
  }
}

// `count` floats from src to dst, by the block, 16 bytes an access where
// `global` (the side in device memory) is 16-byte aligned. A block's rows
// start 128 x row bytes into sh_rest, a multiple of 16: the base decides.
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src,
                                      int count, const float* global) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(global) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < n4; k += THREADS) d4[k] = s4[k];
    done = 4 * n4;
  }
  for (int k = done + threadIdx.x; k < count; k += THREADS) dst[k] = src[k];
}

template <int D>
__global__ void __launch_bounds__(THREADS) project_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ log_scales,
    const float* __restrict__ opacity_logits,
    const float* __restrict__ sh_dc, const float* __restrict__ sh_rest,
    const uint8_t* __restrict__ active, const float* __restrict__ offset,
    const float* __restrict__ w2c, const float* __restrict__ K,
    float* __restrict__ center, float* __restrict__ conic,
    float* __restrict__ rgb, float* __restrict__ depth,
    float* __restrict__ opacity, float* __restrict__ radius,
    uint8_t* __restrict__ valid, int n, int rest, float lim_num_x,
    float lim_num_y, float near) {
  constexpr int KC = (D + 1) * (D + 1);
  __shared__ __align__(16) float sh_s[THREADS * MAX_REST];
  const int64_t base = (int64_t)blockIdx.x * THREADS;
  const int64_t left = (int64_t)n - base;
  const int rows = left < THREADS ? (int)left : THREADS;
  if (D > 0) {
    stage(sh_s, sh_rest + base * rest, rows * rest, sh_rest + base * rest);
    __syncthreads();
  }
  if ((int)threadIdx.x >= rows) return;
  const int64_t i = base + threadIdx.x;
  const Camera cam = load_camera(w2c, K, lim_num_x, lim_num_y);
  const Slot s = geometry(cam, means, quats, log_scales, i);

  float u = cam.fx * s.t[0] / s.tzs + cam.cx;
  float v = cam.fy * s.t[1] / s.tzs + cam.cy;
  if (offset != nullptr) {
    u += offset[2 * i];
    v += offset[2 * i + 1];
  }
  reinterpret_cast<float2*>(center)[i] = make_float2(u, v);
  conic[3 * i] = s.c / s.ds;
  conic[3 * i + 1] = -s.b / s.ds;
  conic[3 * i + 2] = s.a / s.ds;
  const float mid = 0.5f * (s.a + s.c);
  const float lam1 = mid + sqrtf(fmaxf(mid * mid - s.det, 0.1f));
  radius[i] = ceilf(3.0f * sqrtf(lam1));
  depth[i] = s.tz;

  float d[3], dn[3], r;
  view_dir(cam, s.m, d, dn, &r);
  float bas[16];
  sh_basis<D>(dn[0], dn[1], dn[2], bas);
  const float* row = sh_s + threadIdx.x * rest;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float res = bas[0] * sh_dc[3 * i + ch];
#pragma unroll
    for (int k = 1; k < KC; ++k) res += bas[k] * row[3 * (k - 1) + ch];
    rgb[3 * i + ch] = fmaxf(res + 0.5f, 0.0f);
  }

  const bool ok = active[i] != 0 && s.tz > near && s.det > 0.0f;
  valid[i] = ok;
  opacity[i] = ok ? 1.0f / (1.0f + expf(-opacity_logits[i])) : 0.0f;
}

template <int D>
__global__ void __launch_bounds__(THREADS) project_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ log_scales,
    const float* __restrict__ opacity_logits,
    const float* __restrict__ sh_dc, const float* __restrict__ sh_rest,
    const uint8_t* __restrict__ active, const float* __restrict__ w2c,
    const float* __restrict__ K, const float* __restrict__ g_center,
    const float* __restrict__ g_conic, const float* __restrict__ g_rgb,
    const float* __restrict__ g_depth, const float* __restrict__ g_opacity,
    float* __restrict__ d_means, float* __restrict__ d_quats,
    float* __restrict__ d_log_scales, float* __restrict__ d_opacity_logits,
    float* __restrict__ d_sh_dc, float* __restrict__ d_sh_rest, int n,
    int rest, float lim_num_x, float lim_num_y, float near) {
  constexpr int KC = (D + 1) * (D + 1);
  __shared__ __align__(16) float sh_s[THREADS * MAX_REST];
  const int64_t base = (int64_t)blockIdx.x * THREADS;
  const int64_t left = (int64_t)n - base;
  const int rows = left < THREADS ? (int)left : THREADS;
  if (D > 0) {
    stage(sh_s, sh_rest + base * rest, rows * rest, sh_rest + base * rest);
    __syncthreads();
  }
  if ((int)threadIdx.x < rows) {
    const int64_t i = base + threadIdx.x;
    const Camera cam = load_camera(w2c, K, lim_num_x, lim_num_y);
    const Slot s = geometry(cam, means, quats, log_scales, i);
    const bool ok = active[i] != 0 && s.tz > near && s.det > 0.0f;

    // opacity = sigmoid(logit) where valid
    float dol = 0.0f;
    if (ok && g_opacity != nullptr) {
      const float sg = 1.0f / (1.0f + expf(-opacity_logits[i]));
      dol = g_opacity[i] * (1.0f - sg) * sg;
    }
    d_opacity_logits[i] = dol;

    // colour: rgb = max(SH(dn) + 0.5, 0); the clamp passes the gradient
    // where SH + 0.5 >= 0
    float d[3], dn[3], r;
    view_dir(cam, s.m, d, dn, &r);
    float bas[16];
    sh_basis<D>(dn[0], dn[1], dn[2], bas);
    float* row = sh_s + threadIdx.x * rest;
    float ge[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float res = bas[0] * sh_dc[3 * i + ch];
#pragma unroll
      for (int k = 1; k < KC; ++k) res += bas[k] * row[3 * (k - 1) + ch];
      ge[ch] = (g_rgb != nullptr && res + 0.5f >= 0.0f) ? g_rgb[3 * i + ch]
                                                        : 0.0f;
      d_sh_dc[3 * i + ch] = ge[ch] * bas[0];
    }
    // w_k = sum over channels of ge * sh_k; d sh_k = ge b_k, written over
    // the row it was read from
    float wk[16];
#pragma unroll
    for (int k = 1; k < KC; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        acc += ge[ch] * row[3 * (k - 1) + ch];
        row[3 * (k - 1) + ch] = ge[ch] * bas[k];
      }
      wk[k] = acc;
    }
    for (int k = 3 * (KC - 1); k < rest; ++k) row[k] = 0.0f;
    float gdn[3] = {0.0f, 0.0f, 0.0f};
    sh_basis_grad<D>(dn[0], dn[1], dn[2], wk, gdn);
    // dn = d r, r = (|d|^2 + 1e-12)^(-1/2): dd = r gdn - r^3 (gdn . d) d
    const float gd_dot = gdn[0] * d[0] + gdn[1] * d[1] + gdn[2] * d[2];
    const float r3 = r * r * r;
    float dm[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) dm[k] = r * gdn[k] - r3 * gd_dot * d[k];

    // conic = (c, -b, a) / det_safe; det_safe = det where det > 0
    float gk0 = 0.0f, gk1 = 0.0f, gk2 = 0.0f;
    if (g_conic != nullptr) {
      gk0 = g_conic[3 * i];
      gk1 = g_conic[3 * i + 1];
      gk2 = g_conic[3 * i + 2];
    }
    float da = gk2 / s.ds, db = -gk1 / s.ds, dc = gk0 / s.ds;
    if (s.det > 0.0f) {
      // d/d det of (c, -b, a) / det is -conic / det: no det^2 to overflow
      const float ddet = -(gk0 * (s.c / s.ds) + gk1 * (-s.b / s.ds) +
                           gk2 * (s.a / s.ds)) / s.ds;
      da += s.c * ddet;
      dc += s.a * ddet;
      db -= 2.0f * s.b * ddet;
    }
    // (a, b, c) = (M0 . T0, M0 . T1, M1 . T1), M = T Sigma
    float dM[6], dT[6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dM[k] = da * s.T[k] + db * s.T[3 + k];
      dM[3 + k] = dc * s.T[3 + k];
      dT[k] = da * s.M[k];
      dT[3 + k] = db * s.M[k] + dc * s.M[3 + k];
    }
    // M = T Sigma: dT += dM Sigma^T, dSigma = T^T dM
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        dT[3 * rr + j] += dM[3 * rr] * s.sig[3 * j] +
                          dM[3 * rr + 1] * s.sig[3 * j + 1] +
                          dM[3 * rr + 2] * s.sig[3 * j + 2];
    float dsig[9];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dsig[3 * j + k] = s.T[j] * dM[k] + s.T[3 + j] * dM[3 + k];

    // Sigma = Rq diag(s2) Rq^T with G = dSigma + dSigma^T:
    // dRq_ij = s2_j (G Rq)_ij; ds2_j = 1/2 Rq_j^T G Rq_j (column j)
    float G[9];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        G[3 * a + b] = dsig[3 * a + b] + dsig[3 * b + a];
    float drq[9];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float gr[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        gr[a] = G[3 * a] * s.rq[j] + G[3 * a + 1] * s.rq[3 + j] +
                G[3 * a + 2] * s.rq[6 + j];
#pragma unroll
      for (int a = 0; a < 3; ++a) drq[3 * a + j] = s.s2[j] * gr[a];
      const float ds2 = 0.5f * (s.rq[j] * gr[0] + s.rq[3 + j] * gr[1] +
                                s.rq[6 + j] * gr[2]);
      d_log_scales[3 * i + j] = 2.0f * s.s2[j] * ds2;
    }
    // the rotation of the normalised quaternion (w, x, y, z)
    const float w = s.qn[0], x = s.qn[1], y = s.qn[2], z = s.qn[3];
    const float dw = 2.0f * (-z * drq[1] + y * drq[2] + z * drq[3] -
                             x * drq[5] - y * drq[6] + x * drq[7]);
    const float dx = 2.0f * (y * drq[1] + z * drq[2] + y * drq[3] -
                             2.0f * x * drq[4] - w * drq[5] + z * drq[6] +
                             w * drq[7] - 2.0f * x * drq[8]);
    const float dy = 2.0f * (-2.0f * y * drq[0] + x * drq[1] + w * drq[2] +
                             x * drq[3] + z * drq[5] - w * drq[6] +
                             z * drq[7] - 2.0f * y * drq[8]);
    const float dz = 2.0f * (-2.0f * z * drq[0] - w * drq[1] + x * drq[2] +
                             w * drq[3] - 2.0f * z * drq[4] + y * drq[5] +
                             x * drq[6] + y * drq[7]);
    // qn = q qr, qr = (|q|^2 + 1e-12)^(-1/2): dq = qr dqn - qr^3 (dqn . q) q
    const float4 q = reinterpret_cast<const float4*>(quats)[i];
    const float dq_dot = dw * q.x + dx * q.y + dy * q.z + dz * q.w;
    const float qr3 = s.qr * s.qr * s.qr;
    reinterpret_cast<float4*>(d_quats)[i] = make_float4(
        s.qr * dw - qr3 * dq_dot * q.x, s.qr * dx - qr3 * dq_dot * q.y,
        s.qr * dy - qr3 * dq_dot * q.z, s.qr * dz - qr3 * dq_dot * q.w);

    // T = J R: dJ = dT R^T
    float dj[4];    // j00, j02, j11, j12
    dj[0] = dT[0] * cam.r[0] + dT[1] * cam.r[1] + dT[2] * cam.r[2];
    dj[1] = dT[0] * cam.r[6] + dT[1] * cam.r[7] + dT[2] * cam.r[8];
    dj[2] = dT[3] * cam.r[3] + dT[4] * cam.r[4] + dT[5] * cam.r[5];
    dj[3] = dT[3] * cam.r[6] + dT[4] * cam.r[7] + dT[5] * cam.r[8];
    const float tz2 = s.tzs * s.tzs;
    float dt[3] = {0.0f, 0.0f, 0.0f};
    // j00 = fx / tz, j11 = fy / tz
    float dtzs = -(dj[0] * cam.fx + dj[2] * cam.fy) / tz2;
    // j02 = (-fx txz) / tz^2, j12 = (-fy tyz) / tz^2
    const float dtxz = -cam.fx * (dj[1] / tz2);
    const float dtyz = -cam.fy * (dj[3] / tz2);
    dtzs -= 2.0f * s.tzs * (dj[1] * s.j02 + dj[3] * s.j12) / tz2;
    // txz = clamp(rx) tz_safe, rx = tx / tz_safe
    dtzs += dtxz * s.crx + dtyz * s.cry;
    const float drx = s.rx_in ? dtxz * s.tzs : 0.0f;
    const float dry = s.ry_in ? dtyz * s.tzs : 0.0f;
    dt[0] += drx / s.tzs;
    dt[1] += dry / s.tzs;
    dtzs -= (drx * s.t[0] + dry * s.t[1]) / tz2;
    // centre = (fx tx / tz_safe + cx, fy ty / tz_safe + cy)
    if (g_center != nullptr) {
      const float gu = g_center[2 * i], gv = g_center[2 * i + 1];
      dt[0] += cam.fx * (gu / s.tzs);
      dt[1] += cam.fy * (gv / s.tzs);
      dtzs -= (gu * (cam.fx * s.t[0]) + gv * (cam.fy * s.t[1])) / tz2;
    }
    dt[2] = s.tz_kept ? dtzs : 0.0f;
    if (g_depth != nullptr) dt[2] += g_depth[i];
    // t = R m + tv: dm += R^T dt
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d_means[3 * i + k] = dm[k] + cam.r[k] * dt[0] + cam.r[3 + k] * dt[1] +
                           cam.r[6 + k] * dt[2];
  }
  if (rest > 0) {
    __syncthreads();
    stage(d_sh_rest + base * rest, sh_s, rows * rest, d_sh_rest + base * rest);
  }
}

template <int D>
cudaError_t launch_fwd(dim3 grid, cudaStream_t st, const float* means,
                       const float* quats, const float* log_scales,
                       const float* opacity_logits, const float* sh_dc,
                       const float* sh_rest, const uint8_t* active,
                       const float* offset, const float* w2c, const float* K,
                       float* center, float* conic, float* rgb, float* depth,
                       float* opacity, float* radius, uint8_t* valid, int n,
                       int rest, float lim_num_x, float lim_num_y,
                       float near) {
  project_fwd_kernel<D><<<grid, THREADS, 0, st>>>(
      means, quats, log_scales, opacity_logits, sh_dc, sh_rest, active,
      offset, w2c, K, center, conic, rgb, depth, opacity, radius, valid, n,
      rest, lim_num_x, lim_num_y, near);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(dim3 grid, cudaStream_t st, const float* means,
                       const float* quats, const float* log_scales,
                       const float* opacity_logits, const float* sh_dc,
                       const float* sh_rest, const uint8_t* active,
                       const float* w2c, const float* K,
                       const float* g_center, const float* g_conic,
                       const float* g_rgb, const float* g_depth,
                       const float* g_opacity, float* d_means,
                       float* d_quats, float* d_log_scales,
                       float* d_opacity_logits, float* d_sh_dc,
                       float* d_sh_rest, int n, int rest, float lim_num_x,
                       float lim_num_y, float near) {
  project_bwd_kernel<D><<<grid, THREADS, 0, st>>>(
      means, quats, log_scales, opacity_logits, sh_dc, sh_rest, active, w2c,
      K, g_center, g_conic, g_rgb, g_depth, g_opacity, d_means, d_quats,
      d_log_scales, d_opacity_logits, d_sh_dc, d_sh_rest, n, rest, lim_num_x,
      lim_num_y, near);
  return cudaGetLastError();
}

bool bad_args(int n, int rest, int degree, const void* quats) {
  return n <= 0 || degree < 0 || degree > 3 || rest < 0 || rest > MAX_REST ||
         rest < 3 * ((degree + 1) * (degree + 1) - 1) ||
         (reinterpret_cast<uintptr_t>(quats) & 15) != 0;
}

}  // namespace

// Forward: every output written for every slot. offset may be null; n >= 1;
// rest = the row length of sh_rest, at least 3 ((degree + 1)^2 - 1) and at
// most 45; quats 16-byte aligned; center 8-byte aligned.
extern "C" int syn3r_project_fwd(
    const void* means, const void* quats, const void* log_scales,
    const void* opacity_logits, const void* sh_dc, const void* sh_rest,
    const void* active, const void* offset, const void* w2c, const void* K,
    void* center, void* conic, void* rgb, void* depth, void* opacity,
    void* radius, void* valid, int n, int rest, int degree, float lim_num_x,
    float lim_num_y, float near, void* stream) {
  if (bad_args(n, rest, degree, quats) ||
      (reinterpret_cast<uintptr_t>(center) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + THREADS - 1) / THREADS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SYN3R_PROJECT_FWD(D)                                                \
  launch_fwd<D>(grid, st, static_cast<const float*>(means),                 \
                static_cast<const float*>(quats),                           \
                static_cast<const float*>(log_scales),                      \
                static_cast<const float*>(opacity_logits),                  \
                static_cast<const float*>(sh_dc),                           \
                static_cast<const float*>(sh_rest),                         \
                static_cast<const uint8_t*>(active),                        \
                static_cast<const float*>(offset),                          \
                static_cast<const float*>(w2c), static_cast<const float*>(K), \
                static_cast<float*>(center), static_cast<float*>(conic),    \
                static_cast<float*>(rgb), static_cast<float*>(depth),       \
                static_cast<float*>(opacity), static_cast<float*>(radius),  \
                static_cast<uint8_t*>(valid), n, rest, lim_num_x,           \
                lim_num_y, near)
  switch (degree) {
    case 0: return (int)SYN3R_PROJECT_FWD(0);
    case 1: return (int)SYN3R_PROJECT_FWD(1);
    case 2: return (int)SYN3R_PROJECT_FWD(2);
    default: return (int)SYN3R_PROJECT_FWD(3);
  }
#undef SYN3R_PROJECT_FWD
}

// Backward: the output gradients may each be null (zero); every parameter
// gradient is written for every slot, d_sh_rest whole (zeros beyond the
// degree). The same arguments' rules as the forward; d_quats 16-byte
// aligned.
extern "C" int syn3r_project_bwd(
    const void* means, const void* quats, const void* log_scales,
    const void* opacity_logits, const void* sh_dc, const void* sh_rest,
    const void* active, const void* w2c, const void* K, const void* g_center,
    const void* g_conic, const void* g_rgb, const void* g_depth,
    const void* g_opacity, void* d_means, void* d_quats, void* d_log_scales,
    void* d_opacity_logits, void* d_sh_dc, void* d_sh_rest, int n, int rest,
    int degree, float lim_num_x, float lim_num_y, float near, void* stream) {
  if (bad_args(n, rest, degree, quats) ||
      (reinterpret_cast<uintptr_t>(d_quats) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + THREADS - 1) / THREADS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SYN3R_PROJECT_BWD(D)                                                \
  launch_bwd<D>(grid, st, static_cast<const float*>(means),                 \
                static_cast<const float*>(quats),                           \
                static_cast<const float*>(log_scales),                      \
                static_cast<const float*>(opacity_logits),                  \
                static_cast<const float*>(sh_dc),                           \
                static_cast<const float*>(sh_rest),                         \
                static_cast<const uint8_t*>(active),                        \
                static_cast<const float*>(w2c), static_cast<const float*>(K), \
                static_cast<const float*>(g_center),                        \
                static_cast<const float*>(g_conic),                         \
                static_cast<const float*>(g_rgb),                           \
                static_cast<const float*>(g_depth),                         \
                static_cast<const float*>(g_opacity),                       \
                static_cast<float*>(d_means), static_cast<float*>(d_quats), \
                static_cast<float*>(d_log_scales),                          \
                static_cast<float*>(d_opacity_logits),                      \
                static_cast<float*>(d_sh_dc), static_cast<float*>(d_sh_rest), \
                n, rest, lim_num_x, lim_num_y, near)
  switch (degree) {
    case 0: return (int)SYN3R_PROJECT_BWD(0);
    case 1: return (int)SYN3R_PROJECT_BWD(1);
    case 2: return (int)SYN3R_PROJECT_BWD(2);
    default: return (int)SYN3R_PROJECT_BWD(3);
  }
#undef SYN3R_PROJECT_BWD
}
