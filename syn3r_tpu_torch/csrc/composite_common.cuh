// Shared pieces of the tile-composite kernels (composite_fwd.cu,
// composite_bwd.cu).
//
// Layouts are those of syn3r_tpu/ops/pallas_rasterize.py, float32,
// Gaussian-minor: P (6, px) tile-local pixel features [x^2, xy, y^2, x, y, 1];
// G (T, 6, cap) packed quadratic Gaussian features; C (T, 5, cap)
// [r, g, b, depth, 1]; O (T, 1, cap) opacities; per tile the entries are in
// depth order and cap is a multiple of the chunk K <= 128.
//
// Both kernels share one pixel geometry and one skip test:
//  * Four pixels a thread: lane l of warp w owns column 32 (w & 1) + l of
//    rows 4 (w >> 1) .. +3 of a block of 2 x WARPS rows of 64 pixels (pixel
//    p = row * 64 + column, the tile's layout), so a warp covers a 4 x 32
//    rectangle (ops/composite.py bwd_pixel_map; with 8 warps a block is
//    1024 pixels).
//  * Entries staged entry-major, 16 floats an entry (G0-5, C0-4, O, 4
//    unused): a thread reads an entry once for its four pixels, as three
//    128-bit broadcast loads.
//  * The exact skip of entries that cannot reach a warp's pixels. Each entry
//    is tested once per warp against the rectangle spanned by the warp's
//    pixels, from G and O alone (the 3 sigma box of the binning is not
//    conservative: at opacity 0.99 alpha reaches 1/255 at 3.3 sigma).
//    power = G . [x^2, xy, y^2, x, y, 1] is a quadratic; where it is
//    strictly concave its maximum over the rectangle is at the centre if
//    that lies inside, else at the clamped vertex of one of the four edges.
//    The entry is skipped for the warp when O exp(max power) stays below
//    1/255 by a margin that covers the float rounding of the kernels' own
//    power (1e-6 of the sum of |G_f P_f|; six roundings are at most 3.6e-7
//    of it) and the error of __expf and of the product (1e-5 in the log
//    domain). The test runs in double, its per-entry part (the centre,
//    1 / 2a, 1 / 2c, log(1/255 / O)) once per entry. It is only taken where
//    every pixel of the warp has P = [x^2, xy, y^2, x, y, 1] exactly (else
//    every entry with opacity >= 1/255 is kept). A skipped pair has alpha
//    cut to 0 at every pixel, which contributes exactly nothing to any
//    output or to the transmittance (log1p(-0) = 0): a kernel's result is
//    the one without the skip. ops/composite.py reach_mask is its plain
//    mirror; keep bits are laid out (T, n_chunks, warp rectangles, 4 words
//    of 32 entries).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace syn3r {

constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr int PXT = 4;              // pixels a thread (rows)
constexpr int ROW = 64;             // columns of a pixel row
constexpr int KMAX = 128;           // entries a chunk at most
constexpr int WORDS = KMAX / 32;    // keep words a warp and chunk
constexpr int ESTRIDE = 16;         // floats a staged entry
constexpr unsigned FULL = 0xffffffffu;

template <int WARPS>
__device__ __forceinline__ int pixel_of(int pb, int warp, int lane, int k) {
  static_assert(WARPS % 2 == 0, "two warps a pixel row");
  return pb * (WARPS * 32 * PXT) + ((warp >> 1) * PXT + k) * ROW +
         (warp & 1) * 32 + lane;
}

// Loads the thread's pixel features; dead pixels (p >= px) read 0 and have
// pix -1.
template <int WARPS>
__device__ __forceinline__ void load_pixels(const float* P, int px, int pb,
                                            int warp, int lane,
                                            float (&pf)[PXT][6],
                                            int (&pix)[PXT]) {
#pragma unroll
  for (int k = 0; k < PXT; ++k) {
    const int p = pixel_of<WARPS>(pb, warp, lane, k);
    pix[k] = p < px ? p : -1;
#pragma unroll
    for (int f = 0; f < 6; ++f)
      pf[k][f] = p < px ? P[(size_t)f * px + p] : 0.0f;
  }
}

// Entry j, feature f (0-5 G, 6-10 C, 11 O) of tile t.
__device__ __forceinline__ const float* entry_feature(const float* G,
                                                     const float* C,
                                                     const float* O, int t,
                                                     int cap, int f) {
  return f < 6 ? G + ((size_t)t * 6 + f) * cap
               : (f < 11 ? C + ((size_t)t * 5 + (f - 6)) * cap
                         : O + (size_t)t * cap);
}

// The warp's pixel rectangle (x0, x1, y0, y1) and its state: 0 no live
// pixel, 1 every live pixel has P = [x^2, xy, y^2, x, y, 1] exactly
// (products of floats are exact in double), 2 any other P. Written by lane
// 0. No synchronization.
__device__ __forceinline__ void warp_rect(float* rect, int* state,
                                         const float (&pf)[PXT][6],
                                         const int (&pix)[PXT], int lane) {
  const float inf = __int_as_float(0x7f800000);
  float x0 = inf, x1 = -inf, y0 = inf, y1 = -inf;
  bool any = false, exact = true;
#pragma unroll
  for (int k = 0; k < PXT; ++k) {
    if (pix[k] < 0) continue;
    const double x = pf[k][3], y = pf[k][4];
    any = true;
    exact = exact && x * x == (double)pf[k][0] && x * y == (double)pf[k][1] &&
            y * y == (double)pf[k][2] && pf[k][5] == 1.0f;
    x0 = fminf(x0, pf[k][3]);
    x1 = fmaxf(x1, pf[k][3]);
    y0 = fminf(y0, pf[k][4]);
    y1 = fmaxf(y1, pf[k][4]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(FULL, x0, off));
    x1 = fmaxf(x1, __shfl_xor_sync(FULL, x1, off));
    y0 = fminf(y0, __shfl_xor_sync(FULL, y0, off));
    y1 = fmaxf(y1, __shfl_xor_sync(FULL, y1, off));
  }
  any = __any_sync(FULL, any);
  exact = __all_sync(FULL, exact);
  if (lane == 0) {
    rect[0] = x0;
    rect[1] = x1;
    rect[2] = y0;
    rect[3] = y1;
    *state = any ? (exact ? 1 : 2) : 0;
  }
}

// An entry's quadratic for the rectangle test, in double: G, the centre,
// the edge vertices' reciprocals 1 / 2a and 1 / 2c, log(1/255 / O), and
// its kind: 0 opacity below 1/255 (never reaches), 1 always kept (NaN or
// infinity anywhere, or not strictly concave), 2 tested.
struct Quad {
  double g[6], xc, yc, h2a, h2c, lim;
  int kind;
};

__device__ __forceinline__ double quad(const double (&g)[6], double x,
                                       double y) {
  return g[0] * x * x + g[1] * x * y + g[2] * y * y + g[3] * x + g[4] * y +
         g[5];
}

__device__ inline void make_quad(Quad& q, const float* e) {
  const float o = e[11];
  bool finite = isfinite(o);
  for (int f = 0; f < 6; ++f) {
    q.g[f] = e[f];
    finite = finite && isfinite(e[f]);
  }
  const double a = q.g[0], b = q.g[1], c = q.g[2], d = q.g[3], ee = q.g[4];
  const double det = 4.0 * a * c - b * b;
  q.kind = o < kAlphaMin ? 0
                         : (finite && a < 0.0 && c < 0.0 && det > 0.0 ? 2 : 1);
  if (q.kind != 2) return;
  const double inv = 1.0 / det;
  q.xc = (b * ee - 2.0 * c * d) * inv;
  q.yc = (b * d - 2.0 * a * ee) * inv;
  q.h2a = 1.0 / (2.0 * a);
  q.h2c = 1.0 / (2.0 * c);
  q.lim = log((double)kAlphaMin / (double)o);
}

// False only where the entry's alpha stays below 1/255 at every point of
// the rectangle r = (x0, x1, y0, y1) (see the header).
__device__ inline bool may_reach(const Quad& q, const float* r) {
  if (q.kind != 2) return q.kind == 1;
  const double b = q.g[1], d = q.g[3], ee = q.g[4];
  const double x0 = r[0], x1 = r[1], y0 = r[2], y1 = r[3];
  double m;
  if (q.xc >= x0 && q.xc <= x1 && q.yc >= y0 && q.yc <= y1) {
    m = quad(q.g, q.xc, q.yc);
  } else {
    // the vertex of each edge's 1-D quadratic, clamped to the edge
    const double ya = fmin(fmax(-(b * x0 + ee) * q.h2c, y0), y1);
    const double yb = fmin(fmax(-(b * x1 + ee) * q.h2c, y0), y1);
    const double xa = fmin(fmax(-(b * y0 + d) * q.h2a, x0), x1);
    const double xb = fmin(fmax(-(b * y1 + d) * q.h2a, x0), x1);
    m = fmax(fmax(quad(q.g, x0, ya), quad(q.g, x1, yb)),
             fmax(quad(q.g, xa, y0), quad(q.g, xb, y1)));
  }
  const double X = fmax(fabs(x0), fabs(x1)), Y = fmax(fabs(y0), fabs(y1));
  const double S = fabs(q.g[0]) * X * X + fabs(b) * X * Y +
                   fabs(q.g[2]) * Y * Y + fabs(d) * X + fabs(ee) * Y +
                   fabs(q.g[5]);
  return !(m + 1e-6 * S + 1e-5 < q.lim);
}

}  // namespace syn3r
