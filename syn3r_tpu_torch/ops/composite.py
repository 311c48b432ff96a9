"""Per-tile alpha compositing of depth-ordered Gaussian lists.

Counterpart of ``syn3r_tpu/ops/pallas_rasterize.py``. Layouts are the JAX
package's: P (6, px) tile-local pixel features [x^2, xy, y^2, x, y, 1];
G (T, 6, cap) packed quadratic Gaussian features, C (T, 5, cap)
[r, g, b, depth, 1], O (T, 1, cap) opacities, all float32, Gaussian-minor.
Per tile, over chunks of K Gaussians in depth order::

    power = min(G^T P, 0);  alpha = min(O e^power, 0.99), 0 below 1/255
    w     = alpha * exp(logT + exclusive cumsum of log1p(-alpha))
    accum(5, px) += C w;    logT += sum log1p(-alpha)

The forward returns out (T, 6, px) (rows 0-4 the accumulated
[r, g, b, depth, alpha], row 5 the final logT) and the chunk-start logT
ltc (T, cap / K, px), from which the backward restarts each chunk while it
walks the chunks in reverse with a per-pixel suffix sum.

On CUDA tensors ``composite_tiles`` launches the hand-written kernels in
``csrc/composite_fwd.cu`` and ``csrc/composite_bwd.cu`` (replacing
``_fwd_kernel`` and ``_bwd_kernel``); on CPU tensors it runs
``composite_fwd_reference`` and ``composite_bwd_reference``. A CUDA tensor
never falls back: the wrappers launch or raise. ``utils.profiling.counters``
counts wrapper calls that launched, ``launches.composite_fwd`` and
``launches.composite_bwd`` (a backward call is three CUDA launches:
``composite_bwd_plan``).

Both kernels take four pixels a thread (``bwd_pixel_map``) and skip, per
warp of pixels, the entries whose alpha stays below 1/255 over the warp's
pixel rectangle (``reach_mask`` is the test's plain mirror);
``composite_bwd_launch`` also returns its keep bits, and
``composite_fwd_launch`` its own when asked. The forward walks a tile's
chunks in sequence in one block (``composite_fwd_plan``), testing the next
chunk's entries while it composites the current one. Its bound is
operations, ~0.055 ms at the gs cell's tile lists; the skip removes ~65%
of the work the bound counts.
"""

from __future__ import annotations

import math

import torch

from ..kernels import build
from ..utils.profiling import counters

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
# The kernels' geometry (csrc/composite_common.cuh): threads of 4 pixels;
# warp w, lane l, pixel k of a block holds pixel
# 64 (4 (w // 2) + k) + 32 (w % 2) + l of it, so a warp covers 4 rows x 32
# columns of a 64-wide tile; chunks of at most 128 entries. The backward's
# blocks are 256 threads (1024 pixels), the forward's 128 (512 pixels):
# the same warp rectangles in the same order.
BWD_THREADS = 256
BWD_WARPS = BWD_THREADS // 32
BWD_PIXELS_PER_THREAD = 4
BWD_BLOCK_PIXELS = BWD_THREADS * BWD_PIXELS_PER_THREAD
BWD_ROW = 64
BWD_MAX_K = 128
KEEP_WORDS = BWD_MAX_K // 32
# the forward's blocks: thread j stages and tests entry j
FWD_THREADS = 128
_MAX_GRID_YZ = 65535


def _chunk_alpha(P, Gc, Oc):
    """Of one chunk, (T, K, px) each: the raw power G^T P, exp of the
    clamped power, alpha before the clamps and alpha after them."""
    praw = torch.einsum("tfk,fp->tkp", Gc, P)
    epow = torch.exp(torch.clamp(praw, max=0.0))
    alpha_raw = Oc.transpose(1, 2) * epow
    alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)
    return praw, epow, alpha_raw, alpha


def composite_fwd_reference(P, G, C, O, K: int):
    """Plain torch ``_fwd_kernel``: returns (out (T, 6, px), ltc
    (T, cap / K, px)). Differentiable by autograd (the ``"plain"`` route of
    ``rasterize_tiled``)."""
    T, _, cap = G.shape
    px = P.shape[1]
    accum = G.new_zeros((T, 5, px))
    logT = G.new_zeros((T, 1, px))
    ltc = []
    for c in range(cap // K):
        ltc.append(logT)
        sl = slice(c * K, (c + 1) * K)
        _, _, _, alpha = _chunk_alpha(P, G[:, :, sl], O[:, :, sl])
        l1ma = torch.log1p(-alpha)
        excl = torch.cumsum(l1ma, dim=1) - l1ma
        w = alpha * torch.exp(logT + excl)
        accum = accum + torch.einsum("trk,tkp->trp", C[:, :, sl], w)
        logT = logT + l1ma.sum(1, keepdim=True)
    ltc = torch.cat(ltc, 1) if ltc else G.new_zeros((T, 0, px))
    return torch.cat([accum, logT], 1), ltc


def composite_bwd_reference(P, G, C, O, ltc, dout, K: int):
    """Plain torch ``_bwd_kernel``: (dG, dC, dO) from the output cotangent
    dout (T, 6, px), line by line as the TPU kernel computes them."""
    cap = G.shape[2]
    gacc = dout[:, 0:5]                                   # (T, 5, px)
    s = dout[:, 5:6]                                      # d(logT), carry
    dG, dC, dO = (torch.zeros_like(G), torch.zeros_like(C),
                  torch.zeros_like(O))
    for c in reversed(range(cap // K)):
        sl = slice(c * K, (c + 1) * K)
        praw, epow, alpha_raw, alpha = _chunk_alpha(P, G[:, :, sl],
                                                    O[:, :, sl])
        hi = alpha_raw > ALPHA_MAX
        lo = alpha == 0.0                    # cut below 1/255
        l1ma = torch.log1p(-alpha)
        excl = torch.cumsum(l1ma, dim=1) - l1ma
        t_in = torch.exp(ltc[:, c:c + 1] + excl)
        w = alpha * t_in
        g_c = torch.einsum("trk,trp->tkp", C[:, :, sl], gacc)
        wgc = w * g_c
        tot = wgc.sum(1, keepdim=True)
        suffix = tot - torch.cumsum(wgc, dim=1) + s
        dalpha = t_in * g_c - suffix / (1.0 - alpha)
        dalpha = torch.where(lo | hi, 0.0, dalpha)
        dpower = torch.where(praw > 0.0, 0.0, dalpha * alpha_raw)
        dG[:, :, sl] = torch.einsum("fp,tkp->tfk", P, dpower)
        dC[:, :, sl] = torch.einsum("trp,tkp->trk", gacc, w)
        dO[:, :, sl] = (dalpha * epow).sum(2)[:, None, :]
        s = s + tot
    return dG, dC, dO


def composite_fwd_plan(T: int, px: int, cap: int, K: int) -> dict:
    """Launch plan of the forward kernel for T tiles of px pixels and lists
    of cap entries in chunks of K: blocks of 128 threads (512 pixels, the
    backward's warp rectangles), each walking every chunk of its (pixel
    block, tile) in sequence. Returns the grid (pixel blocks, tiles),
    threads, pixels a thread and the scratch shapes of the keep bits when
    they are asked for (int32, as many warp rectangles as ``reach_mask``;
    the kernel writes the first ``kernel_rects``). Raises on what the
    kernel does not take."""
    if not 1 <= K <= BWD_MAX_K or cap < 1 or cap % K:
        raise ValueError(f"composite forward kernel needs cap % K == 0 and "
                         f"1 <= K <= {BWD_MAX_K}, got cap={cap} K={K}")
    if not 1 <= T <= _MAX_GRID_YZ or px < 1:
        raise ValueError(f"composite forward kernel takes 1 <= T <= "
                         f"{_MAX_GRID_YZ} and px >= 1, got T={T} px={px}")
    block_px = FWD_THREADS * BWD_PIXELS_PER_THREAD
    n_blk = -(-px // block_px)
    keep = (T, cap // K, -(-px // BWD_BLOCK_PIXELS) * BWD_WARPS, KEEP_WORDS)
    return dict(grid=(n_blk, T), threads=FWD_THREADS,
                pixels_per_thread=BWD_PIXELS_PER_THREAD,
                block_pixels=block_px, kernel_rects=n_blk * FWD_THREADS // 32,
                scratch={"keep": keep}, scratch_bytes=4 * math.prod(keep))


def composite_bwd_plan(T: int, px: int, cap: int, K: int) -> dict:
    """Launch plan of the backward kernels for T tiles of px pixels and
    lists of cap entries in chunks of K: the grid (pixel blocks, chunks,
    tiles) of the tot and gradient kernels, pixels a thread, and the
    scratch shapes (tot float32, keep bits int32, part float32). Raises on
    what the kernels do not take."""
    if not 1 <= K <= BWD_MAX_K or cap < 1 or cap % K:
        raise ValueError(f"composite backward kernel needs cap % K == 0 and "
                         f"1 <= K <= {BWD_MAX_K}, got cap={cap} K={K}")
    n_chunks = cap // K
    if not 1 <= T <= _MAX_GRID_YZ or n_chunks > _MAX_GRID_YZ or px < 1:
        raise ValueError(f"composite backward kernel takes 1 <= T <= "
                         f"{_MAX_GRID_YZ}, cap / K <= {_MAX_GRID_YZ} and "
                         f"px >= 1, got T={T} cap/K={n_chunks} px={px}")
    n_blk = -(-px // BWD_BLOCK_PIXELS)
    shapes = {"tot": (T, n_chunks, px),
              "keep": (T, n_chunks, n_blk, BWD_WARPS, KEEP_WORDS),
              "part": (T, n_blk, 12, cap)}
    return dict(grid=(n_blk, n_chunks, T), threads=BWD_THREADS,
                pixels_per_thread=BWD_PIXELS_PER_THREAD,
                block_pixels=BWD_BLOCK_PIXELS, scratch=shapes,
                scratch_bytes=4 * sum(math.prod(v) for v in shapes.values()))


def bwd_pixel_map(px: int) -> torch.Tensor:
    """Pixel index (or -1 past px) of every (block, warp, pixel of a
    thread, lane) of the backward kernel: (n_blk, 8, 4, 32)."""
    n_blk = -(-px // BWD_BLOCK_PIXELS)
    b, w, k, lane = torch.meshgrid(
        torch.arange(n_blk), torch.arange(BWD_WARPS),
        torch.arange(BWD_PIXELS_PER_THREAD), torch.arange(32),
        indexing="ij")
    p = (b * BWD_BLOCK_PIXELS + ((w // 2) * BWD_PIXELS_PER_THREAD + k)
         * BWD_ROW + (w % 2) * 32 + lane)
    return torch.where(p < px, p, -1)


def reach_mask(P, G, O, K: int) -> torch.Tensor:
    """Plain mirror of the composite kernels' skip test, in float64: for
    each tile, warp rectangle (block-major, (n_blk * 8)) and entry, False
    only where the entry's alpha stays below 1/255 at every point of the
    rectangle spanned by the warp's pixels. Returns bool (T, n_rect, cap)."""
    T, _, cap = G.shape
    dev = G.device
    pm = bwd_pixel_map(P.shape[1]).to(dev).reshape(-1, 4 * 32)  # (n_rect, 128)
    live = pm >= 0
    Pw = P.double()[:, pm.clamp_min(0)]                    # (6, n_rect, 128)
    x, y = Pw[3], Pw[4]
    exact = ((x * x == Pw[0]) & (x * y == Pw[1]) & (y * y == Pw[2])
             & (Pw[5] == 1.0)) | ~live
    exact = exact.all(1)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    x0 = torch.where(live, x, inf).amin(1)[None, :, None]
    x1 = torch.where(live, x, -inf).amax(1)[None, :, None]
    y0 = torch.where(live, y, inf).amin(1)[None, :, None]
    y1 = torch.where(live, y, -inf).amax(1)[None, :, None]
    g = G.double()[:, :, None, :]                          # (T, 6, 1, cap)
    a, b, c, d, e, f = g.unbind(1)
    o = O.double()[:, 0, None, :]                          # (T, 1, cap)

    def quad(xx, yy):
        return a * xx * xx + b * xx * yy + c * yy * yy + d * xx + e * yy + f

    with torch.no_grad():
        det = 4.0 * a * c - b * b
        concave = (a < 0) & (c < 0) & (det > 0)
        inv, h2a, h2c = 1.0 / det, 1.0 / (2.0 * a), 1.0 / (2.0 * c)
        xc = (b * e - 2.0 * c * d) * inv
        yc = (b * d - 2.0 * a * e) * inv
        inside = (xc >= x0) & (xc <= x1) & (yc >= y0) & (yc <= y1)
        edges = torch.maximum(
            torch.maximum(
                quad(x0, torch.clamp(-(b * x0 + e) * h2c, y0, y1)),
                quad(x1, torch.clamp(-(b * x1 + e) * h2c, y0, y1))),
            torch.maximum(
                quad(torch.clamp(-(b * y0 + d) * h2a, x0, x1), y0),
                quad(torch.clamp(-(b * y1 + d) * h2a, x0, x1), y1)))
        m = torch.where(inside, quad(xc, yc), edges)
        X = torch.maximum(x0.abs(), x1.abs())
        Y = torch.maximum(y0.abs(), y1.abs())
        S = (a.abs() * X * X + b.abs() * X * Y + c.abs() * Y * Y
             + d.abs() * X + e.abs() * Y + f.abs())
        lim = torch.log(torch.tensor(ALPHA_MIN, dtype=torch.float32)
                        .double() / o)
        finite = (torch.isfinite(G).all(1)
                  & torch.isfinite(O[:, 0]))[:, None, :]
        test = ~(m + 1e-6 * S + 1e-5 < lim) | ~concave | ~finite
        opaque = ~(O[:, 0, None, :] < ALPHA_MIN)
        keep = opaque & torch.where(exact[None, :, None], test, True)
        keep = keep & live.any(1)[None, :, None]
    return keep


def keep_words_to_mask(words: torch.Tensor, K: int) -> torch.Tensor:
    """A kernel's keep bits (T, n_chunks, warp rectangles..., 4 words) as
    bool (T, n_rect, cap), the layout of ``reach_mask``."""
    T, n_chunks = words.shape[:2]
    bits = (words.long()[..., None] >> torch.arange(32, device=words.device)
            ) & 1                                      # (..., 4, 32)
    bits = bits.reshape(T, n_chunks, -1, BWD_MAX_K)[..., :K]
    return bits.permute(0, 2, 1, 3).reshape(T, -1, n_chunks * K).bool()


def _check(P, G, C, O, extra=()):
    T, _, cap = G.shape
    px = P.shape[1]
    shapes = {"P": (P, (6, px)), "G": (G, (T, 6, cap)),
              "C": (C, (T, 5, cap)), "O": (O, (T, 1, cap)),
              **{name: (t, shape) for name, t, shape in extra}}
    for name, (t, shape) in shapes.items():
        if t.device.type != "cuda" or t.device != G.device:
            raise ValueError(f"composite kernel: {name} on {t.device}, "
                             f"G on {G.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"composite kernel takes float32, {name} is "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"composite kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"composite kernel: {name} is not contiguous")


def composite_fwd_launch(P, G, C, O, K: int, keep_bits: bool = False):
    """Launches the forward kernel on CUDA tensors, on G's card (its
    current device and stream). Returns (out, ltc, keep): with
    ``keep_bits`` the skip test's bits (``composite_fwd_plan``'s scratch
    "keep"; ``keep_words_to_mask`` reads them), else None, as when there
    is no work."""
    _check(P, G, C, O)
    T, _, cap = G.shape
    px = P.shape[1]
    out = torch.empty((T, 6, px), dtype=torch.float32, device=G.device)
    ltc = torch.empty((T, cap // K, px), dtype=torch.float32,
                      device=G.device)
    if not (T and px and cap):
        return out.zero_(), ltc, None
    plan = composite_fwd_plan(T, px, cap, K)
    keep = None
    if keep_bits:
        shape = plan["scratch"]["keep"]
        keep = (torch.empty if plan["kernel_rects"] == shape[2]
                else torch.zeros)(shape, dtype=torch.int32, device=G.device)
    with torch.cuda.device(G.device):
        err = build.entry("composite_fwd")(
            P.data_ptr(), G.data_ptr(), C.data_ptr(), O.data_ptr(),
            out.data_ptr(), ltc.data_ptr(),
            None if keep is None else keep.data_ptr(), T, px, cap, K,
            torch.cuda.current_stream(G.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: "
                           f"cudaError {err}")
    counters["launches.composite_fwd"] += 1
    return out, ltc, keep


def composite_fwd(P, G, C, O, K: int):
    """Forward composite: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (out, ltc)."""
    if G.device.type == "cpu":
        return composite_fwd_reference(P, G, C, O, K)
    return composite_fwd_launch(P, G, C, O, K)[:2]


def composite_bwd_launch(P, G, C, O, ltc, dout, K: int):
    """Launches the backward kernels on CUDA tensors, on G's card. Returns
    (dG, dC, dO, keep), keep the skip test's bits (``composite_bwd_plan``'s
    scratch "keep"; ``keep_words_to_mask`` reads them), or None when there
    is no work."""
    T, _, cap = G.shape
    px = P.shape[1]
    _check(P, G, C, O, extra=[("ltc", ltc, (T, cap // K, px)),
                              ("dout", dout, (T, 6, px))])
    dG, dC, dO = (torch.empty_like(G), torch.empty_like(C),
                  torch.empty_like(O))
    if not (T and px and cap):
        return dG.zero_(), dC.zero_(), dO.zero_(), None
    plan = composite_bwd_plan(T, px, cap, K)
    tot, keep, part = (
        torch.empty(shape, dtype=torch.int32 if name == "keep"
                    else torch.float32, device=G.device)
        for name, shape in plan["scratch"].items())
    with torch.cuda.device(G.device):
        err = build.entry("composite_bwd")(
            P.data_ptr(), G.data_ptr(), C.data_ptr(), O.data_ptr(),
            ltc.data_ptr(), dout.data_ptr(), tot.data_ptr(), keep.data_ptr(),
            part.data_ptr(), dG.data_ptr(), dC.data_ptr(), dO.data_ptr(), T,
            px, cap, K, torch.cuda.current_stream(G.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"composite_bwd kernel launch failed: "
                           f"cudaError {err}")
    counters["launches.composite_bwd"] += 1
    return dG, dC, dO, keep


def composite_bwd(P, G, C, O, ltc, dout, K: int):
    """Backward composite: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (dG, dC, dO)."""
    if G.device.type == "cpu":
        return composite_bwd_reference(P, G, C, O, ltc, dout, K)
    return composite_bwd_launch(P, G, C, O, ltc, dout, K)[:3]


class _CompositeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, P, G, C, O, K):
        out, ltc = composite_fwd(P, G, C, O, K)
        ctx.save_for_backward(P, G, C, O, ltc)
        ctx.K = K
        return out

    @staticmethod
    def backward(ctx, dout):
        P, G, C, O, ltc = ctx.saved_tensors
        dG, dC, dO = composite_bwd(P, G, C, O, ltc, dout.contiguous(), ctx.K)
        # P holds constant pixel coordinates: no gradient, as in JAX
        return None, dG, dC, dO, None


def composite_tiles(P, G, C, O, K: int = 128) -> torch.Tensor:
    """Alpha-composite per-tile Gaussian lists over the tile's pixels.
    Returns (T, 6, px): rows 0-4 [r, g, b, depth, alpha] accumulated, row
    5 the final log-transmittance. Differentiable in G, C and O; the
    backward kernel takes chunks of K <= 128 (``bin_tiles``' K)."""
    return _CompositeTiles.apply(P, G, C, O, K)

