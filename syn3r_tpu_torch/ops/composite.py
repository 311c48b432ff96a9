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
never falls back: the wrappers launch or raise. ``composite_tiles.launches``
counts kernel launches, ``{"fwd": n, "bwd": n}``.
"""

from __future__ import annotations

import torch

from ..kernels import build

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
# pixels (one a thread) of a backward block; csrc/composite_bwd.cu's THREADS
BWD_BLOCK_PIXELS = 256


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


def _check(P, G, C, O, K, extra=()):
    T, six, cap = G.shape
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
    if six != 6 or K < 1 or K > 1024 or cap % K:
        raise ValueError(f"composite kernel needs cap % K == 0 and "
                         f"1 <= K <= 1024, got cap={cap} K={K}")


def composite_fwd(P, G, C, O, K: int):
    """Forward composite: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (out, ltc)."""
    if G.device.type == "cpu":
        return composite_fwd_reference(P, G, C, O, K)
    _check(P, G, C, O, K)
    T, _, cap = G.shape
    px = P.shape[1]
    out = torch.empty((T, 6, px), dtype=torch.float32, device=G.device)
    ltc = torch.empty((T, cap // K, px), dtype=torch.float32,
                      device=G.device)
    if T and px:
        err = build.entry("composite_fwd")(
            P.data_ptr(), G.data_ptr(), C.data_ptr(), O.data_ptr(),
            out.data_ptr(), ltc.data_ptr(), T, px, cap, K,
            torch.cuda.current_stream(G.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"composite_fwd kernel launch failed: "
                               f"cudaError {err}")
        composite_tiles.launches["fwd"] += 1
    return out, ltc


def composite_bwd(P, G, C, O, ltc, dout, K: int):
    """Backward composite: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (dG, dC, dO)."""
    if G.device.type == "cpu":
        return composite_bwd_reference(P, G, C, O, ltc, dout, K)
    T, _, cap = G.shape
    px = P.shape[1]
    _check(P, G, C, O, K, extra=[("ltc", ltc, (T, cap // K, px)),
                                 ("dout", dout, (T, 6, px))])
    dG, dC, dO = (torch.empty_like(G), torch.empty_like(C),
                  torch.empty_like(O))
    # per-block partial sums over pixels, reduced in a second pass
    n_blk = -(-px // BWD_BLOCK_PIXELS)
    part = torch.empty((T, n_blk, 12, cap), dtype=torch.float32,
                       device=G.device)
    if T and px and cap:
        err = build.entry("composite_bwd")(
            P.data_ptr(), G.data_ptr(), C.data_ptr(), O.data_ptr(),
            ltc.data_ptr(), dout.data_ptr(), part.data_ptr(),
            dG.data_ptr(), dC.data_ptr(), dO.data_ptr(), T, px, cap, K,
            torch.cuda.current_stream(G.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"composite_bwd kernel launch failed: "
                               f"cudaError {err}")
        composite_tiles.launches["bwd"] += 1
    else:
        dG.zero_(), dC.zero_(), dO.zero_()
    return dG, dC, dO


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


def composite_tiles(P, G, C, O, K: int = 256) -> torch.Tensor:
    """Alpha-composite per-tile Gaussian lists over the tile's pixels.
    Returns (T, 6, px): rows 0-4 [r, g, b, depth, alpha] accumulated, row
    5 the final log-transmittance. Differentiable in G, C and O."""
    return _CompositeTiles.apply(P, G, C, O, K)


composite_tiles.launches = {"fwd": 0, "bwd": 0}
