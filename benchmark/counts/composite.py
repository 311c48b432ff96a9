"""Operations and bytes of the tile-composite kernels (``composite_fwd``
and ``composite_bwd`` of ``syn3r_tpu_torch/ops/composite.py``), as
functions of what one call's inputs need: per tile, its live entries
(opacity >= 1/255: only these can reach a pixel) and its hit pairs
((entry, pixel) pairs whose alpha passes 1/255).

Operations per pair, counted from the formulas (an exp, log1p or divide
counts one): reaching alpha (6 multiplies, 5 adds, clamp, exp, multiply,
clamp) for every live entry at every pixel; the forward, where alpha
passes 1/255: log1p, add, exp, multiply, 5 multiply-adds (10), add = 15;
the backward there: T_in, w, gC (9), suffix (3), dalpha (4), dpower, the
12 products and their 12 sums over pixels, log1p and add = 45.

Bytes: each input read once and each output written once, float32. The
forward reads P (6 x px) and 12 values of each live entry (G 6, C 5,
O 1), writes out (6 x px a tile) and the chunk-start log-transmittance
(chunks x px a tile); the backward reads P, the entries, ltc and dout
(6 x px a tile) and writes the entries' 12 gradients.

The bound is the larger of operations over the card's float32 peak
outside the tensor cores and bytes over its memory bandwidth.
"""

from __future__ import annotations

import torch

from .peaks import PEAK_HBM_BYTES

# float32 outside the tensor cores, one H100 SXM (data sheet, 700 W)
PEAK_F32_FLOPS = 67e12
OPS_LIVE, OPS_FWD_HIT, OPS_BWD_HIT = 15, 15, 45
ENTRY_FLOATS = 12            # G 6, C 5, O 1
ALPHA_MIN, ALPHA_MAX = 1.0 / 255.0, 0.99


def fwd_cost(px: int, chunks: int, live, hits) -> tuple:
    """(operations, bytes) of one forward call over tiles whose live
    entries and hit pairs are ``live`` and ``hits`` (one number a tile):
    ``px`` pixels a tile, ``chunks`` rows of ltc a tile."""
    tiles, n_live, n_hit = len(live), int(sum(live)), int(sum(hits))
    ops = OPS_LIVE * n_live * px + OPS_FWD_HIT * n_hit
    nbytes = 4 * (6 * px + ENTRY_FLOATS * n_live
                  + tiles * (6 + chunks) * px)
    return ops, nbytes


def bwd_cost(px: int, chunks: int, live, hits) -> tuple:
    """(operations, bytes) of one backward call (its three launches), as
    ``fwd_cost``."""
    tiles, n_live, n_hit = len(live), int(sum(live)), int(sum(hits))
    ops = OPS_LIVE * n_live * px + OPS_BWD_HIT * n_hit
    nbytes = 4 * (6 * px + 2 * ENTRY_FLOATS * n_live
                  + tiles * (chunks + 6) * px)
    return ops, nbytes


def pairs(P: torch.Tensor, G: torch.Tensor, o: torch.Tensor) -> tuple:
    """(live entries, hit pairs), each (B,) int64, of B tiles: P (px, 6)
    pixel features, G (B, 6, L) packed entry features, o (B, L)
    opacities; alpha = min(o exp(min(P G, 0)), 0.99), in float32."""
    live = (o >= ALPHA_MIN).sum(-1)
    alpha = torch.clamp(o[:, None] * torch.exp(torch.clamp(P @ G, max=0.0)),
                        max=ALPHA_MAX)
    return live, (alpha >= ALPHA_MIN).sum((1, 2))


def bound_s(ops: float, nbytes: float) -> tuple:
    """(seconds, "operations" or "bytes": the bound that binds)."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
