#!/usr/bin/env python3
"""Time the kernels of a checkout of the port at the main path's shapes, to
compare two checkouts on one card.

    python3 scripts/time_kernels.py [--root DIR] [--label NAME]

Imports syn3r_tpu_torch from DIR (default: this checkout), so its kernel
libraries are built from DIR's sources, and times with CUDA events, on
inputs made from seeds:
  * ``geglu_ffn``, ``flash_attention`` and ``layer_norm`` at the UNet's
    shapes (FFN_SHAPES, ATTN_SHAPES, LN_SHAPES of scripts/kernel_timing.py,
    taken from this checkout so that an older checkout is timed at the same
    shapes); LayerNorm with bf16 weight and bias (as the UNet holds them)
    and with float32 ones;
  * ``gn_stats``, ``gn_apply`` and the whole ``group_norm`` call at the
    UNet's GroupNorm shapes (GN_SHAPES), bf16 with bf16 weight and bias,
    32 groups; the apply and the whole call with and without SiLU in the
    forward's proportion; each also as device time alone (``graph_ms``:
    calls replayed from a CUDA graph, without the host's issue time that
    bounds the windows' times at the small shapes);
  * ``flash_attention_bwd`` (the whole backward, from the forward's out
    and lse; its kernels' launches as the wrapper makes them) at the grad
    pass's shapes (GRAD_ATTN_SHAPES, the UNet's (B, S, H, 64) projection
    views), with the backward of F.scaled_dot_product_attention beside it
    as the control that no checkout changes;
  * ``composite_fwd`` and ``composite_bwd`` on the GS main path's tile
    lists (``gs_tile_lists``: T 96, px 2048, cap 1024, K 128, projected
    and binned by DIR's code).
Each in a window of at least ~0.25 s; nvidia-smi samples the SM clock and
power draw every 20 ms and each row carries their medians over its window.
Prints one JSON line: per row ms, MHz and W, the sums over one batch-3
UNet forward, and the backward's over one grad pass. Run it as parent,
change, change, parent in one call to compare two checkouts. Needs a CUDA
device.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

from kernel_timing import (ATTN_SHAPES, FFN_SHAPES, GN_SHAPES,
                           GRAD_ATTN_SHAPES, LN_SHAPES, SmiSampler, graph_ms,
                           gs_tile_lists, window_iters)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from syn3r_tpu_torch.ops import composite as TC
    from syn3r_tpu_torch.ops import attention as A
    from syn3r_tpu_torch.ops.attention import flash_attention
    from syn3r_tpu_torch.ops.geglu_ffn import geglu_ffn
    from syn3r_tpu_torch.ops import norm as N
    from syn3r_tpu_torch.ops.norm import layer_norm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(dtype)

    def timed(fn):
        ms, mhz, watts = smi.timed(fn, window_iters(fn))
        return dict(ms=ms, sm_mhz=mhz, power_w=watts)

    rows = []
    per_forward = {"geglu_ffn": 0.0, "flash_attention": 0.0,
                   "layer_norm": 0.0, "layer_norm_f32_weights": 0.0,
                   "gn_stats": 0.0, "gn_apply": 0.0, "group_norm": 0.0,
                   "gn_stats_graph": 0.0, "gn_apply_graph": 0.0,
                   "group_norm_graph": 0.0}
    smi = SmiSampler()
    try:
        for r, c, calls in FFN_SHAPES:
            x = rnd(r, c)
            w1, b1 = rnd(8 * c, c, std=c ** -0.5), rnd(8 * c, std=0.1)
            w2, b2 = rnd(c, 4 * c, std=(4 * c) ** -0.5), rnd(c, std=0.1)
            row = timed(lambda: geglu_ffn(x, w1, b1, w2, b2))
            rows.append(dict(kernel="geglu_ffn", rows=r, c=c, **row,
                             tflops=24 * r * c * c / row["ms"] / 1e9))
            per_forward["geglu_ffn"] += calls * row["ms"]
            del x, w1, b1, w2, b2
        for bh, s, calls in ATTN_SHAPES:
            q, k, v = (torch.randn((75, s, bh // 75, 64), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       .transpose(1, 2) for _ in range(3))
            row = timed(lambda: flash_attention(q, k, v, 0.125))
            rows.append(dict(kernel="flash_attention", bh=bh, tokens=s,
                             **row,
                             tflops=4 * bh * s * s * 64 / row["ms"] / 1e9))
            per_forward["flash_attention"] += calls * row["ms"]
            del q, k, v
        per_grad_pass = {"flash_attention_bwd": 0.0, "sdpa_bwd": 0.0}
        for b, h, s, calls in GRAD_ATTN_SHAPES:
            q, k, v, dout = (torch.randn((b, s, h, 64), generator=gen,
                                         device=dev).to(torch.bfloat16)
                             .transpose(1, 2) for _ in range(4))
            out, lse = A._flash_forward(q, k, v, 0.125, with_lse=True)
            qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
            o_sdpa = torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, scale=0.125)
            for key, fn in (
                    ("flash_attention_bwd", lambda: A.flash_attention_bwd(
                        q, k, v, out, lse, dout, 0.125)),
                    ("sdpa_bwd", lambda: torch.autograd.grad(
                        o_sdpa, (qs, ks, vs), dout, retain_graph=True))):
                row = timed(fn)
                rows.append(dict(kernel=key, b=b, h=h, tokens=s, **row,
                                 tflops=10 * b * h * s * s * 64 / row["ms"]
                                 / 1e9))
                per_grad_pass[key] += calls * row["ms"]
            del q, k, v, dout, out, lse, qs, ks, vs, o_sdpa
            torch.cuda.empty_cache()
        for r, c, calls in LN_SHAPES:
            x = rnd(r, c, std=1.5)
            w32 = rnd(c, std=0.3, dtype=torch.float32) + 1.0
            b32 = rnd(c, std=0.2, dtype=torch.float32)
            for key, w, b in (
                    ("layer_norm", w32.bfloat16(), b32.bfloat16()),
                    ("layer_norm_f32_weights", w32, b32)):
                row = timed(lambda: layer_norm(x, w, b, 1e-5))
                rows.append(dict(kernel=key, rows=r, c=c, **row,
                                 gb_s=4 * r * c / row["ms"] / 1e6))
                per_forward[key] += calls * row["ms"]
            del x
        for b_, s, c, calls, n_silu in GN_SHAPES:
            x = rnd(b_, s, c, std=1.5)
            w = rnd(c, std=0.3) + 1.0
            b = rnd(c, std=0.2)
            a, bb = N.group_norm_stats(x, w, b, 32, 1e-6)
            shape = dict(b=b_, s=s, c=c)
            fn = lambda: N.group_norm_stats(x, w, b, 32, 1e-6)
            row = dict(timed(fn), graph_ms=graph_ms(fn))
            rows.append(dict(kernel="gn_stats", **shape, **row,
                             gb_s=2 * x.numel() / row["graph_ms"] / 1e6))
            per_forward["gn_stats"] += calls * row["ms"]
            per_forward["gn_stats_graph"] += calls * row["graph_ms"]
            for silu, n in ((True, n_silu), (False, calls - n_silu)):
                if not n:
                    continue
                for key, fn in (
                        ("gn_apply",
                         lambda: N.group_norm_apply(x, a, bb, silu)),
                        ("group_norm",
                         lambda: N.group_norm(x, w, b, 32, 1e-6, silu))):
                    row = dict(timed(fn), graph_ms=graph_ms(fn))
                    rows.append(dict(kernel=key, **shape, silu=silu, **row))
                    per_forward[key] += n * row["ms"]
                    per_forward[key + "_graph"] += n * row["graph_ms"]
            del x, a, bb
        torch.cuda.empty_cache()
        tl = gs_tile_lists(dev)
        args_ = (tl.P, tl.G, tl.C, tl.O)
        _, ltc = TC.composite_fwd(*args_, tl.K)
        dout = torch.randn((tl.G.shape[0], 6, tl.P.shape[1]), generator=gen,
                           device=dev)
        for key, fn in (
                ("composite_fwd", lambda: TC.composite_fwd(*args_, tl.K)),
                ("composite_bwd", lambda: TC.composite_bwd(
                    *args_, ltc, dout, tl.K))):
            rows.append(dict(kernel=key, shape=list(tl.G.shape),
                             px=tl.P.shape[1], K=tl.K, **timed(fn)))
    finally:
        smi.close()
    device = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "root": args.root,
                      "device": device, "per_forward_ms": per_forward,
                      "per_grad_pass_ms": per_grad_pass, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
