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
  * ``composite_fwd`` and ``composite_bwd`` on the GS main path's tile
    lists (``gs_tile_lists``: T 96, px 2048, cap 1024, K 128, projected
    and binned by DIR's code).
Each in a window of at least ~0.25 s; nvidia-smi samples the SM clock and
power draw every 20 ms and each row carries their medians over its window.
Prints one JSON line: per row ms, MHz and W, and the sums over one batch-3
UNet forward. Run it as parent, change, change, parent in one call to
compare two checkouts. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

from kernel_timing import (ATTN_SHAPES, FFN_SHAPES, LN_SHAPES, SmiSampler,
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
    from syn3r_tpu_torch.ops.attention import flash_attention
    from syn3r_tpu_torch.ops.geglu_ffn import geglu_ffn
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
                   "layer_norm": 0.0, "layer_norm_f32_weights": 0.0}
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
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
