#!/usr/bin/env python3
"""Time the GEGLU-FFN and flash-attention kernels of a checkout of the port
at the UNet's shapes, to compare two checkouts on one card.

    python3 scripts/time_unet_kernels.py [--root DIR] [--label NAME]

Imports syn3r_tpu_torch from DIR (default: this checkout), so its kernel
libraries are built from DIR's sources, and times ``geglu_ffn`` and
``flash_attention`` at the main path's shapes (FFN_SHAPES and ATTN_SHAPES
of scripts/kernel_timing.py, taken from this checkout so that an older
checkout is timed at the same shapes) with CUDA events, on inputs made from
a seed, each in a window of at least ~0.25 s. nvidia-smi samples the SM
clock and power draw every 20 ms; each shape carries their medians over its
window. Prints one JSON line: per shape ms, TFLOP/s, MHz and W, and the
sums over one batch-3 UNet forward. Run it as parent, change, change,
parent in one call to compare two checkouts. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

from kernel_timing import ATTN_SHAPES, FFN_SHAPES, SmiSampler, window_iters


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
    from syn3r_tpu_torch.ops.attention import flash_attention
    from syn3r_tpu_torch.ops.geglu_ffn import geglu_ffn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(torch.bfloat16)

    def timed(fn):
        ms, mhz, watts = smi.timed(fn, window_iters(fn))
        return dict(ms=ms, sm_mhz=mhz, power_w=watts)

    rows, per_forward = [], {"geglu_ffn": 0.0, "flash_attention": 0.0}
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
