#!/usr/bin/env python3
"""Where the time of one GS train step goes on the card.

    PYTHONPATH=. python3 scripts/profile_torch_gs_step.py [--steps 10]
        [--trace-steps 10]

Builds the GS main path's scene (bench.py's GS layout: 65,536 Gaussians
from numpy seed 0, one 504x378 camera, tile_cap 1024) in the port's
GSTrainer with the composite kernels, warms up, times ``--steps`` train
steps untraced, each to its own synchronize (median and mean), then traces
``--trace-steps`` with torch.profiler. Prints the wall time per step, the
kernel time and device idle share (one stream, kernels do not overlap), the
kernel time by category and the top kernels, and writes them to
chiprun_out/profile_torch_gs_step.json. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from syn3r_tpu_torch.device import resolve_device  # noqa: E402
from syn3r_tpu_torch.gs.trainer import (GSTrainer, TrainConfig,  # noqa
                                        make_viewset)
from syn3r_tpu_torch.models import gaussians as GM  # noqa: E402
from syn3r_tpu_torch.utils.camera import (camera_from_fov,  # noqa: E402
                                          look_at_w2c)

# kernel-name fragments -> category, first match wins
CATEGORIES = [
    ("composite_fwd kernel", ("composite_fwd_kernel",)),
    ("composite_bwd kernels (tot, gradient, partial sums)",
     ("composite_bwd",)),
    ("sort (depth argsort)", ("sort", "radix")),
    ("scan (hit cumsum)", ("scan",)),
    ("searchsorted (slot search)", ("searchsorted",)),
    ("convolution (SSIM window)", ("conv", "cudnn", "fprop", "dgrad")),
    ("matmul (cuBLAS: the projection's batched 2x3/3x3 products)", (
        "gemm", "xmma", "cutlass")),
    ("gather / scatter (tile lists and their backward)", (
        "index", "gather", "scatter", "put_")),
    ("reduction", ("reduce",)),
    ("copy / layout", ("copy", "cat", "repeat", "transpose", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace-steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    w, h, n = 504, 378, 65_536
    rng = np.random.default_rng(0)
    xyz = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                          rng.uniform(1.5, 4.0, (n, 1))], 1).astype(np.float32)
    state = GM.from_points(torch.from_numpy(xyz).to(dev), torch.from_numpy(
        rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(dev), capacity=n)
    cam = camera_from_fov(0.9, 0.7, w, h, look_at_w2c([0.0, 0.0, 0.0],
                                                      [0.0, 0.0, 2.5]))
    img = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = os.path.join(root, "chiprun_out")
    tr = GSTrainer(make_viewset([cam], img),
                   TrainConfig(tile_cap=1024, densify_from_iter=10 ** 9),
                   state, model_path=os.path.join(root, "build",
                                                  "gs_profile"),
                   device=dev)
    cam0, img0 = tr.train_views.view(0)

    def steps(n):
        for _ in range(n):
            tr.state, _ = tr._train_step(tr.state, cam0, img0)
        torch.cuda.synchronize()

    steps(args.trace_steps)
    step_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        steps(1)
        step_ms.append(1e3 * (time.perf_counter() - t0))
    wall_untraced = float(np.mean(step_ms)) / 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(args.trace_steps)
        wall_traced = (time.perf_counter() - t0) / args.trace_steps

    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0)
        if dev_us and "CUDA" in str(getattr(ev, "device_type", "")):
            kernels[ev.key] = (dev_us / 1e3 / args.trace_steps,
                               ev.count // args.trace_steps)
    busy_ms = sum(ms for ms, _ in kernels.values())
    by_cat = {}
    for name, (ms, cnt) in kernels.items():
        c = category(name)
        ms0, n0 = by_cat.get(c, (0.0, 0))
        by_cat[c] = (ms0 + ms, n0 + cnt)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]

    print(f"device: {smi}  torch {torch.__version__}")
    print(f"GS train step, 504x378, 65,536 Gaussians, tile_cap 1024: wall "
          f"untraced median {np.median(step_ms)} ms, mean "
          f"{wall_untraced * 1e3} ms (p10 {np.percentile(step_ms, 10)}, "
          f"p90 {np.percentile(step_ms, 90)}; {args.steps} steps), "
          f"{wall_traced * 1e3:.2f} ms traced; kernel time {busy_ms:.2f} "
          f"ms; device idle share {1 - busy_ms / (wall_traced * 1e3):.3f}")
    for c, (ms, cnt) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:8.3f} ms  {ms / busy_ms:6.1%}  {cnt:5d} launches  {c}")
    print("top kernels (ms per step, launches per step):")
    for name, (ms, cnt) in top:
        print(f"  {ms:8.3f} ms  {cnt:4d}  {name[:110]}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_torch_gs_step.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__,
                   "wall_ms_untraced": wall_untraced * 1e3,
                   "wall_ms_untraced_median": float(np.median(step_ms)),
                   "step_ms": step_ms,
                   "wall_ms_traced": wall_traced * 1e3,
                   "kernel_ms": busy_ms,
                   "by_category": {c: {"ms": ms, "launches": cnt}
                                   for c, (ms, cnt) in by_cat.items()},
                   "top": [{"name": k, "ms": ms, "launches": cnt}
                           for k, (ms, cnt) in top]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
