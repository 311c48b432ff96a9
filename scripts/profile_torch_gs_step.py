#!/usr/bin/env python3
"""Where the time of one GS train step goes on the card, for both paths.

    PYTHONPATH=. python3 scripts/profile_torch_gs_step.py [--steps 10]
        [--trace-steps 10]

Builds the GS main path's scene (bench.py's GS layout: 65,536 Gaussians
from numpy seed 0, one 504x378 camera, tile_cap 1024) in the port's
GSTrainer with the composite kernels and times its two paths in turns:
eager (``_train_step``, the per-step path), graph (one replay of the
trainer's captured static step, its default), graph, eager. Each turn
warms up, times ``--steps`` steps untraced, each to its own synchronize
(median, p10, p90), then traces ``--trace-steps`` with torch.profiler.
Prints per turn the wall time per step, the kernel time and device idle
share (one stream, kernels do not overlap) and, for the first turn of
each path, the kernel time by category and the top kernels; writes them
to chiprun_out/profile_torch_gs_step.json. Needs a CUDA device.
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
from scripts.kernel_timing import gs_replays  # noqa: E402

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
    tr._run_loop(0, 2, densify=False)        # captures the static step
    replays = gs_replays(tr)

    def eager(n):
        for _ in range(n):
            tr.state, _ = tr._train_step(tr.state, cam0, img0)
        torch.cuda.synchronize()

    def graph(n):
        replays(n)
        torch.cuda.synchronize()

    turns = []
    for name, steps in (("eager", eager), ("graph", graph),
                        ("graph", graph), ("eager", eager)):
        steps(args.trace_steps)
        step_ms = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            steps(1)
            step_ms.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps(args.trace_steps)
            wall_traced = (time.perf_counter() - t0) / args.trace_steps
        turns.append(dict(path=name, step_ms=step_ms,
                          **kernel_table(prof, args.trace_steps,
                                         wall_traced)))

    print(f"device: {smi}  torch {torch.__version__}")
    print("GS train step, 504x378, 65,536 Gaussians, tile_cap 1024, in "
          "turns (each step timed to its own synchronize):")
    for t in turns:
        ms = t["step_ms"]
        print(f"  {t['path']:5s}: wall median {np.median(ms)} ms (p10 "
              f"{np.percentile(ms, 10)}, p90 {np.percentile(ms, 90)}; "
              f"{len(ms)} steps), {t['wall_ms_traced']:.2f} ms traced; "
              f"kernel time {t['kernel_ms']:.3f} ms; device idle share "
              f"{t['idle_share']:.3f}")
    for t in turns[:2]:
        print(f"{t['path']} (first turn), by category:")
        busy = max(t["kernel_ms"], 1e-9)
        for c, v in sorted(t["by_category"].items(),
                           key=lambda kv: -kv[1]["ms"]):
            print(f"  {v['ms']:8.3f} ms  {v['ms'] / busy:6.1%}  "
                  f"{v['launches']:5d} launches  {c}")
        print("  top kernels (ms per step, launches per step):")
        for k in t["top"]:
            print(f"  {k['ms']:8.3f} ms  {k['launches']:4d}  "
                  f"{k['name'][:110]}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_torch_gs_step.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__,
                   "turns": [dict(t, wall_ms_untraced_median=float(
                       np.median(t["step_ms"])), p10_p90=[
                       float(np.percentile(t["step_ms"], q))
                       for q in (10, 90)]) for t in turns]}, f, indent=1)
    return 0


def kernel_table(prof, steps, wall_traced):
    """Kernel time per step by name and category from a trace of
    ``steps`` steps, and the device idle share of the traced wall time."""
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0)
        if dev_us and "CUDA" in str(getattr(ev, "device_type", "")):
            kernels[ev.key] = (dev_us / 1e3 / steps, ev.count // steps)
    busy_ms = sum(ms for ms, _ in kernels.values())
    by_cat = {}
    for name, (ms, cnt) in kernels.items():
        c = category(name)
        ms0, n0 = by_cat.get(c, (0.0, 0))
        by_cat[c] = (ms0 + ms, n0 + cnt)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]
    return dict(wall_ms_traced=wall_traced * 1e3, kernel_ms=busy_ms,
                idle_share=1 - busy_ms / (wall_traced * 1e3),
                by_category={c: {"ms": ms, "launches": cnt}
                             for c, (ms, cnt) in by_cat.items()},
                top=[{"name": k, "ms": ms, "launches": cnt}
                     for k, (ms, cnt) in top])


if __name__ == "__main__":
    sys.exit(main())
