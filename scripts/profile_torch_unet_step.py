#!/usr/bin/env python3
"""Where the time of one guided-denoise UNet forward goes on the card.

    PYTHONPATH=. python3 scripts/profile_torch_unet_step.py [--forwards 2]
        [--grad]

Runs the port's SVD-XT UNet (random bf16 weights from a seed) at the
completion unit's fused batch-3 shape (3 x 25 frames x 72x128 latents,
batch_groups (1, 2)), warms up once, then traces ``--forwards`` forwards
with torch.profiler. With ``--grad`` each traced call is instead one grad
pass of the ``guidance_through_unet`` opt-in: a batch-1 forward with its
blocks checkpointed (``remat_blocks=True``, zero CLIP context) and the
gradient of a scalar of its output with respect to the sample (the
recompute and the backward, flash's dkv and dq kernels among them).
Prints the wall time per call, the device busy share (kernel time over
wall time: one stream, kernels do not overlap), the kernel time by
category and the top kernels, and writes them to
chiprun_out/profile_torch_unet_step.json (``_grad.json`` with
``--grad``). Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from syn3r_tpu_torch.device import resolve_device  # noqa: E402
from syn3r_tpu_torch.diffusion.pipeline import init_random_weights_  # noqa
from syn3r_tpu_torch.models.svd_unet import \
    UNetSpatioTemporalConditionModel  # noqa: E402

# kernel-name fragments -> category, first match wins
CATEGORIES = [
    ("flash_attention backward kernels", ("flash_bwd_",)),
    ("geglu_ffn kernel", ("ffn_wgmma_kernel",)),
    ("flash_attention kernel", ("flash_wgmma_kernel",)),
    ("group_norm kernels", ("gn_stats_kernel", "gn_apply_kernel")),
    ("layer_norm kernel", ("layer_norm_kernel",)),
    ("convolution (cuDNN)", ("conv", "cudnn", "implicit", "xmma_fprop",
                             "nchwToNhwc", "nhwcToNchw", "fprop")),
    ("matmul (cuBLAS: Linear, packed/dense attention)", ("gemm", "cutlass",
                                                         "sm90_xmma",
                                                         "cublas")),
    ("softmax", ("softmax",)),
    ("reduction (norm statistics)", ("reduce",)),
    ("copy / layout", ("copy", "cat", "index", "gather", "repeat",
                       "transpose")),
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
    ap.add_argument("--forwards", type=int, default=2)
    ap.add_argument("--grad", action="store_true",
                    help="trace grad passes of guidance_through_unet")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with torch.device(dev):
        unet = UNetSpatioTemporalConditionModel()
    init_random_weights_(unet, torch.Generator(device=dev).manual_seed(0))
    unet = unet.to(torch.bfloat16).eval().requires_grad_(False)
    batch = 1 if args.grad else 3
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((batch, 25, 72, 128, 8), generator=g, device=dev,
                    dtype=torch.bfloat16)
    ehs = torch.randn((batch, 1, 1024), generator=g, device=dev,
                      dtype=torch.bfloat16)
    tids = torch.tensor([[6.0, 127.0, 0.02]], device=dev).repeat(batch, 1)
    t = torch.tensor(1.3, device=dev)

    def forward():
        if args.grad:
            xs = x.detach().requires_grad_(True)
            out = unet(xs, t, torch.zeros_like(ehs), tids, remat_blocks=True)
            return torch.autograd.grad(out.float().square().sum(), xs)[0]
        with torch.no_grad():
            return unet(x, t, ehs, tids, (1, 2))

    forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.forwards):
        forward()
    torch.cuda.synchronize()
    wall_untraced = (time.perf_counter() - t0) / args.forwards

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.forwards):
            forward()
        torch.cuda.synchronize()
        wall_traced = (time.perf_counter() - t0) / args.forwards

    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and getattr(ev, "device_type", None) is not None and \
                "CUDA" in str(ev.device_type):
            kernels[ev.key] = (dev_us / 1e3 / args.forwards,
                               ev.count // args.forwards)
    if not kernels:
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", 0)
            if dev_us and ev.cpu_time_total == 0:
                kernels[ev.key] = (dev_us / 1e3 / args.forwards,
                                   ev.count // args.forwards)
    busy_ms = sum(ms for ms, _ in kernels.values())
    by_cat = {}
    for name, (ms, n) in kernels.items():
        c = category(name)
        ms0, n0 = by_cat.get(c, (0.0, 0))
        by_cat[c] = (ms0 + ms, n0 + n)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]

    print(f"device: {smi}  torch {torch.__version__}")
    what = ("grad pass (batch-1 forward, recompute, backward)" if args.grad
            else "batch-3 UNet forward")
    print(f"{what}, 25 x 72x128 latents, bf16: wall "
          f"{wall_untraced * 1e3:.1f} ms untraced, {wall_traced * 1e3:.1f} "
          f"ms traced; kernel time {busy_ms:.1f} ms; device idle share "
          f"{1 - busy_ms / (wall_traced * 1e3):.3f}")
    for c, (ms, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.2f} ms  {ms / busy_ms:6.1%}  {n:6d} launches  {c}")
    print("top kernels (ms per call, launches per call):")
    for name, (ms, n) in top:
        print(f"  {ms:9.2f} ms  {n:5d}  {name[:110]}")
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = "profile_torch_unet_step" + ("_grad" if args.grad else "")
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__, "what": what,
                   "wall_ms_untraced": wall_untraced * 1e3,
                   "wall_ms_traced": wall_traced * 1e3,
                   "kernel_ms": busy_ms,
                   "by_category": {c: {"ms": ms, "launches": n}
                                   for c, (ms, n) in by_cat.items()},
                   "top": [{"name": k, "ms": ms, "launches": n}
                           for k, (ms, n) in top]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
