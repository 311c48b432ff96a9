#!/usr/bin/env python3
"""Where the LPIPS refine term's time goes on the card.

One LPIPS (VGG16, random weights from a seed) of a (render, target) pair
at the GS main path's 504x378, float32 with TF32 off, as the GS step runs
it: the forward alone (no gradient), and the forward with the backward to
the render (the input gradient; the weights take none) with cuDNN's
deterministic algorithms on (the module's own call) and off
(``LPIPS.distance``), in turns (on, off, off, on), each timed with CUDA
events over ``--iters`` calls. The convolutions' FLOPs give the achieved
rate. Then a torch.profiler table of
the deterministic forward + backward's device time by kernel name.

    PYTHONPATH=. python3 scripts/profile_torch_lpips.py [--iters 20]

Prints one line a measurement and the card's name and power limit; writes
chiprun_out/profile_torch_lpips.json.
"""

import argparse
import json
import os
import subprocess

import torch

from scripts.kernel_timing import GS_H, GS_W, cuda_ms, random_lpips_params
from syn3r_tpu_torch.device import resolve_device
from syn3r_tpu_torch.models.lpips import _VGG_CFG, lpips_module


def conv_flops(h, w):
    """Multiply-add FLOPs (2 a MAC) of the 13 VGG16 convolutions of one
    image of h x w."""
    flops, c_in = 0, 3
    for c in _VGG_CFG:
        if c == "M":
            h, w = h // 2, w // 2
        else:
            flops += 2 * h * w * 9 * c_in * c
            c_in = c
    return flops


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_lpips: torch sees no CUDA device")
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    model = lpips_module(random_lpips_params(12), dev)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.rand((GS_H, GS_W, 3), generator=g, device=dev)
    b = torch.rand((GS_H, GS_W, 3), generator=g, device=dev)

    def forward():
        with torch.no_grad():
            return model(a, b)

    def forward_backward(deterministic):
        # the module's own call takes the deterministic algorithms where a
        # gradient is taken; ``distance`` is the same function without them
        fn = model if deterministic else model.distance

        def run():
            x = a.clone().requires_grad_(True)
            return torch.autograd.grad(fn(x, b), x)[0]
        return run

    per_image = conv_flops(GS_H, GS_W)
    res = {"device": smi, "shape": [GS_H, GS_W], "iters": args.iters,
           "gflop_forward_pair": 2 * per_image / 1e9,
           "gflop_forward_backward": 3 * per_image / 1e9,
           "forward_ms": cuda_ms(forward, args.iters, warmup=2)}
    turns = {"deterministic": [], "default": []}
    for det in (True, False, False, True):
        turns["deterministic" if det else "default"].append(
            cuda_ms(forward_backward(det), args.iters, warmup=2))
    res["forward_backward_ms"] = turns
    ms = min(turns["deterministic"])
    res["tflops_forward_backward"] = 3 * per_image / ms / 1e9
    res["tflops_forward"] = 2 * per_image / res["forward_ms"] / 1e9
    for k, v in res.items():
        print(f"[lpips] {k}={v}", flush=True)

    fb = forward_backward(True)
    fb()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            fb()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():        # the kernels' own rows
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            rows.append((t / 5e3, e.count // 5, e.key))
    rows.sort(reverse=True)
    res["kernels_ms_per_call"] = [
        {"ms": r[0], "launches": r[1], "name": r[2][:120]} for r in rows[:20]]
    res["kernel_ms_total"] = sum(r[0] for r in rows)
    for r in res["kernels_ms_per_call"]:
        print(f"[lpips] kernel ms={r['ms']:.4f} launches={r['launches']} "
              f"{r['name']}", flush=True)
    print(f"[lpips] kernel_ms_total={res['kernel_ms_total']}", flush=True)
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_torch_lpips.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
