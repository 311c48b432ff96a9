#!/usr/bin/env python3
"""Whether the GS step with the LPIPS loss needs cuDNN's deterministic
algorithms for its CUDA-graph replay to agree bit for bit with the
per-step path: chip_smoke.py's lpips phase (a 100-step segment from graph
replays against the per-step path from the same state and picks), run
``--repeats`` times with ``models/lpips.deterministic_convs`` replaced by a
null context (cuDNN's default algorithms), then once as it is.

    PYTHONPATH=. python3 scripts/lpips_determinism.py [--repeats 2]

Prints one line a run (bit for bit or the first disagreement) and the
card's name and power limit.
"""

import argparse
import contextlib
import subprocess

import torch

import chip_smoke
from syn3r_tpu_torch.device import resolve_device
from syn3r_tpu_torch.kernels import build
from syn3r_tpu_torch.models import lpips as LP


def run(dev, deterministic):
    saved = LP.deterministic_convs
    if not deterministic:
        LP.deterministic_convs = contextlib.nullcontext
    try:
        res = chip_smoke.run_lpips(dev)
        return dict(bit_for_bit=True, losses=res["losses"],
                    step_ms_median=res["step_ms_median"])
    except AssertionError as e:
        return dict(bit_for_bit=False, reading=str(e)[:600])
    finally:
        LP.deterministic_convs = saved


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--repeats", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lpips_determinism: torch sees no CUDA device")
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    build.build_all()
    for det in [False] * args.repeats + [True]:
        print(f"[determinism] deterministic_convs={det} "
              f"{run(dev, det)}", flush=True)
    print(smi)


if __name__ == "__main__":
    main()
