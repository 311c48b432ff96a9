"""Readings that the limits of a cell's check are set from.

    python benchmark/tests/control.py --workload <cell> --seeds 1,2,3
        [--steps 7,8] [--control-seeds 3] [--out control.json]

For each seed, in one process: the program runs one ``denoise`` call of
the cell at its own size through the timed path's code (``kind_denoise``),
keeping ``--steps`` (by default the configuration's ``check.steps``); then
the reference follows each kept step from the program's latents in
float32 (what a run compares with) and, on the first ``--control-seeds``
seeds (default all), in the control's precision, float8 e4m3 (the
reference put in the program's place, one precision below the
configuration's bfloat16). Printed, a line a seed and step: the program's
``unet_rel`` and ``step_rel`` against the float32 reference, and the
control's.

Needs the card, as a run does; the tests call ``readings`` at a tiny size
on the CPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import torch  # noqa: E402

from harness import common  # noqa: E402
from harness.cli import load_cell  # noqa: E402
from harness.kind_denoise import (Kept, Step, build_program,  # noqa: E402
                                  gaps, keep_steps, reference_params,
                                  reference_step)
from harness.traffic import denoise_pair  # noqa: E402
from reference.svd_unet import Precision  # noqa: E402


def program_call(run: common.Run, steps: tuple) -> Kept:
    """One denoise call of pair 0 of ``run.seed``, keeping ``steps``."""
    pcfg = run.config["pipeline"]
    unet, pipe, _ = build_program(run, pcfg["num_inference_steps"])
    kept = Kept(steps=tuple(steps))
    hook = keep_steps(pipe, unet, kept)
    kept.inputs = denoise_pair(run.traffic, pcfg, run.seed, 0, run.device)
    pipe.denoise(**kept.inputs)
    common.sync(run.device)
    hook.remove()
    del unet, pipe
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return kept


def readings(run: common.Run, steps: tuple, control: bool = True) -> list:
    """[{seed, step, program: {unet_rel, step_rel}, control: {...}}]; no
    control without ``control``."""
    kept = program_call(run, steps)
    params = reference_params(run)
    rows = []
    for step in steps:
        t = time.perf_counter()
        x_next, eps = reference_step(run, kept, step, params=params)
        ref_s = time.perf_counter() - t
        rec = kept.records[step]
        row = {"seed": run.seed, "step": step,
               "program": gaps(rec, x_next, eps), "reference_s": ref_s}
        if control:
            x8, eps8 = reference_step(run, kept, step, Precision("fp8"),
                                      params=params)
            stand_in = Step(x_in=rec.x_in, x_out=x8, eps=eps8)
            row["control"] = gaps(stand_in, x_next, eps)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", default=None)
    ap.add_argument("--control-seeds", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell, config, traffic, per_layer = load_cell(args.workload)
    steps = tuple(int(s) for s in (args.steps.split(",") if args.steps
                                   else config["check"]["steps"]))
    seeds = [int(s) for s in args.seeds.split(",")]
    n_control = len(seeds) if args.control_seeds is None \
        else args.control_seeds
    print(f"card: {common.power_limit()}", file=sys.stderr)
    rows = []
    for i, seed in enumerate(seeds):
        run = common.Run(config=config, traffic=traffic,
                         per_layer=per_layer, seed=seed, seconds=0.0,
                         trace=False, device=torch.device("cuda", 0),
                         t0=time.perf_counter())
        for row in readings(run, steps, control=i < n_control):
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
