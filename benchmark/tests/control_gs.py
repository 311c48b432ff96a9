"""Readings that the limits of a GS cell's check are set from.

    python benchmark/tests/control_gs.py --seeds 1,2,3 [--fault-seeds 3]
        [--workload llff_gs_refine] [--train lpips_weight=1.0]
        [--faults a,b] [--no-control] [--out control.json]

``--workload`` names the cell (``llff_gs_refine`` by default); each
``--train key=value`` (a JSON value) sets a key of the configuration's
``train`` for this process only, as a cell that a later configuration
adds would state it.

For each seed, in one process: the cell's set-up (``kind_gs.build``: the
scene, the fit, the warm episodes) and one episode of the window,
recorded as a run records it; then, against the float32 reference:

  - ``program``: the program's numbers, as a run's check reads them;
  - ``control``: the reference in TF32 (``Precision("tf32")``, one
    precision below the configuration's float32 with TF32 off) put in the
    program's place for the three steps and the densify, from the same
    program state (a growth does no arithmetic: it has no control);
  - on the first ``--fault-seeds`` seeds, ``faults``: one more episode
    with each fault of ``gs_faults.py`` whose code the configuration runs
    (or each of ``--faults``) planted in the program (the
    growth fault in an episode from the start at its own capacity, which
    grows as the first warm episode did), its numbers.

One JSON line a seed on standard output. Needs the card, as a run does;
the tests call ``readings`` at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE),
                os.path.dirname(os.path.dirname(HERE))]

import torch  # noqa: E402

import gs_faults  # noqa: E402
from harness import common  # noqa: E402
from harness import kind_gs as K  # noqa: E402
from harness.cli import load_cell  # noqa: E402
from reference import gs as ref  # noqa: E402

CELL = "llff_gs_refine"


def control_numbers(run: common.Run, kept: K.Kept, ref_steps) -> dict:
    """The TF32 reference in the program's place, against float32."""
    tf32 = ref.Precision("tf32")
    tf32.switches()
    try:
        stand_in = K.reference_steps(run, kept, tf32)
        out = K.step_numbers(stand_in, ref_steps)
        before, expect, written = K.reference_densify(run, kept)
        _, mine, _ = K.reference_densify(run, kept, tf32)
        out.update(K.densify_numbers(before, mine, expect, written))
    finally:
        ref.Precision().switches()
    return out


def fault_numbers(run: common.Run, prog: K.Program, name: str) -> dict:
    """One episode with fault ``name`` planted, its numbers."""
    trainer, rec = prog.trainer, prog.rec
    train = run.config["train"]
    lo, hi = train["start_sample_svd_iter"], train["iterations"]
    with gs_faults.planted(name):
        trainer._segments = None          # capture the faulty step
        rec.phase = "fault"
        if name == "growth_resets_count":
            prog.start.restore(trainer, prog.start.state.gaussians.capacity)
            rec.episode()
            trainer._run_loop(lo, hi, densify=True)
        else:
            K.episode(prog)
        trainer._segments = None
    kept = K.Kept.of(prog)
    if name == "growth_resets_count":
        grown = [g for g in rec.growths if g[0] == "fault"]
        kept.growth = grown[-1] if grown else None
    rec.growths = [g for g in rec.growths if g[0] != "fault"]
    return {k: v["value"] for k, v in K.check(run, kept).items()}


def readings(run: common.Run, fault_names=(), control: bool = True) -> dict:
    t0 = time.perf_counter()
    prog = K.build(run)
    t_setup = time.perf_counter() - t0
    K.episode(prog)
    common.sync(run.device)
    kept = K.Kept.of(prog)
    t = time.perf_counter()
    program = {k: v["value"] for k, v in K.check(run, kept).items()}
    reference_s = time.perf_counter() - t
    row = {"seed": run.seed, "program": program, "setup_s": t_setup,
           "reference_s": reference_s, "active": prog.active,
           "densified": [int(n) for n in prog.rec.densified],
           "picks": kept.steps.picks if kept.steps else None,
           "boundary": prog.rec.boundary,
           "growth_phase": kept.growth[0] if kept.growth else None}
    if control:
        row["control"] = control_numbers(run, kept,
                                         K.reference_steps(run, kept))
    if fault_names:
        row["faults"] = {n: fault_numbers(run, prog, n)
                         for n in fault_names}
    K.free(prog)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--train", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--faults", default=None)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell, config, traffic, per_layer = load_cell(args.workload)
    for item in args.train:
        key, _, value = item.partition("=")
        config["train"][key] = json.loads(value)
    names = (args.faults.split(",") if args.faults
             else gs_faults.applicable(config["train"]))
    print(f"card: {common.power_limit()}", file=sys.stderr)
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = common.Run(config=config, traffic=traffic,
                         per_layer=per_layer, seed=seed, seconds=0.0,
                         trace=False, device=torch.device("cuda", 0),
                         t0=time.perf_counter())
        faults = tuple(names) if i < args.fault_seeds else ()
        row = readings(run, faults, control=not args.no_control)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
