"""The benchmark's command line: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Reads the cell from ``BENCHMARK.json`` at the checkout's root, its
configuration file and ``traffic/<traffic>.json``, whose ``kind`` names
the module ``harness/kind_<kind>.py`` that runs it on the card; prints
the numbers the check compared beside their limits on standard error and,
as the last line of standard output, the result as one JSON object. With
``--trace 1`` the metrics are the cell's per-layer metrics, each read by
``metrics/<name>.py``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import sys

import torch

from . import common

BENCH_JSON = common.BENCH_DIR.parent / "BENCHMARK.json"
# top-level module names that may not be loaded in the process that
# prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "syn3r_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_cell(name: str):
    """(workload entry, config, traffic, per-layer entries) of cell
    ``name``."""
    bench = json.loads(BENCH_JSON.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {BENCH_JSON}; have "
                         f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((BENCH_JSON.parent / conf["file"]).read_text())
    traffic = json.loads((common.BENCH_DIR / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    moved = {m["name"] for m in bench["end_to_end"]
             if name in m.get("workloads", [name])}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in moved
                 and name in m.get("workloads", [name])]
    return cell, config, traffic, per_layer


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(run: common.Run) -> dict:
    """The result of one run, by the module of the cell's traffic kind."""
    kind = importlib.import_module(f"harness.kind_{run.traffic['kind']}")
    if run.device.type == "cuda":
        torch.zeros(1, device=run.device)     # the allocator exists now
        torch.cuda.reset_peak_memory_stats(run.device)
    out = kind.run(run)
    checked = out.pop("check")
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in checked.values())
    result = {"correct": ok, "attempted": out["attempted"],
              "failed": 0 if ok else 1, "metrics": out["metrics"],
              "device": out["device"]}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["check"] = checked
    return result


def main(argv=None, t0: float = 0.0) -> int:
    args = parse(argv)
    cell, config, traffic, per_layer = load_cell(args.workload)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    run = common.Run(config=config, traffic=traffic,
                     per_layer=per_layer, seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace),
                     device=torch.device("cuda", 0), t0=t0)
    result = run_cell(run)
    print(f"card: {common.power_limit()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {found}: no result", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
