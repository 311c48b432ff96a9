"""Spreads of a set of runs, as the bounds are set from them.

    python benchmark/tests/spread.py <result file> [<result file> ...]

Each file holds one run's standard output (its last line the result). For
each metric: the runs' values, the median, the first and third quartiles
(``statistics.quantiles(values, n=4)``) and the spread: their distance over
the median. Also the spread with the run farthest from the median left
out, as the check reads a set for tightness.
"""

from __future__ import annotations

import json
import statistics
import sys


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list) -> list:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(paths) -> int:
    runs = []
    for p in paths:
        with open(p) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        runs.append(json.loads(lines[-1]))
    names = sorted({k for r in runs for k in r["metrics"]})
    for name in names:
        vals = [r["metrics"][name]["value"] for r in runs
                if name in r["metrics"]]
        if len(vals) < 3:
            print(f"{name}: {vals}")
            continue
        print(json.dumps({"metric": name, "n": len(vals),
                          "median": statistics.median(vals),
                          "spread": spread(vals),
                          "spread_trimmed": spread(trimmed(vals)),
                          "values": vals}))
    print(json.dumps({"correct": [r["correct"] for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
