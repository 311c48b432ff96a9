"""Entry point of the benchmark of syn3r_tpu_torch (see README.md).

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
