"""Per-phase wall-clock timing.

Counterpart of ``syn3r_tpu/utils/profiling.py`` ``PhaseTimer``: wall time
per named pipeline phase (init_gs, densify, refine), summed over calls. A
phase with ``sync=True`` waits for the card (``torch.cuda.synchronize``)
before it stops the clock, so queued kernels are charged to it.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Aggregates wall time per named phase; json-serializable summary."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_available() \
                    and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": v, "count": self.counts[k],
                    "mean_s": v / max(self.counts[k], 1)}
                for k, v in sorted(self.totals.items())}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)
