"""Spans, counters, per-phase wall-clock timing, device traces and
memory statistics.

Counterpart of ``syn3r_tpu/utils/profiling.py``, plus the port's spans and
counters:

- ``span(name)`` marks a stretch of the host's work for ``torch.profiler``.
  While a profiler records, it is a host op (``_RecordFunctionFast``) in
  the same session as the kernels, on the trace's clock: the ops and
  kernels issued inside it are its children, kernels launched by the
  hand-written wrappers' ctypes entry points included (the profiler links
  a kernel to the innermost op open when it was launched). It is never a
  user annotation, so it adds no event to the device's timeline. With no
  profiler recording it is one shared null context. The names are dotted,
  layer first: ``denoise.*`` in ``diffusion/pipeline.py``, ``unet.*`` in
  ``models/svd_unet.py``. A span may enclose a ``yield`` of a ``steps``
  generator (``models.layers.run_local``): on one device the generators
  nest and so do their spans; under ``parallel/sequence_parallel.py`` the
  shards' generators run in lock-step, so their spans overlap and a kernel
  of a call across the shards is linked to the last shard's.
- ``counters``: one process-wide ``collections.Counter`` of dotted names,
  ``launches.<kernel>`` for each hand-written kernel's launches and
  ``norm.copies`` for the norms' input copies. ``gs/step_graph.py`` adds
  a captured step's share to it on each replay.
- ``PhaseTimer`` sums the wall time per named pipeline phase (init_gs,
  densify, refine); a phase with ``sync=True`` waits for the card
  (``torch.cuda.synchronize``) before it stops the clock, so queued
  kernels are charged to it. Each phase is also a span.
- ``trace`` (JAX's ``xla_trace``) records a ``torch.profiler`` trace of
  its block, spans included, and writes it as a Chrome trace under
  ``log_dir``, for an operator to open in Perfetto or ``chrome://tracing``.
- ``device_memory_stats`` gives the card's allocator statistics under
  JAX's keys, or None off a card.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import Counter, defaultdict
from typing import Optional

import torch

counters: Counter = Counter()

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager marking its block as ``name`` in a profiler's
    trace; the shared null context while no profiler records."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


class PhaseTimer:
    """Aggregates wall time per named phase; json-serializable summary."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        try:
            with span(name):
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


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host and, on a card, device activity) and write
    ``trace_<pid>_<ns>.json`` (Chrome trace format) under ``log_dir``;
    yields the path it will write."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


def device_memory_stats(device=None) -> Optional[dict]:
    """The caching allocator's bytes in use and peak, and the card's
    memory (JAX's ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``)
    of ``device`` (the current card by default); None without a card or
    for a CPU device."""
    if not torch.cuda.is_available():
        return None
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(dev)[1]}
