"""Bound torch's CPU intra-op threads to an xdist worker's share of the cores.

Torch opens an intra-op pool as wide as the machine in every process, so
``pytest -n 6`` on 8 cores runs 48 torch threads on 8 cores, and the port's
tests spend their time waiting for one another's threads. Every
``tests/test_torch_*.py`` imports this module before its torch work. An
xdist worker collects every test module before it runs one, so the first
port module it imports sets the bound for everything the worker runs; the
import in each file keeps a file run alone or under ``-k`` bounded too.

The bound is the cores this process may use over the workers xdist says it
started (``PYTEST_XDIST_WORKER_COUNT``), at least 1. ``OMP_NUM_THREADS``
carries it to the processes a test starts (a real ``cli.train`` worker),
whose torch reads it for its default. Outside xdist torch's default stays,
so a file run by hand keeps its speed.
"""
import os

import torch


_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
BOUND = (max(1, len(os.sched_getaffinity(0)) // _WORKERS) if _WORKERS > 1
         else None)
if BOUND is not None:
    torch.set_num_threads(BOUND)
    os.environ["OMP_NUM_THREADS"] = str(BOUND)
