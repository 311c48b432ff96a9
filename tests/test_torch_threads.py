"""Torch's CPU threads in the port's tests (``tests/torch_threads.py``).

Under xdist each worker's intra-op pool, and that of a process it starts,
is bounded to its share of the cores; outside xdist torch keeps the
default a fresh interpreter opens.
"""
import torch_threads

import os
import subprocess
import sys

import torch


def test_xdist_worker_threads_bounded():
    """Under xdist torch's threads here and in a child process are the
    helper's bound, at most the cores over the workers; outside it they
    are a fresh process's."""
    child = int(subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, check=True).stdout)
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        share = max(1, len(os.sched_getaffinity(0)) // workers)
        assert torch.get_num_threads() == torch_threads.BOUND == child
        assert torch_threads.BOUND <= share
    else:
        assert torch_threads.BOUND is None
        assert torch.get_num_threads() == child
