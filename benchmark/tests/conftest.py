"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests marked ``chip`` need a CUDA card and skip without one; the rest run
on the CPU at tiny sizes (``tiny.py``)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips on a machine without one")
