"""What every kind of cell shares: the run's context, the clock, device
facts, the profiler's reading and the per-layer metric readers."""

from __future__ import annotations

import dataclasses
import importlib.util
import subprocess
import time
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent.parent
# longest kernel or gap name kept in a breakdown
NAME_CHARS = 120


@dataclasses.dataclass
class Run:
    """One run of one cell: what the command line and BENCHMARK.json give."""
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    per_layer: list       # the per_layer entries this cell reports
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float             # perf_counter() at process start


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now(device: torch.device) -> float:
    sync(device)
    return time.perf_counter()


def device_facts(device: torch.device) -> dict:
    """The result line's ``device`` (peak memory filled in later)."""
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": 0}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip() or out.stderr.strip()


def memory_peak(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


class Profile:
    """torch.profiler over one stretch of a run (CPU and device activity):
    kernel time by name, the device's busy time (the union of its
    operations' intervals), the stretch's wall time, the longest device
    operations and the longest gaps between them, each gap named by the
    shortest host operation that spans its start. Reading the trace takes
    longer than the stretch: a run traces a stretch after its window."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=acts)

    def __enter__(self):
        sync(self.device)
        self.prof.__enter__()
        self.t_start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.wall_s = time.perf_counter() - self.t_start
        self.prof.__exit__(*exc)
        return False

    def read(self):
        from torch.autograd import DeviceType
        kernels = {}
        for ev in self.prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            if dev_us and "CUDA" in str(getattr(ev, "device_type", "")):
                kernels[ev.key] = (dev_us / 1e6, ev.count)
        self.kernels = kernels
        events = list(self.prof.events())
        dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        busy_us, gaps, end = 0.0, [], None
        for e in dev:
            s, t = e.time_range.start, e.time_range.end
            if end is None or s >= end:
                busy_us += t - s
                if end is not None and s > end:
                    gaps.append((s - end, end))
                end = t
            elif t > end:
                busy_us += t - end
                end = t
        self.busy_s = (busy_us / 1e6 if dev else
                       sum(s for s, _ in kernels.values()))
        self.gaps = sorted(gaps, reverse=True)[:10]
        self.host = [e for e in events if e.device_type == DeviceType.CPU]

    def breakdown(self) -> dict:
        ops = sorted(((name[:NAME_CHARS], s) for name, (s, _) in
                      self.kernels.items()), key=lambda kv: -kv[1])[:10]
        gaps = []
        for length_us, start in self.gaps:
            spans = [e for e in self.host
                     if e.time_range.start <= start < e.time_range.end]
            what = (min(spans, key=lambda e: e.time_range.end
                        - e.time_range.start).name if spans else "host")
            gaps.append([what[:NAME_CHARS], length_us / 1e6])
        return {"device_ops": [list(o) for o in ops], "idle_gaps": gaps}

    def kernel_s(self, *fragments) -> float:
        """Device seconds of the kernels whose name holds a fragment."""
        return sum(s for name, (s, _) in self.kernels.items()
                   if any(f in name for f in fragments))


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_per_layer(run: Run, ctx: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds, by name."""
    out = {}
    for m in run.per_layer:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
