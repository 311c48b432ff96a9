"""The GS step's LPIPS term on the card at DL3DV's 960x540: which kernels
its spans (``lpips.forward``, ``lpips.backward``) hold, and its counter
(``lpips.calls``) over captured segment replays.

The kernels are named by the benchmark's rule for the term's convolutions
(``benchmark/harness/lpips_kernels.py``, which ``gs.lpips_conv_ms``
reads): in one eager train step, every kernel the rule takes must have
been launched inside an ``lpips.*`` span, those kernels must hold at least
60% of the spans' kernel time (the rest is the ReLUs, pools, the unit
normalisation and the layout copies), and the spans at least 60% of the
step's kernel time.

Every test here needs the card (marker ``chip``) and skips without one;
the CPU tests of the spans and counter are in
``tests/test_torch_lpips.py``. On a card, from the root of the
repository (the tests' conftest imports JAX, which the port does not
need)::

    python -m pytest --noconftest -p no:cacheprovider -q -s \\
        tests/test_torch_lpips_card.py
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from scripts.kernel_timing import random_lpips_params
from syn3r_tpu_torch.gs import trainer as TT
from syn3r_tpu_torch.models import gaussians as G
from syn3r_tpu_torch.utils.camera import camera_from_fov, look_at_w2c
from syn3r_tpu_torch.utils.profiling import counters

H, W = 540, 960
SLOTS = 65536
ROOT = Path(__file__).resolve().parent.parent


def _is_conv():
    """The benchmark's name rule for the term's convolutions."""
    path = ROOT / "benchmark" / "harness" / "lpips_kernels.py"
    spec = importlib.util.spec_from_file_location("lpips_kernels", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.is_conv


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _trainer(dev, tmp_path) -> TT.GSTrainer:
    """Two 960x540 views (60 degrees across) of 49,152 coloured points in
    65,536 slots, random targets, seeded LPIPS weights installed, weight
    1."""
    rng = np.random.default_rng(0)
    n = 49152
    xyz = np.concatenate([rng.uniform(-2.0, 2.0, (n, 2)),
                          rng.uniform(3.0, 6.0, (n, 1))], 1)
    init = G.from_points(torch.tensor(xyz, dtype=torch.float32),
                         torch.tensor(rng.uniform(0, 1, (n, 3)),
                                      dtype=torch.float32),
                         capacity=SLOTS)
    cams = [camera_from_fov(math.radians(60.0), 2 * math.atan(
        math.tan(math.radians(30.0)) * H / W), W, H, look_at_w2c(
        torch.tensor([x, 0.0, 0.0]), torch.tensor([0.0, 0.0, 4.5])))
        for x in (-0.3, 0.3)]
    imgs = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    tr = TT.GSTrainer(TT.make_viewset(cams, imgs),
                      TT.TrainConfig(densify_from_iter=10 ** 9,
                                     lpips_weight=1.0, seed=1),
                      init, model_path=str(tmp_path), device=dev)
    tr.set_lpips(random_lpips_params(3))
    return tr


def _kernels_by_span(events):
    """(device us of each kernel launched inside an ``lpips.*`` span, by
    name; the same of those launched outside every such span). Each op id
    counts once, from its longest event (the profiler also hands an op's
    kernels to marker events it records inside the op)."""
    from torch.autograd import DeviceType
    linked = {}
    for ev in events:
        if ev.device_type == DeviceType.CUDA or not ev.kernels:
            continue
        held = linked.get(ev.id)
        if held is None or (ev.time_range.elapsed_us()
                            > held.time_range.elapsed_us()):
            linked[ev.id] = ev
    inside, outside = {}, {}
    for ev in linked.values():
        p = ev
        while p is not None and not p.name.startswith("lpips."):
            p = p.cpu_parent
        into = inside if p is not None else outside
        for k in ev.kernels:
            into[k.name] = into.get(k.name, 0.0) + k.duration
    return inside, outside


@pytest.mark.chip
def test_card_eager_step_kernels_lie_under_the_spans(dev, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    tr = _trainer(dev, tmp_path)
    cam, img = tr.train_views.view(0)
    for _ in range(2):                 # cuDNN's plans, the kernel builds
        tr._train_step(tr.state, cam, img, use_lpips=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr._train_step(tr.state, cam, img, use_lpips=True)
        torch.cuda.synchronize()
    inside, outside = _kernels_by_span(prof.events())
    is_conv = _is_conv()
    conv_in = sum(us for k, us in inside.items() if is_conv(k))
    spans_us, rest_us = sum(inside.values()), sum(outside.values())
    for name, us in sorted(inside.items(), key=lambda kv: -kv[1])[:25]:
        print(f"lpips span  {us / 1e3:9.3f} ms  conv={is_conv(name)}  "
              f"{name[:150]}")
    for name, us in sorted(outside.items(), key=lambda kv: -kv[1])[:10]:
        print(f"outside     {us / 1e3:9.3f} ms  conv={is_conv(name)}  "
              f"{name[:150]}")
    print(f"conv in spans {conv_in / 1e3:.3f} ms, spans {spans_us / 1e3:.3f}"
          f" ms, outside {rest_us / 1e3:.3f} ms")
    assert [k for k in outside if is_conv(k)] == []
    assert conv_in > 0
    assert conv_in >= 0.6 * spans_us
    assert spans_us >= 0.6 * (spans_us + rest_us)


@pytest.mark.chip
def test_card_replays_count_a_call_a_step(dev, tmp_path):
    """A segment of 8 steps with the term, captured once: each run of it
    (8 replays) adds 8 to ``lpips.calls``."""
    tr = _trainer(dev, tmp_path)
    tr.use_lpips_loss = True
    s0 = tr.state
    for _ in range(2):
        tr.state = s0
        before = counters["lpips.calls"]
        tr._run_loop(0, 8, densify=False)
        torch.cuda.synchronize()
        assert counters["lpips.calls"] - before == 8
    assert tr.graph_builds["step"] == 1
    assert tr._segments.key[-1] is True
