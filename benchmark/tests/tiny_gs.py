"""The GS cell of BENCHMARK.json cut to a size the CPU runs in seconds,
for rehearsing a run without the card: a 128x64 frame (4 tiles), 6,000
truth Gaussians, 4,000 start points (in a capacity of 4,096: the first
densify grows it) fitted up to a capacity of 8,192 and cut to 7,680
live, 5 frames a pair (12 pseudo views), a fit of 40 iterations and
episodes of 20 with a densify every 10; the port's plain composite (the
kernel route runs its plain version on the CPU)."""

from __future__ import annotations

import copy
import time

import torch

from harness import common
from harness.cli import load_cell

CELL = "llff_gs_refine"
TINY_SCENE = {"width": 128, "height": 64, "focal": 110.0, "frames": 5,
              "truth_gaussians": 6000}
TINY_TRAIN = {"iterations": 60, "start_sample_svd_iter": 40,
              "densify_from_iter": 10, "densification_interval": 10,
              "opacity_reset_interval": 60, "pseudo_cam_sampling_rate": 0.3,
              "tile_cap": 256}
TINY_TRAFFIC = {"objects": 4, "sparse_points": 4000, "fit_capacity": 8192,
                "start_live": 7680}


def tiny_gs_run(seed: int = 1, seconds: float = 0.0, trace: bool = False,
                **train) -> common.Run:
    entry, config, traffic, per_layer = load_cell(CELL)
    config = copy.deepcopy(config)
    config["scene"].update(TINY_SCENE)
    config["train"].update(TINY_TRAIN, **train)
    traffic = dict(traffic, **TINY_TRAFFIC)
    return common.Run(config=config, traffic=traffic, per_layer=per_layer,
                      seed=seed, seconds=seconds, trace=trace,
                      device=torch.device("cpu"), t0=time.perf_counter())
