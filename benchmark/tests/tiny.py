"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds, for
rehearsing a run without the card: the UNet's widths, the frames, the
latent grid and the CLIP width shrink, everything else stays the cell's."""

from __future__ import annotations

import copy
import time

import torch

from harness import common
from harness.cli import load_cell

TINY_UNET = {"block_out_channels": [32, 64, 64, 64],
             "num_attention_heads": [1, 2, 2, 2],
             "addition_time_embed_dim": 16, "cross_attention_dim": 32}
# 32 x 64 latents: the smallest grid the guidance's absolute tiles take
TINY_PIPELINE = {"num_frames": 5, "height": 256, "width": 512}


def tiny_run(cell: str, seed: int = 1, seconds: float = 0.0,
             trace: bool = False, **pipeline) -> common.Run:
    entry, config, traffic, per_layer = load_cell(cell)
    config = copy.deepcopy(config)
    config["unet"].update(TINY_UNET)
    config["unet"]["projection_class_embeddings_input_dim"] = \
        3 * TINY_UNET["addition_time_embed_dim"]
    config["pipeline"].update(TINY_PIPELINE, **pipeline)
    traffic = dict(traffic, clip_dim=TINY_UNET["cross_attention_dim"])
    return common.Run(config=config, traffic=traffic,
                      per_layer=per_layer, seed=seed, seconds=seconds,
                      trace=trace, device=torch.device("cpu"),
                      t0=time.perf_counter())
