"""A static-shape step, captured once as a CUDA graph and replayed.

The PyTorch counterpart of the JAX package's one-dispatch segments
(``lax.scan`` in ``GSTrainer._train_steps`` and ``_render_many_jit``,
``syn3r_tpu/gs/trainer.py``): the GS trainer's train step and render are
issued by Python as hundreds of small launches, so the host, not the card,
sets their pace. ``StepGraph`` holds the static buffers of one such step
(a dict of tensors that ``body(bufs)`` reads and writes in place), the
warm-up and the capture, the replay and the launch accounting.

On a CUDA device the holder runs ``body`` ``warmup`` times on a side
stream (the first calls load the kernel libraries and cuBLAS' workspace;
what they write into the buffers is thrown away, so a caller loads its
real state after building the holder), captures one call with
``torch.cuda.graph`` and ``run(n)`` replays it n times. A capture that
fails raises: nothing falls back to the eager step. On the CPU ``run(n)``
calls ``body`` n times.

A replay runs no Python, so the kernel wrappers' launch counts in
``utils.profiling.counters`` would stop: the holder records what the
captured call added to the registry and adds it once per replay. The
warm-up's and the capture's own additions are taken back, so the
registry reads as if only the replayed steps had run.
"""

from __future__ import annotations

import torch

from ..utils.profiling import counters


class StepGraph:
    """``body(bufs)`` over the static tensors ``bufs``, captured on a CUDA
    device and replayed by ``run``. ``key`` is what the capture depends on
    (shapes and the constants the body bakes in); the owner builds a new
    holder when its key changes."""

    def __init__(self, key, bufs: dict, body, device: torch.device,
                 warmup: int = 3):
        self.key = key
        self.bufs = bufs
        self.body = body
        self.graph = None
        self.per_replay = {}
        if device.type != "cuda":
            return
        before = dict(counters)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                body(bufs)
        torch.cuda.current_stream(device).wait_stream(side)
        start = dict(counters)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            body(bufs)
        self.per_replay = {k: v - start.get(k, 0)
                           for k, v in counters.items()
                           if v != start.get(k, 0)}
        counters.clear()
        counters.update(before)

    def run(self, n: int):
        """``n`` steps: graph replays on the card, eager calls on the CPU."""
        if self.graph is None:
            for _ in range(n):
                self.body(self.bufs)
            return
        for _ in range(n):
            self.graph.replay()
        for k, v in self.per_replay.items():
            counters[k] += n * v


def upload(dst: torch.Tensor, values) -> torch.Tensor:
    """Copy host values (a numpy array) into the front of the static tensor
    ``dst`` without waiting for the card (through pinned memory on CUDA)."""
    src = torch.from_numpy(values)
    if dst.is_cuda:
        src = src.pin_memory()
    return dst[:len(values)].copy_(src, non_blocking=True)
