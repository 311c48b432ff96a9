"""Pipeline parallelism: a GPipe microbatch schedule over a mesh axis.

Counterpart of ``syn3r_tpu/parallel/pipeline_parallel.py``. The SVD-XT
UNet's ~1.5B parameters fit one card, so pipeline parallelism is not on
this package's production path (direction and pair placement, TP and
frame-axis SP are, see the sibling modules); it is a capability for
models that outgrow one card: GPipe, stage s's parameters on device s,
each activation copied to the next stage's device by a stream-ordered
copy, every stage's work issued from the one host thread.

Uniform-stage restriction (JAX's, kept so the two agree):
``stage_fn(stage_params, x) -> y`` must have ``y.shape == x.shape`` and
one structure for all stages (per-stage weights differ; shapes do not).
Transformer and resnet towers, including this package's
``BasicTransformerBlock`` stacks, have that shape; a UNet's changing
resolutions would need per-stage padding to a common activation shape.

There is deliberately no expert parallelism here: nothing in the
reference (or in SVD, DUSt3R, GMFlow, CLIP) is a mixture of experts, so an
"ep" axis has no load to carry: a documented absence, not an omission.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .mesh import Mesh, to_device


def make_gpipe(mesh: Mesh, stage_fn: Callable, n_stages: int,
               axis: str = "stage"):
    """A GPipe runner for ``n_stages`` stages over ``mesh``'s ``axis``.

    ``stage_fn(params_i, x)`` is one stage; the returned
    ``run(stage_params, x, n_microbatch)`` applies stages 0..S-1 in
    sequence, pipelined over microbatches. ``stage_params`` holds one
    entry a stage (a module or a tensor), moved to its stage's device (a
    module in place);
    ``x`` is (B, ...) with B divisible by ``n_microbatch``. The output is
    on x's device.

    Schedule: S + M - 1 ticks; at tick t stage s computes microbatch
    t - s (where 0 <= t - s < M) from what stage s - 1 handed it at tick
    t - 1, and its activation is copied to stage s + 1's device; the last
    stage's results are gathered. The bubble is GPipe's (S-1)/(S-1+M).
    """
    if mesh.shape.get(axis) != n_stages:
        raise ValueError(f"mesh axis {axis!r} has size "
                         f"{mesh.shape.get(axis)}, want {n_stages}")
    devices = mesh.along(axis)

    def run(stage_params: Sequence, x: torch.Tensor, n_microbatch: int):
        b = x.shape[0]
        if b % n_microbatch:
            raise ValueError(f"batch {b} not divisible by {n_microbatch}")
        if len(stage_params) != n_stages:
            raise ValueError(f"{len(stage_params)} stage parameters for "
                             f"{n_stages} stages")
        params = [p.to(d) for p, d in zip(stage_params, devices)]
        xs = list(x.chunk(n_microbatch))
        last = n_stages - 1
        inbox = [None] * n_stages        # what each stage takes this tick
        done = [None] * n_microbatch
        for t in range(n_microbatch + n_stages - 1):
            outbox = [None] * n_stages
            for s in range(n_stages):
                m = t - s
                if not 0 <= m < n_microbatch:
                    continue
                inp = to_device(xs[m], devices[0]) if s == 0 else inbox[s]
                y = stage_fn(params[s], inp)
                if s == last:
                    done[m] = y
                else:
                    outbox[s + 1] = to_device(y, devices[s + 1])
            inbox = outbox
        return torch.cat([to_device(y, x.device) for y in done])

    return run
