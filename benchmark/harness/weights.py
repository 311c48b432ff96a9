"""Random weights from a seed, made on the device in a few large calls.

Every weight of ``shapes`` is a view of one flat buffer drawn by one
``torch.randn`` in the dtype the weights are served in, each starting at a
multiple of 128 bytes (as an allocation would: a library picks slower
kernels for a misaligned operand, and the program's kernels copy one); the
buffer is laid out by kind so that each kind is scaled in place by one
call a distinct scale: matrices and kernels LeCun-normal (std 1/sqrt(fan in), one call per
fan in), biases N(0, 0.02^2), norm scales 1 + N(0, 0.1^2), mix factors
N(0, 1). The same seed on the same kind of device gives the same tensors,
so the program and the reference each draw their own copy.
"""

from __future__ import annotations

import hashlib
import math

import torch

# every weight starts at a multiple of this many elements
ALIGN = 64


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for stream ``what`` of run seed ``seed``."""
    digest = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _kind(name: str, shape: tuple) -> tuple:
    """(sort key, scale, shift) of a weight."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "mix_factor":
        return ("mix", 1.0, 0.0)
    if len(shape) == 1 and leaf == "bias":
        return ("bias", 0.02, 0.0)
    if len(shape) == 1:
        return ("scale", 0.1, 1.0)
    fan_in = math.prod(shape[1:])
    return (f"w{fan_in:012d}", fan_in ** -0.5, 0.0)


def seeded_weights(shapes: dict, seed: int, device, dtype) -> dict:
    """{name: tensor} for ``shapes`` ({name: shape}), drawn from ``seed``."""
    names = sorted(shapes, key=lambda n: (_kind(n, shapes[n])[0], n))
    total = sum(-(-math.prod(shapes[n]) // ALIGN) * ALIGN for n in names)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, runs, off = {}, [], 0
    for n in names:
        size = math.prod(shapes[n])
        out[n] = flat[off:off + size].view(shapes[n])
        key, scale, shift = _kind(n, shapes[n])
        span = -(-size // ALIGN) * ALIGN
        if runs and runs[-1][0] == key:
            runs[-1][2] = off + span
        else:
            runs.append([key, off, off + span, scale, shift])
        off += span
    for _, start, end, scale, shift in runs:
        flat[start:end].mul_(scale).add_(shift)
    return out
