"""GEGLU feed-forward of the SVD transformer blocks.

Counterpart of ``syn3r_tpu/ops/pallas_ffn.py``: ``[a|g] = x W1 + b1``
(C -> 8C), ``y = (a * gelu(g)) W2 + b2`` (4C -> C). On a CUDA tensor
``geglu_ffn`` launches the hand-written kernel pair in
``csrc/geglu_ffn.cu`` (GEMM with a GEGLU epilogue, so the 8C pre-activation
never reaches device memory, then GEMM with a bias epilogue); on a CPU
tensor it runs ``geglu_ffn_reference``. A CUDA tensor never falls back:
the wrapper launches or raises.

Weights use torch's Linear layout: ``w1`` (8C, C), ``w2`` (C, 4C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import build


def geglu_ffn_reference(x2: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """Plain torch GEGLU FF on (R, C) rows in x2's dtype: each product in
    that dtype, then the bias, as ``geglu_ffn_reference`` of the JAX
    package does with its Dense layers."""
    dt = x2.dtype
    h = torch.matmul(x2, w1.to(dt).t()) + b1.to(dt)
    a, g = h.chunk(2, dim=-1)
    prod = a * F.gelu(g)
    return torch.matmul(prod, w2.to(dt).t()) + b2.to(dt)


def geglu_ffn(x2: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """GEGLU FF on (R, C): the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. ``geglu_ffn.launches`` counts kernel
    launches (one per call, which runs both GEMMs)."""
    if x2.device.type == "cpu":
        return geglu_ffn_reference(x2, w1, b1, w2, b2)
    if x2.device.type != "cuda":
        raise ValueError(f"geglu_ffn: unsupported device {x2.device}")
    r, c = x2.shape
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"geglu_ffn kernel takes bfloat16, got {x2.dtype}")
    if c % 32:
        raise ValueError(f"geglu_ffn kernel needs C % 32 == 0, got C={c}")
    if (tuple(w1.shape) != (8 * c, c) or tuple(b1.shape) != (8 * c,)
            or tuple(w2.shape) != (c, 4 * c) or tuple(b2.shape) != (c,)):
        raise ValueError("geglu_ffn: weight shapes do not match C="
                         f"{c}: {w1.shape} {b1.shape} {w2.shape} {b2.shape}")
    args = [t.to(torch.bfloat16).contiguous()
            for t in (x2, w1, b1, w2, b2)]
    # the kernel copies x, W1 and W2 in 16-byte pieces
    if any(args[i].data_ptr() % 16 for i in (0, 1, 3)):
        raise ValueError("geglu_ffn kernel needs 16-byte aligned x, w1, w2")
    h = torch.empty((r, 4 * c), dtype=torch.bfloat16, device=x2.device)
    y = torch.empty((r, c), dtype=torch.bfloat16, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = build.entry("geglu_ffn")(
        *(t.data_ptr() for t in args), h.data_ptr(), y.data_ptr(), r, c,
        stream)
    if err != 0:
        raise RuntimeError(f"geglu_ffn kernel launch failed: cudaError {err}")
    geglu_ffn.launches += 1
    return y


geglu_ffn.launches = 0
