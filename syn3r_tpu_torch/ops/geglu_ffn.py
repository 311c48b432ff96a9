"""GEGLU feed-forward of the SVD transformer blocks.

Counterpart of ``syn3r_tpu/ops/pallas_ffn.py``: ``[a|g] = x W1 + b1``
(C -> 8C), ``y = (a * gelu(g)) W2 + b2`` (4C -> C). On a CUDA tensor
``geglu_ffn`` launches the hand-written kernel pair in
``csrc/geglu_ffn.cu`` (persistent wgmma GEMMs fed by TMA: the first with a
GEGLU epilogue, so the 8C pre-activation never reaches device memory, the
second with a bias epilogue) through an autograd Function whose backward
recomputes through the plain version, as JAX's ``_ffn_bwd`` does; on a
CPU tensor it runs ``geglu_ffn_reference``. A CUDA tensor never falls
back: the wrapper launches or raises. ``geglu_plan`` is the launch
geometry, in plain Python.

Weights use torch's Linear layout: ``w1`` (8C, C), ``w2`` (C, 4C); a
tensor-parallel shard of the GEGLU units (``parallel/tensor_parallel.py``)
passes ``w1`` (2 inner, C), its value rows then its gate rows, and ``w2``
(C, inner), inner any multiple of 8 (the SVD UNet's shards: 4C / 2 and
4C / 4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import build
from ..utils.profiling import counters

# Rows of a GEMM tile (128 for each of the two consumer warpgroups);
# GEMM-1's tiles are 64 output columns (a 128-row B tile: their 64 a rows
# of W1 and their 64 g rows), whose GEGLU epilogue runs under the next
# tile's wgmmas; GEMM-2's N tile is one of GEMM2_TILES (the kernel is
# built for these): 160 for the SVD UNet's C = 320/640/1280, 128 for
# narrower UNets (C = 64, 128, as in chip_smoke.py's small UNet, which
# holds it against the plain version).
TILE_ROWS, GEMM1_TN, GEMM2_TILES = 256, 64, (160, 128)
# The budgets of csrc/geglu_ffn.cu: K per ring stage, the ring's share of
# shared memory (as many stages of an A and a B tile as fit 220 KB; GEMM-1
# adds the staging tile its TMA stores of h read from), a block's threads
# (a producer and two consumer warpgroups) and the registers setmaxnreg
# gives a thread of each; what one H100 SM offers a block (227 KB of
# shared memory, 65,536 registers).
GEMM_BK, RING_BYTES, THREADS = 64, 220 * 1024, 384
PRODUCER_REGS, CONSUMER_REGS = 40, 232
SMEM_PER_BLOCK, REGS_PER_SM = 232_448, 65_536


def gemm_smem(bn: int, geglu: bool = False) -> dict:
    """Shared memory of a GEMM whose B tile has ``bn`` rows (GEMM-1, the
    GEGLU one: 2 x GEMM1_TN; GEMM-2: its N tile), as ``Cfg`` in the .cu
    file lays it out: its ring's stages and the dynamic shared memory a
    block asks for (1 KB of alignment slack, the ring, GEMM-1's staging
    tile of h, TILE_ROWS x bn / 2 bf16, a full and an empty mbarrier a
    stage, GEMM-1's order word for each of the 8 consumer warps)."""
    stage = (TILE_ROWS + bn) * GEMM_BK * 2
    stages = RING_BYTES // stage
    staging = TILE_ROWS * (bn // 2) * 2 if geglu else 0
    return dict(stages=stages, staging=staging,
                smem=1024 + stages * stage + staging + 2 * stages * 8
                + (8 * 4 if geglu else 0))


def geglu_plan(rows: int, c: int, num_sms: int,
               inner: int | None = None) -> dict:
    """Launch geometry of the kernel pair for x (rows, c) and ``inner``
    GEGLU units (4c by default) on a card with ``num_sms`` SMs: GEMM-2's N
    tile (the one that computes the fewest columns, the larger on a tie:
    160 at C = 320, 640 and 1280, where none is wasted), each GEMM's output
    tiles and its persistent grid (one block per SM, at most one per
    tile)."""
    inner = 4 * c if inner is None else inner
    bn2 = min(GEMM2_TILES, key=lambda n: (-(-c // n) * n, -n))
    m_tiles = -(-rows // TILE_ROWS)
    tiles1 = m_tiles * -(-inner // GEMM1_TN)
    tiles2 = m_tiles * -(-c // bn2)
    return dict(bn2=bn2, tiles1=tiles1, tiles2=tiles2,
                grid1=min(tiles1, num_sms), grid2=min(tiles2, num_sms))


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (TMA's rule), copied
    once if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _num_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def geglu_ffn_reference(x2: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """Plain torch GEGLU FF on (R, C) rows in x2's dtype: each product in
    that dtype, then the bias, as ``geglu_ffn_reference`` of the JAX
    package does with its Dense layers."""
    dt = x2.dtype
    h = torch.matmul(x2, w1.to(dt).t()) + b1.to(dt)
    a, g = h.chunk(2, dim=-1)
    prod = a * F.gelu(g)
    return torch.matmul(prod, w2.to(dt).t()) + b2.to(dt)


def check_geglu_args(x2: torch.Tensor, w1, b1, w2,
                     b2) -> tuple[int, int, int]:
    """(rows, C, inner) of what the kernel takes: bf16 x (rows, C) with C
    and inner (w2's columns) multiples of 8 (TMA needs 16-byte row
    strides) and weights of those widths; raises on anything else."""
    r, c = x2.shape
    inner = w2.shape[-1]
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"geglu_ffn kernel takes bfloat16, got {x2.dtype}")
    if c % 8 or inner % 8 or inner < 8:
        raise ValueError(f"geglu_ffn kernel needs C and inner multiples of "
                         f"8, got C={c}, inner={inner}")
    if (tuple(w1.shape) != (2 * inner, c) or tuple(b1.shape) != (2 * inner,)
            or tuple(w2.shape) != (c, inner) or tuple(b2.shape) != (c,)):
        raise ValueError("geglu_ffn: weight shapes do not match C="
                         f"{c}: {w1.shape} {b1.shape} {w2.shape} {b2.shape}")
    return r, c, inner


def _geglu_launch(x2: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """One launch of the kernel pair on CUDA tensors, on x2's card (its
    current device and stream)."""
    r, c, inner = check_geglu_args(x2, w1, b1, w2, b2)
    args = [aligned16(t.to(torch.bfloat16)) for t in (x2, w1, b1, w2, b2)]
    plan = geglu_plan(r, c, _num_sms(x2.device), inner)
    h = torch.empty((r, inner), dtype=torch.bfloat16, device=x2.device)
    y = torch.empty((r, c), dtype=torch.bfloat16, device=x2.device)
    with torch.cuda.device(x2.device):
        err = build.entry("geglu_ffn")(
            *(t.data_ptr() for t in args), h.data_ptr(), y.data_ptr(), r, c,
            inner, plan["bn2"], plan["grid1"], plan["grid2"],
            torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"geglu_ffn kernel launch failed: cudaError {err}")
    counters["launches.geglu_ffn"] += 1
    counters["launches.geglu_ffn.overlap"] += 1
    return y


class _GegluFFN(torch.autograd.Function):
    """The kernel forward; the backward recomputes through
    ``geglu_ffn_reference`` with autograd, as JAX's ``_ffn_bwd`` takes the
    vjp of its reference (there is no GEGLU backward kernel)."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2):
        ctx.save_for_backward(x2, w1, b1, w2, b2)
        return _geglu_launch(x2, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, gy):
        args = [t.detach().requires_grad_(need)
                for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in args if t.requires_grad]
        with torch.enable_grad():
            y = geglu_ffn_reference(*args)
            got = iter(torch.autograd.grad(y, wanted, gy))
        return tuple(next(got) if t.requires_grad else None for t in args)


def geglu_ffn(x2: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """GEGLU FF on (R, C): the CUDA kernel for a CUDA tensor, through the
    autograd Function ``_GegluFFN`` (the backward recomputes through the
    plain version); the plain version for a CPU tensor.
    ``counters["launches.geglu_ffn"]`` counts kernel launches (one per
    call, which runs both GEMMs), ``"launches.geglu_ffn.overlap"`` those
    whose GEMM-1 ran its epilogue under the next tile's wgmmas."""
    if x2.device.type == "cpu":
        return geglu_ffn_reference(x2, w1, b1, w2, b2)
    if x2.device.type != "cuda":
        raise ValueError(f"geglu_ffn: unsupported device {x2.device}")
    return _GegluFFN.apply(x2, w1, b1, w2, b2)

