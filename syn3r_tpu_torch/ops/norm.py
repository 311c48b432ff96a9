"""GroupNorm and LayerNorm over the channel axis of channel-last tensors.

Counterpart of ``syn3r_tpu/ops/pallas_norm.py``. GroupNorm takes (B, S, C)
(the UNet's and VAE's (B, H, W, C) and (B, F, H, W, C) activations viewed
so), LayerNorm (R, C) rows. Both follow the JAX references: float32
channel-major sums, ``var = E[x^2] - mean^2`` (not Welford), the affine in
float32, optional fused SiLU (GroupNorm), the output in the input's dtype.

On a CUDA tensor the wrappers launch the hand-written kernels:
``csrc/group_norm.cu`` (``group_norm_stats``: per-(B, C) sums over S split
across blocks, then a fixed-order fold to the per-(B, C) affine
``a = rstd w``, ``b = bias - mean a``; ``group_norm_apply``: ``y = x a + b``
with the SiLU, one read-write pass) replacing ``_gn_stats_kernel`` and
``_gn_apply_kernel``, and ``csrc/layer_norm.cu`` (a persistent grid of
warps over groups of rows, weight and bias held in registers in their own
dtype; its launch plan is ``layer_norm_plan``) replacing ``_ln_kernel``.
On a CPU tensor they run the plain versions. A CUDA tensor never falls
back: the wrappers launch or raise, and no switch turns the kernels off.
Launches are counted in ``group_norm.launches`` (``{"stats": n, "apply":
n}``) and ``layer_norm.launches``.

``group_norm`` and ``layer_norm`` are ``torch.autograd.Function``s whose
backward recomputes through the plain version, as ``_gn_bwd`` and
``_ln_bwd`` do in JAX; the guided path itself needs no gradient.

The kernels read their input in place and take float32 or bf16 only. The
modules hand them ``contiguous_counted(x)``: a non-contiguous activation is
copied once and counted in ``contiguous_counted.copies``, never silently.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import build
from .geglu_ffn import _num_sms

# a GroupNorm stats grid aims at about eight resident blocks a SM
_TARGET_BLOCKS = 132 * 8
_MAX_SPLITS = 256
# LayerNorm kernel (csrc/layer_norm.cu): threads a block, the compiled
# counts of 16-byte vectors a lane, resident blocks a SM by row dtype
LN_THREADS = 256
LN_VECTORS = (1, 2, 3, 4, 5, 6, 7, 8, 10)
LN_BLOCKS_PER_SM = {torch.bfloat16: 2, torch.float32: 1}


def contiguous_counted(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when contiguous, else a contiguous copy, counted in
    ``contiguous_counted.copies``."""
    if x.is_contiguous():
        return x
    contiguous_counted.copies += 1
    return x.contiguous()


contiguous_counted.copies = 0


# -- plain versions ----------------------------------------------------------

def _group_stats(xf: torch.Tensor, num_groups: int, eps: float):
    """Per-(B, C) float32 mean and rstd of their groups: per-(B, C) sums of
    x and x^2 over S, folded per group, var = E[x^2] - mean^2."""
    b, s, c = xf.shape
    cg = c // num_groups
    n = s * cg
    mean = xf.sum(dim=1).reshape(b, num_groups, cg).sum(-1) / n
    var = (xf * xf).sum(dim=1).reshape(b, num_groups, cg).sum(-1) / n \
        - mean * mean
    rstd = torch.rsqrt(var + eps)
    return (mean.repeat_interleave(cg, dim=-1),
            rstd.repeat_interleave(cg, dim=-1))


def group_norm_reference(x3: torch.Tensor, weight, bias, num_groups: int,
                         eps: float, silu: bool = False) -> torch.Tensor:
    """Plain GroupNorm over (B, S, C) (``pallas_norm.group_norm_reference``):
    (x - mean) rstd w + b in float32."""
    xf = x3.float()
    mean, rstd = _group_stats(xf, num_groups, eps)
    y = (xf - mean[:, None]) * rstd[:, None]
    y = y * weight.float() + bias.float()
    if silu:
        y = F.silu(y)
    return y.to(x3.dtype)


def group_norm_affine_reference(x3: torch.Tensor, weight, bias,
                                num_groups: int, eps: float):
    """Plain version of the stats kernels: the per-(B, C) float32 affine
    (a, b) with a = rstd w and b = bias - mean a (pallas_norm.py:147-156)."""
    mean, rstd = _group_stats(x3.float(), num_groups, eps)
    a = rstd * weight.float()
    return a, bias.float() - mean * a


def group_norm_apply_reference(x3: torch.Tensor, a: torch.Tensor,
                               b: torch.Tensor, silu: bool = False
                               ) -> torch.Tensor:
    """Plain version of the apply kernel: y = x a + b per (batch,
    channel), optional SiLU, in x's dtype."""
    y = x3.float() * a[:, None] + b[:, None]
    if silu:
        y = F.silu(y)
    return y.to(x3.dtype)


def layer_norm_reference(x2: torch.Tensor, weight, bias,
                         eps: float) -> torch.Tensor:
    """Plain LayerNorm over the last axis (``pallas_norm.
    layer_norm_reference``): float32 stats, var = E[x^2] - mean^2."""
    xf = x2.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x2.dtype)


# -- kernel wrappers ---------------------------------------------------------

def _check_input(name: str, x: torch.Tensor, ndim: int):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} kernel takes a {ndim}-d tensor, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous input")
    vec = 8 if x.dtype == torch.bfloat16 else 4
    if x.shape[-1] % vec:
        raise ValueError(f"{name} kernel needs C % {vec} == 0 in {x.dtype}, "
                         f"got C={x.shape[-1]}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs a 16-byte aligned input")
    return vec


def _affine_param(t, c: int, device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    t = t.detach().to(device=device, dtype=dtype).contiguous()
    if tuple(t.shape) != (c,):
        raise ValueError(f"norm kernel: affine shape {tuple(t.shape)}, "
                         f"expected ({c},)")
    return t


def gn_launch_geometry(b: int, s: int, c: int, vec: int):
    """(threads, nsplit) of the stats kernel: threads tile (rows_par, C/vec)
    with rows_par = threads / (C/vec); S is split so that the grid holds
    about _TARGET_BLOCKS blocks and every split at least 4 rows a thread."""
    ncv = c // vec
    if ncv > 512:
        raise ValueError(f"group_norm kernel takes C <= {512 * vec} in this "
                         f"dtype, got C={c}")
    threads = -(-ncv * max(1, 256 // ncv) // 32) * 32
    rows_par = threads // ncv
    nsplit = max(1, min(-(-_TARGET_BLOCKS // b), -(-s // (rows_par * 4)),
                        _MAX_SPLITS))
    return threads, nsplit


def group_norm_stats(x3: torch.Tensor, weight, bias, num_groups: int,
                     eps: float):
    """The per-(B, C) float32 affine (a, b) of GroupNorm: the stats
    kernels for a CUDA tensor, the plain version for a CPU tensor."""
    if x3.device.type == "cpu":
        return group_norm_affine_reference(x3, weight, bias, num_groups, eps)
    vec = _check_input("group_norm", x3, 3)
    b, s, c = x3.shape
    if c % num_groups or c // num_groups > 256:
        raise ValueError(f"group_norm kernel needs C % G == 0 and C/G <= 256, "
                         f"got C={c} G={num_groups}")
    if b > 65535:
        raise ValueError(f"group_norm kernel takes B <= 65535, got {b}")
    w = _affine_param(weight, c, x3.device)
    bi = _affine_param(bias, c, x3.device)
    threads, nsplit = gn_launch_geometry(b, s, c, vec)
    part = torch.empty((b, nsplit, 2, c), dtype=torch.float32,
                       device=x3.device)
    a = torch.empty((b, c), dtype=torch.float32, device=x3.device)
    bb = torch.empty((b, c), dtype=torch.float32, device=x3.device)
    err = build.entry("group_norm", "syn3r_gn_stats")(
        x3.data_ptr(), w.data_ptr(), bi.data_ptr(), part.data_ptr(),
        a.data_ptr(), bb.data_ptr(), b, s, c, num_groups, float(eps),
        nsplit, threads, int(x3.dtype == torch.bfloat16),
        torch.cuda.current_stream(x3.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm stats kernel launch failed: "
                           f"cudaError {err}")
    group_norm.launches["stats"] += 1
    return a, bb


def group_norm_apply(x3: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     silu: bool = False) -> torch.Tensor:
    """y = x a + b (+ SiLU) in x's dtype: the apply kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x3.device.type == "cpu":
        return group_norm_apply_reference(x3, a, b, silu)
    _check_input("group_norm", x3, 3)
    bsz, s, c = x3.shape
    for name, t in (("a", a), ("b", b)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (bsz, c)
                or not t.is_contiguous() or t.device != x3.device):
            raise ValueError(f"group_norm apply: {name} must be float32 "
                             f"({bsz}, {c}) on {x3.device}")
    y = torch.empty_like(x3)
    err = build.entry("group_norm", "syn3r_gn_apply")(
        x3.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, s, c,
        int(silu), int(x3.dtype == torch.bfloat16),
        torch.cuda.current_stream(x3.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm apply kernel launch failed: "
                           f"cudaError {err}")
    group_norm.launches["apply"] += 1
    return y


def layer_norm_plan(r: int, c: int, dtype: torch.dtype, num_sms: int) -> dict:
    """Launch plan of the LayerNorm kernel for (r, c) rows of ``dtype`` on
    a card with ``num_sms`` SMs: 16-byte vectors of ``vec`` elements,
    ``lanes`` lanes a row (the largest power of two up to 32 that divides
    the row's vectors, so that no lane idles), ``vectors`` a lane,
    ``rows_per_warp``, ``idle`` vector slots a row (0 but where the row
    falls back to 32 lanes) and the persistent ``grid`` (at most
    LN_BLOCKS_PER_SM blocks a SM, at most one warp a group of rows).
    Raises on what the kernel does not take."""
    if dtype not in LN_BLOCKS_PER_SM:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    vec = 8 if dtype == torch.bfloat16 else 4
    if c < 1 or c % vec:
        raise ValueError(f"layer_norm kernel needs C % {vec} == 0 in {dtype}, "
                         f"got C={c}")
    n = c // vec
    lanes = 32
    while n % lanes:
        lanes //= 2
    vectors = n // lanes
    if vectors not in LN_VECTORS:
        lanes = 32
        vectors = next((k for k in LN_VECTORS if 32 * k >= n), None)
        if vectors is None:
            raise ValueError(f"layer_norm kernel takes C <= "
                             f"{32 * LN_VECTORS[-1] * vec} in {dtype}, got "
                             f"C={c}")
    rows_per_warp = 32 // lanes
    groups = -(-r // rows_per_warp)
    grid = max(1, min(-(-groups // (LN_THREADS // 32)),
                      num_sms * LN_BLOCKS_PER_SM[dtype]))
    return dict(vec=vec, lanes=lanes, vectors=vectors,
                rows_per_warp=rows_per_warp, idle=lanes * vectors - n,
                grid=grid)


def _layer_norm_forward(x2: torch.Tensor, weight, bias,
                        eps: float) -> torch.Tensor:
    if x2.device.type == "cpu":
        return layer_norm_reference(x2, weight, bias, eps)
    _check_input("layer_norm", x2, 2)
    r, c = x2.shape
    # parameters in their own dtype where it is x's (widened in registers,
    # no cast launch), else float32
    wdt = (x2.dtype if weight.dtype == bias.dtype == x2.dtype
           else torch.float32)
    w = _affine_param(weight, c, x2.device, wdt)
    bi = _affine_param(bias, c, x2.device, wdt)
    plan = layer_norm_plan(r, c, x2.dtype, _num_sms(x2.device))
    y = torch.empty_like(x2)
    err = build.entry("layer_norm")(
        x2.data_ptr(), w.data_ptr(), bi.data_ptr(), y.data_ptr(), r, c,
        float(eps), int(x2.dtype == torch.bfloat16),
        int(wdt == torch.bfloat16), plan["lanes"], plan["vectors"],
        plan["grid"], torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: cudaError "
                           f"{err}")
    layer_norm.launches += 1
    return y


def _grads_through(fn, ctx, gy, *args):
    """Gradients of fn(x, weight, bias, *args) recomputed by autograd."""
    x, w, b = (t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad))
    with torch.enable_grad():
        y = fn(x, w, b, *args)
        wanted = [t for t in (x, w, b) if t.requires_grad]
        got = iter(torch.autograd.grad(y, wanted, gy))
    return tuple(next(got) if t.requires_grad else None for t in (x, w, b))


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, weight, bias, num_groups, eps, silu):
        ctx.save_for_backward(x3, weight, bias)
        ctx.args = (num_groups, eps, silu)
        if x3.device.type == "cpu":
            return group_norm_reference(x3, weight, bias, num_groups, eps,
                                        silu)
        a, b = group_norm_stats(x3, weight, bias, num_groups, eps)
        return group_norm_apply(x3, a, b, silu)

    @staticmethod
    def backward(ctx, gy):
        return _grads_through(group_norm_reference, ctx, gy,
                              *ctx.args) + (None, None, None)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, bias, eps):
        ctx.save_for_backward(x2, weight, bias)
        ctx.eps = eps
        return _layer_norm_forward(x2, weight, bias, eps)

    @staticmethod
    def backward(ctx, gy):
        return _grads_through(layer_norm_reference, ctx, gy,
                              ctx.eps) + (None,)


def group_norm(x3: torch.Tensor, weight, bias, num_groups: int, eps: float,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm over (B, S, C), optional fused SiLU: the kernels for a
    CUDA tensor, ``group_norm_reference`` for a CPU tensor."""
    return _GroupNorm.apply(x3, weight, bias, num_groups, eps, silu)


def layer_norm(x2: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    """LayerNorm over (R, C) rows: the kernel for a CUDA tensor,
    ``layer_norm_reference`` for a CPU tensor."""
    return _LayerNorm.apply(x2, weight, bias, eps)


group_norm.launches = {"stats": 0, "apply": 0}
layer_norm.launches = 0
