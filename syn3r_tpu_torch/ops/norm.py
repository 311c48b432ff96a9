"""GroupNorm and LayerNorm over the channel axis of channel-last tensors.

Counterpart of ``syn3r_tpu/ops/pallas_norm.py``. GroupNorm takes (B, S, C)
(the UNet's and VAE's (B, H, W, C) and (B, F, H, W, C) activations viewed
so), LayerNorm (R, C) rows. Both follow the JAX references: float32
channel-major sums, ``var = E[x^2] - mean^2`` (not Welford), the affine in
float32, optional fused SiLU (GroupNorm), the output in the input's dtype.

On a CUDA tensor the wrappers launch the hand-written kernels:
``csrc/group_norm.cu`` (``group_norm_stats``: one launch of per-(B, C)
sums over equal items of rows on a grid sized to residency, folded by the
last block of each batch element, in a fixed order, to the per-(B, C)
affine ``a = rstd w``, ``b = bias - mean a``; ``group_norm_apply``:
``y = x a + b`` with the SiLU, one read-write pass over the same items;
their launch plan is ``group_norm_plan``) replacing ``_gn_stats_kernel``
and ``_gn_apply_kernel``, and ``csrc/layer_norm.cu`` (a persistent grid of
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

import math

import torch
import torch.nn.functional as F

from ..kernels import build
from .geglu_ffn import _num_sms

# GroupNorm kernels (csrc/group_norm.cu): threads a block are a multiple
# of lcm(C / vec, 32) between GN_MIN_THREADS and GN_MAX_THREADS; groups the
# fold takes; items a block at least
GN_MIN_THREADS = 128
GN_MAX_THREADS = 512
GN_MAX_GROUPS = 128
GN_ITEMS_PER_BLOCK = 4
GN_KERNELS = ("stats", "apply")
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

def _vec(dtype: torch.dtype, name: str) -> int:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    return 8 if dtype == torch.bfloat16 else 4


def _check_input(name: str, x: torch.Tensor, ndim: int):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    vec = _vec(x.dtype, name)
    if x.dim() != ndim:
        raise ValueError(f"{name} kernel takes a {ndim}-d tensor, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous input")
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


def _launch(name: str, fn_name: str | None, device, *args) -> int:
    """Calls kernel entry ``fn_name`` of library ``name`` on ``device``'s
    current stream, each tensor of ``args`` as its device pointer; returns
    the cudaError."""
    return build.entry(name, fn_name)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        torch.cuda.current_stream(device).cuda_stream)


def group_norm_threads(c: int, dtype: torch.dtype, kernel: str) -> int:
    """Threads a block of GroupNorm kernel ``kernel`` ("stats" or "apply"):
    a multiple of lcm(C/vec, 32), so that no lane idles and each thread
    keeps one window of vec channels. The stats take the largest up to
    GN_MAX_THREADS (fewer blocks, fewer partials for the fold), the apply
    the smallest from GN_MIN_THREADS (more resident blocks)."""
    if kernel not in GN_KERNELS:
        raise ValueError(f"group_norm kernel is one of {GN_KERNELS}, got "
                         f"{kernel!r}")
    vec = _vec(dtype, "group_norm")
    if c < 1 or c % vec:
        raise ValueError(f"group_norm kernel needs C % {vec} == 0 in "
                         f"{dtype}, got C={c}")
    unit = math.lcm(c // vec, 32)
    if unit > GN_MAX_THREADS:
        raise ValueError(f"group_norm kernel takes C with lcm(C/{vec}, 32) "
                         f"<= {GN_MAX_THREADS} in {dtype}, got C={c}")
    if kernel == "stats":
        return unit * (GN_MAX_THREADS // unit)
    return unit * -(-GN_MIN_THREADS // unit)


def group_norm_plan(b: int, s: int, c: int, dtype: torch.dtype,
                    num_sms: int, blocks_per_sm: int, kernel: str = "stats",
                    groups: int = 32) -> dict:
    """Launch plan of GroupNorm kernel ``kernel`` for x (b, s, c) of
    ``dtype`` on a card with ``num_sms`` SMs that keeps ``blocks_per_sm``
    of its blocks resident: ``threads`` (``group_norm_threads``), ``rows``
    rows a pass (threads / (C/vec)), an item = one pass over ``rows`` rows
    of one batch element (``items_per_b`` a batch element, ``items`` in
    all), a 1-D ``grid`` of at most the resident blocks with at least
    GN_ITEMS_PER_BLOCK items a block, the stats kernel's float32 scratch
    of ``slots`` (2, C) partials, its ``counters`` (one int32 a batch
    element) and its dynamic shared memory ``smem`` in bytes. Raises on
    what the kernels do not take."""
    threads = group_norm_threads(c, dtype, kernel)
    if groups < 1 or c % groups:
        raise ValueError(f"group_norm kernel needs C % G == 0, got C={c} "
                         f"G={groups}")
    if groups > GN_MAX_GROUPS:
        raise ValueError(f"group_norm kernel folds G <= {GN_MAX_GROUPS} "
                         f"groups, got G={groups}")
    if b < 1 or s < 1:
        raise ValueError(f"group_norm kernel needs B, S >= 1, got {b}, {s}")
    vec = _vec(dtype, "group_norm")
    rows = threads // (c // vec)
    items_per_b = -(-s // rows)
    items = b * items_per_b
    grid = max(1, min(num_sms * blocks_per_sm, items // GN_ITEMS_PER_BLOCK))
    return dict(vec=vec, threads=threads, rows=rows, items_per_b=items_per_b,
                items=items, grid=grid, slots=grid + b - 1, counters=b,
                smem=threads * vec * 8 if kernel == "stats" else 0)


def _item_block(i: int, plan: dict) -> int:
    return ((i + 1) * plan["grid"] - 1) // plan["items"]


def group_norm_segments(plan: dict, s: int, k: int) -> list:
    """Plain mirror of the kernels' walk: the (batch element, first row,
    end row, partial slot) segments that block ``k`` of ``plan`` takes, in
    order, for S = ``s``."""
    i = k * plan["items"] // plan["grid"]
    i1 = (k + 1) * plan["items"] // plan["grid"]
    ipb, rows, out = plan["items_per_b"], plan["rows"], []
    while i < i1:
        b = i // ipb
        e = min(i1, (b + 1) * ipb)
        out.append((b, (i - b * ipb) * rows, min(s, (e - b * ipb) * rows),
                    k + b))
        i = e
    return out


def group_norm_parts(plan: dict, b: int) -> range:
    """Plain mirror of the fold: the partial slots of batch element ``b``,
    in the order the last block to arrive sums them."""
    first = _item_block(b * plan["items_per_b"], plan)
    last = _item_block((b + 1) * plan["items_per_b"] - 1, plan)
    return range(first + b, last + b + 1)


_gn_blocks: dict = {}
_gn_plans: dict = {}
_gn_scratch: dict = {}


def _gn_resident(which: int, dtype, variant: bool, threads: int,
                 device) -> tuple[int, int]:
    """(SMs, resident blocks a SM) of GroupNorm kernel ``which`` (0 stats,
    1 apply) on ``device``: cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    asked once a (device, kernel, dtype, variant, threads)."""
    key = (device, which, dtype, variant, threads)
    if key not in _gn_blocks:
        with torch.cuda.device(device):
            n = build.entry("group_norm", "syn3r_gn_blocks_per_sm")(
                which, int(dtype == torch.bfloat16), int(variant), threads)
        if n < 1:
            raise RuntimeError(f"group_norm kernel {which}: occupancy query "
                               f"gave {n}")
        _gn_blocks[key] = (_num_sms(device), n)
    return _gn_blocks[key]


def _gn_launch_plan(which: int, x3: torch.Tensor, variant: bool,
                    groups: int) -> dict:
    """``group_norm_plan`` of kernel ``which`` for ``x3`` on its card,
    made once a (device, kernel, shape, dtype, variant, groups)."""
    key = (x3.device, which, tuple(x3.shape), x3.dtype, variant, groups)
    plan = _gn_plans.get(key)
    if plan is None:
        b, s, c = x3.shape
        kernel = GN_KERNELS[which]
        threads = group_norm_threads(c, x3.dtype, kernel)
        plan = group_norm_plan(b, s, c, x3.dtype, *_gn_resident(
            which, x3.dtype, variant, threads, x3.device), kernel=kernel,
            groups=groups)
        _gn_plans[key] = plan
    return plan


def _gn_buffers(device, n_part: int, b: int):
    """The stats kernel's scratch on ``device``: float32 partials (at least
    ``n_part`` values) and int32 arrival counters (at least ``b``), kept
    between calls. The kernel leaves the counters at zero and reads only
    the partials its own launch wrote: one stream, as the whole port."""
    part, counters = _gn_scratch.get(device, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(max(n_part, 1 << 20), dtype=torch.float32,
                           device=device)
    if counters is None or counters.numel() < b:
        counters = torch.zeros(max(b, 128), dtype=torch.int32, device=device)
    _gn_scratch[device] = (part, counters)
    return part, counters


def _gn_params(weight, bias, c: int, device):
    """Weight and bias as the stats kernel takes them: in their own dtype
    where both are bf16 or both float32 (widened in the fold, no cast
    launch), else float32."""
    wdt = (weight.dtype if weight.dtype == bias.dtype
           and weight.dtype in (torch.float32, torch.bfloat16)
           else torch.float32)
    return _affine_param(weight, c, device, wdt), \
        _affine_param(bias, c, device, wdt)


def group_norm_stats(x3: torch.Tensor, weight, bias, num_groups: int,
                     eps: float):
    """The per-(B, C) float32 affine (a, b) of GroupNorm: the stats
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x3.device.type == "cpu":
        return group_norm_affine_reference(x3, weight, bias, num_groups, eps)
    _check_input("group_norm", x3, 3)
    b, s, c = x3.shape
    w, bi = _gn_params(weight, bias, c, x3.device)
    w_bf16 = w.dtype == torch.bfloat16
    plan = _gn_launch_plan(0, x3, w_bf16, num_groups)
    part, counters = _gn_buffers(x3.device, plan["slots"] * 2 * c, b)
    ab = torch.empty((2, b, c), dtype=torch.float32, device=x3.device)
    err = _launch("group_norm", "syn3r_gn_stats", x3.device, x3, w, bi,
                  part, counters, ab[0], ab[1], b, s, c, num_groups,
                  float(eps), int(x3.dtype == torch.bfloat16), int(w_bf16),
                  plan["threads"], plan["grid"])
    if err != 0:
        raise RuntimeError(f"group_norm stats kernel launch failed: "
                           f"cudaError {err}")
    group_norm.launches["stats"] += 1
    return ab[0], ab[1]


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
    plan = _gn_launch_plan(1, x3, silu, 1)
    y = torch.empty_like(x3)
    err = _launch("group_norm", "syn3r_gn_apply", x3.device, x3, a, b, y,
                  bsz, s, c, int(silu), int(x3.dtype == torch.bfloat16),
                  plan["threads"], plan["grid"])
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
    err = _launch("layer_norm", None, x2.device, x2, w, bi, y, r, c,
                  float(eps), int(x2.dtype == torch.bfloat16),
                  int(wdt == torch.bfloat16), plan["lanes"],
                  plan["vectors"], plan["grid"])
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
