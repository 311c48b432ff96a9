"""Exact multi-head attention and its dispatch.

Counterpart of the attention functions of ``syn3r_tpu/models/layers.py``
(``_attention_dense``, ``_attention_chunked``, ``_attention_packed_heads``
and ``_attention``). Tensors are (B, H, S, D) and may be strided views
(the projections are (B, S, H, D) in memory). Logits and softmax are in
float32, the probabilities are cast to V's dtype before the second
product, as in the JAX package.

Where the JAX package takes the Pallas TPU flash attention, the port takes
``flash_attention``: on a CUDA tensor the hand-written forward kernel of
``csrc/flash_attention.cu`` and, where a gradient is taken (the guidance
pass through the UNet), the dq and dkv kernels of
``csrc/flash_attention_bwd.cu``, both through one autograd Function; on a
CPU tensor the exact chunked version, whose gradient is autograd's (as
JAX differentiates ``_attention_chunked`` off the TPU). A CUDA tensor
never takes a plain fallback: the wrappers launch or raise. The packed,
dense and chunked paths stay plain torch, as they stay XLA in JAX.
``attention_lse_reference`` and ``flash_attention_bwd_reference`` are the
plain versions of the forward's lse and of the backward.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from ..utils.profiling import counters

# Query rows of the kernel's work item, keys of its K/V stage, head dim.
FLASH_BQ, FLASH_BKV, FLASH_D = 128, 192, 64
# The backward kernels: rows of a work item (its resident tiles, 64 a
# consumer warpgroup), rows of a streamed stage, stages in the ring.
FLASH_BWD_ROWS, FLASH_BWD_STAGE_ROWS, FLASH_BWD_STAGES = 128, 64, 6
# bf16 inputs of each backward kernel, in its argument order
FLASH_BWD_INPUTS = {"dkv": ("q", "k", "v", "dout"),
                    "dq": ("q", "k", "v", "dout", "out")}
# dynamic shared memory a block may use on an H100 (227 KB)
SMEM_BYTES = 232448


def attention_dense(q, k, v, scale: float) -> torch.Tensor:
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(logits, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def _query_chunks(b: int, h: int, sk: int) -> int:
    """Query rows a chunk of the plain versions: the f32 (b, h, chunk, sk)
    logits stay near 256 MB, as in ``attention_chunked``."""
    q_chunk = (256 * 1024 * 1024) // max(1, b * h * sk * 4)
    return max(64, min(512, (q_chunk // 64) * 64))


def attention_chunked(q, k, v, scale: float):
    """Exact attention over query chunks with the full key set; the chunk
    bounds the float32 logit buffer (b, h, q_chunk, sk) to about 256 MB,
    as ``_attention_chunked`` does."""
    b, h, sq, _ = q.shape
    q_chunk = _query_chunks(b, h, k.shape[2])
    outs = [attention_dense(q[:, :, i:i + q_chunk], k, v, scale)
            for i in range(0, sq, q_chunk)]
    return torch.cat(outs, dim=2)


def attention_packed_heads(q, k, v, scale: float) -> torch.Tensor:
    """Short-sequence attention with all heads packed into one sequence and
    a block-diagonal -inf mask keeping heads apart (exp(-inf) = 0 exactly,
    so it equals per-head attention)."""
    b, h, s, d = q.shape
    hs = h * s
    qq, kk, vv = (t.reshape(b, hs, d) for t in (q, k, v))
    blk = torch.arange(hs, device=q.device) // s
    bias = torch.zeros((hs, hs), dtype=torch.float32, device=q.device)
    bias.masked_fill_(blk[:, None] != blk[None, :], float("-inf"))
    logits = torch.matmul(qq.float(), kk.float().transpose(-1, -2)) * scale
    attn = torch.softmax(logits + bias, dim=-1)
    out = torch.matmul(attn.to(vv.dtype), vv)
    return out.reshape(b, h, s, d)


def flash_tensor_map(shape, strides, data_ptr: int, rows: int,
                     elem_bytes: int = 2):
    """The 4-D TMA tensor map of the flash kernel over a (B, H, S, 64) view
    with element ``strides``, loading ``rows`` rows of S at a time:
    {"dims": (64, X, Y, B), "strides": byte strides of X, Y, B, "box":
    (64, ...), "s_dim": the axis of S}, where X and Y are S and H in the
    order of their strides. None when the view cannot be mapped as it is:
    the head axis not contiguous, a stride not a multiple of 16 bytes or a
    start not 16-byte aligned."""
    b, h, s, d = shape
    sb, sh, ss, sd = strides
    if (sd != 1 or data_ptr % 16
            or any(st * elem_bytes % 16 for st in (sb, sh, ss))):
        return None
    if ss <= sh:
        dims, st, s_dim = (d, s, h, b), (ss, sh, sb), 1
    else:
        dims, st, s_dim = (d, h, s, b), (sh, ss, sb), 2
    box = (d,) + tuple(rows if i == s_dim else 1 for i in (1, 2)) + (1,)
    return {"dims": dims, "strides": tuple(x * elem_bytes for x in st),
            "box": box, "s_dim": s_dim}


def flash_grid(b: int, h: int, s: int, num_sms: int) -> int:
    """Persistent grid: one block per SM, at most one per work item (a
    128-row query tile of one batch and head)."""
    return min(b * h * -(-s // FLASH_BQ), num_sms)


def check_flash_args(q, k, v) -> None:
    """Raises unless q, k, v are bf16 (B, H, S, 64) of one shape."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("flash_attention kernel takes bfloat16 q, k, v")
    if (q.dim() != 4 or q.shape[3] != FLASH_D or k.shape != q.shape
            or v.shape != q.shape):
        raise ValueError("flash_attention kernel needs q, k, v of one shape "
                         f"with d = 64, got {q.shape} {k.shape} {v.shape}")


def check_cuda(q) -> None:
    """Raises unless q lies on a CUDA device: the kernel route takes no
    CPU tensor."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention kernels take CUDA tensors, got "
                         f"{q.device}")


def mapped(t: torch.Tensor, rows: int):
    """(t, its tensor map): t itself where its strides and start suit TMA,
    else one contiguous copy in a fresh (aligned) allocation."""
    m = flash_tensor_map(t.shape, t.stride(), t.data_ptr(), rows)
    if m is None:
        t = t.clone(memory_format=torch.contiguous_format)
        m = flash_tensor_map(t.shape, t.stride(), t.data_ptr(), rows)
    return t, m


def _flash_forward(q, k, v, scale: float, with_lse: bool):
    """One launch of the forward kernel on CUDA tensors, on q's card (its
    current device and stream): (out, lse), out
    (B, H, S, D) a view of a (B, S, H, D) tensor, lse the f32 (B, H, S)
    log-sum-exp of each row where ``with_lse``, else None."""
    check_cuda(q)
    check_flash_args(q, k, v)
    b, h, s, d = q.shape
    (q, mq), (k, mk), (v, mv) = (mapped(q, FLASH_BQ), mapped(k, FLASH_BKV),
                                 mapped(v, FLASH_BKV))
    geom = (ctypes.c_longlong * 36)(*(
        x for m in (mq, mk, mv)
        for x in (*m["dims"], *m["strides"], *m["box"], m["s_dim"])))
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    ob, oh, os_, _ = out.stride()
    grid = flash_grid(b, h, s, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    with torch.cuda.device(q.device):
        err = build.entry("flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), geom, b, h, s, ob, oh,
            os_, float(scale), grid,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err}")
    counters["launches.flash"] += 1
    return out, lse


def like_projection(t: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, S, D) view of a (B, S, H, D) tensor, the layout of
    the UNet's projections (so their gradients need no copy)."""
    b, h, s, d = t.shape
    return torch.empty((b, s, h, d), dtype=t.dtype,
                       device=t.device).permute(0, 2, 1, 3)


def flash_bwd_plan(b: int, h: int, s: int, num_sms: int,
                   d: int = FLASH_D) -> dict:
    """Launch plan of the backward kernels of ``csrc/flash_attention_bwd.cu``
    for (B, H, S, d) on a card of ``num_sms`` SMs: per kernel ("dkv", "dq")
    the rows of a work item and of a streamed stage, the stages, the
    dynamic shared bytes, the TMA box rows of each tensor (resident tiles
    128, streamed 64; dkv's lse and D rows 64) and the persistent grid; and
    ``ld``, the row length of lse and D (S rounded up to 4, so that each
    row starts 16-byte aligned for TMA). Raises ValueError on what the
    kernels do not take."""
    if d != FLASH_D:
        raise ValueError(f"flash backward kernels take d = 64, got {d}")
    if min(b, h, s) <= 0 or num_sms <= 0:
        raise ValueError(f"flash backward kernels need B, H, S and SMs > 0, "
                         f"got {(b, h, s, num_sms)}")
    rows, stage_rows, stages = (FLASH_BWD_ROWS, FLASH_BWD_STAGE_ROWS,
                                FLASH_BWD_STAGES)
    items = b * h * -(-s // rows)
    if b * h * -(-s // stage_rows) >= 2 ** 31:
        raise ValueError(f"flash backward kernels: {b * h} heads of {s} "
                         "rows pass the kernels' 32-bit tile indices")
    tile_r, tile_s = rows * d * 2, stage_rows * d * 2
    bars = (2 + 2 * stages) * 8
    plan = {"ld": -(-s // 4) * 4, "items": items}
    for name, resident, streamed, stage_bytes in (
            ("dkv", ("k", "v"), ("q", "dout"), 2 * tile_s + 1024),
            ("dq", ("q", "dout", "out"), ("k", "v"), 2 * tile_s)):
        smem = 1024 + len(resident) * tile_r + stages * stage_bytes + bars
        if smem > SMEM_BYTES:
            raise ValueError(f"flash backward {name} kernel: {smem} bytes of "
                             f"shared memory, over the {SMEM_BYTES} a block "
                             "may use")
        boxes = {t: rows for t in resident}
        boxes.update({t: stage_rows for t in streamed})
        plan[name] = {"rows": rows, "stage_rows": stage_rows,
                      "stages": stages, "smem": smem, "boxes": boxes,
                      "grid": min(items, num_sms)}
    plan["dkv"]["boxes"].update(lse=stage_rows, delta=stage_rows)
    return plan


def flash_bwd_operands(q, k, v, out, dout, lse, ld: int):
    """The backward kernels' inputs: ({"q", "k", "v", "out", "dout"}: each
    view as it is where TMA can read it, else one aligned copy (``mapped``),
    lse as f32 (B, H, ld) rows (a zero-padded copy where ld != S), and an
    empty f32 (B, H, ld) for D, which the dq kernel writes)."""
    views = {n: mapped(t, FLASH_BWD_ROWS)[0]
             for n, t in (("q", q), ("k", k), ("v", v), ("out", out),
                          ("dout", dout))}
    lse = lse.contiguous()
    if lse.shape[-1] != ld:
        lse = torch.nn.functional.pad(lse, (0, ld - lse.shape[-1]))
    return views, lse, torch.empty_like(lse)


def flash_bwd_maps(name: str, views: dict, plan: dict) -> list:
    """The tensor maps of kernel ``name``'s bf16 inputs in its argument
    order (``FLASH_BWD_INPUTS``), each with the plan's box rows."""
    boxes = plan[name]["boxes"]
    maps = [flash_tensor_map(views[n].shape, views[n].stride(),
                             views[n].data_ptr(), boxes[n])
            for n in FLASH_BWD_INPUTS[name]]
    if any(m is None for m in maps):
        raise ValueError(f"flash backward {name}: an input TMA cannot read "
                         "(pass it through flash_bwd_operands)")
    return maps


def flash_bwd_launch(name: str, plan: dict, views: dict, lse, delta, outs,
                     scale: float) -> None:
    """One launch of the backward kernel ``name`` on the inputs of
    ``flash_bwd_operands``: "dq" reads q, k, v, dout, out and lse and writes
    outs = (dq,) and D into ``delta``; "dkv" reads q, k, v, dout, lse and
    that D and writes outs = (dk, dv). The outputs are (B, H, S, 64) views
    with a contiguous last axis (``like_projection``)."""
    b, h, s, _ = views["q"].shape
    maps = flash_bwd_maps(name, views, plan)
    geom = (ctypes.c_longlong * (12 * len(maps)))(*(
        x for m in maps
        for x in (*m["dims"], *m["strides"], *m["box"], m["s_dim"])))
    ostr = (ctypes.c_longlong * (3 * len(outs)))(
        *(st for t in outs for st in t.stride()[:3]))
    dev = views["q"].device
    with torch.cuda.device(dev):
        err = build.entry("flash_attention_bwd", f"syn3r_flash_bwd_{name}")(
            *(views[n].data_ptr() for n in FLASH_BWD_INPUTS[name]),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            geom, ostr, b, h, s, plan["ld"], float(scale),
            plan[name]["grid"], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd {name} kernel launch "
                           f"failed: cudaError {err}")
    counters[f"launches.flash_bwd.{name}"] += 1


def flash_attention_bwd(q, k, v, out, lse, dout, scale: float):
    """(dq, dk, dv) of exact attention on CUDA tensors: the dq kernel of
    ``csrc/flash_attention_bwd.cu`` (which also forms D = rowsum(dout *
    out)), then its dkv kernel. q, k, v, out and dout are bf16 (B, H, S, 64)
    views, lse the forward's f32 (B, H, S); the gradients are views of
    (B, S, H, 64) tensors. ``counters`` counts each kernel's launches
    (``launches.flash_bwd.dq``, ``launches.flash_bwd.dkv``)."""
    check_flash_args(q, k, v)
    if (dout.shape != q.shape or dout.dtype != q.dtype
            or out.shape != q.shape or out.dtype != q.dtype
            or lse.shape != q.shape[:3] or lse.dtype != torch.float32):
        raise ValueError("flash_attention_bwd: out and dout must be like q "
                         f"{tuple(q.shape)} {q.dtype}, lse f32 (B, H, S); "
                         f"got {tuple(out.shape)} {out.dtype} "
                         f"{tuple(dout.shape)} {dout.dtype} "
                         f"{tuple(lse.shape)} {lse.dtype}")
    check_cuda(q)
    b, h, s, d = q.shape
    plan = flash_bwd_plan(b, h, s, torch.cuda.get_device_properties(
        q.device).multi_processor_count, d)
    views, lse, delta = flash_bwd_operands(q, k, v, out, dout, lse,
                                           plan["ld"])
    dq, dk, dv = like_projection(q), like_projection(k), like_projection(v)
    flash_bwd_launch("dq", plan, views, lse, delta, (dq,), scale)
    flash_bwd_launch("dkv", plan, views, lse, delta, (dk, dv), scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with lse; the backward kernels for the
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _flash_forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, lse, dout,
                                   ctx.scale) + (None,)


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """Exact attention: the CUDA kernels for CUDA tensors (bf16, d = 64),
    through the autograd Function ``_FlashAttention`` where a gradient will
    be taken (the forward then also writes lse), the forward kernel alone
    otherwise; ``attention_chunked`` (autograd's gradient) for CPU tensors.
    ``counters["launches.flash"]`` counts forward kernel launches. Returns
    (B, H, S, D), a view of a (B, S, H, D) tensor on CUDA."""
    if q.device.type == "cpu":
        return attention_chunked(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    return _flash_forward(q, k, v, scale, with_lse=False)[0]


def attention_lse_reference(q, k, scale: float) -> torch.Tensor:
    """Plain log-sum-exp of each row of scale q k^T in float32, (B, H, S),
    over query chunks: what the forward kernel writes as lse."""
    b, h, sq, _ = q.shape
    c = _query_chunks(b, h, k.shape[2])
    kf = k.float()
    return torch.cat([
        torch.logsumexp(torch.matmul(q[:, :, i:i + c].float(),
                                     kf.transpose(-1, -2)) * scale, dim=-1)
        for i in range(0, sq, c)], dim=2)


def flash_attention_bwd_reference(q, k, v, out, lse, dout, scale: float):
    """Plain (dq, dk, dv) of exact attention in float32 from the forward's
    out and lse, over query chunks: P = exp(scale q k^T - lse),
    dv = P^T dout, dP = dout v^T, dS = P (dP - D) with D = rowsum(dout
    out), dq = scale dS k, dk = scale dS^T q. Used by the tests and
    chip_smoke.py only."""
    b, h, sq, _ = q.shape
    c = _query_chunks(b, h, k.shape[2])
    kf, vf = k.float(), v.float()
    delta = (dout.float() * out.float()).sum(-1)
    dk, dv, dqs = torch.zeros_like(kf), torch.zeros_like(vf), []
    for i in range(0, sq, c):
        qc, doc = q[:, :, i:i + c].float(), dout[:, :, i:i + c].float()
        p = torch.exp(torch.matmul(qc, kf.transpose(-1, -2)) * scale
                      - lse[:, :, i:i + c, None])
        dv += torch.matmul(p.transpose(-1, -2), doc)
        ds = p * (torch.matmul(doc, vf.transpose(-1, -2))
                  - delta[:, :, i:i + c, None])
        dqs.append(torch.matmul(ds, kf) * scale)
        dk += torch.matmul(ds.transpose(-1, -2), qc) * scale
    return torch.cat(dqs, dim=2), dk, dv


def takes_flash(sq: int, sk: int, d: int) -> bool:
    """Where ``_attention`` takes the Pallas flash kernel on a TPU: equal
    lengths, d <= 128, and a 1024/768/512 block dividing the sequence or a
    sequence in (128, 1024] after padding to 128."""
    if sq != sk or d > 128:
        return False
    if any(sq % c == 0 for c in (1024, 768, 512)):
        return True
    return 128 < sq and -(-sq // 128) * 128 <= 1024


def attention(q, k, v, scale: float) -> torch.Tensor:
    """Pick the implementation by shape, as ``_attention`` does."""
    sq, sk = q.shape[2], k.shape[2]
    if sq == sk and sq <= 32 and q.shape[1] > 1:
        return attention_packed_heads(q, k, v, scale)
    if sq < 512 and sk < 512:
        return attention_dense(q, k, v, scale)
    if takes_flash(sq, sk, q.shape[3]):
        return flash_attention(q, k, v, scale)
    return attention_chunked(q, k, v, scale)
