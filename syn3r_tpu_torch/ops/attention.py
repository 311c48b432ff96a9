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
pass through the UNet), the dkv and dq kernels of
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

# Query rows of the kernel's work item, keys of its K/V stage, head dim.
FLASH_BQ, FLASH_BKV, FLASH_D = 128, 192, 64


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
    """One launch of the forward kernel on CUDA tensors: (out, lse), out
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ob, oh, os_, _ = out.stride()
    grid = flash_grid(b, h, s, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    err = build.entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), geom, b, h, s, ob, oh, os_,
        float(scale), grid, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out, lse


def row_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, H, S, 64) as the backward kernels read it (contiguous head
    dim, element strides multiple of 8, 16-byte aligned start), copied once
    into a contiguous tensor where it is not."""
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any(st % 8 for st in t.stride()[:3])):
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
    return t


def like_projection(t: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, S, D) view of a (B, S, H, D) tensor, the layout of
    the UNet's projections (so their gradients need no copy)."""
    b, h, s, d = t.shape
    return torch.empty((b, s, h, d), dtype=t.dtype,
                       device=t.device).permute(0, 2, 1, 3)


def flash_bwd_launch(name: str, q, k, v, dout, lse, delta, outs,
                     scale: float) -> None:
    """One launch of the backward kernel ``name``: "dkv" writes outs =
    (dk, dv), "dq" writes outs = (dq,). Arguments as ``flash_attention_bwd``
    prepares them (``row_aligned`` views, contiguous f32 lse and D)."""
    b, h, s, _ = q.shape
    views = (q, k, v, dout) + tuple(outs)
    strides = (ctypes.c_longlong * (3 * len(views)))(
        *(st for t in views for st in t.stride()[:3]))
    err = build.entry("flash_attention_bwd", f"syn3r_flash_bwd_{name}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
        strides, b, h, s, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd {name} kernel launch "
                           f"failed: cudaError {err}")
    flash_attention_bwd.launches[name] += 1


def flash_attention_bwd(q, k, v, out, lse, dout, scale: float):
    """(dq, dk, dv) of exact attention on CUDA tensors: D = rowsum(dout *
    out) in torch, then the dkv and the dq kernels of
    ``csrc/flash_attention_bwd.cu``. ``flash_attention_bwd.launches``
    counts each kernel's launches."""
    check_flash_args(q, k, v)
    if (dout.shape != q.shape or dout.dtype != q.dtype
            or out.shape != q.shape or lse.shape != q.shape[:3]
            or lse.dtype != torch.float32):
        raise ValueError("flash_attention_bwd: out and dout must be like q "
                         f"{tuple(q.shape)}, lse f32 (B, H, S); got "
                         f"{tuple(out.shape)} {tuple(dout.shape)} "
                         f"{dout.dtype} {tuple(lse.shape)} {lse.dtype}")
    check_cuda(q)
    q, k, v, dout = (row_aligned(t) for t in (q, k, v, dout))
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    lse = lse.contiguous()
    dq, dk, dv = like_projection(q), like_projection(k), like_projection(v)
    flash_bwd_launch("dkv", q, k, v, dout, lse, delta, (dk, dv), scale)
    flash_bwd_launch("dq", q, k, v, dout, lse, delta, (dq,), scale)
    return dq, dk, dv


flash_attention_bwd.launches = {"dkv": 0, "dq": 0}


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
    ``flash_attention.launches`` counts forward kernel launches. Returns
    (B, H, S, D), a view of a (B, S, H, D) tensor on CUDA."""
    if q.device.type == "cpu":
        return attention_chunked(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    return _flash_forward(q, k, v, scale, with_lse=False)[0]


flash_attention.launches = 0


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
