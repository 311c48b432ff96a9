"""Exact multi-head attention and its dispatch.

Counterpart of the attention functions of ``syn3r_tpu/models/layers.py``
(``_attention_dense``, ``_attention_chunked``, ``_attention_packed_heads``
and ``_attention``). Tensors are (B, H, S, D) and may be strided views
(the projections are (B, S, H, D) in memory). Logits and softmax are in
float32, the probabilities are cast to V's dtype before the second
product, as in the JAX package.

Where the JAX package takes the Pallas TPU flash attention, the port takes
``flash_attention``: the hand-written kernel of ``csrc/flash_attention.cu``
on a CUDA tensor, the exact chunked version on a CPU tensor. The packed,
dense and chunked paths stay plain torch, as they stay XLA in JAX.
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


def attention_chunked(q, k, v, scale: float):
    """Exact attention over query chunks with the full key set; the chunk
    bounds the float32 logit buffer (b, h, q_chunk, sk) to about 256 MB,
    as ``_attention_chunked`` does."""
    b, h, sq, _ = q.shape
    q_chunk = (256 * 1024 * 1024) // max(1, b * h * k.shape[2] * 4)
    q_chunk = max(64, min(512, (q_chunk // 64) * 64))
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


def mapped(t: torch.Tensor, rows: int):
    """(t, its tensor map): t itself where its strides and start suit TMA,
    else one contiguous copy in a fresh (aligned) allocation."""
    m = flash_tensor_map(t.shape, t.stride(), t.data_ptr(), rows)
    if m is None:
        t = t.clone(memory_format=torch.contiguous_format)
        m = flash_tensor_map(t.shape, t.stride(), t.data_ptr(), rows)
    return t, m


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """Exact attention: the CUDA kernel for CUDA tensors (bf16, d = 64),
    ``attention_chunked`` for CPU tensors. ``flash_attention.launches``
    counts kernel launches. Returns (B, H, S, D), a view of a (B, S, H, D)
    tensor."""
    if q.device.type == "cpu":
        return attention_chunked(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_flash_args(q, k, v)
    b, h, s, d = q.shape
    (q, mq), (k, mk), (v, mv) = (mapped(q, FLASH_BQ), mapped(k, FLASH_BKV),
                                 mapped(v, FLASH_BKV))
    geom = (ctypes.c_longlong * 36)(*(
        x for m in (mq, mk, mv)
        for x in (*m["dims"], *m["strides"], *m["box"], m["s_dim"])))
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ob, oh, os_, _ = out.stride()
    grid = flash_grid(b, h, s, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    err = build.entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geom, b, h,
        s, ob, oh, os_, float(scale), grid, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


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
