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

import torch

from ..kernels import build


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


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """Exact attention: the CUDA kernel for CUDA tensors (bf16, d = 64),
    ``attention_chunked`` for CPU tensors. ``flash_attention.launches``
    counts kernel launches. Returns (B, H, S, D), a view of a (B, S, H, D)
    tensor."""
    if q.device.type == "cpu":
        return attention_chunked(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, s, d = q.shape
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("flash_attention kernel takes bfloat16 q, k, v")
    if d != 64 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention kernel needs q, k, v of one shape "
                         f"with d = 64, got {q.shape} {k.shape} {v.shape}")
    # the kernel copies 16-byte rows: one shared set of strides, rows
    # 16-byte aligned
    if (not (q.stride() == k.stride() == v.stride()) or q.stride(3) != 1
            or any(st % 8 for st in q.stride()[:3])
            or any(t.data_ptr() % 16 for t in (q, k, v))):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sb, sh, ss, _ = q.stride()
    ob, oh, os_, _ = out.stride()
    err = build.entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, d,
        sb, sh, ss, ob, oh, os_, float(scale), stream)
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
