"""Building blocks of the SVD model stack in torch.

Counterpart of ``syn3r_tpu/models/layers.py``. Submodule and parameter
names are diffusers' state-dict names, so a diffusers checkpoint loads
as it is and the flax trees (which mirror the same names) bridge
mechanically (``models/convert.py``).

Conventions, as in the JAX package: spatial tensors are channel-last
(B, H, W, C), sequences (B, S, C). Convolutions hand torch a zero-copy
NCHW view of that memory (channels_last) and return channel-last again.
The compute dtype is the dtype of the activations: every Linear and
convolution casts its weights to it (a no-op when they are stored in it),
and the norms take float32 statistics and float32 affine parameters and
cast their output back, as the flax modules with ``dtype=`` do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.geglu_ffn import geglu_ffn
from ..ops.norm import contiguous_counted, group_norm, layer_norm


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embeddings (diffusers ``get_timestep_embedding`` with
    SVD's settings: cos first, no frequency shift, period 10000), f32."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def run_local(steps):
    """Runs ``steps`` on one device: a forward written as a generator that
    yields its frame-coupled calls (those that read frames other than the
    ones they write) as ``(fn, *args)``; each call is made as it is and its
    result sent back. ``parallel/sequence_parallel.py`` runs the generators
    of all frame shards in lock-step and makes each such call across the
    shards."""
    try:
        call = next(steps)
        while True:
            call = steps.send(call[0](*call[1:]))
    except StopIteration as stop:
        return stop.value


class Stepped(nn.Module):
    """A module whose forward is its generator ``steps`` (``run_local``)."""

    def forward(self, *args, **kwargs):
        return run_local(self.steps(*args, **kwargs))


def frame_ids(num_frames: int, batch: int, device) -> torch.Tensor:
    """The frame index of each (batch element, frame) row."""
    return torch.arange(num_frames, device=device).repeat(batch)


class Linear(nn.Linear):
    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2d(nn.Conv2d):
    """Conv over channel-last (B, H, W, C) input."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = self._conv_forward(x.permute(0, 3, 1, 2),
                               self.weight.to(x.dtype), b)
        return y.permute(0, 2, 3, 1)


class Conv3d(nn.Conv3d):
    """Conv over channel-last (B, F, H, W, C) input."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = self._conv_forward(x.permute(0, 4, 1, 2, 3),
                               self.weight.to(x.dtype), b)
        return y.permute(0, 2, 3, 4, 1)


class GroupNorm(nn.Module):
    """GroupNorm over the last axis with float32 channel-major statistics,
    optionally fused SiLU: ``ops.norm.group_norm`` on the (B, S, C) view
    (the CUDA kernels on the card)."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-6, silu: bool = False):
        super().__init__()
        self.num_groups, self.eps, self.silu = num_groups, eps, silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        shape = x.shape
        x3 = contiguous_counted(x).view(shape[0], -1, shape[-1])
        return group_norm(x3, self.weight, self.bias, self.num_groups,
                          self.eps, self.silu).view(shape)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, float32 statistics
    (var = E[x^2] - mean^2): ``ops.norm.layer_norm`` on the (R, C) view
    (the CUDA kernel on the card)."""

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        shape = x.shape
        x2 = contiguous_counted(x).view(-1, shape[-1])
        return layer_norm(x2, self.weight, self.bias, self.eps).view(shape)


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2."""

    def __init__(self, in_channels: int, time_embed_dim: int,
                 out_dim: int | None = None):
        super().__init__()
        self.linear_1 = Linear(in_channels, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, out_dim or time_embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Attention(nn.Module):
    """Multi-head attention with diffusers ``Attention`` semantics: qkv
    without bias unless ``qkv_bias``, ``to_out.0`` with bias, optional
    GroupNorm before the projections and residual (VAE mid block)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None, qkv_bias: bool = False,
                 norm_num_groups: int | None = None,
                 residual_connection: bool = False, eps: float = 1e-5):
        super().__init__()
        inner = heads * dim_head
        ctx = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.residual_connection = residual_connection
        self.group_norm = (GroupNorm(query_dim, norm_num_groups, eps)
                           if norm_num_groups is not None else None)
        self.to_q = Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = Linear(ctx, inner, bias=qkv_bias)
        self.to_v = Linear(ctx, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])

    def forward(self, x, context=None):
        spatial = x.dim() == 4
        if spatial:
            b, h, w, c = x.shape
            x = x.reshape(b, h * w, c)
        residual = x
        if self.group_norm is not None:
            x = self.group_norm(x)
        out = self.attend(x, context)
        if context is not None and context.shape[1] == 1:
            out = out.expand(x.shape[0], x.shape[1], -1)
        if self.residual_connection:
            out = out + residual
        if spatial:
            out = out.reshape(b, h, w, -1)
        return out

    def attend(self, x, context=None, shard=None):
        """to_out of the attention of x (B, S, C) to ``context`` (x itself
        when None), over all heads with to_out's bias, or over the heads of
        ``shard`` without it: a tensor-parallel partial, ``shard`` =
        {"heads": n, "to_q" / "to_k" / "to_v": (weight rows, bias rows or
        None), "to_out": (weight columns, None)}
        (``parallel/tensor_parallel.py``). With one context token the
        result is (B, 1, C): softmax over one key is exactly 1, so the
        output is to_out(to_v(context)), which ``forward`` broadcasts over
        the queries (to_q / to_k stay in the state dict, unused)."""
        def proj(name, t):
            if shard is None:
                return (self.to_out[0] if name == "to_out"
                        else getattr(self, name))(t)
            w, b = shard[name]
            return F.linear(t, w.to(t.dtype),
                            None if b is None else b.to(t.dtype))

        if context is not None and context.shape[1] == 1:
            return proj("to_out", proj("to_v", context))
        heads = self.heads if shard is None else shard["heads"]
        ctx = x if context is None else context
        bsz, s = x.shape[0], x.shape[1]

        def split(t):
            return t.view(t.shape[0], t.shape[1], heads,
                          self.dim_head).transpose(1, 2)

        q, k, v = (split(proj("to_q", x)), split(proj("to_k", ctx)),
                   split(proj("to_v", ctx)))
        out = attention(q, k, v, 1.0 / math.sqrt(self.dim_head))
        return proj("to_out", out.transpose(1, 2).reshape(bsz, s, -1))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, inner: int):
        super().__init__()
        self.proj = Linear(dim_in, inner * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers ``FeedForward``): ``net.0.proj`` and
    ``net.2``, run through ``ops.geglu_ffn.geglu_ffn`` (the CUDA kernel on
    the card). ``net.1`` is diffusers' dropout slot and holds nothing."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(),
                                  Linear(inner, dim)])

    def forward(self, x):
        c = x.shape[-1]
        p1, p2 = self.net[0].proj, self.net[2]
        y = geglu_ffn(x.reshape(-1, c), p1.weight, p1.bias, p2.weight,
                      p2.bias)
        return y.reshape(x.shape[:-1] + (p2.out_features,))


class ResnetBlock2D(nn.Module):
    """GN+SiLU -> conv3x3 -> (+temb) -> GN+SiLU -> conv3x3, + shortcut."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int | None = None, eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, 32, eps, silu=True)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (Linear(temb_channels, out_channels)
                              if temb_channels else None)
        self.norm2 = GroupNorm(out_channels, 32, eps, silu=True)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class TemporalResnetBlock(Stepped):
    """Resnet over the frame axis with (3, 1, 1) convolutions.
    x: (B, F, H, W, C); temb: (B, F, D) or None. Its GroupNorms (over
    F x H x W) and its convolutions are frame-coupled (``run_local``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int | None = None, eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, 32, eps, silu=True)
        self.conv1 = Conv3d(in_channels, out_channels, (3, 1, 1),
                            padding=(1, 0, 0))
        self.time_emb_proj = (Linear(temb_channels, out_channels)
                              if temb_channels else None)
        self.norm2 = GroupNorm(out_channels, 32, eps, silu=True)
        self.conv2 = Conv3d(out_channels, out_channels, (3, 1, 1),
                            padding=(1, 0, 0))
        self.conv_shortcut = (Conv3d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def steps(self, x, temb=None):
        h = yield self.norm1, x
        h = yield self.conv1, h
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None, :]
        h = yield self.norm2, h
        h = yield self.conv2, h
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AlphaBlender(nn.Module):
    """Learned spatial/temporal mix. With SVD's all-zero
    image_only_indicator both strategies reduce to alpha =
    sigmoid(mix_factor); the VAE switches the two sides."""

    def __init__(self, switch_spatial_to_temporal_mix: bool = False):
        super().__init__()
        self.switch = switch_spatial_to_temporal_mix
        self.mix_factor = nn.Parameter(torch.tensor([0.5]))

    def forward(self, x_spatial, x_temporal):
        alpha = torch.sigmoid(self.mix_factor[0]).to(x_spatial.dtype)
        if self.switch:
            alpha = 1.0 - alpha
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample then conv3x3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.conv(x)

