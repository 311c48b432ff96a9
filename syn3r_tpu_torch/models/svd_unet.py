"""SVD spatio-temporal UNet (diffusers UNetSpatioTemporalConditionModel).

Counterpart of ``syn3r_tpu/models/svd_unet.py``, with diffusers'
state-dict names. Spatial tensors are channel-last (B*F, H, W, C).

The reference builds the temporal cross-attention context hw-major while
the attention rows are batch-major, so pixel row r attends to the first
frame's context of batch element r % B (transformer_temporal.py:311-317).
``batch_groups`` reproduces that per group for a batch made of
independent sub-calls, so one fused batch-3 call with groups (1, 2) equals
the separate batch-1 guidance and batch-2 CFG calls. A ``BatchWindow`` in
its place runs a slice of a batch with the whole batch's quirk (a
data-parallel replica's rows, ``parallel/data_parallel.py``).

The modules that hold frame-coupled work (the temporal resnets and
transformers, and the blocks above them) write their forward as a
generator ``steps`` (``layers.run_local``): a frame-sharded forward
(``parallel/sequence_parallel.py``) runs the same code on each shard.

Spans (``utils.profiling.span``) split a forward in a profiler's trace:
``unet.forward`` holds ``unet.embed`` (the time and added embeddings,
``conv_in``, the repeats over frames), each ``unet.resnet`` (children
``unet.resnet.spatial`` and ``unet.resnet.temporal``; the mixer is the
parent's own), each ``unet.transformer`` (children
``unet.transformer.spatial`` and ``unet.transformer.temporal``; the
GroupNorm, ``proj_in`` / ``proj_out``, the position embedding, reshapes
and mixer are the parent's own), each down- or upsampler
(``unet.sample``), each skip concatenation (``unet.skip``) and
``unet.out`` (``conv_norm_out``, ``conv_out``). SVD-XT's forward has 22
resnets, 16 transformers, 6 samplers and 12 skips.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import span
from .layers import (AlphaBlender, Attention, Conv2d, Downsample2D,
                     FeedForward, GroupNorm, LayerNorm, Linear, ResnetBlock2D,
                     Stepped, TemporalResnetBlock, TimestepEmbedding,
                     Upsample2D, frame_ids, timestep_embedding)


class BatchWindow(NamedTuple):
    """Elements [offset, offset + b) of a batch grouped by ``groups``
    (sizes summing to the whole batch), ``first_context`` (B, 1, D) the
    whole batch's encoder states: passed as ``batch_groups``, the slice's
    time context is the one its rows take in the whole batch's call."""
    groups: Tuple[int, ...]
    offset: int
    first_context: torch.Tensor


def time_context_rows(groups, s: int, device) -> torch.Tensor:
    """The batch element whose first-frame context each (element, pixel)
    row of a call attends to in temporal cross-attention: pixel row r of a
    group of m elements starting at element off takes off + r % m."""
    parts, off = [], 0
    for m in groups:
        parts.append(off + torch.arange(m * s, device=device) % m)
        off += m
    return torch.cat(parts)


class SpatioTemporalResBlock(Stepped):
    """Spatial ResnetBlock2D + temporal (3,1,1)-conv resnet, alpha-blended."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int | None = None, eps: float = 1e-6,
                 temporal_eps: float | None = None,
                 switch_spatial_to_temporal_mix: bool = False):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_channels, out_channels,
                                               temb_channels, eps)
        self.temporal_res_block = TemporalResnetBlock(
            out_channels, out_channels, temb_channels, temporal_eps or eps)
        self.time_mixer = AlphaBlender(switch_spatial_to_temporal_mix)

    def steps(self, x, temb, num_frames: int):
        with span("unet.resnet"):
            with span("unet.resnet.spatial"):
                x = self.spatial_res_block(x, temb)
            bf, h, w, c = x.shape
            b = bf // num_frames
            x5 = x.reshape(b, num_frames, h, w, c)
            temb5 = (temb.reshape(b, num_frames, -1) if temb is not None
                     else None)
            with span("unet.resnet.temporal"):
                xt = yield from self.temporal_res_block.steps(x5, temb5)
            return self.time_mixer(x5, xt).reshape(bf, h, w, c)


class BasicTransformerBlock(nn.Module):
    """Spatial block: self-attention, cross-attention, GEGLU FF."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(Stepped):
    """Per-pixel block over the frame axis. Input (B*S, F, C). Its
    self-attention over the frames is frame-coupled."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def steps(self, x, context):
        x = self.ff_in(self.norm_in(x)) + x
        x = x + (yield self.attn1, self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class TransformerSpatioTemporalModel(Stepped):
    """Spatial + temporal transformer pair with learned time mixing."""

    def __init__(self, channels: int, heads: int, dim_head: int,
                 context_dim: int, num_layers: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(channels, 32, 1e-6)
        self.proj_in = Linear(channels, inner)
        self.time_pos_embed = TimestepEmbedding(channels, channels * 4,
                                                channels)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim)
             for _ in range(num_layers)])
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(inner, heads, dim_head,
                                           context_dim)
             for _ in range(num_layers)])
        self.time_mixer = AlphaBlender()
        self.proj_out = Linear(inner, channels)

    def steps(self, x, context, num_frames: int,
              batch_groups: Optional[Tuple[int, ...]] = None):
        with span("unet.transformer"):
            bf, height, width, channels = x.shape
            b = bf // num_frames
            s = height * width
            if isinstance(batch_groups, BatchWindow):
                w = batch_groups
                rows = time_context_rows(w.groups, s, x.device)[
                    w.offset * s:(w.offset + b) * s]
                time_context = w.first_context.to(x.device, x.dtype)[rows]
            else:
                tc_first = context.reshape(b, num_frames, context.shape[1],
                                           context.shape[2])[:, 0]
                groups = batch_groups if batch_groups is not None else (b,)
                if sum(groups) != b:
                    raise ValueError(f"batch_groups {groups} != batch {b}")
                time_context = tc_first[time_context_rows(groups, s,
                                                          x.device)]

            residual = x
            h = self.norm(x).reshape(bf, s, channels)
            h = self.proj_in(h)
            inner = h.shape[-1]
            # the frame ids are frame-coupled: a shard's are its global ones
            ids = yield frame_ids, num_frames, b, x.device
            t_emb = timestep_embedding(ids, channels).to(x.dtype)
            emb = self.time_pos_embed(t_emb)[:, None, :]      # (B*F, 1, C)

            for block, temporal in zip(self.transformer_blocks,
                                       self.temporal_transformer_blocks):
                with span("unet.transformer.spatial"):
                    h = block(h, context)
                mix = (h + emb).reshape(b, num_frames, s,
                                        inner).transpose(1, 2)
                with span("unet.transformer.temporal"):
                    mix = yield from temporal.steps(
                        mix.reshape(b * s, num_frames, inner), time_context)
                mix = mix.reshape(b, s, num_frames, inner).transpose(1, 2)
                h = self.time_mixer(h, mix.reshape(bf, s, inner))

            h = self.proj_out(h)
            return h.reshape(bf, height, width, channels) + residual


class CrossAttnDownBlockSpatioTemporal(Stepped):
    def __init__(self, in_channels, out_channels, temb_channels, heads,
                 context_dim, num_layers=2, add_downsample=True):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(in_channels if i == 0 else out_channels,
                                    out_channels, temb_channels, 1e-6)
             for i in range(num_layers)])
        self.attentions = nn.ModuleList(
            [TransformerSpatioTemporalModel(out_channels, heads,
                                            out_channels // heads,
                                            context_dim)
             for _ in range(num_layers)])
        self.downsamplers = nn.ModuleList(
            [Downsample2D(out_channels)] if add_downsample else [])

    def steps(self, x, temb, context, num_frames, batch_groups=None):
        outputs = []
        for res, attn in zip(self.resnets, self.attentions):
            x = yield from res.steps(x, temb, num_frames)
            x = yield from attn.steps(x, context, num_frames, batch_groups)
            outputs.append(x)
        for down in self.downsamplers:
            with span("unet.sample"):
                x = down(x)
            outputs.append(x)
        return x, outputs


class DownBlockSpatioTemporal(Stepped):
    def __init__(self, in_channels, out_channels, temb_channels,
                 num_layers=2):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(in_channels if i == 0 else out_channels,
                                    out_channels, temb_channels, 1e-5)
             for i in range(num_layers)])

    def steps(self, x, temb, num_frames):
        outputs = []
        for res in self.resnets:
            x = yield from res.steps(x, temb, num_frames)
            outputs.append(x)
        return x, outputs


class UNetMidBlockSpatioTemporal(Stepped):
    def __init__(self, channels, temb_channels, heads, context_dim):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(channels, channels, temb_channels, 1e-5)
             for _ in range(2)])
        self.attentions = nn.ModuleList(
            [TransformerSpatioTemporalModel(channels, heads,
                                            channels // heads, context_dim)])

    def steps(self, x, temb, context, num_frames, batch_groups=None):
        x = yield from self.resnets[0].steps(x, temb, num_frames)
        x = yield from self.attentions[0].steps(x, context, num_frames,
                                                batch_groups)
        return (yield from self.resnets[1].steps(x, temb, num_frames))


class UpBlockSpatioTemporal(Stepped):
    """``in_channels``: one entry per resnet, the concatenated width;
    ``res_states``: the skips, the last one taken first."""

    def __init__(self, in_channels: Sequence[int], out_channels,
                 temb_channels, heads=None, context_dim=None,
                 add_upsample=True):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(c, out_channels, temb_channels, 1e-6)
             for c in in_channels])
        if heads is not None:
            self.attentions = nn.ModuleList(
                [TransformerSpatioTemporalModel(out_channels, heads,
                                                out_channels // heads,
                                                context_dim)
                 for _ in in_channels])
        else:
            self.attentions = None
        self.upsamplers = nn.ModuleList(
            [Upsample2D(out_channels)] if add_upsample else [])

    def steps(self, x, res_states, temb, context, num_frames,
              batch_groups=None):
        for i, res in enumerate(self.resnets):
            with span("unet.skip"):
                x = torch.cat([x, res_states[-1 - i]], dim=-1)
            x = yield from res.steps(x, temb, num_frames)
            if self.attentions is not None:
                x = yield from self.attentions[i].steps(
                    x, context, num_frames, batch_groups)
        for up in self.upsamplers:
            with span("unet.sample"):
                x = up(x)
        return x


class UNetSpatioTemporalConditionModel(Stepped):
    """The SVD denoiser.

    sample: (B, F, H, W, 8) noisy latents concatenated with the
    conditioning latents, in the compute dtype; timestep: scalar;
    encoder_hidden_states: (B, 1, D) CLIP image embedding; added_time_ids:
    (B, 3) [fps, motion_bucket_id, noise_aug]. Returns (B, F, H, W, 4) in
    the compute dtype.
    """

    def __init__(self, in_channels: int = 8, out_channels: int = 4,
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2,
                 num_attention_heads: Sequence[int] = (5, 10, 20, 20),
                 addition_time_embed_dim: int = 256,
                 cross_attention_dim: int = 1024):
        super().__init__()
        ch = list(block_out_channels)
        temb = ch[0] * 4
        self.block_out_channels = ch
        self.addition_time_embed_dim = addition_time_embed_dim
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(3 * addition_time_embed_dim,
                                               temb)
        self.conv_in = Conv2d(in_channels, ch[0], 3, padding=1)

        n = len(ch)
        skips = [ch[0]]
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, c in enumerate(ch):
            if i < n - 1:
                block = CrossAttnDownBlockSpatioTemporal(
                    prev, c, temb, num_attention_heads[i],
                    cross_attention_dim, layers_per_block)
                skips += [c] * (layers_per_block + 1)
            else:
                block = DownBlockSpatioTemporal(prev, c, temb,
                                                layers_per_block)
                skips += [c] * layers_per_block
            self.down_blocks.append(block)
            prev = c

        self.mid_block = UNetMidBlockSpatioTemporal(
            ch[-1], temb, num_attention_heads[-1], cross_attention_dim)

        rev_ch = ch[::-1]
        rev_heads = list(num_attention_heads)[::-1]
        self.up_blocks = nn.ModuleList()
        for i, c in enumerate(rev_ch):
            ins = []
            for _ in range(layers_per_block + 1):
                ins.append(prev + skips.pop())
                prev = c
            self.up_blocks.append(UpBlockSpatioTemporal(
                ins, c, temb, None if i == 0 else rev_heads[i],
                cross_attention_dim, add_upsample=i < n - 1))

        self.conv_norm_out = GroupNorm(ch[0], 32, 1e-5, silu=True)
        self.conv_out = Conv2d(ch[0], out_channels, 3, padding=1)

    def steps(self, sample, timestep, encoder_hidden_states, added_time_ids,
              batch_groups: Optional[Tuple[int, ...]] = None,
              remat_blocks: bool = False):
        """The forward. ``remat_blocks``: checkpoint each down, mid and up
        block (the blocks JAX wraps in ``nn.remat``), so a gradient through
        the UNet keeps one block's activations at a time and recomputes
        the block's forward in the backward (on one device); the values
        are the same."""
        def run(block, *args):
            if remat_blocks:
                return checkpoint(block, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            return (yield from block.steps(*args))

        with span("unet.forward"):
            b, f, h, w, c = sample.shape
            dt = sample.dtype
            with span("unet.embed"):
                ts = torch.as_tensor(timestep, dtype=torch.float32,
                                     device=sample.device).expand(b)
                emb = self.time_embedding(
                    timestep_embedding(ts,
                                       self.block_out_channels[0]).to(dt))
                add = timestep_embedding(added_time_ids.reshape(-1),
                                         self.addition_time_embed_dim)
                emb = emb + self.add_embedding(add.reshape(b, -1).to(dt))

                x = self.conv_in(sample.reshape(b * f, h, w, c))
                emb = emb.repeat_interleave(f, dim=0)             # (B*F, D)
                context = encoder_hidden_states.repeat_interleave(f, dim=0)

            res_stack = [x]
            for block in self.down_blocks:
                if isinstance(block, CrossAttnDownBlockSpatioTemporal):
                    x, outs = yield from run(block, x, emb, context, f,
                                             batch_groups)
                else:
                    x, outs = yield from run(block, x, emb, f)
                res_stack.extend(outs)

            x = yield from run(self.mid_block, x, emb, context, f,
                               batch_groups)

            for block in self.up_blocks:
                n_lay = len(block.resnets)
                res = tuple(res_stack.pop() for _ in range(n_lay))[::-1]
                x = yield from run(block, x, res, emb, context, f,
                                   batch_groups)

            with span("unet.out"):
                x = self.conv_out(self.conv_norm_out(x))
                return x.reshape(b, f, h, w, -1)
