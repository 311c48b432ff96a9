"""SVD VAE (diffusers AutoencoderKLTemporalDecoder).

Counterpart of ``syn3r_tpu/models/vae.py``: the SD KL encoder and the
temporal decoder, whose SpatioTemporalResBlocks use the learned mix with
the spatial and temporal sides switched, ending in a (3,1,1) Conv3d over
frames. Images and latents are channel-last.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Attention, Conv2d, Conv3d, GroupNorm, ResnetBlock2D, \
    Upsample2D
from .svd_unet import SpatioTemporalResBlock


class VAEDownsample(nn.Module):
    """Stride-2 conv after the SD-VAE asymmetric (0, 1) padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, num_layers=2,
                 add_downsample=True):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_channels if i == 0 else out_channels,
                           out_channels, None, 1e-6)
             for i in range(num_layers)])
        self.downsamplers = nn.ModuleList(
            [VAEDownsample(out_channels)] if add_downsample else [])

    def forward(self, x):
        for res in self.resnets:
            x = res(x)
        for down in self.downsamplers:
            x = down(x)
        return x


class UNetMidBlock2D(nn.Module):
    """resnet -> single-head spatial attention -> resnet."""

    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(channels, channels, None, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList(
            [Attention(channels, 1, channels, qkv_bias=True,
                       norm_num_groups=32, residual_connection=True)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        ch = list(block_out_channels)
        self.conv_in = Conv2d(3, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [DownEncoderBlock2D(ch[max(i - 1, 0)], c, layers_per_block,
                                add_downsample=i < len(ch) - 1)
             for i, c in enumerate(ch)])
        self.mid_block = UNetMidBlock2D(ch[-1])
        self.conv_norm_out = GroupNorm(ch[-1], 32, 1e-6, silu=True)
        self.conv_out = Conv2d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


def _temporal_res(cin, cout):
    return SpatioTemporalResBlock(cin, cout, None, eps=1e-6,
                                  temporal_eps=1e-5,
                                  switch_spatial_to_temporal_mix=True)


class MidBlockTemporalDecoder(nn.Module):
    def __init__(self, channels: int, num_layers: int = 2):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_temporal_res(channels, channels) for _ in range(num_layers)])
        self.attentions = nn.ModuleList(
            [Attention(channels, 1, channels, qkv_bias=True,
                       norm_num_groups=32, residual_connection=True,
                       eps=1e-6)] if num_layers > 1 else [])

    def forward(self, x, num_frames: int):
        x = self.resnets[0](x, None, num_frames)
        for res in self.resnets[1:]:
            x = self.attentions[0](x)
            x = res(x, None, num_frames)
        return x


class UpBlockTemporalDecoder(nn.Module):
    def __init__(self, in_channels, out_channels, num_layers=3,
                 add_upsample=True):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_temporal_res(in_channels if i == 0 else out_channels,
                           out_channels) for i in range(num_layers)])
        self.upsamplers = nn.ModuleList(
            [Upsample2D(out_channels)] if add_upsample else [])

    def forward(self, x, num_frames: int):
        for res in self.resnets:
            x = res(x, None, num_frames)
        for up in self.upsamplers:
            x = up(x)
        return x


class TemporalDecoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 out_channels: int = 3):
        super().__init__()
        ch = list(block_out_channels)
        rev = ch[::-1]
        self.conv_in = Conv2d(latent_channels, ch[-1], 3, padding=1)
        self.mid_block = MidBlockTemporalDecoder(ch[-1], layers_per_block)
        self.up_blocks = nn.ModuleList(
            [UpBlockTemporalDecoder(rev[max(i - 1, 0)], c,
                                    layers_per_block + 1,
                                    add_upsample=i < len(rev) - 1)
             for i, c in enumerate(rev)])
        self.conv_norm_out = GroupNorm(ch[0], 32, 1e-6, silu=True)
        self.conv_out = Conv2d(ch[0], out_channels, 3, padding=1)
        self.time_conv_out = Conv3d(out_channels, out_channels, (3, 1, 1),
                                    padding=(1, 0, 0))

    def forward(self, z, num_frames: int):
        x = self.conv_in(z)
        x = self.mid_block(x, num_frames)
        for block in self.up_blocks:
            x = block(x, num_frames)
        x = self.conv_out(self.conv_norm_out(x))
        bf, h, w, c = x.shape
        x = self.time_conv_out(x.reshape(bf // num_frames, num_frames, h, w,
                                         c))
        return x.reshape(bf, h, w, c)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 scaling_factor: float = 0.18215):
        super().__init__()
        self.scaling_factor = scaling_factor
        self.encoder = Encoder(block_out_channels, layers_per_block,
                               latent_channels)
        self.decoder = TemporalDecoder(block_out_channels, layers_per_block,
                                       latent_channels)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1)

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] -> latent mode (B, h, w, 4), the mean of
        the posterior (the clipped log-variance is not needed for it)."""
        moments = self.quant_conv(self.encoder(x))
        return moments.chunk(2, dim=-1)[0]

    def decode(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        """(B*F, h, w, 4) unscaled latents -> (B*F, H, W, 3)."""
        return self.decoder(z, num_frames)
