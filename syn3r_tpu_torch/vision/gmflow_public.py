"""GMFlow with the public checkpoint's architecture (haofeixu/gmflow).

Counterpart of ``syn3r_tpu/vision/gmflow_public.py`` in float32, with the
public state-dict names (``backbone.layer{s}.{b}.conv1``,
``transformer.layers.{i}.self_attn.q_proj``, ``feature_flow_attn``,
``upsampler.0`` ...); ``models/convert.gmflow_state_from_flax`` bridges the
JAX package's flax tree. One scale, 128 channels, 6 transformer layers,
attn_splits 2:

  CNNEncoder          instance-norm ResNet to 1/8 resolution (7x7/2 stem,
                      stages of 64, 96, 128 channels) + 1x1 output conv
  FeatureTransformer  self-attention (no FFN) + cross-attention with FFN a
                      layer, split-window attention on 2 x 2 windows, odd
                      layers shifted by half a window (swin mask -100);
                      the sine position embedding added per window first
  matching            global correlation softmax -> expected coordinates
  SelfAttnPropagation feature self-attention carrying the flow
  upsampler           9-neighbour convex upsampling x8

The transformer's LayerNorms take epsilon 1e-6, flax's default that JAX
uses, not the public model's 1e-5: JAX is the reference here. A height
whose 1/8 size rounds up comes back taller (540 rows -> 68 -> 544), as in
JAX.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_LN_EPS = 1e-6
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) of (B, C, H, W): each channel of each
    sample over its pixels, biased variance."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, padding=1,
                               bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride, bias=False))

    def forward(self, x):
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class CNNEncoder(nn.Module):
    """(B, 3, H, W) -> (B, output_dim, ~H/8, ~W/8)."""

    def __init__(self, output_dim: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        stages, cin = [], 64
        for planes, stride in ((64, 1), (96, 2), (128, 2)):
            stages.append(nn.Sequential(ResidualBlock(cin, planes, stride),
                                        ResidualBlock(planes, planes)))
            cin = planes
        self.layer1, self.layer2, self.layer3 = stages
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(instance_norm(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


# ---------------------------------------------------------------------------
# split-window attention
# ---------------------------------------------------------------------------

def split_feature(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """(B, H, W, C) -> (B K K, H/K, W/K, C), windows row-major."""
    b, h, w, c = x.shape
    k = num_splits
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def merge_splits(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """Inverse of split_feature."""
    bkk, hk, wk, c = x.shape
    k = num_splits
    x = x.reshape(bkk // (k * k), k, k, hk, wk, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bkk // (k * k), k * hk, k * wk, c)


def shift_window_attn_mask(h: int, w: int, num_splits: int,
                           device="cpu") -> torch.Tensor:
    """The swin shifted-window mask (K K, win, win): -100 between tokens of
    different rolled regions, 0 within one."""
    wh, ww = h // num_splits, w // num_splits
    sh, sw = wh // 2, ww // 2
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = img.reshape(1, num_splits, wh, num_splits, ww, 1) \
        .transpose(0, 1, 3, 2, 4, 5).reshape(num_splits ** 2, wh * ww)
    diff = win[:, None, :] - win[:, :, None]
    return torch.as_tensor(np.where(diff != 0, -100.0, 0.0)
                           .astype(np.float32), device=device)


def swin_attention(q, k, v, num_splits: int, with_shift: bool, h: int,
                   w: int, attn_mask=None):
    """Single-head attention within each of the K x K windows of (B, H W,
    C) q, k, v; shifted layers roll by half a window first (and back)."""
    b, _, c = q.shape
    qi, ki, vi = (t.reshape(b, h, w, c) for t in (q, k, v))
    sh, sw = (h // num_splits) // 2, (w // num_splits) // 2
    if with_shift:
        qi, ki, vi = (torch.roll(t, (-sh, -sw), dims=(1, 2))
                      for t in (qi, ki, vi))
    qs, ks, vs = (split_feature(t, num_splits).reshape(b * num_splits ** 2,
                                                       -1, c)
                  for t in (qi, ki, vi))
    scores = (qs @ ks.transpose(1, 2)) / c ** 0.5
    if with_shift:
        scores = scores + attn_mask.repeat(b, 1, 1)
    out = torch.softmax(scores, -1) @ vs
    out = merge_splits(out.reshape(b * num_splits ** 2, h // num_splits,
                                   w // num_splits, c), num_splits)
    if with_shift:
        out = torch.roll(out, (sh, sw), dims=(1, 2))
    return out.reshape(b, h * w, c)


def position_embedding_sine(h: int, w: int, num_pos_feats: int,
                            temperature: float = 10000.0,
                            device="cpu") -> torch.Tensor:
    """DETR's PositionEmbeddingSine (normalize=True, scale 2 pi) as
    (H, W, 2 num_pos_feats), the y part first."""
    scale = 2.0 * math.pi
    eps = 1e-6
    y = np.cumsum(np.ones((h, w), np.float32), axis=0)
    x = np.cumsum(np.ones((h, w), np.float32), axis=1)
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2.0 * (dim_t // 2) / num_pos_feats)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])],
                     axis=-1).reshape(h, w, num_pos_feats)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])],
                     axis=-1).reshape(h, w, num_pos_feats)
    return torch.as_tensor(np.concatenate([pos_y, pos_x], axis=-1),
                           device=device)


def feature_add_position(f0, f1, attn_splits: int, channels: int):
    """The sine position embedding added to (B, H, W, C) features, per
    split window when attn_splits > 1."""
    if attn_splits > 1:
        s0 = split_feature(f0, attn_splits)
        s1 = split_feature(f1, attn_splits)
        pos = position_embedding_sine(s0.shape[1], s0.shape[2],
                                      channels // 2, device=f0.device)
        return (merge_splits(s0 + pos, attn_splits),
                merge_splits(s1 + pos, attn_splits))
    pos = position_embedding_sine(f0.shape[1], f0.shape[2], channels // 2,
                                  device=f0.device)
    return f0 + pos, f1 + pos


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------

class TransformerLayer(nn.Module):
    """q/k/v projections, attention, ``merge`` and ``norm1``; unless
    ``no_ffn``, an FFN on concat(source, message) and ``norm2``; added to
    the source. Single-head."""

    def __init__(self, d: int, no_ffn: bool = False,
                 ffn_dim_expansion: int = 4):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.merge = nn.Linear(d, d)
        self.norm1 = nn.LayerNorm(d, eps=_LN_EPS)
        self.mlp = self.norm2 = None
        if not no_ffn:
            self.mlp = nn.Sequential(
                nn.Linear(2 * d, 2 * d * ffn_dim_expansion, bias=False),
                nn.GELU(), nn.Linear(2 * d * ffn_dim_expansion, d, bias=False))
            self.norm2 = nn.LayerNorm(d, eps=_LN_EPS)

    def forward(self, source, target, h, w, attn_splits, with_shift,
                attn_mask=None):
        d = source.shape[-1]
        q, k, v = self.q_proj(source), self.k_proj(target), \
            self.v_proj(target)
        if attn_splits > 1:
            msg = swin_attention(q, k, v, attn_splits, with_shift, h, w,
                                 attn_mask)
        else:
            msg = torch.softmax((q @ k.transpose(1, 2)) / d ** 0.5, -1) @ v
        msg = self.norm1(self.merge(msg))
        if self.mlp is not None:
            msg = self.norm2(self.mlp(torch.cat([source, msg], -1)))
        return source + msg


class TransformerBlock(nn.Module):
    def __init__(self, d: int, ffn_dim_expansion: int = 4):
        super().__init__()
        self.self_attn = TransformerLayer(d, no_ffn=True)
        self.cross_attn_ffn = TransformerLayer(d, ffn_dim_expansion=
                                               ffn_dim_expansion)

    def forward(self, source, target, h, w, attn_splits, with_shift,
                attn_mask=None):
        source = self.self_attn(source, source, h, w, attn_splits,
                                with_shift, attn_mask)
        return self.cross_attn_ffn(source, target, h, w, attn_splits,
                                   with_shift, attn_mask)


class FeatureTransformer(nn.Module):
    """Both views at once: (f0, f1) and (f1, f0) stacked on the batch axis;
    odd layers shifted when attn_splits > 1."""

    def __init__(self, num_layers: int = 6, d_model: int = 128,
                 ffn_dim_expansion: int = 4):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(d_model, ffn_dim_expansion)
            for _ in range(num_layers))

    def forward(self, f0, f1, attn_splits: int):
        b, h, w, c = f0.shape
        mask = (shift_window_attn_mask(h, w, attn_splits, f0.device)
                if attn_splits > 1 else None)
        c0 = torch.cat([f0, f1]).reshape(2 * b, h * w, c)
        c1 = torch.cat([f1, f0]).reshape(2 * b, h * w, c)
        for i, layer in enumerate(self.layers):
            c0 = layer(c0, c1, h, w, attn_splits,
                       attn_splits > 1 and i % 2 == 1, mask)
            c1 = torch.cat([c0[b:], c0[:b]])
        return c0[:b].reshape(b, h, w, c), c0[b:].reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# matching, propagation, upsampling
# ---------------------------------------------------------------------------

def global_correlation_softmax(f0, f1, bidir: bool = False):
    """(B, H, W, C) features -> flow (B, H, W, 2) (x, y) in pixels at this
    resolution; ``bidir`` stacks the backward flow (the correlation's
    transpose) on the batch axis."""
    b, h, w, c = f0.shape
    corr = (f0.reshape(b, h * w, c) @ f1.reshape(b, h * w, c)
            .transpose(1, 2)) / c ** 0.5
    dev = f0.device
    xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    ys = torch.arange(h, dtype=torch.float32, device=dev) \
        .repeat_interleave(w)
    grid = torch.stack([xs, ys], -1)                     # (HW, 2) (x, y)
    if bidir:
        corr = torch.cat([corr, corr.transpose(1, 2)])
    flow = torch.softmax(corr, -1) @ grid - grid
    return flow.reshape(-1, h, w, 2)


class SelfAttnPropagation(nn.Module):
    """Query and key from the features, value the flow (global)."""

    def __init__(self, c: int):
        super().__init__()
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)

    def forward(self, feature, flow):
        b, h, w, c = feature.shape
        f = feature.reshape(b, h * w, c)
        scores = (self.q_proj(f) @ self.k_proj(f).transpose(1, 2)) / c ** 0.5
        v = flow.reshape(b, h * w, flow.shape[-1])
        return (torch.softmax(scores, -1) @ v).reshape(b, h, w, -1)


def convex_upsample(flow, mask_logits, factor: int = 8):
    """Convex upsampling: flow (B, h, w, 2), mask_logits (B, h, w,
    9 factor^2) in (9, factor, factor) order -> (B, h factor, w factor,
    2); the 9 neighbours of the scaled flow (zero padded) in F.unfold's
    (dy, dx) row-major order."""
    b, h, w, _ = flow.shape
    m = torch.softmax(mask_logits.reshape(b, h, w, 9, factor, factor), 3)
    fpad = F.pad(flow * factor, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([fpad[:, dy:dy + h, dx:dx + w]
                         for dy in range(3) for dx in range(3)], 3)
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", m, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, h * factor, w * factor, 2)


class GMFlowPublic(nn.Module):
    """``forward(img0, img1)`` on (B, H, W, 3) in [0, 1] (ImageNet
    normalization inside) -> flow (B, H', W', 2) in pixels (x, y), H' and
    W' eight times the 1/8 grid; ``bidir=True`` returns (forward,
    backward)."""

    def __init__(self, feature_channels: int = 128,
                 num_transformer_layers: int = 6, attn_splits: int = 2,
                 upsample_factor: int = 8):
        super().__init__()
        self.feature_channels = feature_channels
        self.attn_splits = attn_splits
        self.upsample_factor = upsample_factor
        self.backbone = CNNEncoder(feature_channels)
        self.transformer = FeatureTransformer(num_transformer_layers,
                                              feature_channels)
        self.feature_flow_attn = SelfAttnPropagation(feature_channels)
        self.upsampler = nn.Sequential(
            nn.Conv2d(2 + feature_channels, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 9 * upsample_factor ** 2, 1))

    def forward(self, img0, img1, bidir: bool = False):
        mean = torch.tensor(_MEAN, device=img0.device)
        std = torch.tensor(_STD, device=img0.device)
        b = img0.shape[0]
        x = (torch.cat([img0, img1]) - mean) / std
        feats = self.backbone(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        f0, f1 = feature_add_position(feats[:b], feats[b:],
                                      self.attn_splits, self.feature_channels)
        f0, f1 = self.transformer(f0, f1, self.attn_splits)
        flow = global_correlation_softmax(f0, f1, bidir=bidir)
        feat = torch.cat([f0, f1]) if bidir else f0
        flow = self.feature_flow_attn(feat, flow)
        m = self.upsampler(torch.cat([flow, feat], -1).permute(0, 3, 1, 2))
        up = convex_upsample(flow, m.permute(0, 2, 3, 1),
                             self.upsample_factor)
        return (up[:b], up[b:]) if bidir else up


def gmflow_config(params: dict) -> dict:
    """``GMFlowPublic`` arguments of a flax param tree: channels, layers
    and upsampling factor from the shapes (attn_splits is the public 2)."""
    tree = params.get("params", params)
    up = np.shape(tree["upsampler_2"]["kernel"])[-1]     # 9 factor^2
    return dict(
        feature_channels=np.shape(tree["backbone"]["conv2"]["kernel"])[-1],
        num_transformer_layers=sum(
            1 for k in tree["transformer"] if re.fullmatch(r"layers_\d+", k)),
        upsample_factor=int(round((up // 9) ** 0.5)))


def load_gmflow(params: dict, device="cuda") -> GMFlowPublic:
    """The ``GMFlowPublic`` of a flax param tree, float32 on ``device``,
    in eval mode."""
    from ..models.convert import gmflow_state_from_flax
    model = GMFlowPublic(**gmflow_config(params))
    model.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                           for k, v in gmflow_state_from_flax(params).items()})
    return model.to(device).eval()


def make_flow_fn(model: GMFlowPublic):
    """The orchestrator's ``flow_fn(a, b) -> (H', W', 2)`` (one direction;
    ``gmflow.correspondence_mask`` calls it both ways)."""

    @torch.no_grad()
    def fn(a, b):
        return model(a[None], b[None])[0]

    return fn
