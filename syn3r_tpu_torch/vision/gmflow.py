"""Forward-backward flow consistency, and a GMFlow-style fallback net.

Counterpart of ``syn3r_tpu/vision/gmflow.py``. The reference uses flow in
one gate: the bidirectional flow between a frame and its GS render, the
pixels whose forward-backward cycle lands within 3 px, and the mean of
that mask against a threshold (``correspondence_mask``). ``GMFlow`` is the
JAX package's simplified global-matching net (GroupNorm CNN to 1/8, cross
transformer blocks, softmax matching, bilinear upsampling), its submodules
named as the flax ones so ``models.convert.load_flax_params`` loads it;
the public architecture is ``gmflow_public.GMFlowPublic``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grid_sample import sample_pixels
from ..ops.warp import pixel_grid
from ..utils.image import resize_bilinear

_EPS = 1e-6          # flax's GroupNorm and LayerNorm epsilon


def warp_flow(flow_bw: torch.Tensor, flow_fw: torch.Tensor) -> torch.Tensor:
    """The backward flow (H, W, 2) sampled bilinearly at the forward flow's
    targets (zeros outside)."""
    h, w = flow_fw.shape[:2]
    tgt = pixel_grid(h, w, device=flow_fw.device) + flow_fw
    return sample_pixels(flow_bw, tgt[..., 0], tgt[..., 1], mode="bilinear")


def fb_consistency_mask(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
                        dist_thresh: float = 3.0) -> torch.Tensor:
    """(H, W) bool: |f_fw(p) + f_bw(p + f_fw(p))| < dist_thresh."""
    cycle = torch.linalg.norm(flow_fw + warp_flow(flow_bw, flow_fw), dim=-1)
    return cycle < dist_thresh


def correspondence_mask(flow_fn, image_a: torch.Tensor,
                        image_b: torch.Tensor, dist_thresh: float = 3.0):
    """``flow_fn(a, b)`` both ways, the cycle-consistency mask and its mean
    (the frame-quality gate): (mask, (f_fw, f_bw), mean)."""
    f_fw = flow_fn(image_a, image_b)
    f_bw = flow_fn(image_b, image_a)
    mask = fb_consistency_mask(f_fw, f_bw, dist_thresh)
    return mask, (f_fw, f_bw), mask.float().mean()


# ---------------------------------------------------------------------------
# the fallback network
# ---------------------------------------------------------------------------

class ConvBlock(nn.Module):
    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, ch, 3, stride, padding=1)
        self.norm1 = nn.GroupNorm(8, ch, eps=_EPS)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(8, ch, eps=_EPS)
        self.short = (nn.Conv2d(cin, ch, 1, stride)
                      if cin != ch or stride != 1 else None)

    def forward(self, x):
        h = F.relu(self.norm1(self.conv1(x)))
        h = self.norm2(self.conv2(h))
        if self.short is not None:
            x = self.short(x)
        return F.relu(x + h)


class CNNBackbone(nn.Module):
    """(B, 3, H, W) -> (B, dim, ~H/8, ~W/8)."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.stem = nn.Conv2d(3, dim // 2, 7, 2, padding=3)
        self.b1 = ConvBlock(dim // 2, dim // 2)
        self.b2 = ConvBlock(dim // 2, dim, 2)
        self.b3 = ConvBlock(dim, dim, 2)

    def forward(self, x):
        return self.b3(self.b2(self.b1(F.relu(self.stem(x)))))


class CrossTransformerBlock(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.cross_q = nn.Linear(d, d)
        self.cross_k = nn.Linear(d, d)
        self.cross_v = nn.Linear(d, d)
        self.na1 = nn.LayerNorm(d, eps=_EPS)
        self.nb1 = nn.LayerNorm(d, eps=_EPS)
        self.na2 = nn.LayerNorm(d, eps=_EPS)
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)

    def forward(self, a, b):
        qa, kb = self.na1(a), self.nb1(b)
        q, k, v = self.cross_q(qa), self.cross_k(kb), self.cross_v(kb)
        w = torch.softmax((q @ k.transpose(1, 2)) * q.shape[-1] ** -0.5, -1)
        a2 = a + w @ v
        return a2 + self.fc2(F.gelu(self.fc1(self.na2(a2))))


class GMFlow(nn.Module):
    """``forward(a, b)`` on (B, H, W, 3) in [0, 1] -> flow (B, H, W, 2) in
    pixels: global matching at 1/8 resolution, scaled by 8 and bilinearly
    upsampled."""

    def __init__(self, dim: int = 128, num_blocks: int = 6):
        super().__init__()
        self.dim = dim
        self.num_blocks = num_blocks
        self.backbone = CNNBackbone(dim)
        for i in range(num_blocks):
            setattr(self, f"t{i}_a", CrossTransformerBlock(dim))
            setattr(self, f"t{i}_b", CrossTransformerBlock(dim))

    def forward(self, a, b):
        bsz, h, w, _ = a.shape

        def feats(img):
            f = self.backbone((img * 2.0 - 1.0).permute(0, 3, 1, 2))
            return f.flatten(2).transpose(1, 2), f.shape[2:]

        fa, (gh, gw) = feats(a)
        fb, _ = feats(b)
        for i in range(self.num_blocks):
            fa, fb = (getattr(self, f"t{i}_a")(fa, fb),
                      getattr(self, f"t{i}_b")(fb, fa))
        prob = torch.softmax((fa @ fb.transpose(1, 2)) / self.dim ** 0.5, -1)
        ys = torch.arange(gh, dtype=torch.float32,
                          device=a.device).repeat_interleave(gw)
        xs = torch.arange(gw, dtype=torch.float32, device=a.device).repeat(gh)
        flow = torch.stack([prob @ xs - xs, prob @ ys - ys], -1)
        return resize_bilinear(flow.reshape(bsz, gh, gw, 2) * 8.0, h, w)
