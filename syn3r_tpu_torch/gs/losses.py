"""Photometric and depth losses of the GS fit.

Counterpart of ``syn3r_tpu/gs/losses.py``:
(1 - lambda_dssim) L1 + lambda_dssim (1 - SSIM), scaled by the per-camera
confidence, and the Pearson depth loss of the SVD pseudo views. The LPIPS
term is not ported (it needs VGG weights; see ``gs/trainer.py``).
"""

from __future__ import annotations

import torch

from ..utils.image import ssim


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def dssim_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - SSIM (11x11 Gaussian window)."""
    return 1.0 - ssim(pred, target)


def photometric_loss(pred: torch.Tensor, target: torch.Tensor,
                     lambda_dssim: float = 0.2,
                     confidence: torch.Tensor | float = 1.0) -> torch.Tensor:
    loss = (1.0 - lambda_dssim) * l1_loss(pred, target) \
        + lambda_dssim * dssim_loss(pred, target)
    return confidence * loss


def pearson_depth_loss(pred_depth: torch.Tensor, target_depth: torch.Tensor,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """1 - Pearson correlation of rendered and target depth over ``valid``
    pixels (scale- and shift-invariant); finite on an all-invalid mask."""
    p = pred_depth.reshape(-1)
    t = target_depth.reshape(-1)
    v = (valid.reshape(-1).to(p.dtype) if valid is not None
         else torch.ones_like(p))
    n = v.sum().clamp_min(1.0)
    pm = (p * v).sum() / n
    tm = (t * v).sum() / n
    pc = (p - pm) * v
    tc = (t - tm) * v
    cov = (pc * tc).sum() / n
    var_p = (pc * pc).sum() / n
    var_t = (tc * tc).sum() / n
    return 1.0 - cov * torch.rsqrt(var_p * var_t + 1e-12)
