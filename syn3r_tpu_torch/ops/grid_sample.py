"""Image resampling (gather) with torch's grid_sample semantics.

Counterpart of ``syn3r_tpu/ops/grid_sample.py``: channel-last (H, W, C)
images sampled at float pixel coordinates or normalized grids, zeros
outside the image. Written as explicit gathers, as in JAX: nearest rounds
with ``floor(x + 0.5)`` (half away from zero at .5 ties for positive x),
which is not ``F.grid_sample``'s round-half-even.
"""

from __future__ import annotations

import torch


def _gather_2d(img: torch.Tensor, ix: torch.Tensor,
               iy: torch.Tensor) -> torch.Tensor:
    """img[(iy, ix)] (..., C) with zeros outside the image."""
    h, w = img.shape[:2]
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    out = img[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
    return torch.where(valid[..., None], out, torch.zeros((), dtype=img.dtype,
                                                          device=img.device))


def sample_pixels(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  mode: str = "bilinear") -> torch.Tensor:
    """Sample ``img`` (H, W, C) at float pixel coordinates x, y (...).
    Zeros outside the image. Returns (..., C)."""
    if mode == "nearest":
        return _gather_2d(img, torch.floor(x + 0.5).long(),
                          torch.floor(y + 0.5).long())
    if mode != "bilinear":
        raise ValueError(f"unknown mode {mode}")
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    v00 = _gather_2d(img, x0i, y0i)
    v01 = _gather_2d(img, x0i + 1, y0i)
    v10 = _gather_2d(img, x0i, y0i + 1)
    v11 = _gather_2d(img, x0i + 1, y0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                mode: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """``F.grid_sample`` semantics (zeros padding) on a channel-last image.
    img: (H, W, C); grid: (..., 2) normalized coordinates in [-1, 1],
    grid[..., 0] = x. Returns (..., C)."""
    h, w = img.shape[:2]
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        x = (gx + 1.0) * 0.5 * (w - 1)
        y = (gy + 1.0) * 0.5 * (h - 1)
    else:
        x = ((gx + 1.0) * w - 1.0) * 0.5
        y = ((gy + 1.0) * h - 1.0) * 0.5
    return sample_pixels(img, x, y, mode=mode)
