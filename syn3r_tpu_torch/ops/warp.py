"""Backward (gather) image warping with depth-consistency masks.

Counterpart of ``syn3r_tpu/ops/warp.py`` on the backward-warp path:
``pixel_grid``, ``consistency_check_with_depth`` (two-view cycle
reprojection error), ``inverse_warp`` (a source view gathered into a target
view through the target's rendered depth, with its eight masks) and
``downsample_mask_to_latent``. Images are channel-last (H, W, C) float32,
depths (H, W), poses 4x4 world->camera, intrinsics 3x3.

The reference's half-pixel quirks are kept: it normalizes grids as
``2x/W - 1`` or ``x/((W-1)/2) - 1`` but samples with align_corners=False,
so the effective sample positions are shifted; the same positions are
computed here.

Not ported: ``forward_warp``, ``bilinear_splat`` and ``dilate_mask``, used
only by ``--interp_type forward_warp``, which no shipped config runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.camera import project, transform_points, unproject
from .grid_sample import sample_pixels


def pixel_grid(h: int, w: int, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """(H, W, 2) grid of (x, y) pixel coordinates."""
    x = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    y = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    return torch.stack([x, y], dim=-1)


def consistency_check_with_depth(depth1: torch.Tensor, w2c1: torch.Tensor,
                                 K1: torch.Tensor, depth2: torch.Tensor,
                                 w2c2: torch.Tensor,
                                 K2: torch.Tensor) -> torch.Tensor:
    """Per-pixel cycle reprojection error of view 1: unproject depth1,
    move into view 2, sample depth2 there, rescale the ray to it, move
    back, project, distance to the original pixel."""
    h, w = depth1.shape
    pts1 = unproject(depth1, K1)
    pts2 = transform_points(pts1, w2c1, w2c2)
    uv2, _ = project(pts2, K2)
    # normalized by (w-1)/2, sampled with align_corners=False: the
    # effective pixel coordinate is x w / (w - 1) - 0.5
    sx = uv2[..., 0] * (w / (w - 1.0)) - 0.5
    sy = uv2[..., 1] * (h / (h - 1.0)) - 0.5
    d12 = sample_pixels(depth2[..., None], sx, sy, mode="bilinear")[..., 0]
    z2 = pts2[..., 2:]
    zsafe = torch.where(z2.abs() < 1e-8, torch.full_like(z2, 1e-8), z2)
    pts2_scaled = pts2 / zsafe * d12[..., None]
    pts1_cycle = transform_points(pts2_scaled, w2c2, w2c1)
    uv1, _ = project(pts1_cycle, K1)
    return torch.linalg.norm(uv1 - pixel_grid(h, w, depth1.dtype,
                                              depth1.device), dim=-1)


class InverseWarpResult(NamedTuple):
    warped_img: torch.Tensor        # (H, W, C) source gathered at target
    warped_depth: torch.Tensor      # (H, W) source depth gathered at target
    mask_warp: torch.Tensor         # (H, W) bool: reprojected inside source
    mask_depth: torch.Tensor        # (H, W) bool: depth agreement < 0.3
    mask_depth_strict: torch.Tensor  # (H, W) bool: < 0.1
    mask: torch.Tensor              # mask_warp & mask_depth
    mask_reproj: torch.Tensor       # (H, W) bool: cycle error < bandwidth
    soft_mask_reproj: torch.Tensor  # (H, W) float: exp(-(err/bandwidth)^3)


def inverse_warp(img: torch.Tensor, depth_src: torch.Tensor,
                 depth_dst: torch.Tensor, w2c_src: torch.Tensor,
                 w2c_dst: torch.Tensor, K: torch.Tensor,
                 bandwidth: float = 20.0) -> InverseWarpResult:
    """Backward-warp a source view to a target view through the target's
    rendered depth. img (H, W, C); depth_src, depth_dst (H, W); shared K."""
    h, w = depth_dst.shape
    pts_dst = unproject(depth_dst, K)
    pts_src = transform_points(pts_dst, w2c_dst, w2c_src)
    uv, _ = project(pts_src, K)
    x, y = uv[..., 0], uv[..., 1]

    # grid 2x/W - 1 sampled nearest with align_corners=False: the effective
    # coordinate is x - 0.5, i.e. floor(x)
    sx, sy = x - 0.5, y - 0.5
    warped_img = sample_pixels(img, sx, sy, mode="nearest")
    warped_depth = sample_pixels(depth_src[..., None], sx, sy,
                                 mode="nearest")[..., 0]
    mask_warp = (x >= 0) & (x < w) & (y >= 0) & (y < h)

    # depth agreement normalized by the warped depth's range over the whole
    # image, holes (zero depth) left out of the min
    nonzero = warped_depth > 0
    d_max = warped_depth.max()
    d_min = torch.where(nonzero, warped_depth,
                        torch.full_like(warped_depth, 1e4)).min()
    rng = torch.clamp(d_max - d_min, min=1e-12)
    norm_warped = torch.where(nonzero, (warped_depth - d_min) / rng,
                              torch.zeros_like(warped_depth))
    norm_dst = (depth_dst - d_min) / rng
    diff = (norm_warped - norm_dst).abs()
    mask_depth = diff < 0.3
    mask_depth_strict = diff < 0.1

    reproj_err = consistency_check_with_depth(depth_dst, w2c_dst, K,
                                              depth_src, w2c_src, K)
    return InverseWarpResult(
        warped_img=warped_img,
        warped_depth=torch.where(nonzero, warped_depth,
                                 torch.zeros_like(warped_depth)),
        mask_warp=mask_warp,
        mask_depth=mask_depth,
        mask_depth_strict=mask_depth_strict,
        mask=mask_warp & mask_depth,
        mask_reproj=(reproj_err < bandwidth) & mask_warp,
        soft_mask_reproj=torch.exp(-((reproj_err / bandwidth) ** 3)),
    )


def downsample_mask_to_latent(mask: torch.Tensor, lat_h: int,
                              lat_w: int) -> torch.Tensor:
    """Pixel-resolution mask -> latent-resolution mask by block means."""
    h, w = mask.shape
    fh, fw = h // lat_h, w // lat_w
    return mask.float().reshape(lat_h, fh, lat_w, fw).mean(dim=(1, 3))
