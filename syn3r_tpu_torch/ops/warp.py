"""Image warping: forward (splat) and backward (gather), with
depth-consistency masks.

Counterpart of ``syn3r_tpu/ops/warp.py``: ``pixel_grid``,
``bilinear_splat`` and ``forward_warp`` (a source view splatted into a
target view with a soft z-buffer, the ``--interp_type forward_warp``
conditioning), ``consistency_check_with_depth`` (two-view cycle
reprojection error), ``inverse_warp`` (a source view gathered into a target
view through the target's rendered depth, with its eight masks),
``dilate_mask`` and ``downsample_mask_to_latent``. Images are channel-last
(H, W, C) float32, depths (H, W), poses 4x4 world->camera, intrinsics 3x3.

The reference's half-pixel quirks are kept: it normalizes grids as
``2x/W - 1`` or ``x/((W-1)/2) - 1`` but samples with align_corners=False,
so the effective sample positions are shifted; the same positions are
computed here.

The splat is a scatter-add (``index_put_`` with ``accumulate``): on the
card its float atomics sum in an order that varies from run to run, so its
output is reproducible to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils.camera import project, transform_points, unproject
from .grid_sample import sample_pixels


def pixel_grid(h: int, w: int, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """(H, W, 2) grid of (x, y) pixel coordinates."""
    x = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    y = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    return torch.stack([x, y], dim=-1)


def bilinear_splat(frame: torch.Tensor, depth: torch.Tensor,
                   flow: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   depth_weight_scale: float = 50.0,
                   max_depth: float = 5000.0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depth-weighted bilinear splatting of ``frame`` (H, W, C) along
    ``flow`` (H, W, 2): each source pixel goes to the 4 integer neighbours
    of its target position (in a 1-pixel border, clipped to it) with
    bilinear weights divided by exp(log1p(z) / max log1p(z) x 50), a soft
    z-buffer; the sums are normalized. ``depth`` (H, W) is each source
    pixel's depth in the target frame. Returns (warped (H, W, C), valid
    (H, W) bool)."""
    h, w, c = frame.shape
    pos = pixel_grid(h, w, frame.dtype, frame.device) + flow + 1.0
    x0, y0 = torch.floor(pos[..., 0]), torch.floor(pos[..., 1])
    # ceil as np.ceil: equal to floor at integral positions, not floor + 1
    x1, y1 = torch.ceil(pos[..., 0]), torch.ceil(pos[..., 1])
    px = torch.clamp(pos[..., 0], 0, w + 1)
    py = torch.clamp(pos[..., 1], 0, h + 1)
    x0c, x1c = (torch.clamp(v, 0, w + 1).long() for v in (x0, x1))
    y0c, y1c = (torch.clamp(v, 0, h + 1).long() for v in (y0, y1))

    w_nw = (1 - (py - y0c)) * (1 - (px - x0c))
    w_sw = (1 - (y1c - py)) * (1 - (px - x0c))
    w_ne = (1 - (py - y0c)) * (1 - (x1c - px))
    w_se = (1 - (y1c - py)) * (1 - (x1c - px))

    logd = torch.log1p(torch.clamp(depth, 0.0, max_depth))
    zw = torch.exp(logd / torch.clamp(logd.max(), min=1e-12)
                   * depth_weight_scale)
    m = (torch.ones((h, w), dtype=frame.dtype, device=frame.device)
         if mask is None else mask.to(frame.dtype))
    base = m / zw

    acc_img = frame.new_zeros(((h + 2) * (w + 2), c), dtype=torch.float32)
    acc_w = frame.new_zeros(((h + 2) * (w + 2),), dtype=torch.float32)
    src = frame.float().reshape(-1, c)
    for wt, yy, xx in ((w_nw, y0c, x0c), (w_sw, y1c, x0c),
                       (w_ne, y0c, x1c), (w_se, y1c, x1c)):
        wgt = (wt * base).float().reshape(-1)
        flat = (yy * (w + 2) + xx).reshape(-1)
        acc_img.index_put_((flat,), src * wgt[:, None], accumulate=True)
        acc_w.index_put_((flat,), wgt, accumulate=True)

    img = acc_img.reshape(h + 2, w + 2, c)[1:-1, 1:-1]
    wsum = acc_w.reshape(h + 2, w + 2)[1:-1, 1:-1]
    valid = wsum > 0
    out = torch.where(valid[..., None],
                      img / torch.where(valid, wsum, 1.0)[..., None], 0.0)
    return out.to(frame.dtype), valid


def forward_warp(frame: torch.Tensor, depth: torch.Tensor,
                 w2c_src: torch.Tensor, w2c_dst: torch.Tensor,
                 K_src: torch.Tensor, K_dst: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None):
    """Splat ``frame`` from the source camera to the destination camera
    through the source ``depth``. Returns (warped, valid, flow)."""
    if K_dst is None:
        K_dst = K_src
    pts_dst = transform_points(unproject(depth, K_src), w2c_src, w2c_dst)
    uv, z = project(pts_dst, K_dst)
    flow = uv - pixel_grid(*depth.shape, frame.dtype, frame.device)
    warped, valid = bilinear_splat(frame, z, flow, mask=mask)
    return warped, valid, flow


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


def dilate_mask(mask: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Binary dilation with a size x size square (a max pool whose padding
    acts as -inf, as ``reduce_window``'s does)."""
    m = mask.float()[None, None]
    return F.max_pool2d(m, size, stride=1, padding=size // 2)[0, 0] > 0.5


def downsample_mask_to_latent(mask: torch.Tensor, lat_h: int,
                              lat_w: int) -> torch.Tensor:
    """Pixel-resolution mask -> latent-resolution mask by block means."""
    h, w = mask.shape
    fh, fw = h // lat_h, w // lat_w
    return mask.float().reshape(lat_h, fh, lat_w, fw).mean(dim=(1, 3))
