"""Differentiable Gaussian-splatting rasterizer.

Counterpart of ``syn3r_tpu/ops/rasterize.py``. ``project_gaussians`` is the
EWA projection; ``rasterize`` composites every Gaussian against every pixel
(the test oracle); ``rasterize_tiled`` is the production path: each 32x64
tile composites only the depth-sorted Gaussians whose 3-sigma screen box
meets it, at most ``cap`` of them (overflow drops the rearmost), in
tile-local pixel coordinates. Its composite is ``"kernel"``
(``ops/composite.composite_tiles``: the CUDA kernels on the card, their
plain versions on the CPU) or ``"plain"`` (the same chunk loop in torch,
differentiated by autograd: the JAX package's ``"xla"`` route).

The power of a Gaussian at pixel (x, y) is the bilinear form
[x^2, xy, y^2, x, y, 1] . G with G packed from the conic and centre.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.gaussians import GaussianState, covariance_3d, eval_sh
from ..utils.camera import Camera
from .composite import composite_fwd_reference, composite_tiles


class ScreenGaussians(NamedTuple):
    """Per-camera projected Gaussians (every slot; invalid ones zeroed)."""
    center: torch.Tensor   # (N, 2) pixel-space mean
    conic: torch.Tensor    # (N, 3) inverse 2D covariance (a, b, c)
    rgb: torch.Tensor      # (N, 3)
    depth: torch.Tensor    # (N,) camera-space z
    opacity: torch.Tensor  # (N,)
    radius: torch.Tensor   # (N,) 3-sigma screen radius (pixels)
    valid: torch.Tensor    # (N,) bool


class RenderOutput(NamedTuple):
    rgb: torch.Tensor      # (H, W, 3)
    depth: torch.Tensor    # (H, W) alpha-weighted accumulated depth
    alpha: torch.Tensor    # (H, W)


def project_gaussians(state: GaussianState, camera: Camera,
                      sh_degree: int = 3, near: float = 0.2,
                      center_offset: torch.Tensor | None = None
                      ) -> ScreenGaussians:
    """EWA projection with a 0.3 px dilation, the Jacobian clamped to 1.3x
    the frustum and a 3-sigma radius. ``center_offset`` (N, 2), normally
    zeros, lets a trainer take d(loss)/d(screen centre) for the densify
    statistics."""
    R = camera.w2c[:3, :3]
    tvec = camera.w2c[:3, 3]
    fx, fy = camera.K[0, 0], camera.K[1, 1]
    cx, cy = camera.K[0, 2], camera.K[1, 2]

    t = state.means @ R.T + tvec
    tz = t[:, 2]
    tz_safe = torch.where(tz.abs() < 1e-6, 1e-6, tz)
    u = fx * t[:, 0] / tz_safe + cx
    v = fy * t[:, 1] / tz_safe + cy
    center = torch.stack([u, v], dim=-1)
    if center_offset is not None:
        center = center + center_offset

    lim_x = 1.3 * 0.5 * camera.width / fx
    lim_y = 1.3 * 0.5 * camera.height / fy
    txz = torch.clamp(t[:, 0] / tz_safe, -lim_x, lim_x) * tz_safe
    tyz = torch.clamp(t[:, 1] / tz_safe, -lim_y, lim_y) * tz_safe
    zero = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([fx / tz_safe, zero, -fx * txz / tz_safe ** 2], dim=-1),
        torch.stack([zero, fy / tz_safe, -fy * tyz / tz_safe ** 2], dim=-1),
    ], dim=-2)                                                  # (N, 2, 3)
    T = J @ R                                                   # (N, 2, 3)
    sigma = covariance_3d(state.log_scales, state.quats)
    cov2d = T @ sigma @ T.transpose(1, 2)                       # (N, 2, 2)
    a = cov2d[:, 0, 0] + 0.3
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + 0.3

    det = a * c - b * b
    det_safe = torch.where(det <= 0, 1.0, det)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    dirs = state.means - camera.position
    dirs = dirs * torch.rsqrt((dirs * dirs).sum(-1, keepdim=True) + 1e-12)
    rgb = torch.clamp(eval_sh(state.sh, dirs, sh_degree) + 0.5, min=0.0)

    valid = state.active & (tz > near) & (det > 0)
    opacity = torch.where(valid, torch.sigmoid(state.opacity_logits[:, 0]),
                          0.0)
    return ScreenGaussians(center=center, conic=conic, rgb=rgb, depth=tz,
                           opacity=opacity, radius=radius, valid=valid)


def _packed_features(conic, center):
    """G rows (..., 6) of the power in pixel features:
    -0.5 [a dx^2 + 2b dx dy + c dy^2] = [x^2, xy, y^2, x, y, 1] . G."""
    a, b, c = conic.unbind(-1)
    gx, gy = center.unbind(-1)
    return torch.stack([
        -0.5 * a, -b, -0.5 * c, a * gx + b * gy, b * gx + c * gy,
        -0.5 * (a * gx * gx + 2.0 * b * gx * gy + c * gy * gy)], dim=-1)


def _matmul_features(sg: ScreenGaussians):
    """(G (N, 6), C (N, 5) [r, g, b, depth, 1]), zero for invalid slots
    (their opacity is 0, but 0 * exp(inf) would leak NaN)."""
    G = _packed_features(sg.conic, sg.center)
    C = torch.cat([sg.rgb, sg.depth[:, None],
                   torch.ones_like(sg.depth)[:, None]], dim=-1)
    v = sg.valid[:, None]
    return torch.where(v, G, 0.0), torch.where(v, C, 0.0)


def pixel_features(ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """[x^2, xy, y^2, x, y, 1] of pixel coordinates (P,) -> (P, 6)."""
    return torch.stack([xs * xs, xs * ys, ys * ys, xs, ys,
                        torch.ones_like(xs)], dim=-1)


def _depth_order(sg: ScreenGaussians) -> torch.Tensor:
    """Stable front-to-back order; invisible slots (inf depth) last, in
    slot order."""
    key = torch.where(sg.valid & (sg.opacity > 0), sg.depth.detach(),
                      math.inf)
    return torch.argsort(key, stable=True)


def _finish(rgb, depth, alpha, bg):
    if bg is not None:
        rgb = rgb + (1.0 - alpha[..., None]) * bg
    return RenderOutput(rgb=rgb, depth=depth, alpha=alpha)


def rasterize(sg: ScreenGaussians, height: int, width: int,
              bg: torch.Tensor | None = None, chunk: int = 256
              ) -> RenderOutput:
    """Full-frame rasterization: every Gaussian against every pixel, in
    chunks of ``chunk`` in depth order. bg: (3,) background colour."""
    n = sg.center.shape[0]
    dev = sg.center.device
    n_pad = -(-max(n, 1) // chunk) * chunk
    order = _depth_order(sg)
    G, C = _matmul_features(sg)

    def sorted_padded(x):
        return torch.cat([x[order], x.new_zeros((n_pad - n,) + x.shape[1:])])

    G, C = sorted_padded(G), sorted_padded(C)
    O = sorted_padded(sg.opacity)
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                         device=dev),
                            torch.arange(width, dtype=torch.float32,
                                         device=dev), indexing="ij")
    P = pixel_features(ys.reshape(-1), xs.reshape(-1)).T
    out, _ = composite_fwd_reference(P, G.T[None], C.T[None], O[None, None],
                                     chunk)
    rgb = out[0, 0:3].T.reshape(height, width, 3)
    depth = out[0, 3].reshape(height, width)
    alpha = (1.0 - torch.exp(out[0, 5])).reshape(height, width)
    return _finish(rgb, depth, alpha, bg)


class TileLists(NamedTuple):
    """The composite's inputs for one camera: pixel features P (6, px) and
    per-tile Gaussian lists G (T, 6, cap_p), C (T, 5, cap_p), O (T, 1, cap_p)
    in depth order, zero-padded from ``cap`` up to a multiple of K."""
    P: torch.Tensor
    G: torch.Tensor
    C: torch.Tensor
    O: torch.Tensor
    K: int


def bin_tiles(sg: ScreenGaussians, height: int, width: int,
              tile_h: int = 32, tile_w: int = 64, cap: int = 1024,
              chunk: int = 256) -> TileLists:
    """Depth-sort, bin into tiles and gather each tile's list.

    Stable depth argsort; the (T, N) hit mask of 3-sigma boxes against
    tiles; its inclusive cumsum per tile; slot s of tile t is the first
    sorted index where the cumsum reaches s + 1 (``searchsorted``, left
    side, clamped to N - 1). The binning is bookkeeping without gradients;
    gradients flow through the gathered features. K = min(chunk, cap, 128)
    as the JAX package's kernel route takes it.
    """
    n = sg.center.shape[0]
    dev = sg.center.device
    ty, tx = -(-height // tile_h), -(-width // tile_w)
    n_tiles = ty * tx
    order = _depth_order(sg)
    center_s = sg.center.detach()[order]
    radius_s = torch.where(sg.valid, sg.radius.detach(), 0.0)[order]
    valid_s = (sg.valid & (sg.opacity > 0))[order]

    tiles = torch.arange(n_tiles, device=dev)
    tx0 = ((tiles % tx) * tile_w).float()[:, None]
    ty0 = ((tiles // tx) * tile_h).float()[:, None]
    x0, x1 = center_s[:, 0] - radius_s, center_s[:, 0] + radius_s
    y0, y1 = center_s[:, 1] - radius_s, center_s[:, 1] + radius_s
    hit = (valid_s[None, :] & (x1[None, :] >= tx0)
           & (x0[None, :] < tx0 + tile_w)
           & (y1[None, :] >= ty0) & (y0[None, :] < ty0 + tile_h))

    cap = min(cap, n)
    cs = torch.cumsum(hit, dim=1)                              # (T, N)
    counts = cs[:, -1] if n else cs.new_zeros((n_tiles,))
    slots = torch.arange(1, cap + 1, device=dev).expand(n_tiles, cap)
    idx = torch.searchsorted(cs, slots.contiguous()).clamp_max(max(n - 1, 0))
    entry_ok = (torch.arange(cap, device=dev)[None, :]
                < torch.clamp(counts, max=cap)[:, None])

    G, C = _matmul_features(sg)
    feats = torch.cat([G, C, sg.opacity[:, None], sg.center], dim=-1)
    tF = torch.where(entry_ok[..., None], feats[order[idx]], 0.0)
    tF = tF.transpose(1, 2)                                    # (T, 14, cap)
    # rebuild G in tile-local coordinates (the power is translation
    # invariant, and local coordinates keep the pixel features small)
    conic = torch.stack([-2.0 * tF[:, 0], -tF[:, 1], -2.0 * tF[:, 2]], -1)
    local = torch.stack([tF[:, 12] - tx0, tF[:, 13] - ty0], -1)
    tG = _packed_features(conic, local).permute(0, 2, 1)      # (T, 6, cap)
    tC, tO = tF[:, 6:11], tF[:, 11:12]

    K = max(1, min(chunk, cap, 128))
    cap_p = -(-max(cap, 1) // K) * K
    if cap_p != cap:
        pad = (0, cap_p - cap)
        tG, tC, tO = (torch.nn.functional.pad(x, pad) for x in (tG, tC, tO))
    ys, xs = torch.meshgrid(torch.arange(tile_h, dtype=torch.float32,
                                         device=dev),
                            torch.arange(tile_w, dtype=torch.float32,
                                         device=dev), indexing="ij")
    P = pixel_features(ys.reshape(-1), xs.reshape(-1)).T.contiguous()
    return TileLists(P=P, G=tG.contiguous(), C=tC.contiguous(),
                     O=tO.contiguous(), K=K)


def rasterize_tiled(sg: ScreenGaussians, height: int, width: int,
                    tile_h: int = 32, tile_w: int = 64, cap: int = 1024,
                    chunk: int = 256, bg: torch.Tensor | None = None,
                    composite: str = "kernel") -> RenderOutput:
    """Tile-culled rasterization, the production path (see ``bin_tiles``).
    ``composite``: ``"kernel"`` (``composite_tiles``) or ``"plain"`` (the
    torch chunk loop of ``chunk`` entries, differentiated by autograd)."""
    tl = bin_tiles(sg, height, width, tile_h, tile_w, cap, chunk)
    if composite == "kernel":
        out = composite_tiles(tl.P, tl.G, tl.C, tl.O, tl.K)
    elif composite == "plain":
        k = max(1, min(chunk, tl.G.shape[2]))
        pad = (0, -tl.G.shape[2] % k)
        out, _ = composite_fwd_reference(
            tl.P, *(torch.nn.functional.pad(x, pad)
                    for x in (tl.G, tl.C, tl.O)), k)
    else:
        raise ValueError(f"unknown composite {composite!r}")
    ty, tx = -(-height // tile_h), -(-width // tile_w)
    img = torch.cat([out[:, 0:4], 1.0 - torch.exp(out[:, 5:6])], 1)
    img = img.reshape(ty, tx, 5, tile_h, tile_w).permute(0, 3, 1, 4, 2)
    img = img.reshape(ty * tile_h, tx * tile_w, 5)[:height, :width]
    return _finish(img[..., 0:3], img[..., 3], img[..., 4], bg)


def render(state: GaussianState, camera: Camera, sh_degree: int = 3,
           bg: torch.Tensor | None = None, near: float = 0.2,
           chunk: int = 256, center_offset: torch.Tensor | None = None,
           method: str = "dense", tile_cap: int = 1024) -> RenderOutput:
    """Project and rasterize in one call. method: ``"dense"`` (every
    Gaussian against every pixel, the oracle), ``"tiled"`` (culled, plain
    composite) or ``"kernel"`` (culled, the composite kernels)."""
    sg = project_gaussians(state, camera, sh_degree=sh_degree, near=near,
                           center_offset=center_offset)
    if method in ("tiled", "kernel"):
        return rasterize_tiled(sg, camera.height, camera.width, cap=tile_cap,
                               chunk=min(chunk, tile_cap), bg=bg,
                               composite="kernel" if method == "kernel"
                               else "plain")
    if method != "dense":
        raise ValueError(f"unknown render method {method!r}")
    return rasterize(sg, camera.height, camera.width, bg=bg, chunk=chunk)
