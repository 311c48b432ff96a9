"""Image resize, range and metric helpers.

Counterpart of ``syn3r_tpu/utils/image.py`` (``gaussian_blur``,
``resize_bicubic``, ``resize_antialiased``, ``resize_cubic_antialiased``,
``resize_nearest``, ``resize_bilinear``, ``psnr``, ``ssim``, ``to_neg1_1``,
``to_01``). Images are channel-last (H, W, C) float tensors.

``resize_antialiased`` is a Gaussian pre-blur followed by a Keys (a=-0.75)
bicubic resize with align_corners=True, matching the reference's
``_resize_with_antialiasing``. ``F.interpolate(antialias=True)`` uses a
different filter and is not a substitute.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _gaussian_kernel1d(ksize: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(ksize, dtype=torch.float32, device=device) \
        - (ksize - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def gaussian_blur(img: torch.Tensor, ksize: tuple[int, int],
                  sigma: tuple[float, float]) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding. img: (H, W, C)."""
    ky, kx = ksize
    c = img.shape[-1]
    kyv = _gaussian_kernel1d(ky, sigma[0], img.device).to(img.dtype)
    kxv = _gaussian_kernel1d(kx, sigma[1], img.device).to(img.dtype)
    x = img.permute(2, 0, 1)[None]                       # (1, C, H, W)
    x = F.pad(x, (kx // 2, kx // 2, ky // 2, ky // 2), mode="reflect")
    x = F.conv2d(x, kxv.view(1, 1, 1, kx).expand(c, 1, 1, kx), groups=c)
    x = F.conv2d(x, kyv.view(1, 1, ky, 1).expand(c, 1, ky, 1), groups=c)
    return x[0].permute(1, 2, 0)


def _cubic_weights(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Keys weights of the taps at offsets (-1, 0, 1, 2) from floor(src)."""
    t2 = t * t
    t3 = t2 * t
    w0 = a * t3 - 2 * a * t2 + a * t
    w1 = (a + 2) * t3 - (a + 3) * t2 + 1
    w2 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w3 = -a * t3 + a * t2
    return torch.stack([w0, w1, w2, w3], dim=-1)


def _resize_axis_cubic(img: torch.Tensor, out_size: int,
                       axis: int) -> torch.Tensor:
    in_size = img.shape[axis]
    if out_size == in_size:
        return img
    if out_size == 1:
        src = torch.zeros((1,), dtype=torch.float32, device=img.device)
    else:
        src = torch.arange(out_size, dtype=torch.float32, device=img.device) \
            * (in_size - 1) / (out_size - 1)
    i0 = torch.floor(src)
    w = _cubic_weights(src - i0).to(img.dtype)          # (out, 4)
    idx = i0.long()[:, None] + torch.arange(-1, 3, device=img.device)
    idx = idx.clamp(0, in_size - 1)
    x = img.movedim(axis, 0)
    taken = x[idx.reshape(-1)].reshape((out_size, 4) + x.shape[1:])
    out = torch.einsum("ok,ok...->o...", w, taken)
    return out.movedim(0, axis)


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bicubic resize of (H, W, C), align_corners=True."""
    return _resize_axis_cubic(_resize_axis_cubic(img, out_h, 0), out_w, 1)


def resize_antialiased(img: torch.Tensor, out_h: int,
                       out_w: int) -> torch.Tensor:
    """Gaussian-prefiltered bicubic resize (CLIP preprocessing)."""
    h, w = img.shape[:2]
    fy, fx = h / out_h, w / out_w
    sy = max((fy - 1.0) / 2.0, 0.001)
    sx = max((fx - 1.0) / 2.0, 0.001)
    ky = int(max(4.0 * sy, 3))
    kx = int(max(4.0 * sx, 3))
    ky += (ky % 2 == 0)
    kx += (kx % 2 == 0)
    return resize_bicubic(gaussian_blur(img, (ky, kx), (sy, sx)), out_h, out_w)


def _interpolate_hwc(img: torch.Tensor, out_h: int, out_w: int,
                     **kw) -> torch.Tensor:
    """F.interpolate of a channel-last (H, W, C) or (B, H, W, C) image."""
    x = img.movedim(-1, -3)
    x = F.interpolate(x if x.dim() == 4 else x[None], size=(out_h, out_w),
                      **kw)
    return (x if img.dim() == 4 else x[0]).movedim(-3, -1)


def resize_cubic_antialiased(img: torch.Tensor, out_h: int,
                             out_w: int) -> torch.Tensor:
    """Antialiased Keys-cubic resize of (H, W, C) (PIL's default filter,
    which the reference uses to bring completed frames back to the GS
    resolution); ``jax.image.resize(..., "cubic", antialias=True)``
    computes the same filter."""
    return _interpolate_hwc(img, out_h, out_w, mode="bicubic",
                            antialias=True, align_corners=False)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of (H, W, C) or (B, H, W, C) at half-pixel centres
    (``jax.image.resize(..., "linear", antialias=antialias)``): with
    ``antialias`` a downscale widens the triangle filter by 1/scale, and
    weights that fall outside the image are dropped and the rest
    renormalized, as ``F.interpolate(antialias=True)`` does."""
    return _interpolate_hwc(img, out_h, out_w, mode="bilinear",
                            antialias=antialias, align_corners=False)


def resize_nearest(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of (H, W, C) with pixel-centre sampling
    (``jax.image.resize(..., "nearest")``; ``mode="nearest"`` of
    F.interpolate floors instead and differs)."""
    return _interpolate_hwc(img, out_h, out_w, mode="nearest-exact")


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return 20.0 * math.log10(max_val) \
        - 10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Gaussian-window SSIM (11x11, sigma 1.5, C1 = (0.01 L)^2,
    C2 = (0.03 L)^2), mean over pixels and channels. pred/target: (H, W, C).
    The window runs separably with ZERO padding, as the JAX package's
    ``ssim`` pads (not the reflection of ``gaussian_blur``)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    c = pred.shape[-1]
    r = window_size // 2
    g = _gaussian_kernel1d(window_size, sigma, pred.device).to(pred.dtype)
    wy = g.view(1, 1, window_size, 1).expand(5 * c, 1, window_size, 1)
    wx = g.view(1, 1, 1, window_size).expand(5 * c, 1, 1, window_size)
    x = torch.cat([pred, target, pred * pred, target * target,
                   pred * target], dim=-1).permute(2, 0, 1)[None]
    x = F.conv2d(F.pad(x, (0, 0, r, r)), wy, groups=5 * c)
    x = F.conv2d(F.pad(x, (r, r, 0, 0)), wx, groups=5 * c)
    mu_p, mu_t, mu_pp, mu_tt, mu_pt = x[0].split(c)
    var_p = mu_pp - mu_p ** 2
    var_t = mu_tt - mu_t ** 2
    cov = mu_pt - mu_p * mu_t
    s = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2))
    return s.mean()


def to_neg1_1(img01: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return img01 * 2.0 - 1.0


def to_01(img_pm1: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], clipped."""
    return torch.clamp(img_pm1 * 0.5 + 0.5, 0.0, 1.0)
