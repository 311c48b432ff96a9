"""Plain float32 reference of the GS refine's train step.

3D Gaussian Splatting (Kerbl et al., SIGGRAPH 2023) as FSGS trains it
(confidence-weighted pseudo views, the Pearson depth term) and SYN3R's
refine adds to it (the LPIPS term, ``reference/lpips.py``), written from
the published description and the port's documented rasterizer rules
(``syn3r_tpu_torch/ops/rasterize.py`` and ``ops/composite.py`` docstrings:
32x64 tiles, 3-sigma boxes, a tile cap whose overflow drops the rearmost,
alpha capped at 0.99 and cut below 1/255). Nothing here imports the program
under test. A state is a dict: the six parameter fields (``FIELDS``, stored
before activation: log-scales, opacity logits, raw wxyz quaternions,
flat SH rest), ``active``, Adam's ``mu`` and ``nu`` (dicts by field),
``count`` (Adam's steps), ``step`` (the iteration) and ``stats``
(``grad_accum``, ``denom``, ``max_radii``). A camera is a dict: ``K``
(3, 3), ``w2c`` (4, 4), ``width``, ``height``, ``confidence``.

Departures from the published method, each the port's documented rule:

- no transmittance stop: every list entry composites (the port's
  composite has none), and the pixel's alpha is 1 - exp(sum log(1 - a));
- the 2D covariance is dilated by 0.3 px, the Jacobian clamped to 1.3x
  the frustum, the radius ceil(3 sqrt(largest eigenvalue)) with the
  discriminant floored at 0.1, Gaussians nearer than z 0.2 dropped;
- a Gaussian's power is the bilinear form [x^2, xy, y^2, x, y, 1] . G in
  tile-local pixel coordinates (pixel centres on integers), taken as a
  matrix product: its rounding is the product's;
- SSIM pads with zeros (11x11, sigma 1.5);
- the densify statistic is |d loss / d screen centre| scaled to NDC
  (x W/2, y H/2), summed where the Gaussian is on screen; split samples are
  R (eps * scales) with the caller's standard-normal ``noise``; candidates
  (clones, then first and then second split samples, each in slot order)
  fill freed slots (pruned, split origins, never used) in slot order, and
  those beyond the free slots are dropped; written slots' Adam moments
  are zeroed; capacity doubles when more than ``capacity_growth_occupancy``
  of the slots are live after a densify.

The composite of one view runs in blocks of ``TILES_A_BLOCK`` tiles. Its
gradient is taken in two stages: autograd of the loss gives the image's
cotangent, then each block's composite is run again under autograd and
given its share of it, and the projected features' gradients are taken
back through the projection by autograd.

``Precision("tf32")`` is the control: every matrix product's and
convolution's operands rounded to TF32 (10 mantissa bits) and both of
torch's TF32 switches on; the default is float32 with both switches off.
LPIPS's convolutions take the same ``Precision``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import lpips as lp

TILE_H, TILE_W = 32, 64
ALPHA_MIN, ALPHA_MAX = 1.0 / 255.0, 0.99
NEAR = 0.2
DILATION = 0.3
FRUSTUM = 1.3
TILES_A_BLOCK = 8
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15
SPLIT_FACTOR = 1.6
FIELDS = ("means", "quats", "log_scales", "opacity_logits", "sh_dc",
          "sh_rest")
STATS = ("grad_accum", "denom", "max_radii")

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def _any(value) -> bool:
    return True


def _non_negative(value) -> bool:
    return (isinstance(value, (int, float)) and not isinstance(value, bool)
            and math.isfinite(value) and value >= 0)


# The train configuration's keys that this reference implements, each with
# the test of the values it implements: a key outside this table, or a
# value the test refuses, stops the run.
SUPPORTED = {
    "iterations": _any, "position_lr_init": _any, "position_lr_final": _any,
    "position_lr_max_steps": _any, "feature_lr": _any, "opacity_lr": _any,
    "scaling_lr": _any, "rotation_lr": _any, "lambda_dssim": _any,
    "svd_depth_warmup": _any, "depth_loss_weight": _any,
    "densify_from_iter": _any, "densify_until_iter": _any,
    "densification_interval": _any, "opacity_reset_interval": _any,
    "densify_grad_threshold": _any, "percent_dense": _any,
    "min_opacity": _any, "max_world_scale": _any, "max_screen_size": _any,
    "capacity_growth_occupancy": _any, "max_capacity": _any,
    "use_proximity_densify": lambda v: v is False,
    "sample_svd_pseudo_interval": _any, "start_sample_svd_iter": _any,
    "pseudo_cam_sampling_rate": _any,
    # both take the tile rules above; "dense" composites every Gaussian
    "rasterizer": lambda v: v in ("kernel", "tiled"),
    "tile_cap": lambda v: isinstance(v, int) and v >= 1,
    "sh_degree": lambda v: v in (0, 1, 2, 3),
    # the composite's chunk and the JAX scan's group change no value here;
    # the seed draws the view picks, which the reference is handed
    "chunk": _any, "group": _any, "seed": _any,
    "bg_color": lambda v: len(v) == 3,
    # the LPIPS term's weight; the term runs where LPIPS weights are given
    "lpips_weight": _non_negative,
}


def refuse_unknown(train: dict) -> None:
    """Raises ValueError naming the first key of ``train`` that this
    reference does not implement at its value."""
    for key, value in train.items():
        test = SUPPORTED.get(key)
        if test is None or not test(value):
            raise ValueError(f"the GS reference does not implement "
                             f"{key}={value!r}")


class Precision:
    """Rounding of matrix-product and convolution operands. ``None``:
    float32 as it is, TF32 off; ``"tf32"``: rounded to 10 mantissa bits
    (nearest, ties away from zero), TF32 on."""

    def __init__(self, kind: str | None = None):
        if kind not in (None, "tf32"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def switches(self) -> None:
        on = self.kind == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind is None:
            return t
        bits = t.detach().contiguous().view(torch.int32)
        rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return t + (rounded - t).detach()      # gradients pass unrounded

    def matmul(self, a, b):
        return torch.matmul(self(a), self(b))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Raw wxyz quaternions (N, 4), normalised (rsqrt(|q|^2 + 1e-12)), to
    rotation matrices (N, 3, 3)."""
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    rows = [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]
    return torch.stack(rows, -1).reshape(-1, 3, 3)


def sh_colour(sh: torch.Tensor, d: torch.Tensor, degree: int):
    """Real spherical harmonics (N, K, 3) along unit directions (N, 3),
    before the +0.5 offset."""
    out = SH_C0 * sh[:, 0]
    if degree < 1:
        return out
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
        - SH_C1 * x * sh[:, 3]
    if degree < 2:
        return out
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
           + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
           + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree < 3:
        return out
    return (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
            + SH_C3[1] * xy * z * sh[:, 10]
            + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
            + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
            + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
            + SH_C3[5] * z * (xx - yy) * sh[:, 14]
            + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])


def camera_centre(w2c: torch.Tensor) -> torch.Tensor:
    R, t = w2c[:3, :3], w2c[:3, 3]
    return -(R.T @ t)


def project(params: dict, active: torch.Tensor, cam: dict, degree: int,
            prec: Precision, offset: torch.Tensor | None = None) -> dict:
    """EWA projection of every slot: centre (N, 2) in pixels (plus
    ``offset``), conic (N, 3), colour (N, 3), depth (N,), opacity (N,; 0
    where not valid), radius (N,), valid (N,)."""
    R, tvec = cam["w2c"][:3, :3], cam["w2c"][:3, 3]
    K = cam["K"]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    t = prec.matmul(params["means"], R.T) + tvec
    tz = t[:, 2]
    z = torch.where(tz.abs() < 1e-6, 1e-6, tz)
    centre = torch.stack([fx * t[:, 0] / z + cx, fy * t[:, 1] / z + cy], -1)
    if offset is not None:
        centre = centre + offset
    lim_x = FRUSTUM * 0.5 * cam["width"] / fx
    lim_y = FRUSTUM * 0.5 * cam["height"] / fy
    tx = torch.clamp(t[:, 0] / z, -lim_x, lim_x) * z
    ty = torch.clamp(t[:, 1] / z, -lim_y, lim_y) * z
    zero = torch.zeros_like(z)
    J = torch.stack([torch.stack([fx / z, zero, -fx * tx / z ** 2], -1),
                     torch.stack([zero, fy / z, -fy * ty / z ** 2], -1)], -2)
    M = prec.matmul(J, R)                                       # (N, 2, 3)
    rot = quat_to_rotmat(params["quats"])
    rs = rot * torch.exp(params["log_scales"])[:, None, :]      # R S
    sigma = prec.matmul(rs, rs.transpose(1, 2))                 # R S S^T R^T
    cov = prec.matmul(prec.matmul(M, sigma), M.transpose(1, 2))
    a = cov[:, 0, 0] + DILATION
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + DILATION
    det = a * c - b * b
    det_s = torch.where(det <= 0, 1.0, det)
    conic = torch.stack([c / det_s, -b / det_s, a / det_s], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    d = params["means"] - camera_centre(cam["w2c"])
    d = d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-12)
    n = params["sh_dc"].shape[0]
    sh = torch.cat([params["sh_dc"], params["sh_rest"].reshape(n, -1, 3)], 1)
    colour = torch.clamp(sh_colour(sh, d, degree) + 0.5, min=0.0)
    valid = active & (tz > NEAR) & (det > 0)
    opacity = torch.where(valid, torch.sigmoid(params["opacity_logits"][:, 0]),
                          0.0)
    return {"centre": centre, "conic": conic, "colour": colour, "depth": tz,
            "opacity": opacity, "radius": radius, "valid": valid}


def tile_grid(height: int, width: int) -> tuple:
    return -(-height // TILE_H), -(-width // TILE_W)


def tile_lists(proj: dict, height: int, width: int, cap: int):
    """Each tile's entries: (ids (T, L) of slots in front-to-back order,
    zero-padded; counts (T,)). A slot enters a tile where it is valid, has
    opacity and its 3-sigma box meets the tile; the order is by depth,
    ties by slot; a tile keeps its first ``cap`` entries."""
    ty, tx = tile_grid(height, width)
    dev = proj["depth"].device
    live = proj["valid"] & (proj["opacity"] > 0)
    key = torch.where(live, proj["depth"].detach(), math.inf)
    order = torch.sort(key, stable=True).indices
    c = proj["centre"].detach()[order]
    r = torch.where(proj["valid"], proj["radius"].detach(), 0.0)[order]
    t = torch.arange(ty * tx, device=dev)
    x0 = ((t % tx) * TILE_W).float()[:, None]
    y0 = ((t // tx) * TILE_H).float()[:, None]
    hit = (live[order][None] & (c[None, :, 0] + r >= x0)
           & (c[None, :, 0] - r < x0 + TILE_W)
           & (c[None, :, 1] + r >= y0) & (c[None, :, 1] - r < y0 + TILE_H))
    hit &= torch.cumsum(hit, 1, dtype=torch.int32) <= cap
    counts = hit.sum(1)
    tile, pos = hit.nonzero(as_tuple=True)          # by tile, then depth
    width_l = max(int(counts.max()) if counts.numel() else 0, 1)
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(tile.numel(), device=dev) - start[tile]
    ids = torch.zeros((ty * tx, width_l), dtype=torch.long, device=dev)
    ids[tile, slot] = order[pos]
    return ids, counts


def pixel_features(device) -> torch.Tensor:
    """[x^2, xy, y^2, x, y, 1] of a tile's pixels, row-major (px, 6)."""
    y, x = torch.meshgrid(torch.arange(TILE_H, dtype=torch.float32,
                                       device=device),
                          torch.arange(TILE_W, dtype=torch.float32,
                                       device=device), indexing="ij")
    x, y = x.reshape(-1), y.reshape(-1)
    return torch.stack([x * x, x * y, y * y, x, y, torch.ones_like(x)], -1)


def tile_features(feat: dict, ids, counts, tiles: range, tx: int):
    """Of tiles ``tiles`` (B of them): the packed features G (B, 6, L) of
    each entry in tile-local pixel coordinates, opacities (B, L), colour
    and depth (B, L, 4), all zero past each tile's count."""
    dev = ids.device
    sel = torch.arange(tiles.start, tiles.stop, device=dev)
    idx = ids[sel]                                             # (B, L)
    ok = (torch.arange(idx.shape[1], device=dev)[None]
          < counts[sel][:, None])
    x0 = ((sel % tx) * TILE_W).float()[:, None]
    y0 = ((sel // tx) * TILE_H).float()[:, None]
    a, b, c = feat["conic"][idx].unbind(-1)
    gx = feat["centre"][idx][..., 0] - x0
    gy = feat["centre"][idx][..., 1] - y0
    G = torch.stack([-0.5 * a, -b, -0.5 * c, a * gx + b * gy,
                     b * gx + c * gy,
                     -0.5 * (a * gx * gx + 2.0 * b * gx * gy + c * gy * gy)],
                    1)
    G = torch.where(ok[:, None], G, 0.0)
    o = torch.where(ok, feat["opacity"][idx], 0.0)
    values = torch.cat([feat["colour"][idx], feat["depth"][idx][..., None]],
                       -1)
    return G, o, torch.where(ok[..., None], values, 0.0)


def composite_block(feat: dict, ids, counts, tiles: range, tx: int,
                    prec: Precision) -> torch.Tensor:
    """Tiles ``tiles``' pixels (B, px, 5): r, g, b, depth accumulated
    front to back and alpha, from the projected features ``feat``."""
    G, o, values = tile_features(feat, ids, counts, tiles, tx)
    power = prec.matmul(pixel_features(ids.device), G)         # (B, px, L)
    alpha = torch.clamp(o[:, None] * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)
    l1ma = torch.log1p(-alpha)
    w = alpha * torch.exp(torch.cumsum(l1ma, -1) - l1ma)
    acc = prec.matmul(w, values)                               # (B, px, 4)
    alpha_px = 1.0 - torch.exp(l1ma.sum(-1, keepdim=True))
    return torch.cat([acc, alpha_px], -1)


def blocks(n_tiles: int):
    for s in range(0, n_tiles, TILES_A_BLOCK):
        yield range(s, min(s + TILES_A_BLOCK, n_tiles))


def _image(tiles: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(T, px, C) tile pixels -> (H, W, C)."""
    ty, tx = tile_grid(height, width)
    ch = tiles.shape[-1]
    img = tiles.reshape(ty, tx, TILE_H, TILE_W, ch).permute(0, 2, 1, 3, 4)
    return img.reshape(ty * TILE_H, tx * TILE_W, ch)[:height, :width]


def _tiles(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(H, W, C) -> (T, px, C), zero past the frame."""
    ty, tx = tile_grid(height, width)
    ch = img.shape[-1]
    full = img.new_zeros((ty * TILE_H, tx * TILE_W, ch))
    full[:height, :width] = img
    full = full.reshape(ty, TILE_H, tx, TILE_W, ch).permute(0, 2, 1, 3, 4)
    return full.reshape(ty * tx, TILE_H * TILE_W, ch)


FEATURES = ("centre", "conic", "colour", "depth", "opacity")


def composite(feat: dict, ids, counts, height: int, width: int,
              prec: Precision) -> torch.Tensor:
    """The frame (H, W, 5), block by block (no gradient kept)."""
    ty, tx = tile_grid(height, width)
    with torch.no_grad():
        out = torch.cat([composite_block(feat, ids, counts, blk, tx, prec)
                         for blk in blocks(ty * tx)])
    return _image(out, height, width)


def render(params: dict, active, cam: dict, train: dict,
           prec: Precision | None = None) -> dict:
    """rgb (H, W, 3) over the background, depth (H, W) normalised by
    alpha (0 where alpha <= 1e-6) and alpha (H, W); no gradient."""
    prec = prec or Precision()
    h, w = cam["height"], cam["width"]
    with torch.no_grad():
        proj = project(params, active, cam, train["sh_degree"], prec)
        ids, counts = tile_lists(proj, h, w, train["tile_cap"])
        img = composite(proj, ids, counts, h, w, prec)
    return _outputs(img, train)


def _outputs(img: torch.Tensor, train: dict) -> dict:
    alpha = img[..., 4]
    bg = torch.tensor(train["bg_color"], dtype=torch.float32,
                      device=img.device)
    rgb = img[..., 0:3] + (1.0 - alpha[..., None]) * bg
    depth = torch.where(alpha > 1e-6,
                        img[..., 3] / torch.clamp(alpha, min=1e-6), 0.0)
    return {"rgb": rgb, "depth": depth, "alpha": alpha}


def ssim(pred: torch.Tensor, target: torch.Tensor, prec: Precision,
         size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of (H, W, C) images: Gaussian window, zero padding,
    C1 = 0.01^2, C2 = 0.03^2."""
    x = torch.arange(size, dtype=torch.float32, device=pred.device) \
        - (size - 1) / 2.0
    g = torch.exp(-x ** 2 / (2.0 * sigma ** 2))
    g = g / g.sum()
    c = pred.shape[-1]
    stack = torch.cat([pred, target, pred * pred, target * target,
                       pred * target], -1).permute(2, 0, 1)[None]
    r = size // 2
    wy = g.view(1, 1, size, 1).expand(5 * c, 1, size, 1)
    wx = g.view(1, 1, 1, size).expand(5 * c, 1, 1, size)
    stack = F.conv2d(prec(stack), prec(wy), padding=(r, 0), groups=5 * c)
    stack = F.conv2d(prec(stack), prec(wx), padding=(0, r), groups=5 * c)
    mp, mt, mpp, mtt, mpt = stack[0].split(c)
    vp, vt, cov = mpp - mp ** 2, mtt - mt ** 2, mpt - mp * mt
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mp * mt + c1) * (2 * cov + c2)) / (
        (mp ** 2 + mt ** 2 + c1) * (vp + vt + c2))
    return s.mean()


def pearson_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - Pearson correlation over the pixels where the target is > 0."""
    p, t = pred.reshape(-1), target.reshape(-1)
    v = (t > 0).to(p.dtype)
    n = v.sum().clamp_min(1.0)
    pc = (p - (p * v).sum() / n) * v
    tc = (t - (t * v).sum() / n) * v
    cov = (pc * tc).sum() / n
    return 1.0 - cov * torch.rsqrt((pc * pc).sum() / n * (tc * tc).sum() / n
                                   + 1e-12)


def view_loss(out: dict, view: dict, train: dict, prec: Precision,
              lpips: dict | None = None):
    """The camera's confidence x ((1 - l) L1 + l (1 - SSIM)); where LPIPS
    weights ``lpips`` are given, plus the confidence x ``lpips_weight`` x
    LPIPS(rgb, target); on a view with a depth target, plus
    ``depth_loss_weight`` x the Pearson term."""
    lam = train["lambda_dssim"]
    target = view["image"]
    conf = view["cam"]["confidence"]
    loss = conf * ((1.0 - lam) * (out["rgb"] - target).abs().mean()
                   + lam * (1.0 - ssim(out["rgb"], target, prec)))
    if lpips is not None:
        loss = loss + conf * train["lpips_weight"] * lp.distance(
            lpips, out["rgb"], target, prec)
    if view.get("depth") is not None:
        loss = loss + train["depth_loss_weight"] * pearson_loss(
            out["depth"], view["depth"])
    return loss


def loss_and_grads(params: dict, active, view: dict, train: dict,
                   prec: Precision, lpips: dict | None = None):
    """(loss, {field: gradient}, d loss / d screen centre (N, 2), the
    projection) of one view; ``lpips`` as ``view_loss`` takes it."""
    cam = view["cam"]
    h, w = cam["height"], cam["width"]
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    offset = torch.zeros_like(params["means"][:, :2], requires_grad=True)
    proj = project(leaves, active, cam, train["sh_degree"], prec, offset)
    ids, counts = tile_lists(proj, h, w, train["tile_cap"])
    feat = {k: proj[k].detach().requires_grad_(True) for k in FEATURES}
    img = composite(feat, ids, counts, h, w, prec).clone().requires_grad_(
        True)
    loss = view_loss(_outputs(img, train), view, train, prec, lpips)
    (d_img,) = torch.autograd.grad(loss, img)
    d_tiles = _tiles(d_img, h, w)
    ty, tx = tile_grid(h, w)
    for blk in blocks(ty * tx):
        out = composite_block(feat, ids, counts, blk, tx, prec)
        torch.autograd.backward(out, d_tiles[blk.start:blk.stop])
    back = [k for k in FEATURES if feat[k].grad is not None]
    torch.autograd.backward([proj[k] for k in back],
                            [feat[k].grad for k in back])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return loss.detach(), grads, offset.grad, proj


def position_lr(train: dict, extent: float, step: int) -> float:
    """The log-linear decay of the position learning rate, x extent."""
    t = min(max(step / train["position_lr_max_steps"], 0.0), 1.0)
    return extent * math.exp((1 - t) * math.log(train["position_lr_init"])
                             + t * math.log(train["position_lr_final"]))


def learning_rates(train: dict, extent: float, step: int) -> dict:
    f = train["feature_lr"]
    return {"means": position_lr(train, extent, step),
            "quats": train["rotation_lr"], "log_scales": train["scaling_lr"],
            "opacity_logits": train["opacity_lr"], "sh_dc": f,
            "sh_rest": f / 20.0}


def scene_extent(train_cams: list) -> float:
    """1.1 x the largest distance of a train camera from their mean."""
    pos = torch.stack([camera_centre(c["w2c"]) for c in train_cams]).double()
    return float(1.1 * (pos - pos.mean(0)).norm(dim=-1).max())


def train_step(state: dict, view: dict, train: dict, extent: float,
               prec: Precision | None = None, lpips: dict | None = None):
    """One step: (new state, loss, gradients). ``view``: ``cam``,
    ``image`` (H, W, 3), ``depth`` (H, W) or None; ``lpips``: the LPIPS
    weights (``reference/lpips.py``) where the step has that term."""
    prec = prec or Precision()
    loss, grads, g_off, proj = loss_and_grads(state["params"],
                                              state["active"], view, train,
                                              prec, lpips)
    cam = view["cam"]
    h, w = cam["height"], cam["width"]
    count = state["count"] + 1
    ic1 = 1.0 / (1.0 - ADAM_B1 ** count)
    ic2 = 1.0 / (1.0 - ADAM_B2 ** count)
    lrs = learning_rates(train, extent, state["step"])
    params, mu, nu = {}, {}, {}
    with torch.no_grad():
        for k in FIELDS:
            g = grads[k]
            mu[k] = ADAM_B1 * state["mu"][k] + (1 - ADAM_B1) * g
            nu[k] = ADAM_B2 * state["nu"][k] + (1 - ADAM_B2) * g * g
            params[k] = state["params"][k] - lrs[k] * (mu[k] * ic1) / (
                torch.sqrt(nu[k] * ic2) + ADAM_EPS)
        screen = torch.stack([g_off[:, 0] * (w * 0.5),
                              g_off[:, 1] * (h * 0.5)], -1)
        c, r = proj["centre"].detach(), proj["radius"]
        vis = (proj["valid"] & (r > 0) & (c[:, 0] > -r) & (c[:, 0] < w + r)
               & (c[:, 1] > -r) & (c[:, 1] < h + r)).float()
        st = state["stats"]
        stats = {"grad_accum": st["grad_accum"] + screen.norm(dim=-1) * vis,
                 "denom": st["denom"] + vis,
                 "max_radii": torch.maximum(st["max_radii"], r * vis)}
    new = dict(state, params=params, mu=mu, nu=nu, count=count,
               step=state["step"] + 1, stats=stats)
    return new, loss, grads


def densify(state: dict, noise: tuple, train: dict, extent: float,
            prec: Precision | None = None):
    """Clone, split and prune at fixed capacity: (new params, new active,
    written (N,) bool). ``noise``: the two (N, 3) standard-normal draws of
    the split samples."""
    prec = prec or Precision()
    p, active, st = state["params"], state["active"], state["stats"]
    avg = st["grad_accum"] / torch.clamp(st["denom"], min=1.0)
    scales = torch.exp(p["log_scales"])
    smax = scales.max(-1).values
    hot = active & (avg > train["densify_grad_threshold"])
    small = smax <= train["percent_dense"] * extent
    clone, split = hot & small, hot & ~small
    keep = active & ~split & (torch.sigmoid(p["opacity_logits"][:, 0])
                              > train["min_opacity"])
    if state["step"] > train["opacity_reset_interval"]:
        big = torch.zeros_like(keep)
        if train["max_world_scale"] is not None:
            big |= smax > train["max_world_scale"] * extent
        if train["max_screen_size"] is not None:
            big |= st["max_radii"] > train["max_screen_size"]
        keep &= ~big
    rot = quat_to_rotmat(p["quats"])
    samples = [p["means"] + prec.matmul(rot, (e * scales)[..., None])[..., 0]
               for e in noise]
    shrunk = p["log_scales"] - math.log(SPLIT_FACTOR)
    src_c = clone.nonzero()[:, 0]
    src_s = split.nonzero()[:, 0]
    src = torch.cat([src_c, src_s, src_s])
    free = (~keep).nonzero()[:, 0]
    n = min(src.numel(), free.numel())
    src, dst = src[:n], free[:n]
    kind = torch.cat([torch.zeros_like(src_c), torch.ones_like(src_s),
                      torch.full_like(src_s, 2)])[:n]
    new = {k: v.clone() for k, v in p.items()}
    for k in FIELDS:
        new[k][dst] = p[k][src]
    for j in (1, 2):
        rows = kind == j
        new["means"][dst[rows]] = samples[j - 1][src[rows]]
        new["log_scales"][dst[rows]] = shrunk[src[rows]]
    written = torch.zeros_like(active)
    written[dst] = True
    return new, keep | written, written


def after_densify(state: dict, params: dict, active, written) -> dict:
    """The state after a densify: written slots' moments zeroed, the
    statistics zeroed, Adam's count and the step kept."""
    def zero(x):
        return torch.where(written.reshape((-1,) + (1,) * (x.ndim - 1)),
                           0.0, x)
    return dict(state, params=params, active=active,
                mu={k: zero(v) for k, v in state["mu"].items()},
                nu={k: zero(v) for k, v in state["nu"].items()},
                stats={k: torch.zeros_like(v)
                       for k, v in state["stats"].items()})


def grow(state: dict, train: dict) -> dict:
    """Capacity doubled, with zero rows (inactive, zero moments) after the
    live ones, when more than ``capacity_growth_occupancy`` of the slots
    are live and the double fits ``max_capacity``; else the state."""
    cap = state["active"].shape[0]
    live = int(state["active"].sum())
    if live / cap <= train["capacity_growth_occupancy"] \
            or 2 * cap > train["max_capacity"]:
        return state

    def pad(x):
        return torch.cat([x, torch.zeros_like(x)])
    return dict(state, params={k: pad(v) for k, v in state["params"].items()},
                active=pad(state["active"]),
                mu={k: pad(v) for k, v in state["mu"].items()},
                nu={k: pad(v) for k, v in state["nu"].items()},
                stats={k: torch.zeros(2 * cap, device=v.device)
                       for k, v in state["stats"].items()})
