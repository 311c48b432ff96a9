"""Differentiable Gaussian-splatting rasterizer.

Counterpart of ``syn3r_tpu/ops/rasterize.py``. ``project_gaussians`` is the
EWA projection with the SH colour, an autograd Function: on CUDA tensors
the hand-written kernels of ``csrc/project.cu`` (one forward and one
backward launch, counted in ``launches.project_fwd`` and
``launches.project_bwd``; a CUDA tensor never falls back), on CPU tensors
the plain forward ``project_gaussians_reference`` and the plain mirror of
the backward kernel, ``project_bwd_reference``. ``rasterize`` composites
every Gaussian against every pixel (the test oracle); ``rasterize_tiled``
is the production path: each 32x64 tile composites only the depth-sorted
Gaussians whose 3-sigma screen box meets it, at most ``cap`` of them
(overflow drops the rearmost), in tile-local pixel coordinates. Its
composite is ``"kernel"`` (``ops/composite.composite_tiles``: the CUDA
kernels on the card, their plain versions on the CPU) or ``"plain"`` (the
same chunk loop in torch, differentiated by autograd: the JAX package's
``"xla"`` route).

The power of a Gaussian at pixel (x, y) is the bilinear form
[x^2, xy, y^2, x, y, 1] . G with G packed from the conic and centre.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels import build
from ..models.gaussians import (PARAM_FIELDS, SH_C0, SH_C1, SH_C2, SH_C3,
                                GaussianState, covariance_3d, eval_sh,
                                quat_to_rotmat)
from ..utils.camera import Camera
from ..utils.profiling import counters
from .composite import composite_fwd_reference, composite_tiles

# the projection kernels' sh_rest rows: at most SH degree 3
MAX_SH_REST = 45


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


def project_gaussians_reference(state: GaussianState, camera: Camera,
                                sh_degree: int = 3, near: float = 0.2,
                                center_offset: torch.Tensor | None = None
                                ) -> ScreenGaussians:
    """Plain torch ``project_gaussians``, differentiable by autograd: the
    forward of ``_Project`` on CPU tensors, and what the kernel is held
    to."""
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


def _sh_basis(dn: torch.Tensor, degree: int) -> torch.Tensor:
    """The real SH basis (N, (degree + 1)^2) along unit dirs dn (N, 3), with
    ``eval_sh``'s constants: eval_sh = sum_k basis_k sh_k."""
    x, y, z = dn.unbind(-1)
    b = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        b += [-(SH_C1 * y), SH_C1 * z, -(SH_C1 * x)]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        b += [SH_C2[0] * (x * y), SH_C2[1] * (y * z),
              SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * (x * z),
              SH_C2[4] * (xx - yy)]
    if degree >= 3:
        b += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * (x * y) * z,
              SH_C3[2] * y * (4 * zz - xx - yy),
              SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
              SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
              SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(b, -1)


def _sh_basis_grad(dn: torch.Tensor, degree: int) -> torch.Tensor:
    """d basis_k / d dn, (N, (degree + 1)^2, 3)."""
    x, y, z = dn.unbind(-1)
    o = torch.zeros_like(x)
    g = [(o, o, o)]
    if degree >= 1:
        c = SH_C1
        g += [(o, o - c, o), (o, o, o + c), (o - c, o, o)]
    if degree >= 2:
        c = SH_C2
        g += [(c[0] * y, c[0] * x, o), (o, c[1] * z, c[1] * y),
              (-2 * c[2] * x, -2 * c[2] * y, 4 * c[2] * z),
              (c[3] * z, o, c[3] * x), (2 * c[4] * x, -2 * c[4] * y, o)]
    if degree >= 3:
        c = SH_C3
        xx, yy, zz = x * x, y * y, z * z
        g += [(6 * c[0] * x * y, c[0] * (3 * xx - 3 * yy), o),
              (c[1] * y * z, c[1] * x * z, c[1] * x * y),
              (-2 * c[2] * x * y, c[2] * (4 * zz - xx - 3 * yy),
               8 * c[2] * y * z),
              (-6 * c[3] * x * z, -6 * c[3] * y * z,
               c[3] * (6 * zz - 3 * xx - 3 * yy)),
              (c[4] * (4 * zz - 3 * xx - yy), -2 * c[4] * x * y,
               8 * c[4] * x * z),
              (2 * c[5] * x * z, -2 * c[5] * y * z, c[5] * (xx - yy)),
              (c[6] * (3 * xx - 3 * yy), -6 * c[6] * x * y, o)]
    return torch.stack([torch.stack(row, -1) for row in g], 1)


def project_bwd_reference(state: GaussianState, camera: Camera, g_center,
                          g_conic, g_rgb, g_depth, g_opacity,
                          sh_degree: int = 3, near: float = 0.2) -> dict:
    """Plain torch mirror of the backward kernel: the gradients of every
    parameter field (``PARAM_FIELDS``, in their layouts) from those of the
    projection's centre (N, 2), conic (N, 3), rgb (N, 3), depth (N,) and
    opacity (N,), each None for zero. It recomputes the forward from the
    parameters and applies autograd's rules through
    ``project_gaussians_reference`` by hand: the clamps pass the gradient
    on their inclusive bounds, the ``where`` of tz_safe, det_safe and valid
    none to the side not taken, radius none. (The centre offset's gradient
    is ``g_center``.)"""
    m, q = state.means, state.quats
    n = m.shape[0]

    def given(g, *shape):
        return m.new_zeros((n,) + shape) if g is None else g

    g_center, g_conic, g_rgb = (given(g_center, 2), given(g_conic, 3),
                                given(g_rgb, 3))
    g_depth, g_opacity = given(g_depth), given(g_opacity)
    R = camera.w2c[:3, :3]
    fx, fy = camera.K[0, 0], camera.K[1, 1]
    t = m @ R.T + camera.w2c[:3, 3]
    tz = t[:, 2]
    kept = ~(tz.abs() < 1e-6)
    tzs = torch.where(kept, tz, 1e-6)
    lim_x = 1.3 * 0.5 * camera.width / fx
    lim_y = 1.3 * 0.5 * camera.height / fy
    rx, ry = t[:, 0] / tzs, t[:, 1] / tzs
    rx_in = (rx >= -lim_x) & (rx <= lim_x)
    ry_in = (ry >= -lim_y) & (ry <= lim_y)
    crx = torch.clamp(rx, -lim_x, lim_x)
    cry = torch.clamp(ry, -lim_y, lim_y)
    tz2 = tzs * tzs
    j02 = -fx * (crx * tzs) / tz2
    j12 = -fy * (cry * tzs) / tz2
    T = torch.stack([(fx / tzs)[:, None] * R[0] + j02[:, None] * R[2],
                     (fy / tzs)[:, None] * R[1] + j12[:, None] * R[2]], 1)
    qr = torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    rq = quat_to_rotmat(q)
    s2 = torch.exp(2.0 * state.log_scales)
    sig = torch.einsum("nij,nj,nkj->nik", rq, s2, rq)
    M = T @ sig                                                # (N, 2, 3)
    a = (M[:, 0] * T[:, 0]).sum(-1) + 0.3
    b = (M[:, 0] * T[:, 1]).sum(-1)
    c = (M[:, 1] * T[:, 1]).sum(-1) + 0.3
    det = a * c - b * b
    pos = det > 0
    ds = torch.where(pos, det, 1.0)

    # opacity = sigmoid(logit) where valid
    valid = state.active & (tz > near) & pos
    sg = torch.sigmoid(state.opacity_logits[:, 0])
    d_ol = torch.where(valid, g_opacity * (1.0 - sg) * sg, 0.0)[:, None]

    # colour: rgb = max(SH(dn) + 0.5, 0), dn = d / |d|
    d = m - camera.position
    r = torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-12)
    dn = d * r
    kc = (sh_degree + 1) ** 2
    sh = state.sh[:, :kc]
    ge = torch.where(eval_sh(state.sh, dn, sh_degree) + 0.5 >= 0, g_rgb, 0.0)
    basis = _sh_basis(dn, sh_degree)
    d_sh = ge[:, None, :] * basis[..., None]                   # (N, kc, 3)
    wk = (ge[:, None, :] * sh).sum(-1)                         # (N, kc)
    gdn = (wk[..., None] * _sh_basis_grad(dn, sh_degree)).sum(1)
    dm = r * gdn - r ** 3 * (gdn * d).sum(-1, keepdim=True) * d

    # conic = (c, -b, a) / det_safe
    gk0, gk1, gk2 = g_conic.unbind(-1)
    ddet = torch.where(pos, -(gk0 * (c / ds) + gk1 * (-b / ds)
                              + gk2 * (a / ds)) / ds, 0.0)
    da = gk2 / ds + c * ddet
    db = -gk1 / ds - 2.0 * b * ddet
    dc = gk0 / ds + a * ddet
    # (a, b, c) = (M0 . T0, M0 . T1, M1 . T1), M = T Sigma
    dM = torch.stack([da[:, None] * T[:, 0] + db[:, None] * T[:, 1],
                      dc[:, None] * T[:, 1]], 1)
    dT = torch.stack([da[:, None] * M[:, 0],
                      db[:, None] * M[:, 0] + dc[:, None] * M[:, 1]], 1)
    dT = dT + dM @ sig.transpose(1, 2)
    dsig = T.transpose(1, 2) @ dM
    # Sigma = Rq diag(s2) Rq^T
    GR = (dsig + dsig.transpose(1, 2)) @ rq
    drq = (GR * s2[:, None, :]).reshape(n, 9)
    d_ls = 2.0 * s2 * (0.5 * (rq * GR).sum(1))
    w, x, y, z = (q * qr).unbind(-1)
    e = drq.unbind(-1)
    dqn = 2.0 * torch.stack([
        -z * e[1] + y * e[2] + z * e[3] - x * e[5] - y * e[6] + x * e[7],
        y * e[1] + z * e[2] + y * e[3] - 2 * x * e[4] - w * e[5] + z * e[6]
        + w * e[7] - 2 * x * e[8],
        -2 * y * e[0] + x * e[1] + w * e[2] + x * e[3] + z * e[5] - w * e[6]
        + z * e[7] - 2 * y * e[8],
        -2 * z * e[0] - w * e[1] + x * e[2] + w * e[3] - 2 * z * e[4]
        + y * e[5] + x * e[6] + y * e[7]], -1)
    d_q = qr * dqn - qr ** 3 * (dqn * q).sum(-1, keepdim=True) * q

    # T = J R; J's entries fx / tz, (-fx txz) / tz^2, fy / tz, (-fy tyz) / tz^2
    dj00, dj02 = (dT[:, 0] * R[0]).sum(-1), (dT[:, 0] * R[2]).sum(-1)
    dj11, dj12 = (dT[:, 1] * R[1]).sum(-1), (dT[:, 1] * R[2]).sum(-1)
    dtxz, dtyz = -fx * (dj02 / tz2), -fy * (dj12 / tz2)
    dtzs = (-(dj00 * fx + dj11 * fy) / tz2
            - 2.0 * tzs * (dj02 * j02 + dj12 * j12) / tz2
            + dtxz * crx + dtyz * cry)
    # txz = clamp(tx / tz_safe) tz_safe
    drx = torch.where(rx_in, dtxz * tzs, 0.0)
    dry = torch.where(ry_in, dtyz * tzs, 0.0)
    gu, gv = g_center.unbind(-1)
    dt0 = drx / tzs + fx * (gu / tzs)
    dt1 = dry / tzs + fy * (gv / tzs)
    dtzs = dtzs - (drx * t[:, 0] + dry * t[:, 1]) / tz2 \
        - (gu * (fx * t[:, 0]) + gv * (fy * t[:, 1])) / tz2
    dt = torch.stack([dt0, dt1, torch.where(kept, dtzs, 0.0) + g_depth], -1)

    d_rest = torch.zeros_like(state.sh_rest)
    d_rest[:, :3 * (kc - 1)] = d_sh[:, 1:].reshape(n, -1)
    return {"means": dm + dt @ R, "quats": d_q, "log_scales": d_ls,
            "opacity_logits": d_ol, "sh_dc": d_sh[:, :1].contiguous(),
            "sh_rest": d_rest}


def _project_check(state: GaussianState, camera: Camera, sh_degree: int,
                   extra=()):
    """Raises on what the kernels do not take: CUDA tensors on one card,
    float32 (active bool), contiguous, the state's layout, an SH degree of
    0 to 3 within sh_rest's rows of at most 45."""
    n = state.means.shape[0]
    rest = state.sh_rest.shape[1] if state.sh_rest.dim() == 2 else -1
    dev = state.means.device
    if not 0 <= sh_degree <= 3 or rest % 3 or not \
            3 * ((sh_degree + 1) ** 2 - 1) <= rest <= MAX_SH_REST:
        raise ValueError(f"projection kernel: SH degree {sh_degree} with "
                         f"sh_rest rows of {rest} (at most {MAX_SH_REST})")
    shapes = {"means": (3,), "quats": (4,), "log_scales": (3,),
              "opacity_logits": (1,), "sh_dc": (1, 3), "sh_rest": (rest,)}
    items = [(f, getattr(state, f), (n,) + s) for f, s in shapes.items()]
    items += [("active", state.active, (n,)), ("w2c", camera.w2c, (4, 4)),
              ("K", camera.K, (3, 3)), *extra]
    for name, x, shape in items:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"projection kernel: {name} on {x.device}, "
                             f"means on {dev}")
        want = torch.bool if name == "active" else torch.float32
        if x.dtype != want:
            raise TypeError(f"projection kernel: {name} is {x.dtype}, "
                            f"expected {want}")
        if tuple(x.shape) != shape:
            raise ValueError(f"projection kernel: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"projection kernel: {name} is not contiguous")
    if state.quats.data_ptr() % 16:
        raise ValueError("projection kernel: quats not 16-byte aligned")


def _camera_args(camera: Camera, near: float):
    return (1.3 * 0.5 * camera.width, 1.3 * 0.5 * camera.height, near)


def project_fwd_launch(state: GaussianState, camera: Camera,
                       sh_degree: int = 3, near: float = 0.2,
                       center_offset: torch.Tensor | None = None
                       ) -> ScreenGaussians:
    """Launches the forward kernel on CUDA tensors (on the state's card,
    its current stream): ``project_gaussians_reference``'s outputs."""
    n = state.means.shape[0]
    extra = [] if center_offset is None else [
        ("center_offset", center_offset, (n, 2))]
    _project_check(state, camera, sh_degree, extra)
    dev = state.means.device
    f32 = dict(dtype=torch.float32, device=dev)
    sg = ScreenGaussians(
        center=torch.empty((n, 2), **f32), conic=torch.empty((n, 3), **f32),
        rgb=torch.empty((n, 3), **f32), depth=torch.empty((n,), **f32),
        opacity=torch.empty((n,), **f32), radius=torch.empty((n,), **f32),
        valid=torch.empty((n,), dtype=torch.bool, device=dev))
    if n == 0:
        return sg
    with torch.cuda.device(dev):
        err = build.entry("project", "syn3r_project_fwd")(
            *(getattr(state, f).data_ptr() for f in PARAM_FIELDS),
            state.active.data_ptr(),
            None if center_offset is None else center_offset.data_ptr(),
            camera.w2c.data_ptr(), camera.K.data_ptr(),
            *(x.data_ptr() for x in sg), n, state.sh_rest.shape[1],
            sh_degree, *_camera_args(camera, near),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"project_fwd kernel launch failed: cudaError "
                           f"{err}")
    counters["launches.project_fwd"] += 1
    return sg


def project_bwd_launch(state: GaussianState, camera: Camera, g_center,
                       g_conic, g_rgb, g_depth, g_opacity,
                       sh_degree: int = 3, near: float = 0.2) -> dict:
    """Launches the backward kernel on CUDA tensors: the gradients of every
    parameter field, as ``project_bwd_reference`` gives them (an output
    gradient may be None)."""
    n = state.means.shape[0]
    grads = [("g_center", g_center, (n, 2)), ("g_conic", g_conic, (n, 3)),
             ("g_rgb", g_rgb, (n, 3)), ("g_depth", g_depth, (n,)),
             ("g_opacity", g_opacity, (n,))]
    grads = [(name, g.contiguous(), shape) for name, g, shape in grads
             if g is not None]
    _project_check(state, camera, sh_degree, grads)
    out = {f: torch.empty_like(getattr(state, f)) for f in PARAM_FIELDS}
    if n == 0:
        return out
    given = {name: g for name, g, _ in grads}
    dev = state.means.device
    with torch.cuda.device(dev):
        err = build.entry("project", "syn3r_project_bwd")(
            *(getattr(state, f).data_ptr() for f in PARAM_FIELDS),
            state.active.data_ptr(), camera.w2c.data_ptr(),
            camera.K.data_ptr(),
            *(given[k].data_ptr() if k in given else None
              for k in ("g_center", "g_conic", "g_rgb", "g_depth",
                        "g_opacity")),
            *(out[f].data_ptr() for f in PARAM_FIELDS), n,
            state.sh_rest.shape[1], sh_degree, *_camera_args(camera, near),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"project_bwd kernel launch failed: cudaError "
                           f"{err}")
    counters["launches.project_bwd"] += 1
    return out


class _Project(torch.autograd.Function):
    """``project_gaussians``: the kernels on CUDA tensors, the plain forward
    and the plain mirror of the backward on CPU tensors."""

    @staticmethod
    def forward(ctx, camera, sh_degree, near, active, center_offset,
                *params):
        ctx.set_materialize_grads(False)
        state = GaussianState(**dict(zip(PARAM_FIELDS, params)),
                              active=active)
        if state.means.device.type == "cpu":
            sg = project_gaussians_reference(state, camera, sh_degree, near,
                                             center_offset)
        else:
            sg = project_fwd_launch(state, camera, sh_degree, near,
                                    center_offset)
        ctx.save_for_backward(active, *params)
        ctx.camera, ctx.sh_degree, ctx.near = camera, sh_degree, near
        ctx.has_offset = center_offset is not None
        ctx.mark_non_differentiable(sg.radius, sg.valid)
        return tuple(sg)

    @staticmethod
    def backward(ctx, g_center, g_conic, g_rgb, g_depth, g_opacity, *_):
        active, *params = ctx.saved_tensors
        state = GaussianState(**dict(zip(PARAM_FIELDS, params)),
                              active=active)
        bwd = (project_bwd_reference if state.means.device.type == "cpu"
               else project_bwd_launch)
        grads = bwd(state, ctx.camera, g_center, g_conic, g_rgb, g_depth,
                    g_opacity, ctx.sh_degree, ctx.near)
        return (None, None, None, None,
                g_center if ctx.has_offset else None,
                *(grads[f] for f in PARAM_FIELDS))


def project_gaussians(state: GaussianState, camera: Camera,
                      sh_degree: int = 3, near: float = 0.2,
                      center_offset: torch.Tensor | None = None
                      ) -> ScreenGaussians:
    """EWA projection with a 0.3 px dilation, the Jacobian clamped to 1.3x
    the frustum and a 3-sigma radius; SH colour of ``sh_degree``.
    ``center_offset`` (N, 2), normally zeros, lets a trainer take
    d(loss)/d(screen centre) for the densify statistics. Differentiable in
    the parameter fields and the offset."""
    return ScreenGaussians(*_Project.apply(
        camera, sh_degree, near, state.active, center_offset,
        *(getattr(state, f) for f in PARAM_FIELDS)))


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
