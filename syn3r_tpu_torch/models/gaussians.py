"""3D Gaussian state: the optimized object of the GS fit.

Counterpart of ``syn3r_tpu/models/gaussians.py``. The state is a
fixed-capacity set of tensors plus an ``active`` mask: densify and prune
change which slots are live, never the shapes, and capacity grows by
doubling. Keeping the JAX package's layout makes clone/split/prune, the
zeroing of Adam moments and the slot order compare one to one. Parameters
are stored before activation (log-scale, opacity logit, raw quaternion);
``sh_rest`` is flat (N, 3 * (K - 1)).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.knn import knn_mean_sq_dist

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

PARAM_FIELDS = ("means", "quats", "log_scales", "opacity_logits",
                "sh_dc", "sh_rest")


@dataclasses.dataclass(frozen=True)
class GaussianState:
    means: torch.Tensor           # (N, 3)
    quats: torch.Tensor           # (N, 4) unnormalized wxyz
    log_scales: torch.Tensor      # (N, 3)
    opacity_logits: torch.Tensor  # (N, 1)
    sh_dc: torch.Tensor           # (N, 1, 3)
    sh_rest: torch.Tensor         # (N, 3 * (K - 1)) flat
    active: torch.Tensor          # (N,) bool

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    @property
    def sh(self) -> torch.Tensor:
        rest = self.sh_rest.reshape(self.sh_rest.shape[0], -1, 3)
        return torch.cat([self.sh_dc, rest], dim=1)

    def replace(self, **kw) -> "GaussianState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "GaussianState":
        return GaussianState(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})


def get_params(state: GaussianState) -> dict:
    return {f: getattr(state, f) for f in PARAM_FIELDS}


def with_params(state: GaussianState, params: dict) -> GaussianState:
    return state.replace(**params)


def next_capacity(n: int, minimum: int = 4096) -> int:
    """Power-of-two bucket >= n."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) raw quats -> (N, 3, 3). rsqrt(|q|^2 + eps) keeps the gradient
    of an all-zero quaternion finite."""
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return m.reshape(-1, 3, 3)


def covariance_3d(log_scales: torch.Tensor, quats: torch.Tensor
                  ) -> torch.Tensor:
    """Sigma = R S S^T R^T, (N, 3, 3)."""
    R = quat_to_rotmat(quats)
    s2 = torch.exp(2.0 * log_scales)
    return torch.einsum("nij,nj,nkj->nik", R, s2, R)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int
            ) -> torch.Tensor:
    """Real SH colours (N, 3) of sh (N, K, 3) along unit dirs (N, 3), before
    the +0.5 offset."""
    res = SH_C0 * sh[:, 0]
    if degree >= 1:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        res = res - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        res = (res + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
               + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        res = (res + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
               + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return res


def rgb_to_sh_dc(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / SH_C0


def from_points(xyz, rgb, sh_degree: int = 3, capacity: int | None = None,
                initial_opacity: float = 0.1, device=None) -> GaussianState:
    """Gaussians from a coloured point cloud (the 3DGS recipe): isotropic
    scale sqrt(mean sq dist to 3 NNs), identity rotation, opacity 0.1,
    DC-only SH. Padding slots: log-scale -10, opacity logit -100, identity
    quaternion, inactive."""
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
    rgb = torch.as_tensor(rgb, dtype=torch.float32, device=xyz.device)
    n = xyz.shape[0]
    cap = capacity or next_capacity(n)
    k_sh = (sh_degree + 1) ** 2
    dev = xyz.device

    mean_sq = knn_mean_sq_dist(xyz, k=3)
    log_scales = torch.log(torch.sqrt(mean_sq.clamp_min(1e-7)))
    inv_sig = math.log(initial_opacity / (1.0 - initial_opacity))

    def pad(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill,
                         dtype=torch.float32, device=dev)
        out[:n] = x
        return out

    quats = torch.zeros((cap, 4), device=dev)
    quats[:, 0] = 1.0
    return GaussianState(
        means=pad(xyz),
        quats=quats,
        log_scales=pad(log_scales[:, None].repeat(1, 3), fill=-10.0),
        opacity_logits=pad(torch.full((n, 1), inv_sig, device=dev),
                           fill=-100.0),
        sh_dc=pad(rgb_to_sh_dc(rgb)[:, None]),
        sh_rest=pad(torch.zeros((n, (k_sh - 1) * 3), device=dev)),
        active=torch.arange(cap, device=dev) < n,
    )


def random_init(generator: torch.Generator, n: int, extent: float = 1.3,
                sh_degree: int = 3, capacity: int | None = None,
                device=None) -> GaussianState:
    """Random point-cloud init (the reference's ``--rand_pcd`` path); the
    draws come from ``generator`` (on ``generator.device``)."""
    gdev = generator.device
    xyz = (torch.rand((n, 3), generator=generator, device=gdev) * 2 - 1) \
        * extent
    rgb = torch.rand((n, 3), generator=generator, device=gdev)
    return from_points(xyz.to(device or gdev), rgb.to(device or gdev),
                       sh_degree=sh_degree, capacity=capacity)


def gaussians_from_numpy(src, device="cpu") -> GaussianState:
    """Carry a Gaussian state across: a state of the JAX package (any object
    with the fields as arrays), a dict of arrays, or the path of a
    checkpoint ``.npz`` written by either package. A rank-3 ``sh_rest``
    (an older layout) is flattened."""
    if isinstance(src, (str, bytes)) or hasattr(src, "__fspath__"):
        with np.load(src) as data:
            arrays = {f: np.asarray(data[f])
                      for f in PARAM_FIELDS + ("active",)}
    elif isinstance(src, dict):
        arrays = {f: np.asarray(src[f]) for f in PARAM_FIELDS + ("active",)}
    else:
        arrays = {f: np.asarray(getattr(src, f))
                  for f in PARAM_FIELDS + ("active",)}
    if arrays["sh_rest"].ndim == 3:
        arrays["sh_rest"] = arrays["sh_rest"].reshape(
            len(arrays["sh_rest"]), -1)
    fields = {f: torch.tensor(arrays[f], dtype=torch.float32, device=device)
              for f in PARAM_FIELDS}
    return GaussianState(**fields, active=torch.tensor(
        arrays["active"], dtype=torch.bool, device=device))
