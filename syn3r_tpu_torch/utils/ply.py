"""PLY point-cloud I/O, including the 3DGS interchange format.

Counterpart of ``syn3r_tpu/utils/ply.py`` (numpy only): the dense point
clouds a DL3DV refine cycle writes (``dense_views_cyc{c}.ply``: x, y, z and
8-bit colour, binary little endian), and the standard 3DGS
``point_cloud.ply`` layout (x, y, z, nx, ny, nz, f_dc_*, f_rest_* planar
by channel, opacity, scale_*, rot_*) for the port's ``GaussianState``. A
file either package writes reads back in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gaussians import GaussianState, next_capacity

_TYPES = {"float": "<f4", "float32": "<f4", "uchar": "u1", "uint8": "u1",
          "double": "<f8"}


def write_ply_points(path: str, xyz: np.ndarray, rgb01=None) -> None:
    """Points (N, 3), optionally with colours in [0, 1] (clipped, then
    truncated to 8 bits as the JAX package writes them)."""
    n = len(xyz)
    props = ["property float x", "property float y", "property float z"]
    if rgb01 is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if rgb01 is None:
            f.write(np.asarray(xyz, "<f4").tobytes())
            return
        rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                 ("r", "u1"), ("g", "u1"), ("b", "u1")])
        rec["x"], rec["y"], rec["z"] = np.asarray(xyz, "<f4").T
        c = np.clip(np.asarray(rgb01) * 255, 0, 255).astype("u1")
        rec["r"], rec["g"], rec["b"] = c.T
        f.write(rec.tobytes())


def _read_vertices(path: str):
    """The header's vertex count and property names, and the records."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    n, props = 0, []
    for line in data[:head_end].decode("ascii").splitlines():
        parts = line.split()
        if parts[:2] == ["element", "vertex"]:
            n = int(parts[2])
        elif parts and parts[0] == "property" and len(parts) == 3:
            props.append((parts[2], _TYPES[parts[1]]))
    return np.frombuffer(data, np.dtype(props), count=n, offset=head_end)


def read_ply_points(path: str):
    """(xyz (N, 3) float32, rgb in [0, 1] (N, 3) or None)."""
    rec = _read_vertices(path)
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    rgb = None
    if "red" in rec.dtype.names:
        rgb = np.stack([rec["red"], rec["green"], rec["blue"]],
                       axis=1).astype(np.float32) / 255.0
    return xyz, rgb


def save_gaussians_ply(path: str, state: GaussianState) -> None:
    """The active Gaussians of ``state`` as a 3DGS point_cloud.ply."""
    act = state.active.cpu().numpy()

    def field(name):
        return getattr(state, name).detach().cpu().numpy()[act]

    xyz, sh_dc = field("means"), field("sh_dc")          # (N, 1, 3)
    n = len(xyz)
    sh_rest = field("sh_rest").reshape(n, state.sh_rest.shape[1] // 3, 3)
    k_rest = sh_rest.shape[1] * 3
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(k_rest)] + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    rec = np.zeros(n, dtype=np.dtype([(nm, "<f4") for nm in names]))
    rec["x"], rec["y"], rec["z"] = xyz.T
    for i in range(3):
        rec[f"f_dc_{i}"] = sh_dc[:, 0, i]
    # 3DGS stores f_rest planar: every coefficient of channel 0, then 1, 2
    rest_planar = sh_rest.transpose(0, 2, 1).reshape(n, -1)
    for i in range(k_rest):
        rec[f"f_rest_{i}"] = rest_planar[:, i]
    rec["opacity"] = field("opacity_logits")[:, 0]
    for i, v in enumerate(field("log_scales").T):
        rec[f"scale_{i}"] = v
    for i, v in enumerate(field("quats").T):
        rec[f"rot_{i}"] = v
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              + "\n".join(f"property float {nm}" for nm in names)
              + "\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def load_gaussians_ply(path: str, capacity=None,
                       device="cpu") -> GaussianState:
    """A 3DGS point_cloud.ply as a ``GaussianState`` of ``capacity``
    slots (``next_capacity`` of the count by default); empty slots hold
    the JAX package's padding (log-scale -10, opacity logit -100, unit
    quaternion)."""
    rec = _read_vertices(path)
    names = rec.dtype.names
    n = len(rec)
    k_rest = sum(1 for nm in names if nm.startswith("f_rest_")) // 3
    cap = capacity or next_capacity(n)

    def pad(x, fill=0.0):
        x = np.pad(x, [(0, cap - n)] + [(0, 0)] * (x.ndim - 1),
                   constant_values=fill).astype(np.float32)
        return torch.as_tensor(x, device=device)

    def stack(fmt, count):
        return np.stack([rec[fmt.format(i)] for i in range(count)], 1)

    rest = stack("f_rest_{}", 3 * k_rest)
    # flat (N, 3 (K - 1)) coefficient-major storage (GaussianState.sh_rest)
    sh_rest = rest.reshape(n, 3, k_rest).transpose(0, 2, 1).reshape(n, -1)
    quats = pad(stack("rot_{}", 4))
    quats[n:, 0] = 1.0
    return GaussianState(
        means=pad(np.stack([rec["x"], rec["y"], rec["z"]], 1)),
        quats=quats, log_scales=pad(stack("scale_{}", 3), fill=-10.0),
        opacity_logits=pad(rec["opacity"][:, None], fill=-100.0),
        sh_dc=pad(stack("f_dc_{}", 3)[:, None]), sh_rest=pad(sh_rest),
        active=torch.arange(cap, device=device) < n)
