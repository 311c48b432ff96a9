"""Pinhole camera: intrinsics plus a world-to-camera matrix, as tensors.

Counterpart of ``syn3r_tpu/utils/camera.py``. ``w2c`` is the 4x4
world->camera matrix ([R|t; 0 1]), ``K`` the 3x3 intrinsics in pixels, +z
looks forward (OpenCV/COLMAP). A batch of same-size cameras is one
``Camera`` whose tensors carry a leading view axis (``stack_cameras``);
``at(i)`` takes one view out. ``confidence`` is the per-camera loss weight
the GS trainer applies.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import se3


@dataclasses.dataclass(frozen=True)
class Camera:
    K: torch.Tensor               # (..., 3, 3) intrinsics
    w2c: torch.Tensor             # (..., 4, 4) world->camera
    confidence: torch.Tensor      # (...) per-camera loss weight
    width: int = 0
    height: int = 0

    @property
    def c2w(self) -> torch.Tensor:
        return se3.se3_inverse(self.w2c)

    @property
    def R(self) -> torch.Tensor:
        return self.w2c[..., :3, :3]

    @property
    def position(self) -> torch.Tensor:
        """Camera center in world coordinates."""
        return self.c2w[..., :3, 3]

    def resized(self, width: int, height: int) -> "Camera":
        """Rescale the intrinsics to a new image resolution."""
        sx, sy = width / self.width, height / self.height
        scale = torch.tensor([[sx, 1.0, sx], [1.0, sy, sy], [1.0, 1.0, 1.0]],
                             dtype=self.K.dtype, device=self.K.device)
        return dataclasses.replace(self, K=self.K * scale, width=width,
                                   height=height)

    def at(self, i: int) -> "Camera":
        """View ``i`` of a stacked batch of cameras."""
        return dataclasses.replace(self, K=self.K[i], w2c=self.w2c[i],
                                   confidence=self.confidence[i])

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, K=self.K.to(device),
                                   w2c=self.w2c.to(device),
                                   confidence=self.confidence.to(device))

    def __len__(self) -> int:
        return self.K.shape[0]


def make_camera(K, w2c, width: int, height: int, confidence=1.0,
                device="cpu") -> Camera:
    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.tensor(np.asarray(x, np.float32), device=device)
    return Camera(K=f32(K), w2c=f32(w2c), confidence=f32(confidence),
                  width=int(width), height=int(height))


def camera_from_fov(fov_x_rad: float, fov_y_rad: float, width: int,
                    height: int, w2c, confidence: float = 1.0,
                    device="cpu") -> Camera:
    fx = 0.5 * width / math.tan(0.5 * fov_x_rad)
    fy = 0.5 * height / math.tan(0.5 * fov_y_rad)
    K = [[fx, 0.0, width / 2.0], [0.0, fy, height / 2.0], [0.0, 0.0, 1.0]]
    return make_camera(K, w2c, width, height, confidence, device)


def camera_from_numpy(cam, device="cpu") -> Camera:
    """Carry a camera of the JAX package (or any object with ``K``, ``w2c``,
    ``confidence``, ``width`` and ``height``; batched or not) across."""
    return make_camera(np.asarray(cam.K), np.asarray(cam.w2c), cam.width,
                       cam.height, np.asarray(cam.confidence), device)


def stack_cameras(cams: list[Camera]) -> Camera:
    """Stack same-resolution cameras into one batched Camera."""
    assert len({(c.width, c.height) for c in cams}) == 1, "mixed resolutions"
    return Camera(K=torch.stack([c.K for c in cams]),
                  w2c=torch.stack([c.w2c for c in cams]),
                  confidence=torch.stack([c.confidence for c in cams]),
                  width=cams[0].width, height=cams[0].height)


def unproject(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Depth maps (..., H, W) -> camera-space points (..., H, W, 3), pixel
    centres at integer coordinates: x = (u - cx) / fx * z."""
    h, w = depth.shape[-2:]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :] \
        .expand(h, w)
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None] \
        .expand(h, w)
    x = ((u - K[0, 2]) / K[0, 0]).expand_as(depth)
    y = ((v - K[1, 2]) / K[1, 1]).expand_as(depth)
    return torch.stack([x, y, torch.ones_like(depth)], dim=-1) \
        * depth[..., None]


def transform_points(pts: torch.Tensor, src_w2c: torch.Tensor,
                     dst_w2c: torch.Tensor) -> torch.Tensor:
    """Map points (..., 3) from the src camera frame to the dst camera
    frame, in full float32 (TF32 is off, device.resolve_device)."""
    rel = dst_w2c @ se3.se3_inverse(src_w2c)
    return pts @ rel[:3, :3].T + rel[:3, 3]


def project(pts: torch.Tensor, K: torch.Tensor,
            eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-space points (..., 3) -> (pixel uv (..., 2), depth (...))."""
    z = pts[..., 2]
    zsafe = torch.where(z.abs() < eps,
                        torch.where(z < 0, -eps, eps).to(z.dtype), z)
    u = K[0, 0] * pts[..., 0] / zsafe + K[0, 2]
    v = K[1, 1] * pts[..., 1] / zsafe + K[1, 2]
    return torch.stack([u, v], dim=-1), z


def look_at_w2c(eye, target, up: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """w2c of a camera at ``eye`` looking at ``target`` (OpenCV: +z
    forward, +y down)."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    up = (torch.tensor([0.0, -1.0, 0.0]) if up is None
          else torch.as_tensor(up, dtype=torch.float32))
    fwd = target - eye
    fwd = fwd / (torch.linalg.norm(fwd) + 1e-12)
    right = torch.linalg.cross(up, fwd) * -1.0
    right = right / (torch.linalg.norm(right) + 1e-12)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], dim=0)
    w2c = torch.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return w2c
