"""SE(3) and quaternion helpers the camera model needs.

Counterpart of ``syn3r_tpu/utils/se3.py`` (``quat_to_rotmat``,
``rotmat_to_quat``, ``slerp``, ``interpolate_poses``, ``se3_inverse``,
``rotation_angle_deg``). Quaternions are (w, x, y, z), poses 4x4
homogeneous matrices acting on column vectors.
"""

from __future__ import annotations

import math

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz,
    Shepperd's method with the largest pivot, sign canonicalized to w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack([qw, (m21 - m12) / (4 * qw + 1e-12),
                      (m02 - m20) / (4 * qw + 1e-12),
                      (m10 - m01) / (4 * qw + 1e-12)], dim=-1)
    qx = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([(m21 - m12) / (4 * qx + 1e-12), qx,
                      (m01 + m10) / (4 * qx + 1e-12),
                      (m02 + m20) / (4 * qx + 1e-12)], dim=-1)
    qy = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([(m02 - m20) / (4 * qy + 1e-12),
                      (m01 + m10) / (4 * qy + 1e-12), qy,
                      (m12 + m21) / (4 * qy + 1e-12)], dim=-1)
    qz = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([(m10 - m01) / (4 * qz + 1e-12),
                      (m02 + m20) / (4 * qz + 1e-12),
                      (m12 + m21) / (4 * qz + 1e-12), qz], dim=-1)
    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)           # (..., 4, 4)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Shortest-arc spherical interpolation of (..., 4) quaternions; t is
    broadcast over the leading axes. Lerp where the two are parallel."""
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = dot.abs().clamp(-1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.ndim:
        t = t[..., None]
    near = sin_theta < 1e-6
    safe = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(near, t, torch.sin(t * theta) / safe)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def interpolate_poses(pose_start: torch.Tensor, pose_end: torch.Tensor,
                      num: int = 25) -> torch.Tensor:
    """``num`` poses (num, 4, 4) from ``pose_start`` to ``pose_end``:
    quaternion slerp for the rotation, a straight line for the translation
    (a natural cubic spline through two knots)."""
    ts = torch.linspace(0.0, 1.0, num, dtype=pose_start.dtype,
                        device=pose_start.device)
    q0 = rotmat_to_quat(pose_start[:3, :3])
    q1 = rotmat_to_quat(pose_end[:3, :3])
    qs = slerp(q0[None].expand(num, 4), q1[None].expand(num, 4), ts)
    poses = torch.eye(4, dtype=pose_start.dtype,
                      device=pose_start.device).repeat(num, 1, 1)
    poses[:, :3, :3] = quat_to_rotmat(qs)
    poses[:, :3, 3] = ((1.0 - ts)[:, None] * pose_start[:3, 3]
                       + ts[:, None] * pose_end[:3, 3])
    return poses


def se3_inverse(pose: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    rt = pose[..., :3, :3].transpose(-1, -2)
    inv = torch.zeros_like(pose)
    inv[..., :3, :3] = rt
    inv[..., :3, 3:] = -(rt @ pose[..., :3, 3:])
    inv[..., 3, 3].fill_(1.0)     # no host scalar copied in: it captures
    return inv


def rotation_angle_deg(r0: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    """Geodesic angle in degrees between rotation matrices (..., 3, 3)."""
    rel = r0.transpose(-1, -2) @ r1
    tr = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    return torch.arccos(cos) * (180.0 / math.pi)
