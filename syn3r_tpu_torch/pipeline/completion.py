"""Conditioning of guided completion and its lambda schedule.

Counterpart of ``syn3r_tpu/pipeline/completion.py`` (reference
``model/diffusionGS.py:653-923, 1120-1205``) on the backward-warp path:

  - ``interpolate_pair_poses`` between two endpoint cameras and
    ``perturb_and_select_poses``, which jitters each interior pose and keeps
    the candidate whose backward warp from the nearest endpoint is most
    uncertain (the same numpy draw order as JAX, so both pick the same
    candidates from the same seed);
  - ``prepare_pair_conditioning``: each interior frame backward-warps the
    endpoint photo (left for interior index < 12, right otherwise, the
    reference's constant) through the GS depth rendered at its pose; the
    uncertainty fuses the soft cycle-reprojection mask with the intensity
    confidence exp(-(|warped - rendered| / 0.5)^3), holes zeroed; the
    cond image falls back to the GS render where uncertainty > 0.5; latent
    masks are 8x8 block means; then ``search_hypers_v2``;
  - ``covisibility_distance`` and ``fps_keyframes`` (numpy).

Images are (H, W, 3) in [0, 1]; the caller supplies the render functions
(pose(s) -> rgb, depth at the diffusion resolution). Frames are processed
one after another, as JAX's ``lax.map`` does. Not ported:
``warp_mode="forward_warp"`` (raises) and ``split_point`` /
``normalized_endpoint_dists`` (unused by the reference's live path).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..ops.warp import downsample_mask_to_latent, inverse_warp
from ..utils import se3


def quad_tau(u: torch.Tensor) -> torch.Tensor:
    """Per-frame guidance-stop threshold, the reference's quadratic."""
    a, b, c = -0.22 / 1.4, 2.4 * 0.22 / 1.4, 0.2
    return (a * u ** 2 + b * u + c) * 100.0


def search_hypers_v2(masks: torch.Tensor,
                     num_steps: int = 100) -> torch.Tensor:
    """lambda in {0,1}^(num_steps x F) from the (F-2, h, w) uncertainty
    masks of the inner frames (the 'double_end' mode, the only one the
    completion unit uses): frame tau keeps lambda = 1 while
    num_steps - t > quad_tau(u_tau); both endpoints always keep 1."""
    u = masks.float().mean(dim=(-1, -2))
    u = torch.clamp(u / torch.clamp(u.max(), min=0.5), 0.0, 1.0)
    zero = u.new_zeros(1)
    u = torch.cat([zero, u, zero])
    steps = torch.arange(num_steps, dtype=torch.float32,
                         device=u.device)[:, None]
    lam = (num_steps - steps > quad_tau(u)[None, :]).float()
    lam[:, 0] = 1.0
    lam[:, -1] = 1.0
    return lam


def intensity_confidence(warped: torch.Tensor, rendered: torch.Tensor,
                         hole_mask: torch.Tensor,
                         sigma: float = 0.5) -> torch.Tensor:
    """exp(-(||warped - rendered|| / sigma)^3) with holes zeroed. Shapes
    (..., H, W, 3); hole_mask (..., H, W, 1), 1 at holes."""
    d = torch.linalg.norm(warped - rendered, dim=-1, keepdim=True)
    return torch.exp(-((d / sigma) ** 3)) * (1.0 - hole_mask)


class PairConditioning(NamedTuple):
    image_start: torch.Tensor      # (H, W, 3)
    image_end: torch.Tensor        # (H, W, 3)
    cond_images: torch.Tensor      # (F-2, H, W, 3)
    masks: torch.Tensor            # (F-2, lh, lw) float uncertainty
    lambda_ts: torch.Tensor        # (num_steps, F)


def _stacked(render_fn) -> Callable:
    """A batch render function from a one-pose render function."""
    def render_many(poses):
        outs = [render_fn(p) for p in poses]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    return render_many


def pose_tensor(poses, device) -> torch.Tensor:
    """poses (numpy or tensor) as float32 on ``device``."""
    if isinstance(poses, torch.Tensor):
        return poses.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(poses, np.float32), device=device)


def prepare_pair_conditioning(
        render_fn: Callable, K: torch.Tensor, poses,
        image_l: torch.Tensor, depth_l: torch.Tensor,
        image_r: torch.Tensor, depth_r: torch.Tensor,
        num_steps: int = 100, latent_downsample: int = 8,
        warp_mode: str = "backward_warp",
        render_many_fn=None) -> PairConditioning:
    """SVD conditioning of one endpoint pair. poses: (F, 4, 4) interpolated
    w2c chain, endpoints included. ``render_many_fn(poses (P, 4, 4)) ->
    (rgb (P, H, W, 3), depth (P, H, W))`` renders all interior poses at
    once; without it ``render_fn(pose)`` renders them one by one."""
    if warp_mode == "forward_warp":
        raise NotImplementedError(
            "warp_mode='forward_warp' is not ported: no shipped config "
            "uses it")
    if warp_mode != "backward_warp":
        raise ValueError(warp_mode)
    poses = pose_tensor(poses, image_l.device)
    f = poses.shape[0]
    h, w = image_l.shape[:2]
    lh, lw = h // latent_downsample, w // latent_downsample
    interior = poses[1:-1]
    rendered, rendered_depth = (render_many_fn or _stacked(render_fn))(
        interior)
    conds, masks = [], []
    for k in range(f - 2):
        left = k < 12          # interior index i = k + 1: i - 1 < 12
        cond, mask_lat = _frame_conditioning(
            image_l if left else image_r, depth_l if left else depth_r,
            rendered[k], rendered_depth[k],
            poses[0] if left else poses[-1], interior[k], K, lh, lw)
        conds.append(cond)
        masks.append(mask_lat)
    masks = torch.stack(masks)
    return PairConditioning(image_start=image_l, image_end=image_r,
                            cond_images=torch.stack(conds), masks=masks,
                            lambda_ts=search_hypers_v2(masks, num_steps))


def _frame_conditioning(src_img, src_depth, rendered, rendered_depth,
                        src_pose, pose, K, lh: int, lw: int):
    """Warp, uncertainty fusion and latent mask of one interpolated
    frame."""
    wres = inverse_warp(src_img, src_depth, rendered_depth, src_pose, pose,
                        K)
    warped = wres.warped_img
    hole = (warped.sum(-1, keepdim=True) <= 0).float()
    inten_conf = intensity_confidence(warped, rendered, hole)
    reproj_uncert = 1.0 - wres.soft_mask_reproj
    conf = inten_conf * (1.0 - reproj_uncert[..., None])
    uncert = 1.0 - conf                                  # (H, W, 1)
    mask_lat = downsample_mask_to_latent(uncert[..., 0], lh, lw)
    cond = torch.where(uncert > 0.5, rendered, warped)
    return torch.clamp(cond, 0.0, 1.0), mask_lat


def covisibility_distance(pose_a: np.ndarray, pose_b: np.ndarray,
                          alpha: float = 1.0, beta: float = 1.0) -> float:
    """1 - exp(-a |t|) exp(-b angle), the FPS keyframe metric; |t| is the
    distance of the w2c translation columns, as in the reference."""
    t = float(np.linalg.norm(pose_a[:3, 3] - pose_b[:3, 3]))
    rel = pose_a[:3, :3].T @ pose_b[:3, :3]
    ang = float(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)))
    return 1.0 - np.exp(-alpha * t) * np.exp(-beta * ang)


def fps_keyframes(poses: np.ndarray, num: int) -> list[int]:
    """Farthest-point sampling of ``num`` frames over the covisibility
    metric."""
    n = len(poses)
    if num >= n:
        return list(range(n))
    selected = [0]
    dists = np.array([covisibility_distance(poses[0], poses[j])
                      for j in range(n)])
    for _ in range(num - 1):
        nxt = int(dists.argmax())
        selected.append(nxt)
        d_new = np.array([covisibility_distance(poses[nxt], poses[j])
                          for j in range(n)])
        dists = np.minimum(dists, d_new)
    return sorted(selected)


def interpolate_pair_poses(pose_l, pose_r, num: int = 25) -> np.ndarray:
    """(num, 4, 4) float32 w2c poses from pose_l to pose_r (slerp and a
    straight line)."""
    return se3.interpolate_poses(
        torch.as_tensor(np.asarray(pose_l, np.float32)),
        torch.as_tensor(np.asarray(pose_r, np.float32)), num).numpy()


def perturb_and_select_poses(
        render_fn, K: torch.Tensor, anchor_poses: np.ndarray,
        ref_poses: Sequence[np.ndarray], rng: np.random.Generator,
        perturb_num: int = 5, trans_frac: float = 0.1,
        rot_std_deg: float = 0.1, render_many_fn=None) -> np.ndarray:
    """Jitter each anchor pose ``perturb_num`` times (translation noise
    scaled by the anchor's nearest-neighbour distance, xyz-Euler rotation
    noise) and keep, per anchor, the candidate whose backward warp from
    the nearest reference view is most uncertain. The reference views and
    all candidates render in two batch calls."""
    anchors = np.asarray(anchor_poses)
    trans = anchors[:, :3, 3]
    dists = np.linalg.norm(trans[:, None] - trans[None], axis=-1)
    np.fill_diagonal(dists, dists.max() if len(anchors) > 1 else 1.0)
    nn_dist = dists.min(axis=1)
    ref_pts = np.asarray([p[:3, 3] for p in ref_poses])

    candidates = []
    for i, pose in enumerate(anchors):
        cands_i = [pose.astype(np.float32)]
        for _ in range(perturb_num):
            p = pose.copy()
            p[:3, 3] += rng.normal(0, nn_dist[i] * trans_frac, 3)
            ang = np.radians(rng.normal(0, rot_std_deg, 3))
            cx, cy, cz = np.cos(ang)
            sx, sy, sz = np.sin(ang)
            rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
            ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            p[:3, :3] = (rz @ ry @ rx) @ pose[:3, :3]
            cands_i.append(p.astype(np.float32))
        candidates.append(cands_i)

    a, c = len(candidates), 1 + perturb_num
    nn_idx = np.array([[int(np.linalg.norm(ref_pts - cand[:3, 3],
                                           axis=1).argmin())
                        for cand in cands_i] for cands_i in candidates])
    render_many = render_many_fn or _stacked(render_fn)
    flat = np.stack([q for ci in candidates for q in ci])
    ref_stack = np.stack(ref_poses).astype(np.float32)
    ref_imgs, ref_depths = render_many(ref_stack)
    _, cand_depths = render_many(flat)
    dev = cand_depths.device
    scores = _warp_uncertainty_batch(
        ref_imgs, ref_depths, pose_tensor(ref_stack, dev),
        nn_idx.reshape(-1), cand_depths, pose_tensor(flat, dev), K)
    sel = scores.cpu().numpy().reshape(a, c).argmax(axis=1)
    return np.stack([candidates[i][int(sel[i])] for i in range(a)])


def _warp_uncertainty(ref_img, ref_depth, cand_depth, ref_pose, cand_pose,
                      K) -> torch.Tensor:
    """Mean backward-warp reprojection uncertainty of one candidate."""
    wres = inverse_warp(ref_img, ref_depth, cand_depth, ref_pose, cand_pose,
                        K)
    return (1.0 - wres.soft_mask_reproj).mean()


def _warp_uncertainty_batch(ref_imgs, ref_depths, ref_poses, nn_idx,
                            cand_depths, cand_poses, K) -> torch.Tensor:
    """Every candidate's warp uncertainty from its nearest reference
    render, one candidate after another: (candidates,)."""
    return torch.stack([
        _warp_uncertainty(ref_imgs[n], ref_depths[n], cand_depths[j],
                          ref_poses[n], cand_poses[j], K)
        for j, n in enumerate(int(v) for v in nn_idx)])
