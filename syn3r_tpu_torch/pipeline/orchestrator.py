"""The refine-cycle loop of one scene.

Counterpart of ``syn3r_tpu/pipeline/orchestrator.py`` (the reference's
``DiffusionGS``, ``model/diffusionGS.py:38-1699``). ``run``: fit 3DGS on the
input views (``init_GS``), then per cycle resume from the latest checkpoint
(cycles after the first), ``densify_views`` and ``refine_GS``:

  - ``densify_views``: for each view pair (N wrap-around pairs for
    'interpolate_gs_v2', N - 1 for 'interpolate_loop0_gs') interpolate the
    poses, perturb the interior ones (a numpy rng per (cycle, pair)), build
    the conditioning (``interp_type``: the backward warp, or the forward
    splat) from the ORIGINAL endpoint photos (nearest-upsized to the
    diffusion resolution) and GS depths, run the completion with a
    ``torch.Generator`` seeded ``seed + 1000 cycle + pair`` on the
    trainer's device, dump the pair's debug artifacts (``save_debug``,
    ``utils/debug_dump.py``, under ``debug/cyc{c}_pair{p}``), put the
    endpoint photos back, resize to the GS resolution (antialiased cubic)
    and cache the pair as ``interpolated_dense_views_cyc{c}_view{p}.npz``
    (a cache of another shape is recomputed);
  - ``densify_pcds`` (the DL3DV preset, with a ``dust3r_fn``): keyframes
    per pair (farthest-point over covisibility or evenly spaced, the last
    dropped), a GMFlow frame-quality gate against the GS render (with a
    ``flow_fn``), DUSt3R on the frames resized to width 512 with the poses
    fixed, a uniform downsample to ~1e5 points and statistical outlier
    removal, ``dense_views_cyc{c}.ply``; ``run`` then resets the Gaussians
    from the cloud (cycle 0) or appends it (later cycles);
  - ``refine_GS``: the pairs' frames (each pair's last frame dropped) become
    pseudo views at ``cam_confidence`` and the trainer finetunes.

The completion is any callable ``(image_start, cond_images, image_end,
mask, lambda_ts, generator) -> (F, H, W, 3)``: a ``GuidedSVDPipeline`` or,
without weights, ``_warp_only_completion``.

Not ported, raising ``NotImplementedError``: ``pair_parallel``
(multi-GPU).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..gs.trainer import GSTrainer, order_cameras_tsp
from ..utils.camera import Camera, make_camera
from ..utils.debug_dump import dump_pair_debug
from ..utils.image import (resize_bilinear, resize_cubic_antialiased,
                           resize_nearest)
from ..utils.pcd import remove_statistical_outliers
from ..utils.ply import write_ply_points
from ..utils.profiling import PhaseTimer
from ..utils.se3 import se3_inverse
from ..vision.gmflow import correspondence_mask
from . import completion as C


@dataclasses.dataclass
class DiffusionGSConfig:
    """The JAX package's ``DiffusionGSConfig`` fields and defaults."""
    diffusion_width: int = 1024
    diffusion_height: int = 576
    num_frames: int = 25
    num_inference_steps: int = 100
    refine_cycle_num: int = 2
    cam_confidence: float = 0.05
    disable_densification: bool = False
    pseudo_cam_sampling_rate: float = 0.02
    perturb_interp_poses: bool = True
    replace_endpoints: bool = True
    densify_type: str = "interpolate_gs_v2"
    interp_type: str = "backward_warp"
    use_lpips_loss: bool = False
    capture_pseudo_depth: bool = True
    num_views_for_pcd_densification: int = 1
    pcd_frame_quality_thresh: float = 0.3
    fps_keyframe_sampling: bool = False
    reorg_train_views: bool = True
    pair_parallel: bool = False
    pair_sharding: object = None
    save_debug: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.densify_type not in ("interpolate_gs_v2",
                                     "interpolate_loop0_gs"):
            raise ValueError(f"unknown densify_type {self.densify_type!r}")
        if self.interp_type not in ("backward_warp", "forward_warp"):
            raise ValueError(f"unknown interp_type {self.interp_type!r}")
        if self.pair_parallel or self.pair_sharding is not None:
            raise NotImplementedError(
                "pair_parallel is multi-GPU, not ported (ROADMAP Queue 1, "
                "multi-GPU)")


class DiffusionGS:
    """Test-time NVS loop: alternate 3DGS fitting and guided completion."""

    def __init__(self, trainer: GSTrainer, config: DiffusionGSConfig,
                 completion_fn: Optional[Callable] = None,
                 save_dir: Optional[str] = None,
                 dust3r_fn: Optional[Callable] = None,
                 flow_fn: Optional[Callable] = None):
        """completion_fn(image_start, cond_images, image_end, mask,
        lambda_ts, generator) -> (F, H, W, 3); dust3r_fn(frames, c2w, K) ->
        (xyz, rgb) turns on the point-cloud densification
        (``vision.dust3r.make_dust3r_fn``); flow_fn(a, b) -> flow its
        frame-quality gate (``vision.gmflow_public.make_flow_fn``)."""
        self.trainer = trainer
        self.cfg = config
        self.device = trainer.device
        self.completion_fn = completion_fn or self._warp_only_completion
        self.dust3r_fn = dust3r_fn
        self.flow_fn = flow_fn
        self.save_dir = save_dir or os.path.join(trainer.model_path,
                                                 "dense_views")
        os.makedirs(self.save_dir, exist_ok=True)
        self.timer = PhaseTimer()
        # what densify_pcds chose and counted, by cycle
        self.pcd_logs: dict[int, dict] = {}

        # GS intrinsics and resolution from camera 0, and the intrinsics
        # scaled to the diffusion resolution
        views = trainer.train_views
        self.K_gs = views.cameras.K[0]
        self.gs_height, self.gs_width = views.images.shape[1:3]
        sx = config.diffusion_width / self.gs_width
        sy = config.diffusion_height / self.gs_height
        K = self.K_gs.cpu().numpy()
        self.diffusion_K = torch.tensor(
            [[K[0, 0] * sx, 0.0, K[0, 2] * sx],
             [0.0, K[1, 1] * sy, K[1, 2] * sy],
             [0.0, 0.0, 1.0]], dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------

    def _warp_only_completion(self, image_start, cond_images, image_end,
                              mask, lambda_ts, generator):
        """Diffusion-free completion: the conditioning frames are the
        pseudo frames."""
        del mask, lambda_ts, generator
        return torch.cat([image_start[None], cond_images, image_end[None]])

    def _render_many(self, poses, K, width, height):
        poses = C.pose_tensor(poses, self.device)
        p = poses.shape[0]
        cams = Camera(K=K.expand(p, 3, 3), w2c=poses,
                      confidence=torch.ones((p,), device=self.device),
                      width=width, height=height)
        return self.trainer.render_views_batch(cams)

    def render_diffusion_res(self, pose):
        """(rgb, depth) of a w2c pose at the diffusion resolution."""
        cfg = self.cfg
        cam = make_camera(self.diffusion_K, pose,
                          cfg.diffusion_width, cfg.diffusion_height,
                          device=self.device)
        out = self.trainer.render_view(cam)
        return out["render"], out["depth"]

    def render_many_diffusion_res(self, poses):
        """(rgb (P, H, W, 3), depth (P, H, W)) of (P, 4, 4) poses at the
        diffusion resolution."""
        return self._render_many(poses, self.diffusion_K,
                                 self.cfg.diffusion_width,
                                 self.cfg.diffusion_height)

    def render_gs_res(self, pose):
        """(rgb, depth) of a pose at the GS training resolution."""
        cam = make_camera(self.K_gs, pose, self.gs_width,
                          self.gs_height, device=self.device)
        out = self.trainer.render_view(cam)
        return out["render"], out["depth"]

    def render_many_gs_res(self, poses):
        """A (P, 4, 4) pose batch at the GS training resolution."""
        return self._render_many(poses, self.K_gs, self.gs_width,
                                 self.gs_height)

    def _ordered_train_indices(self) -> list[int]:
        if not self.cfg.reorg_train_views:
            return list(range(len(self.trainer.train_views)))
        return order_cameras_tsp(self.trainer.train_views.cameras)

    # ------------------------------------------------------------------

    def init_GS(self, cycle: int = 0, log_every: int = 0):
        return self.trainer.training(0, epoch_indicator=cycle,
                                     log_every=log_every)

    def _cache_path(self, cycle: int, pi: int) -> str:
        return os.path.join(
            self.save_dir, f"interpolated_dense_views_cyc{cycle}_view{pi}.npz")

    def _pair_conditioning(self, cycle: int, pi: int, i: int, j: int):
        """Interpolated (and perturbed) poses and the conditioning of the
        pair (train view i -> train view j)."""
        cfg = self.cfg
        cams = self.trainer.train_views.cameras
        pose_l = cams.w2c[i].cpu().numpy()
        pose_r = cams.w2c[j].cpu().numpy()
        poses = C.interpolate_pair_poses(pose_l, pose_r, cfg.num_frames)
        if cfg.perturb_interp_poses and cfg.num_frames > 2:
            # a rng per (cycle, pair): a resumed run perturbs as an
            # uninterrupted one does
            pair_rng = np.random.default_rng(cfg.seed + 1000 * cycle + pi)
            interior = C.perturb_and_select_poses(
                self.render_diffusion_res, self.diffusion_K, poses[1:-1],
                [pose_l, pose_r], pair_rng,
                render_many_fn=self.render_many_diffusion_res)
            poses = np.concatenate([poses[:1], interior, poses[-1:]])
        poses = C.pose_tensor(poses, self.device)
        # the endpoints are the input photos, nearest-upsized; only their
        # depths come from the GS render
        images = self.trainer.train_views.images
        img_l = resize_nearest(images[i], cfg.diffusion_height,
                               cfg.diffusion_width)
        img_r = resize_nearest(images[j], cfg.diffusion_height,
                               cfg.diffusion_width)
        _, depth_l = self.render_diffusion_res(poses[0])
        _, depth_r = self.render_diffusion_res(poses[-1])
        cond = C.prepare_pair_conditioning(
            self.render_diffusion_res, self.diffusion_K, poses, img_l,
            depth_l, img_r, depth_r, num_steps=cfg.num_inference_steps,
            warp_mode=cfg.interp_type,
            render_many_fn=self.render_many_diffusion_res)
        return poses, cond

    def densify_views(self, cycle: int, log_every: int = 0):
        """Completed frames (P, F, Hgs, Wgs, 3) and their poses
        (P, F, 4, 4) of every view pair, each pair cached."""
        cfg = self.cfg
        order = self._ordered_train_indices()
        n = len(order)
        num_pairs = n if cfg.densify_type == "interpolate_gs_v2" else n - 1
        expect = (cfg.num_frames, self.gs_height, self.gs_width, 3)
        results = {}

        # phase 1: cache hits, and the conditioning of the other pairs
        pending = []
        for pi in range(num_pairs):
            cache = self._cache_path(cycle, pi)
            if os.path.exists(cache):
                with np.load(cache) as data:
                    frames, poses = data["frames"], data["poses"]
                if frames.shape == expect:
                    results[pi] = (torch.as_tensor(frames, device=self.device),
                                   C.pose_tensor(poses, self.device))
                    continue
                print(f"[densify] ignoring stale cache {cache}: "
                      f"{frames.shape} != {expect}")
            poses, cond = self._pair_conditioning(cycle, pi, order[pi],
                                                  order[(pi + 1) % n])
            pending.append((pi, cache, cond, poses))

        # phase 2: completion, endpoints back, GS resolution, cache
        for pi, cache, cond, poses in pending:
            gen = torch.Generator(device=self.device).manual_seed(
                cfg.seed + 1000 * cycle + pi)
            frames = self.completion_fn(cond.image_start, cond.cond_images,
                                        cond.image_end, cond.masks,
                                        cond.lambda_ts, gen)
            frames = frames.to(device=self.device, dtype=torch.float32)
            if cfg.save_debug:
                dump_pair_debug(os.path.join(self.save_dir, "debug",
                                             f"cyc{cycle}_pair{pi}"),
                                cond, frames)
            if cfg.replace_endpoints:
                frames = torch.cat([cond.image_start[None], frames[1:-1],
                                    cond.image_end[None]])
            frames = torch.stack([
                resize_cubic_antialiased(f, self.gs_height, self.gs_width)
                for f in frames])
            np.savez(cache, frames=frames.cpu().numpy(),
                     poses=poses.cpu().numpy())
            results[pi] = (frames, poses)
            if log_every:
                print(f"[densify] cycle {cycle} pair {pi} done")

        return (torch.stack([results[pi][0] for pi in range(num_pairs)]),
                torch.stack([results[pi][1] for pi in range(num_pairs)]))

    def densify_pcds(self, frames, poses, cycle: int):
        """DUSt3R point cloud of the keyframes of the completed pairs:
        frames (P, F, Hgs, Wgs, 3), poses (P, F, 4, 4) w2c. Returns (xyz,
        rgb) numpy, or None without a dust3r_fn or with at most one
        keyframe a pair."""
        cfg = self.cfg
        if cfg.num_views_for_pcd_densification <= 1 or self.dust3r_fn is None:
            return None
        p, f = frames.shape[:2]
        poses_np = torch.as_tensor(poses).cpu().numpy()
        # keyframes per pair, sorted, the last dropped (it is the next
        # pair's first); frame 0 of a pair is an input view, and so is the
        # chain's very last frame
        key_idx, input_flags = [], []
        for pi in range(p):
            if cfg.fps_keyframe_sampling:
                loc = sorted(C.fps_keyframes(
                    poses_np[pi], cfg.num_views_for_pcd_densification))
            else:
                loc = list(np.linspace(0, f - 1,
                                       cfg.num_views_for_pcd_densification,
                                       dtype=int))
            for i in loc[:-1]:
                key_idx.append(pi * f + int(i))
                input_flags.append(int(i) == 0)
        if cfg.densify_type == "interpolate_loop0_gs":
            key_idx.append((p - 1) * f + f - 1)
            input_flags.append(True)
        flat_frames = torch.as_tensor(frames, device=self.device).reshape(
            -1, *frames.shape[2:])[key_idx]
        flat_poses = C.pose_tensor(poses, self.device).reshape(-1, 4, 4)[
            key_idx]
        log = self.pcd_logs[cycle] = dict(key_idx=key_idx,
                                          input_flags=input_flags)

        # the frame-quality gate: forward-backward flow consistency against
        # the GS render; input frames always pass, and it applies only if
        # at least two frames pass
        if self.flow_fn is not None:
            with self.timer.phase("pcd_flow_gate", sync=True):
                rendered, _ = self.render_many_gs_res(flat_poses)
                keep, means = [], []
                for i in range(len(key_idx)):
                    mean = None
                    if not input_flags[i]:
                        mean = float(correspondence_mask(
                            self.flow_fn, flat_frames[i], rendered[i])[2])
                    means.append(mean)
                    keep.append(input_flags[i]
                                or mean > cfg.pcd_frame_quality_thresh)
                keep = np.asarray(keep)
                if keep.sum() >= 2:
                    flat_frames = flat_frames[torch.as_tensor(keep)]
                    flat_poses = flat_poses[torch.as_tensor(keep)]
            log.update(gate_means=means, gate_keep=keep.tolist())

        c2w = se3_inverse(flat_poses)
        # DUSt3R's input: frames 512 wide, K scaled by 512 / W (both rows)
        scale = 512.0 / self.gs_width
        h512 = max(int(round(self.gs_height * scale)), 1)
        K512 = self.K_gs.clone()
        K512[:2] *= scale
        frames512 = resize_bilinear(flat_frames, h512, 512, antialias=True)
        xyz, rgb = self.dust3r_fn(frames512, c2w, K512)
        # a uniform downsample to ~1e5 points, then the statistical
        # outlier removal (20 neighbours, 3 std)
        every_k = max(1, len(xyz) // 100_000)
        n_fused = len(xyz)
        xyz, rgb = xyz[::every_k], rgb[::every_k]
        n_down = len(xyz)
        with self.timer.phase("pcd_outliers", sync=True):
            xyz, rgb = remove_statistical_outliers(xyz, rgb, k=20,
                                                   std_ratio=3.0,
                                                   device=self.device)
        write_ply_points(os.path.join(self.save_dir,
                                      f"dense_views_cyc{cycle}.ply"),
                         xyz, rgb)
        log.update(frames=len(flat_frames), fused=n_fused, every_k=every_k,
                   downsampled=n_down, kept=len(xyz))
        return xyz, rgb

    def _refine_view_stack(self, frames, poses):
        """(P, F, ...) pair stacks -> the numpy pseudo-view set: each pair's
        frames[:-1] (its last frame is the next pair's first); the
        'interpolate_loop0_gs' chain appends the last pair's final frame."""
        frames = torch.as_tensor(frames).cpu().numpy()
        poses = torch.as_tensor(poses).cpu().numpy()
        p, f = frames.shape[:2]
        flat_f = frames[:, :-1].reshape(p * (f - 1), *frames.shape[2:])
        flat_p = poses[:, :-1].reshape(p * (f - 1), 4, 4)
        if self.cfg.densify_type == "interpolate_loop0_gs":
            flat_f = np.concatenate([flat_f, frames[-1, -1:]])
            flat_p = np.concatenate([flat_p, poses[-1, -1:]])
        return flat_f, flat_p

    def refine_GS(self, frames, poses, cycle: int, load_ckpt: bool = False,
                  log_every: int = 0):
        """Install the pseudo views and finetune."""
        cfg = self.cfg
        tr = self.trainer
        if load_ckpt:
            ckpt = tr.latest_checkpoint()
            if ckpt:
                tr.load_checkpoint(ckpt)
        flat_frames, flat_poses = self._refine_view_stack(frames, poses)
        depths = None
        if cfg.capture_pseudo_depth and tr.cfg.svd_depth_warmup > 0:
            depths = self.render_many_gs_res(flat_poses)[1].cpu().numpy()
        tr.update_cameras(flat_frames, flat_poses, self.K_gs.cpu().numpy(),
                          cam_confidences=cfg.cam_confidence, append=False,
                          depths=depths)
        tr.reset_optimizers()
        tr.reset_gs()
        tr.use_lpips_loss = cfg.use_lpips_loss
        try:
            return tr.finetune(
                0, cycle, disable_densification=cfg.disable_densification,
                pseudo_cam_sampling_rate=cfg.pseudo_cam_sampling_rate,
                log_every=log_every)
        finally:
            tr.use_lpips_loss = False

    def run(self, refine_cycles: Optional[int] = None, log_every: int = 0):
        """The full test-time loop."""
        cycles = (refine_cycles if refine_cycles is not None
                  else self.cfg.refine_cycle_num)
        with self.timer.phase("init_gs", sync=True):
            self.init_GS(0, log_every=log_every)
        for cyc in range(cycles):
            # resume from the latest checkpoint before any point-cloud
            # reset (the JAX package's order)
            if cyc > 0:
                ckpt = self.trainer.latest_checkpoint()
                if ckpt:
                    self.trainer.load_checkpoint(ckpt)
            with self.timer.phase("densify", sync=True):
                frames, poses = self.densify_views(cyc, log_every=log_every)
            with self.timer.phase("densify_pcd", sync=True):
                pcd = self.densify_pcds(frames, poses, cyc)
            if pcd is not None:
                self.trainer.reset_gaussians_from_pcd(
                    pcd[0], pcd[1], append_to_old_gaussians=(cyc > 0))
            with self.timer.phase("refine", sync=True):
                self.refine_GS(frames, poses, cycle=cyc, load_ckpt=False,
                               log_every=log_every)
        if log_every:
            print("[timing]", self.timer.report())
        return self.trainer
