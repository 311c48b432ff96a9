"""The 3DGS test-time trainer.

Counterpart of ``syn3r_tpu/gs/trainer.py``: one train step renders the
picked view, takes the confidence-weighted L1 + DSSIM loss (plus the
Pearson depth term on SVD pseudo views), its gradients, a per-field Adam
step and the densify statistics. Densify/prune runs at fixed capacity
(``gs/densify.py``) and capacity doubles when occupancy passes 85%. The
view picks use the JAX package's numpy stream, so both trainers pick the
same views from the same seed. Checkpoints are npz files with the JAX
package's names and keys, so each package loads the other's.

The loop runs by segments, as JAX's does: ``_next_boundary`` ends a
segment where a host action may run (densify, opacity reset, capacity
growth, a log line); the host pre-picks the segment's views into indices
of the merged train + pseudo set (``_merged_views``) and runs its steps
as one static-shape step (``_static_step``: the view, the depth flag, the
step and Adam's count are device tensors, and every result is written
back into the buffers it read). On a CUDA device that step is captured
once as a CUDA graph and replayed (``gs/step_graph.py``, the counterpart
of JAX's ``lax.scan`` segments); it is captured again only when the
capacity, the view count, the resolution, ``use_depth`` or ``use_lpips``
changes. The capture bakes in the config's learning rates, loss weights
and rasterizer, as JAX's trace does. On the CPU it runs eagerly. The
per-step path (``_train_step``) runs where JAX's does: when the two view
sets differ in resolution, or for a segment of one step.
``render_views_batch`` replays one captured render per camera, like JAX's
``_render_many_jit``.

``TrainConfig.rasterizer``: ``"kernel"`` (the tile composite kernels, the
default), ``"tiled"`` (the same tiles, plain torch composite) or
``"dense"``. ``GSTrainer(..., device="cuda")`` resolves through
``device.resolve_device``: the CPU runs only when the caller asks for it.

The LPIPS refine loss (``set_lpips`` with the JAX package's converted VGG
params, gated by ``use_lpips_loss``, which the orchestrator turns on around
``refine_GS``) adds ``confidence x lpips_weight x LPIPS(render, target)``;
the LPIPS module takes cuDNN's deterministic convolutions for it and its
gradient, so a step's graph replay and its per-step run agree bit for
bit.

The monocular-depth pseudo step (``set_mono_depth_fn`` with a caller's
estimator rgb -> depth; ``sample_pseudo_interval`` is 1e20, off, in every
shipped config): at each due iteration, between segments, a virtual
camera interpolated between TSP-adjacent train cameras is rendered, the
estimator gives its depth, and one Adam step takes the Pearson depth loss
of the render through the same rasterizer route as a train step (the
composite kernels on the card); the densify statistics do not change.
"""

from __future__ import annotations

import dataclasses
import glob
import math
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import gaussians as G
from ..models.lpips import LPIPS, lpips_module
from ..ops import rasterize as rz
from ..ops.composite import composite_tiles
from ..utils import se3
from ..utils.camera import Camera, make_camera, stack_cameras
from . import losses
from .densify import DensifyStats, densify_and_prune, reset_opacity
from .step_graph import StepGraph, upload

# steps one upload of a segment's view picks holds (a longer segment
# uploads again), and cameras a replayed batch render writes before their
# frames are copied out
SEGMENT_STEPS = 1024
RENDER_FRAMES = 16


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` fields and defaults, except
    ``rasterizer`` (see the module docstring)."""
    iterations: int = 10_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    lambda_dssim: float = 0.2
    lpips_weight: float = 1.0
    svd_depth_warmup: int = 0
    depth_loss_weight: float = 0.05
    densify_from_iter: int = 500
    densify_until_iter: int = 10_000
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_grad_threshold: float = 2e-4
    percent_dense: float = 0.01
    min_opacity: float = 0.005
    max_world_scale: Optional[float] = 0.1
    max_screen_size: Optional[float] = 20.0
    capacity_growth_occupancy: float = 0.85
    max_capacity: int = 2 ** 21
    use_proximity_densify: bool = False
    proximity_threshold: float = 0.01
    sample_pseudo_interval: int = 10 ** 20
    start_sample_pseudo: int = 2_000
    mono_depth_weight: float = 0.05
    mono_pseudo_per_pair: int = 10
    sample_svd_pseudo_interval: int = 2
    start_sample_svd_iter: int = 2_000
    pseudo_cam_sampling_rate: float = 0.0
    rasterizer: str = "kernel"
    tile_cap: int = 1024
    sh_degree: int = 3
    chunk: int = 256
    group: int = 8        # the JAX scan's remat group; no effect here
    bg_color: tuple = (0.0, 0.0, 0.0)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class AdamState:
    mu: dict
    nu: dict
    count: int

    @staticmethod
    def init(params: dict) -> "AdamState":
        return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                         nu={k: torch.zeros_like(v) for k, v in params.items()},
                         count=0)


def position_lr(cfg: TrainConfig, extent: float, step: int) -> float:
    """3DGS log-linear decay of the position learning rate, times the
    scene extent."""
    t = min(max(step / cfg.position_lr_max_steps, 0.0), 1.0)
    return extent * math.exp((1 - t) * math.log(cfg.position_lr_init)
                             + t * math.log(cfg.position_lr_final))


def adam_corrections(count: int, b1: float = 0.9,
                     b2: float = 0.999) -> tuple[float, float]:
    """The reciprocals of Adam's bias corrections, 1 / (1 - b1^count) and
    1 / (1 - b2^count)."""
    return 1.0 / (1.0 - b1 ** count), 1.0 / (1.0 - b2 ** count)


def adam_update(params: dict, grads: dict, st: AdamState, lrs: dict,
                corrections=None, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15) -> tuple[dict, AdamState]:
    """One Adam step. ``corrections``: ``adam_corrections`` of step
    ``st.count + 1`` as host floats or device scalars (computed here by
    default). The moments are multiplied by them, never divided: a CUDA
    division by a host scalar multiplies by its reciprocal, by a device
    scalar it divides, and the two round differently."""
    count = st.count + 1
    ic1, ic2 = corrections or adam_corrections(count, b1, b2)
    new_p, new_mu, new_nu = {}, {}, {}
    for k in params:
        mu = b1 * st.mu[k] + (1 - b1) * grads[k]
        nu = b2 * st.nu[k] + (1 - b2) * grads[k] ** 2
        new_p[k] = params[k] - lrs[k] * (mu * ic1) / (torch.sqrt(nu * ic2)
                                                       + eps)
        new_mu[k], new_nu[k] = mu, nu
    return new_p, AdamState(mu=new_mu, nu=new_nu, count=count)


@dataclasses.dataclass(frozen=True)
class ViewSet:
    """Stacked cameras and their target images (V, H, W, 3) in [0, 1]."""
    cameras: Camera
    images: torch.Tensor

    def __len__(self):
        return self.images.shape[0]

    def view(self, i: int) -> tuple[Camera, torch.Tensor]:
        return self.cameras.at(i), self.images[i]

    def to(self, device) -> "ViewSet":
        return ViewSet(cameras=self.cameras.to(device),
                       images=self.images.to(device))


def make_viewset(cams: list[Camera], images) -> ViewSet:
    return ViewSet(cameras=stack_cameras(cams),
                   images=torch.as_tensor(images, dtype=torch.float32))


def scene_extent(cams: Camera) -> float:
    """1.1 x the largest distance of a camera from the mean camera centre."""
    pos = cams.position.detach().cpu().numpy()
    return float(1.1 * np.linalg.norm(pos - pos.mean(0, keepdims=True),
                                      axis=-1).max())


def order_cameras_tsp(cams: Camera) -> list[int]:
    """Greedy nearest-neighbour ordering by camera position."""
    pos = cams.position.detach().cpu().numpy()
    todo = set(range(1, len(pos)))
    order = [0]
    while todo:
        cur = pos[order[-1]]
        nxt = min(todo, key=lambda j: np.linalg.norm(pos[j] - cur))
        order.append(nxt)
        todo.remove(nxt)
    return order


@dataclasses.dataclass(frozen=True)
class TrainState:
    gaussians: G.GaussianState
    adam: AdamState
    stats: DensifyStats
    step: int


class GSTrainer:
    """Per-scene Gaussian-splatting optimizer: ``training`` / ``finetune`` /
    ``render_view`` / ``update_cameras`` / ``reset_optimizers`` /
    ``reset_gs`` / ``reset_gaussians_from_pcd`` / checkpoints."""

    def __init__(self, train_views: ViewSet, config: TrainConfig,
                 init_state: G.GaussianState,
                 model_path: str = "syn3r_model",
                 test_views: Optional[ViewSet] = None,
                 device: str | torch.device = "cuda"):
        if config.rasterizer not in ("kernel", "tiled", "dense"):
            raise ValueError(f"unknown rasterizer {config.rasterizer!r}")
        self.device = resolve_device(device)
        self.cfg = config
        self.train_views = train_views.to(self.device)
        self.test_views = (test_views.to(self.device)
                           if test_views is not None else None)
        self.pseudo_views: Optional[ViewSet] = None
        self.pseudo_depths: Optional[torch.Tensor] = None
        self.use_lpips_loss = False
        self._lpips: Optional[LPIPS] = None
        self.model_path = model_path
        os.makedirs(model_path, exist_ok=True)
        self.extent = max(scene_extent(self.train_views.cameras), 1e-6)
        self.state = self._fresh_state(init_state.to(self.device), step=0)
        self._rng = np.random.default_rng(config.seed)
        self._gen = torch.Generator(device=self.device).manual_seed(
            config.seed)
        # read once: a captured step holds this tensor's address
        self._bg = torch.tensor(config.bg_color, dtype=torch.float32,
                                device=self.device)
        self._mono_depth_fn = None
        self._mono_pseudo_cams: Optional[Camera] = None
        self._segments: Optional[StepGraph] = None
        self._renders: dict[tuple, StepGraph] = {}     # one per (H, W)
        # holders built, one capture each on CUDA: {"step": n, "render": n}
        self.graph_builds = {"step": 0, "render": 0}

    def _fresh_state(self, g: G.GaussianState, step: int) -> TrainState:
        return TrainState(gaussians=g, adam=AdamState.init(G.get_params(g)),
                          stats=DensifyStats.zeros(g.capacity, self.device),
                          step=step)

    def _render(self, g: G.GaussianState, camera: Camera,
                center_offset=None):
        cfg = self.cfg
        sg = rz.project_gaussians(g, camera, sh_degree=cfg.sh_degree,
                                  center_offset=center_offset)
        if cfg.rasterizer == "dense":
            return sg, rz.rasterize(sg, camera.height, camera.width,
                                    bg=self._bg, chunk=cfg.chunk)
        return sg, rz.rasterize_tiled(
            sg, camera.height, camera.width, cap=cfg.tile_cap, bg=self._bg,
            chunk=min(cfg.chunk, cfg.tile_cap),
            composite="kernel" if cfg.rasterizer == "kernel" else "plain")

    # -- one step -------------------------------------------------------------

    def _step_math(self, g: G.GaussianState, adam: AdamState,
                   stats: DensifyStats, camera: Camera, image: torch.Tensor,
                   depth_target, depth_flag, use_depth: bool, lr_means,
                   corrections=None, use_lpips: bool = False):
        """One optimization step as math on tensors, shared by the per-step
        path (``_train_step``: host floats) and the static step (device
        scalars), as JAX's ``_step_math`` serves its per-step jit and its
        scan. ``lr_means`` is the position learning rate of this step and
        ``corrections`` Adam's bias corrections (``adam_update``); both are
        computed on the host by the same code on either path, so the paths
        take the same float32 values. ``depth_flag`` gates the depth term (0
        on a train view inside a segment); ``use_depth`` removes it
        statically, as ``use_lpips`` the LPIPS term. Returns (params, adam,
        stats, loss), new tensors."""
        cfg = self.cfg
        params = {k: v.detach().requires_grad_(True)
                  for k, v in G.get_params(g).items()}
        offset = torch.zeros((g.capacity, 2), device=self.device,
                             requires_grad=True)
        sg, out = self._render(G.with_params(g, params), camera, offset)
        loss = losses.photometric_loss(out.rgb, image,
                                       lambda_dssim=cfg.lambda_dssim,
                                       confidence=camera.confidence)
        if use_lpips:
            loss = loss + camera.confidence * cfg.lpips_weight \
                * self._lpips(out.rgb, image)
        if use_depth:
            pred_depth = torch.where(
                out.alpha > 1e-6,
                out.depth / torch.clamp(out.alpha, min=1e-6), 0.0)
            loss = loss + depth_flag * cfg.depth_loss_weight \
                * losses.pearson_depth_loss(pred_depth, depth_target,
                                            valid=depth_target > 0)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names]
                                    + [offset])
        g_off = grads[-1]
        grads = dict(zip(names, grads[:-1]))

        with torch.no_grad():
            new_params, new_adam = adam_update(
                {k: v.detach() for k, v in params.items()}, grads, adam,
                self._lrs(lr_means), corrections)
            # densify statistics: the screen-centre gradient in the CUDA
            # rasterizer's NDC scale (pixel grad x W/2, H/2)
            screen = torch.stack([g_off[:, 0] * (camera.width * 0.5),
                                  g_off[:, 1] * (camera.height * 0.5)], -1)
            c, r = sg.center.detach(), sg.radius
            visible = (sg.valid & (r > 0) & (c[:, 0] > -r)
                       & (c[:, 0] < camera.width + r) & (c[:, 1] > -r)
                       & (c[:, 1] < camera.height + r))
            new_stats = stats.update(screen, r, visible)
        return new_params, new_adam, new_stats, loss.detach()

    def _lrs(self, lr_means) -> dict:
        """Adam's learning rate of each parameter field."""
        cfg = self.cfg
        return {"means": lr_means, "quats": cfg.rotation_lr,
                "log_scales": cfg.scaling_lr,
                "opacity_logits": cfg.opacity_lr, "sh_dc": cfg.feature_lr,
                "sh_rest": cfg.feature_lr / 20.0}

    def _train_step(self, ts: TrainState, camera: Camera,
                    image: torch.Tensor, depth_target=None,
                    use_depth: bool = False,
                    use_lpips: bool = False) -> tuple[TrainState, dict]:
        """One optimization step: returns (new state, {"loss": tensor})."""
        params, adam, stats, loss = self._step_math(
            ts.gaussians, ts.adam, ts.stats, camera, image, depth_target, 1.0,
            use_depth, position_lr(self.cfg, self.extent, ts.step),
            use_lpips=use_lpips)
        new_ts = TrainState(gaussians=G.with_params(ts.gaussians, params),
                            adam=adam, stats=stats, step=ts.step + 1)
        return new_ts, {"loss": loss}

    def _static_step(self, b: dict, use_depth: bool, use_lpips: bool):
        """One step over the segment buffers ``b`` (``_segment_buffers``),
        in place: entry ``b["j"]`` of the uploaded picks chooses the view
        of the merged set, and of the uploaded scalars the depth flag, the
        position learning rate and Adam's bias corrections; every result
        is copied back into the tensor it came from. Nothing here waits
        for the card, so the step captures as a CUDA graph."""
        j = b["j"].view(1)
        i = b["idx"].index_select(0, j)
        flag, lr, ic1, ic2 = b["scalars"].index_select(0, j)[0]
        cams = b["cams"]
        cam = dataclasses.replace(
            cams, K=cams.K.index_select(0, i)[0],
            w2c=cams.w2c.index_select(0, i)[0],
            confidence=cams.confidence.index_select(0, i)[0])
        image = b["images"].index_select(0, i)[0]
        depth = b["depths"].index_select(0, i)[0] if use_depth else None
        g = G.GaussianState(**b["params"], active=b["active"])
        params, adam, stats, loss = self._step_math(
            g, AdamState(mu=b["mu"], nu=b["nu"], count=0),
            DensifyStats(**b["stats"]), cam, image, depth, flag, use_depth,
            lr, (ic1, ic2), use_lpips)
        with torch.no_grad():
            for k in G.PARAM_FIELDS:
                b["params"][k].copy_(params[k])
                b["mu"][k].copy_(adam.mu[k])
                b["nu"][k].copy_(adam.nu[k])
            for k, v in b["stats"].items():
                v.copy_(getattr(stats, k))
            b["loss"].copy_(loss)
            b["j"].add_(1)

    def _mono_pseudo_step(self, ts: TrainState, camera: Camera,
                          est_depth: torch.Tensor
                          ) -> tuple[TrainState, dict]:
        """One monocular pseudo-view step: the Pearson depth loss between
        the render at a virtual camera and an estimate of its depth, then
        Adam on the parameters (no densify statistics: the view has no
        photometric target)."""
        cfg = self.cfg
        g = ts.gaussians
        params = {k: v.detach().requires_grad_(True)
                  for k, v in G.get_params(g).items()}
        _, out = self._render(G.with_params(g, params), camera)
        pred_depth = torch.where(
            out.alpha > 1e-6, out.depth / torch.clamp(out.alpha, min=1e-6),
            0.0)
        loss = cfg.mono_depth_weight * losses.pearson_depth_loss(
            pred_depth, est_depth, valid=est_depth > 0)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names])))
        with torch.no_grad():
            new_params, new_adam = adam_update(
                {k: v.detach() for k, v in params.items()}, grads, ts.adam,
                self._lrs(position_lr(cfg, self.extent, ts.step)))
        return (TrainState(gaussians=G.with_params(g, new_params),
                           adam=new_adam, stats=ts.stats, step=ts.step),
                {"loss": loss.detach()})

    def _get_mono_pseudo_cams(self) -> Camera:
        """Virtual cameras, ``mono_pseudo_per_pair`` between each two
        TSP-adjacent train cameras (endpoints excluded), built once."""
        if self._mono_pseudo_cams is None:
            cams = self.train_views.cameras
            order = order_cameras_tsp(cams)
            out = []
            for a, b in zip(order[:-1], order[1:]):
                ca, cb = cams.at(a), cams.at(b)
                poses = se3.interpolate_poses(
                    ca.w2c, cb.w2c, self.cfg.mono_pseudo_per_pair + 2)
                out += [make_camera(ca.K, p, ca.width, ca.height,
                                    device=self.device)
                        for p in poses[1:-1]]
            self._mono_pseudo_cams = stack_cameras(out)
        return self._mono_pseudo_cams

    def _maybe_mono_pseudo(self, it: int):
        """The mono-depth pseudo step when it is due: an estimator is
        installed, the interval is finite and ``it`` a multiple of it from
        ``start_sample_pseudo`` on. The camera is drawn from the view
        stream after the segment's picks, as JAX draws it."""
        cfg = self.cfg
        if (self._mono_depth_fn is None
                or cfg.sample_pseudo_interval >= 10 ** 9
                or cfg.sample_pseudo_interval <= 0
                or it < cfg.start_sample_pseudo
                or it % cfg.sample_pseudo_interval):
            return
        pcams = self._get_mono_pseudo_cams()
        cam = pcams.at(int(self._rng.integers(len(pcams))))
        with torch.no_grad():
            rgb = self._render(self.state.gaussians, cam)[1].rgb
            est = self._mono_depth_fn(rgb).detach()
        self.state, _ = self._mono_pseudo_step(self.state, cam, est)

    def _densify_step(self, ts: TrainState) -> TrainState:
        cfg = self.cfg
        new_g, changed = densify_and_prune(
            ts.gaussians, ts.stats, self._gen,
            grad_threshold=cfg.densify_grad_threshold,
            percent_dense=cfg.percent_dense, extent=self.extent,
            min_opacity=cfg.min_opacity,
            max_world_scale=cfg.max_world_scale,
            max_screen_size=cfg.max_screen_size,
            big_point_gate=ts.step > cfg.opacity_reset_interval,
            use_proximity=cfg.use_proximity_densify,
            proximity_threshold=cfg.proximity_threshold)

        def zero_changed(x):
            return torch.where(changed.reshape((-1,) + (1,) * (x.ndim - 1)),
                               0.0, x)
        adam = AdamState(mu={k: zero_changed(v) for k, v in ts.adam.mu.items()},
                         nu={k: zero_changed(v) for k, v in ts.adam.nu.items()},
                         count=ts.adam.count)
        return TrainState(gaussians=new_g, adam=adam,
                          stats=DensifyStats.zeros(new_g.capacity,
                                                   self.device),
                          step=ts.step)

    def _reset_opacity_step(self, ts: TrainState) -> TrainState:
        mu = dict(ts.adam.mu, opacity_logits=torch.zeros_like(
            ts.adam.mu["opacity_logits"]))
        nu = dict(ts.adam.nu, opacity_logits=torch.zeros_like(
            ts.adam.nu["opacity_logits"]))
        return dataclasses.replace(
            ts, gaussians=reset_opacity(ts.gaussians),
            adam=AdamState(mu=mu, nu=nu, count=ts.adam.count))

    def _maybe_grow(self):
        g = self.state.gaussians
        if g.num_active / g.capacity <= self.cfg.capacity_growth_occupancy:
            return
        if g.capacity * 2 > self.cfg.max_capacity:
            return                       # at the ceiling: densify into freed
        new_cap = g.capacity * 2

        def pad(x):
            return torch.cat([x, x.new_zeros((new_cap - g.capacity,)
                                             + x.shape[1:])])
        adam = self.state.adam
        self.state = TrainState(
            gaussians=G.GaussianState(
                **{f: pad(getattr(g, f)) for f in G.PARAM_FIELDS},
                active=pad(g.active)),
            adam=AdamState(mu={k: pad(v) for k, v in adam.mu.items()},
                           nu={k: pad(v) for k, v in adam.nu.items()},
                           count=adam.count),
            stats=DensifyStats.zeros(new_cap, self.device),
            step=self.state.step)

    # -- the loop ---------------------------------------------------------------

    @property
    def gaussians(self) -> G.GaussianState:
        return self.state.gaussians

    def _pick_view_index(self, it: int) -> tuple[int, bool]:
        """(index into its set, is_pseudo), in the JAX package's RNG draw
        order."""
        cfg = self.cfg
        eligible = (self.pseudo_views is not None
                    and len(self.pseudo_views) > 0
                    and it >= cfg.start_sample_svd_iter
                    and cfg.sample_svd_pseudo_interval > 0
                    and it % cfg.sample_svd_pseudo_interval == 0)
        if eligible:
            p = (1.0 if cfg.pseudo_cam_sampling_rate <= 0
                 else min(1.0, cfg.pseudo_cam_sampling_rate))
            if self._rng.random() < p:
                return int(self._rng.integers(len(self.pseudo_views))), True
        return int(self._rng.integers(len(self.train_views))), False

    def _merged_views(self):
        """Train + pseudo views as one set for the segment path: (cameras,
        images (V, H, W, 3), depths (V, H, W)), train views first, zeros
        where a view has no depth target. None when the two sets'
        resolutions differ (then the per-step path runs)."""
        tv = self.train_views
        zeros = torch.zeros(tv.images.shape[:3], dtype=torch.float32,
                            device=self.device)
        if self.pseudo_views is None or len(self.pseudo_views) == 0:
            return tv.cameras, tv.images, zeros
        pv = self.pseudo_views
        if tv.images.shape[1:] != pv.images.shape[1:]:
            return None
        a, c = tv.cameras, pv.cameras
        cams = dataclasses.replace(
            a, K=torch.cat([a.K, c.K]), w2c=torch.cat([a.w2c, c.w2c]),
            confidence=torch.cat([a.confidence, c.confidence]))
        images = torch.cat([tv.images, pv.images])
        if self.pseudo_depths is not None:
            depths = torch.cat([zeros, self.pseudo_depths.float()])
        else:
            depths = torch.zeros(images.shape[:3], dtype=torch.float32,
                                 device=self.device)
        return cams, images, depths

    def _next_boundary(self, it: int, end_iter: int, densify: bool,
                       log_every: int) -> int:
        """First iteration count (exclusive end) after ``it`` at which a
        host action (densify, opacity reset, capacity growth, a log line)
        may run: every multiple of each interval, as JAX's."""
        cfg = self.cfg
        nxt = end_iter
        intervals = []
        if densify:
            intervals += [cfg.densification_interval,
                          cfg.opacity_reset_interval]
        if log_every:
            intervals.append(log_every)
        if (self._mono_depth_fn is not None
                and 0 < cfg.sample_pseudo_interval < 10 ** 9):
            intervals.append(cfg.sample_pseudo_interval)
        for iv in intervals:
            if iv and iv > 0:
                nxt = min(nxt, ((it // iv) + 1) * iv)
        return max(nxt, it + 1)

    def _pick_segment(self, it: int, k: int) -> tuple[np.ndarray,
                                                      np.ndarray]:
        """The view picks of iterations it .. it + k - 1 in
        ``_pick_view_index``'s draw order, as JAX's ``_run_loop`` makes
        them: indices into the merged set (pseudo views after the train
        views) and 0/1 depth flags (1 on a pseudo pick)."""
        n_train = len(self.train_views)
        idx = np.empty(k, np.int64)
        flags = np.zeros(k, np.float32)
        for j in range(k):
            i, is_pseudo = self._pick_view_index(it + j)
            idx[j] = i + n_train if is_pseudo else i
            flags[j] = 1.0 if is_pseudo else 0.0
        return idx, flags

    def _segment_buffers(self, merged, use_depth: bool) -> dict:
        """The static tensors of ``_static_step``: the state's parameters,
        active mask, Adam moments and densify statistics; the merged views;
        an upload of picks and per-step scalars, the entry counter j and
        the last step's loss."""
        g, dev = self.state.gaussians, self.device
        cams, images, depths = merged

        def like(t):
            return torch.empty_like(t, device=dev)
        return dict(
            params={k: like(v) for k, v in G.get_params(g).items()},
            active=like(g.active),
            mu={k: like(v) for k, v in G.get_params(g).items()},
            nu={k: like(v) for k, v in G.get_params(g).items()},
            stats={k: torch.zeros((g.capacity,), device=dev)
                   for k in ("grad_accum", "denom", "max_radii")},
            cams=dataclasses.replace(cams, K=like(cams.K),
                                     w2c=like(cams.w2c),
                                     confidence=like(cams.confidence)),
            images=like(images),
            depths=like(depths) if use_depth else None,
            idx=torch.zeros((SEGMENT_STEPS,), dtype=torch.int64, device=dev),
            # per step: depth flag, position lr, adam_corrections
            scalars=torch.zeros((SEGMENT_STEPS, 4), device=dev),
            j=torch.zeros((), dtype=torch.int64, device=dev),
            loss=torch.zeros((), device=dev))

    def _load_segment_state(self, b: dict, merged):
        """``self.state`` and the merged views into the segment buffers."""
        ts = self.state
        with torch.no_grad():
            for k, v in G.get_params(ts.gaussians).items():
                b["params"][k].copy_(v)
                b["mu"][k].copy_(ts.adam.mu[k])
                b["nu"][k].copy_(ts.adam.nu[k])
            b["active"].copy_(ts.gaussians.active)
            for k, v in b["stats"].items():
                v.copy_(getattr(ts.stats, k))
            cams, images, depths = merged
            for f in ("K", "w2c", "confidence"):
                getattr(b["cams"], f).copy_(getattr(cams, f))
            b["images"].copy_(images)
            if b["depths"] is not None:
                b["depths"].copy_(depths)

    def _run_segment(self, merged, idx: np.ndarray, flags: np.ndarray,
                     use_depth: bool, use_lpips: bool) -> torch.Tensor:
        """The steps of one segment through the static step: replays of
        its captured graph on CUDA, eager calls on the CPU. ``self.state``
        is copied in and comes back as new tensors, which no later replay
        writes. Returns the last step's loss."""
        ts, k = self.state, len(idx)
        g = ts.gaussians
        scalars = np.empty((k, 4), np.float32)
        for j in range(k):
            scalars[j] = (flags[j],
                          position_lr(self.cfg, self.extent, ts.step + j),
                          *adam_corrections(ts.adam.count + j + 1))

        def load(b, s0):
            upload(b["idx"], idx[s0:s0 + SEGMENT_STEPS])
            upload(b["scalars"], scalars[s0:s0 + SEGMENT_STEPS])
            b["j"].zero_()
            return min(SEGMENT_STEPS, k - s0)

        key = (g.capacity, merged[1].shape, use_depth, use_lpips)
        seg = self._segments
        if seg is None or seg.key != key:
            self._segments = seg = None          # free the old capture
            bufs = self._segment_buffers(merged, use_depth)
            self._load_segment_state(bufs, merged)
            load(bufs, 0)               # the warm-up runs the first steps
            seg = StepGraph(key, bufs,
                            lambda b: self._static_step(b, use_depth,
                                                        use_lpips),
                            self.device, [composite_tiles.launches])
            self._segments = seg
            self.graph_builds["step"] += 1
        b = seg.bufs
        self._load_segment_state(b, merged)
        for s0 in range(0, k, SEGMENT_STEPS):
            seg.run(load(b, s0))
        self.state = TrainState(
            gaussians=G.GaussianState(
                **{f: b["params"][f].clone() for f in G.PARAM_FIELDS},
                active=g.active),
            adam=AdamState(mu={f: v.clone() for f, v in b["mu"].items()},
                           nu={f: v.clone() for f, v in b["nu"].items()},
                           count=ts.adam.count + k),
            stats=DensifyStats(**{f: v.clone()
                                  for f, v in b["stats"].items()}),
            step=ts.step + k)
        return b["loss"].clone()

    def _run_loop(self, start_iter: int, end_iter: int,
                  densify: bool = True, log_every: int = 0) -> float:
        """Iterations start_iter .. end_iter - 1 by segments, the host
        actions at each boundary in JAX's order."""
        cfg = self.cfg
        use_lpips = bool(self.use_lpips_loss and self._lpips is not None
                         and cfg.lpips_weight > 0)
        use_depth = bool(cfg.svd_depth_warmup > 0
                         and self.pseudo_depths is not None
                         and self.pseudo_views is not None
                         and len(self.pseudo_views) > 0)
        merged = self._merged_views()
        last_loss, loss = float("nan"), None
        it = start_iter
        while it < end_iter:
            seg_end = self._next_boundary(it, end_iter, densify, log_every)
            k = seg_end - it
            if merged is not None and k > 1:
                idx, flags = self._pick_segment(it, k)
                loss = self._run_segment(merged, idx, flags, use_depth,
                                         use_lpips)
            else:
                for j in range(k):
                    i, is_pseudo = self._pick_view_index(it + j)
                    views = self.pseudo_views if is_pseudo \
                        else self.train_views
                    cam, img = views.view(i)
                    ud = is_pseudo and use_depth
                    depth_t = self.pseudo_depths[i] if ud else None
                    self.state, metrics = self._train_step(
                        self.state, cam, img, depth_t, use_depth=ud,
                        use_lpips=use_lpips)
                    loss = metrics["loss"]
            it = seg_end
            last = it - 1       # the iteration the boundary checks see
            if densify and cfg.densify_from_iter <= last \
                    < cfg.densify_until_iter:
                if (last + 1) % cfg.densification_interval == 0:
                    self.state = self._densify_step(self.state)
                    self._maybe_grow()
                if (last + 1) % cfg.opacity_reset_interval == 0:
                    self.state = self._reset_opacity_step(self.state)
            self._maybe_mono_pseudo(last + 1)
            if log_every and (last + 1) % log_every == 0:
                last_loss = float(loss)
                print(f"[gs] iter {last + 1} loss {last_loss:.4f} "
                      f"active {self.gaussians.num_active}")
        return last_loss

    def set_lpips(self, params: dict):
        """Install converted LPIPS (VGG) params, the JAX package's tree
        (``utils.params.load_params`` of its ``.npz``; see
        ``models/lpips.py``). The loss itself is gated by
        ``use_lpips_loss``, which the orchestrator turns on around
        ``refine_GS``."""
        self._lpips = lpips_module(params, self.device)
        self._segments = None      # a capture holds the old weights

    def set_mono_depth_fn(self, fn):
        """Install the monocular depth estimator rgb (H, W, 3) -> depth
        (H, W) of the ``sample_pseudo_interval`` step (FSGS uses a frozen
        DPT; none is in the repo)."""
        self._mono_depth_fn = fn
        self._mono_pseudo_cams = None

    def training(self, start_iter: int = 0, epoch_indicator: int = 0,
                 log_every: int = 0) -> float:
        """The initial fit; saves ``chkpnt{iterations}``."""
        loss = self._run_loop(start_iter, self.cfg.iterations, densify=True,
                              log_every=log_every)
        self.save_checkpoint(self.cfg.iterations,
                             epoch=epoch_indicator if epoch_indicator
                             else None)
        return loss

    def finetune(self, start_iter: int = 0, epoch: int = 0,
                 disable_densification: bool = False,
                 pseudo_cam_sampling_rate: float = None,
                 log_every: int = 0) -> float:
        """Refinement on input + pseudo views; ``pseudo_cam_sampling_rate``
        overrides the config for this phase."""
        prev = self.cfg.pseudo_cam_sampling_rate
        if pseudo_cam_sampling_rate is not None:
            self.cfg.pseudo_cam_sampling_rate = pseudo_cam_sampling_rate
        try:
            loss = self._run_loop(start_iter, self.cfg.iterations,
                                  densify=not disable_densification,
                                  log_every=log_every)
        finally:
            self.cfg.pseudo_cam_sampling_rate = prev
        self.save_checkpoint(self.cfg.iterations, epoch=epoch)
        return loss

    # -- rendering ----------------------------------------------------------------

    @torch.no_grad()
    def render_view(self, camera: Camera) -> dict:
        """Colour, alpha-normalized depth (0 in holes), accumulated depth
        and alpha at ``camera``."""
        _, out = self._render(self.state.gaussians, camera.to(self.device))
        alpha = out.alpha
        depth = torch.where(alpha > 1e-6,
                            out.depth / torch.clamp(alpha, min=1e-6), 0.0)
        return {"render": out.rgb, "depth": depth, "depth_acc": out.depth,
                "alpha": alpha}

    @torch.no_grad()
    def render_views_batch(self, cameras: Camera):
        """Render a stacked batch of same-size cameras: returns (rgb (P, H,
        W, 3), depth (P, H, W)), each frame as ``render_view`` gives it.
        One static render (``_static_render``) is replayed per camera, from
        a CUDA graph on the card, like JAX's one-dispatch
        ``_render_many_jit``; the cameras go up RENDER_FRAMES at a time and
        their frames come back the same way. A capture is kept per
        resolution (the orchestrator renders at two) and made again when
        the capacity changes."""
        g = self.state.gaussians
        p, h, w = len(cameras), cameras.height, cameras.width
        dev = self.device
        if p == 0:
            return (torch.zeros((0, h, w, 3), device=dev),
                    torch.zeros((0, h, w), device=dev))
        key = (g.capacity, h, w)
        rg = self._renders.get((h, w))
        if rg is None or rg.key != key:
            self._renders.pop((h, w), None)       # free the old capture
            bufs = dict(
                params={k: torch.empty_like(v)
                        for k, v in G.get_params(g).items()},
                active=torch.empty_like(g.active),
                cams=Camera(K=torch.zeros((RENDER_FRAMES, 3, 3), device=dev),
                            w2c=torch.zeros((RENDER_FRAMES, 4, 4),
                                            device=dev),
                            confidence=torch.ones((), device=dev),
                            width=w, height=h),
                j=torch.zeros((), dtype=torch.int64, device=dev),
                rgb=torch.zeros((RENDER_FRAMES, h, w, 3), device=dev),
                depth=torch.zeros((RENDER_FRAMES, h, w), device=dev))
            # the warm-up renders the batch's first cameras
            self._load_render_batch(bufs, cameras, 0)
            rg = StepGraph(key, bufs, self._static_render, dev,
                           [composite_tiles.launches])
            self._renders[(h, w)] = rg
            self.graph_builds["render"] += 1
        b = rg.bufs
        rgb = torch.empty((p, h, w, 3), device=dev)
        depth = torch.empty((p, h, w), device=dev)
        for s0 in range(0, p, RENDER_FRAMES):
            n = self._load_render_batch(b, cameras, s0)
            rg.run(n)
            rgb[s0:s0 + n].copy_(b["rgb"][:n])
            depth[s0:s0 + n].copy_(b["depth"][:n])
        return rgb, depth

    def _load_render_batch(self, b: dict, cameras: Camera, s0: int) -> int:
        """The state's Gaussians (at the first batch) and cameras s0 ..
        s0 + n - 1 into the render buffers, the counter to 0; returns n."""
        if s0 == 0:
            for k, v in G.get_params(self.state.gaussians).items():
                b["params"][k].copy_(v)
            b["active"].copy_(self.state.gaussians.active)
        n = min(RENDER_FRAMES, len(cameras) - s0)
        b["cams"].K[:n].copy_(cameras.K[s0:s0 + n])
        b["cams"].w2c[:n].copy_(cameras.w2c[s0:s0 + n])
        b["j"].zero_()
        return n

    def _static_render(self, b: dict):
        """Render camera ``b["j"]`` of the uploaded batch into frame j of
        the output buffers, in place (no host sync: it captures)."""
        j = b["j"].view(1)
        cams = b["cams"]
        cam = dataclasses.replace(cams, K=cams.K.index_select(0, j)[0],
                                  w2c=cams.w2c.index_select(0, j)[0])
        g = G.GaussianState(**b["params"], active=b["active"])
        _, out = self._render(g, cam)
        alpha = out.alpha
        depth = torch.where(alpha > 1e-6,
                            out.depth / torch.clamp(alpha, min=1e-6), 0.0)
        b["rgb"].index_copy_(0, j, out.rgb[None])
        b["depth"].index_copy_(0, j, depth[None])
        b["j"].add_(1)

    # -- scene surface ----------------------------------------------------------

    def update_cameras(self, views, poses, K, cam_confidences=None,
                       append: bool = True, depths=None):
        """Install pseudo views (V, H, W, 3) with w2c ``poses`` (V, 4, 4) and
        intrinsics ``K`` as confidence-weighted targets; ``depths`` (V, H, W)
        are the targets of the svd_depth_warmup term."""
        views = np.asarray(views, np.float32)
        v, h, w = views.shape[:3]
        if cam_confidences is None:
            cam_confidences = [1.0] * v
        elif np.isscalar(cam_confidences):
            cam_confidences = [float(cam_confidences)] * v
        cams = [make_camera(K, poses[i], w, h, float(cam_confidences[i]),
                            self.device) for i in range(v)]
        new = ViewSet(cameras=stack_cameras(cams),
                      images=torch.as_tensor(views, device=self.device))
        new_depths = (torch.as_tensor(np.asarray(depths, np.float32),
                                      device=self.device)
                      if depths is not None else None)
        if append and self.pseudo_views is not None:
            a, b = self.pseudo_views.cameras, new.cameras
            new = ViewSet(cameras=dataclasses.replace(
                a, K=torch.cat([a.K, b.K]), w2c=torch.cat([a.w2c, b.w2c]),
                confidence=torch.cat([a.confidence, b.confidence])),
                images=torch.cat([self.pseudo_views.images, new.images]))
            if new_depths is not None and self.pseudo_depths is not None:
                new_depths = torch.cat([self.pseudo_depths, new_depths])
            else:
                new_depths = None   # a mixed set cannot index depths
        self.pseudo_views = new
        self.pseudo_depths = new_depths

    def reset_optimizers(self):
        """Fresh Adam, statistics and step counter."""
        self.state = self._fresh_state(self.state.gaussians, step=0)

    def reset_gs(self):
        """Restart the step counter for the finetune phase."""
        self.state = dataclasses.replace(self.state, step=0)

    def reset_gaussians_from_pcd(self, xyz, rgb,
                                 append_to_old_gaussians: bool = False):
        """Re-initialize from a point cloud, optionally appended to the live
        Gaussians (actives compacted to the front before any truncation)."""
        new = G.from_points(torch.as_tensor(np.asarray(xyz, np.float32),
                                            device=self.device),
                            torch.as_tensor(np.asarray(rgb, np.float32),
                                            device=self.device),
                            sh_degree=self.cfg.sh_degree)
        if append_to_old_gaussians:
            old = self.state.gaussians
            cap = G.next_capacity(old.num_active + new.num_active)
            active_cat = torch.cat([old.active, new.active])
            order = torch.argsort((~active_cat).to(torch.int8), stable=True)
            merged = {}
            for f in G.PARAM_FIELDS + ("active",):
                cat = torch.cat([getattr(old, f), getattr(new, f)])[order]
                merged[f] = (cat[:cap] if cat.shape[0] >= cap else torch.cat(
                    [cat, cat.new_zeros((cap - cat.shape[0],)
                                        + cat.shape[1:])]))
            new = G.GaussianState(**merged)
        self.state = self._fresh_state(new, step=0)

    def find_nearest_cam(self, query: Camera, cams: Camera,
                         multi_view_max_angle: float = None,
                         multi_view_min_dis: float = None,
                         multi_view_max_dis: float = None) -> int:
        """Index of the camera nearest to ``query``, restricted to the
        angle/distance window when any candidate lies in it."""
        pos = cams.position.detach().cpu().numpy()
        q = query.position.detach().cpu().numpy()
        dist = np.linalg.norm(pos - q, axis=-1)
        ok = np.ones(len(pos), dtype=bool)
        if multi_view_min_dis is not None:
            ok &= dist >= multi_view_min_dis
        if multi_view_max_dis is not None:
            ok &= dist <= multi_view_max_dis
        if multi_view_max_angle is not None:
            dirs = cams.w2c.detach().cpu().numpy()[:, 2, :3]
            qdir = query.w2c.detach().cpu().numpy()[2, :3]
            cosang = (dirs @ qdir) / (np.linalg.norm(dirs, axis=-1)
                                      * np.linalg.norm(qdir) + 1e-12)
            ang = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
            ok &= ang <= multi_view_max_angle
        if ok.any():
            dist = np.where(ok, dist, np.inf)
        return int(dist.argmin())

    # -- checkpoints (the JAX package's names and keys) ------------------------

    def _ckpt_name(self, iteration: int, epoch=None) -> str:
        if epoch is None:
            return f"chkpnt{iteration}.npz"
        return f"refine_{epoch}_chkpnt{iteration}.npz"

    def save_checkpoint(self, iteration: int, epoch=None) -> str:
        g = self.state.gaussians
        arrays = {f: getattr(g, f).detach().cpu().numpy()
                  for f in G.PARAM_FIELDS + ("active",)}
        arrays["step"] = np.asarray(self.state.step, np.int32)
        path = os.path.join(self.model_path, self._ckpt_name(iteration, epoch))
        np.savez(path, **arrays)
        np.savez(os.path.join(self.model_path, "chkpnt_latest.npz"), **arrays)
        return path

    def load_checkpoint(self, checkpoint: str):
        g = G.gaussians_from_numpy(checkpoint, self.device)
        with np.load(checkpoint) as data:
            step = int(data["step"])
        self.state = self._fresh_state(g, step=step)

    def latest_checkpoint(self) -> Optional[str]:
        """Newest refine_*_chkpnt*.npz, else chkpnt_latest.npz."""
        refined = sorted(glob.glob(os.path.join(self.model_path,
                                                "refine_*_chkpnt*.npz")),
                         key=os.path.getmtime)
        if refined:
            return refined[-1]
        latest = os.path.join(self.model_path, "chkpnt_latest.npz")
        return latest if os.path.exists(latest) else None
