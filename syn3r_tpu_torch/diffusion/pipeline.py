"""Guided SVD video completion: the post variant (LLFF / DL3DV) and the
prob variant (DTU).

Counterpart of ``syn3r_tpu/diffusion/pipeline.py`` ``GuidedSVDPipeline``
with its defaults: for one view pair it takes a start frame, the warped
conditioning frames, an end frame, latent-resolution uncertainty masks and
a lambda schedule, and returns the completed frames.

  - ``encode_conditioning``: CLIP embeddings of both endpoints (antialiased
    224 resize), the float32 VAE encode of all frames in chunks of 8 with
    one shared noise-augmentation draw, cond latents / FACTOR_S.
  - ``denoise``: per step and direction (forward, then the time-flipped
    backward one). Post (``variant="post"``): ONE batch-3 UNet forward
    with batch_groups (1, 2) gives the uncond guidance pass and the CFG
    pair at the pre-grad latents (``fused_guidance_cfg=False``: a batch-1
    and a batch-2 forward); the closed-form 4-tile guidance gradient
    moves the latents, and the Euler step starts from the post-grad
    latents. ``guidance_reuse_cfg_uncond`` takes the guidance eps from the
    CFG pair's uncond row (one batch-2 forward; a documented divergence).
    With ``guidance_through_unet`` the gradient is instead autograd's, of
    ``guidance_loss`` through a batch-1 uncond forward with each UNet
    block checkpointed (the only place grad is enabled), then a batch-2
    CFG forward at the pre-grad latents. Prob (``variant="prob"``,
    ``--diffusion_type 2PassProbUncertain``): no guidance pass; one
    batch-2 CFG forward, then the soft latent replacement step
    (``scheduler.step_interp_prob_uncertain``). ``direction_parallel``
    runs both directions' forwards as one, their batches stacked and
    their batch_groups repeated. ``direction_sharding`` (a placement of
    ``parallel/mesh.py`` over a mesh with a "dir" axis of 2) runs each
    direction's forward on its own device's replica of the networks
    instead, one UNet call a device and step, all issued from the one
    host thread; the backward direction's latents are copied to its
    device and its output back for the merge. Over a (dir, model) mesh
    each direction's UNet is tensor-parallel over its row of "model"
    (``parallel/tensor_parallel.py``); over a (pair, dir) mesh the pair
    slot picks the row. Directions merge with w = linspace(1, 0, F);
    ``latent_num`` draws are averaged.
  - ``complete_wave``: several pairs in lock-step (the orchestrator's
    ``pair_parallel``): each pair's encode, then every denoise step of all
    pairs, then each decode. With a pair placement pair k runs on slot k's
    devices; without one the pairs' same-direction batches are stacked
    into one UNet call a step (batch_groups repeated once a pair).
  - ``decode``: temporal decode in the compute dtype in chunks of
    ``decode_chunk_size`` (the decoder mixes frames within a chunk, so the
    chunk size changes the pixels).

Images are (H, W, 3) in [0, 1], latents (F, h, w, 4), as in JAX.

Spans (``utils.profiling.span``) mark the denoise loop's layers in a
profiler's trace: ``denoise.call`` (every draw and step of a call),
``denoise.step`` (one step of every pair and direction, and the merge), in
it ``denoise.unet`` (a UNet call with its stacking and casts),
``denoise.guidance`` (the guidance gradient), ``denoise.update`` (the CFG
combination and the scheduler step) and ``denoise.merge``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.clip import CLIPVisionModelWithProjection, clip_normalize
from ..models.convert import load_flax_params
from ..models.svd_unet import UNetSpatioTemporalConditionModel
from ..models.vae import AutoencoderKLTemporalDecoder
from ..parallel.mesh import Mesh, module_replicas, to_device
from ..utils.image import resize_antialiased, to_01, to_neg1_1
from ..utils.params import load_params
from ..utils.profiling import span
from . import scheduler as S

FACTOR_S = 5.6  # reference SVD_2pass_prob_uncertain_post.py:609


@dataclasses.dataclass
class SVDModels:
    """The three frozen networks, on one device."""
    unet: UNetSpatioTemporalConditionModel
    vae: AutoencoderKLTemporalDecoder
    clip: CLIPVisionModelWithProjection


@dataclasses.dataclass
class GuidedSVDConfig:
    num_inference_steps: int = 100
    num_frames: int = 25
    min_guidance_scale: float = 1.0
    max_guidance_scale: float = 3.0
    fps: int = 7
    motion_bucket_id: int = 127
    noise_aug_strength: float = 0.02
    guidance_lr: float = 0.02
    decode_chunk_size: int = 8
    latent_num: int = 1
    # "reference" absolute tile bounds, "scaled" for small grids, "auto"
    # = reference when the latent grid is at least 25 x 57
    guidance_tile_mode: str = "auto"
    compute_dtype: torch.dtype = torch.bfloat16
    variant: str = "post"           # "post" or "prob"
    # Post variant opt-in (a documented divergence from the reference, ~2-3x
    # the cost): the guidance gradient taken THROUGH the UNet (autograd of
    # the masked MSE through a per-block-checkpointed batch-1 forward)
    # instead of the detached closed form. Forces direction_parallel off.
    guidance_through_unet: bool = False
    # Post variant: the guidance pass (batch 1, uncond) and the CFG pair
    # (batch 2) at the same pre-grad latents as ONE batch-3 forward with
    # batch_groups (1, 2), the same math as the two calls (each group keeps
    # its own time-context quirk). False runs the two calls.
    fused_guidance_cfg: bool = True
    # Post variant speed knob (opt-in, a documented DIVERGENCE from the
    # reference): reuse the CFG pass's uncond row as the guidance pass's
    # eps instead of the dedicated batch-1 uncond forward, one batch-2
    # forward a step and direction. The two rows differ ONLY through the
    # time-context batch quirk: in the batch-2 CFG group, half of each
    # row's pixel rows attend to the COND clip embedding in temporal
    # cross-attention, while the reference's guidance pass (batch 1) sees
    # the uncond context everywhere. The per-tile std normalization inside
    # guidance_grad_tiled washes out the scale difference; with zero CLIP
    # embeddings the two variants agree.
    guidance_reuse_cfg_uncond: bool = False
    # Both directions of a step as ONE UNet forward: the directions'
    # batches stacked, batch_groups the per-direction groups repeated
    # ((1, 2, 1, 2) for the fused post step), so each direction computes
    # what it does alone. JAX vmaps the direction step instead. With
    # direction_sharding each direction runs on its own device instead.
    direction_parallel: bool = False
    # a placement (parallel.mesh.sharded(mesh, "dir")) whose leading axis
    # of 2 holds the directions; turns direction_parallel on, as JAX's
    direction_sharding: object = None

    def __post_init__(self):
        if self.variant not in ("post", "prob"):
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.direction_sharding is not None:
            if self.direction_sharding.shards != 2:
                raise ValueError("direction_sharding must split its leading "
                                 "axis over 2 devices, got "
                                 f"{self.direction_sharding}")
            self.direction_parallel = True
        elif self.guidance_through_unet:
            self.direction_parallel = False


class _Direction(NamedTuple):
    """What one direction of a denoise step reads."""
    latents: torch.Tensor       # (F, h, w, 4)
    clip_emb: torch.Tensor      # (2, 1, D): uncond zeros, cond
    cond: torch.Tensor          # (F, h, w, 4) cond latents / FACTOR_S
    mask: torch.Tensor          # (F-2, h, w)
    lam: torch.Tensor           # (num_steps, F)
    img_lat: torch.Tensor       # (F, h, w, 4) the endpoint latent repeated


class _PairState(NamedTuple):
    """One pair's denoise: its forward direction runs on units[0], its
    backward one on units[1] (the same unit unless the directions are
    sharded); fwd and bwd are the directions' constants on their units'
    devices (clip_emb, cond, mask, lam, img_lat of ``_Direction``)."""
    units: tuple
    fwd: tuple
    bwd: tuple
    weight_fw: torch.Tensor
    draws: torch.Tensor


class GuidedSVDPipeline:
    def __init__(self, models: SVDModels, config: GuidedSVDConfig):
        # frozen: a gradient through the UNet is only ever taken w.r.t. the
        # latents
        models.unet.requires_grad_(False)
        self.m = models
        self.cfg = config
        self.device = next(models.unet.parameters()).device
        self.schedule = S.svd_schedule(config.num_inference_steps,
                                       device=self.device)
        self.guidance = torch.linspace(
            config.min_guidance_scale, config.max_guidance_scale,
            config.num_frames, device=self.device)[:, None, None, None]
        # the networks' replicas by device and the pipelines that run on
        # them, built once: every device of the dir placement now, a pair
        # slot's device at its first wave
        self._replicas = {self.device: models}
        self._units: dict[tuple, GuidedSVDPipeline] = {}
        pl = config.direction_sharding
        if pl is not None:
            for slot in range(pl.mesh.shape.get("pair", 1)):
                self._units_of(slot)

    # -- placement ------------------------------------------------------

    def _unit_on(self, devices) -> "GuidedSVDPipeline":
        """The pipeline that runs one direction (or a whole unsharded pair)
        on ``devices``: the networks' replica on devices[0], its UNet
        tensor-parallel over all of them when there are several."""
        key = tuple(devices)
        if self.cfg.direction_sharding is None and key == (self.device,):
            return self
        unit = self._units.get(key)
        if unit is None:
            dev = key[0]
            if dev not in self._replicas:
                self._replicas.update(replicate_models(self.m, [dev]))
            m = self._replicas[dev]
            unet = m.unet
            if len(key) > 1:
                from ..parallel.tensor_parallel import TensorParallelUNet
                unet = TensorParallelUNet(Mesh(list(key), ("model",)), unet)
            unit = GuidedSVDPipeline(
                SVDModels(unet=unet, vae=m.vae, clip=m.clip),
                dataclasses.replace(self.cfg, direction_sharding=None,
                                    direction_parallel=False))
            self._units[key] = unit
        return unit

    def _units_of(self, slot: int = 0, placement=None) -> tuple:
        """(forward unit, backward unit) of pair slot ``slot``: with
        direction_sharding the two cells of the dir axis at index ``slot``
        of the mesh's "pair" axis (each a row of "model" where the mesh has
        one); else the pair placement's slot device, or this pipeline."""
        pl = self.cfg.direction_sharding
        if pl is None:
            if placement is None:
                return self, self
            unit = self._unit_on(placement.slot_devices(slot)[:1])
            return unit, unit
        mesh, dax = pl.mesh, pl.leading_axis
        extra = set(mesh.axis_names) - {dax, "pair", "model"}
        if extra:
            raise ValueError(f"direction_sharding: mesh axes {extra} are "
                             "neither 'pair' nor 'model'")

        def cell(d):
            at = {dax: d, "pair": slot}
            if "model" in mesh.axis_names:
                return mesh.along("model", at)
            return [mesh.devices[tuple(at.get(a, 0)
                                       for a in mesh.axis_names)]]
        return self._unit_on(cell(0)), self._unit_on(cell(1))

    def _tensor(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x, dtype=np.float32))
        return x.to(self.device, torch.float32)

    # -- conditioning ---------------------------------------------------

    @torch.no_grad()
    def clip_embed(self, image01) -> torch.Tensor:
        """(H, W, 3) in [0, 1] -> CFG-stacked (2, 1, D): row 0 zeros
        (uncond), row 1 the embedding."""
        x = resize_antialiased(to_neg1_1(self._tensor(image01)), 224, 224)
        x = clip_normalize((x + 1.0) / 2.0)[None]
        emb = self.m.clip(x.to(self.cfg.compute_dtype)).float()[:, None, :]
        return torch.cat([torch.zeros_like(emb), emb], dim=0)

    @torch.no_grad()
    def vae_encode_mode_batch(self, images01, noise) -> torch.Tensor:
        """(N, H, W, 3) in [0, 1] + ONE shared noise (H, W, 3) ->
        (N, h, w, 4), float32, in chunks of 8 (the encoder is
        frame-independent, so chunking only bounds memory)."""
        x = to_neg1_1(self._tensor(images01)) \
            + self.cfg.noise_aug_strength * self._tensor(noise)[None]
        return torch.cat([self.m.vae.encode_mode(x[i:i + 8])
                          for i in range(0, x.shape[0], 8)], dim=0)

    def encode_conditioning(self, image_start, cond_images, image_end,
                            generator: Optional[torch.Generator] = None,
                            noise=None):
        """Returns (clip_start (2,1,D), clip_end, cond_latents (F, h, w, 4)
        scaled by 1/FACTOR_S, start latent, end latent). Pass ``noise``
        (H, W, 3) to pin the noise augmentation, else it is drawn from
        ``generator``."""
        if noise is None:
            noise = torch.randn(tuple(image_start.shape), generator=generator,
                                device=self.device)
        clip_start = self.clip_embed(image_start)
        clip_end = self.clip_embed(image_end)
        stacked = torch.stack([self._tensor(im) for im in
                               (image_start, *cond_images, image_end)])
        lats = self.vae_encode_mode_batch(stacked, noise)
        return clip_start, clip_end, lats / FACTOR_S, lats[0], lats[-1]

    # -- the denoising loop ---------------------------------------------

    def _added_time_ids(self, batch: int) -> torch.Tensor:
        row = torch.tensor([[self.cfg.fps - 1, self.cfg.motion_bucket_id,
                             self.cfg.noise_aug_strength]],
                           dtype=torch.float32, device=self.device)
        return row.repeat(batch, 1)

    def _tile_mode(self, latents) -> str:
        mode = self.cfg.guidance_tile_mode
        if mode == "auto":
            hl, wl = latents.shape[1:3]
            mode = "reference" if hl >= 25 and wl >= 57 else "scaled"
        return mode

    def _unet_stacked(self, t, parts, groups) -> list[torch.Tensor]:
        """One UNet forward of the (sample, ehs) ``parts`` stacked along the
        batch, with ``groups`` its batch_groups; the eps of each part,
        float32."""
        dt = self.cfg.compute_dtype
        with span("denoise.unet"):
            sample = torch.cat([x for x, _ in parts])
            ehs = torch.cat([e for _, e in parts])
            eps = self.m.unet(sample.to(dt), t, ehs.to(dt),
                              self._added_time_ids(sample.shape[0]),
                              tuple(groups)).float()
        return list(eps.split([x.shape[0] for x, _ in parts]))

    def _unet_remat(self, sample, t, ehs, tids):
        """The UNet with each block checkpointed, for the gradient pass:
        live activations stay one block's, so the full-resolution
        (25 x 72x128) guided step fits the card."""
        dt = self.cfg.compute_dtype
        with span("denoise.unet"):
            return self.m.unet(sample.to(dt), t, ehs.to(dt), tids,
                               remat_blocks=True).float()

    def _unet_guidance_grad(self, latents, step_i, clip_emb, cond, msk, lam,
                            img_lat):
        """d guidance_loss / d latents through one batch-1 uncond forward
        (zero CLIP context, zero image latents), normalized: JAX's
        ``jax.grad(gloss)(latents)``. Grad is enabled here only, on a
        detached copy of the latents; the networks take none."""
        sch = self.schedule
        t, sigma = sch.timesteps[step_i], sch.sigmas[step_i]
        lat = latents.detach().requires_grad_(True)
        with torch.enable_grad():
            scaled = S.scale_model_input(sch, lat, step_i)
            inp = torch.cat([scaled, torch.zeros_like(img_lat)], dim=-1)
            eps = self._unet_remat(inp[None], t, torch.zeros_like(
                clip_emb[:1]), self._added_time_ids(1))[0]
            x0 = S.pred_original_sample(eps, lat, sigma).permute(0, 3, 1, 2)
            cond_c = cond.permute(0, 3, 1, 2)
            tm = S.top_k_masks(x0.detach(), cond_c, msk, lam[step_i])
            (grad,) = torch.autograd.grad(S.guidance_loss(x0, cond_c, tm),
                                          lat)
        return S.normalize_guidance_grad(grad, sigma, lr=self.cfg.guidance_lr)

    def _step(self, dirs: list[_Direction], step_i: int,
              guidance) -> list[torch.Tensor]:
        """One denoise step of each direction in ``dirs``; their UNet
        passes run as one forward each (the directions' batches stacked).
        Returns each direction's next latents."""
        cfg, sch = self.cfg, self.schedule
        t, sigma = sch.timesteps[step_i], sch.sigmas[step_i]
        n = len(dirs)
        scaled = [S.scale_model_input(sch, d.latents, step_i) for d in dirs]
        uncond = [torch.cat([s, torch.zeros_like(d.img_lat)], dim=-1)
                  for s, d in zip(scaled, dirs)]
        cond_in = [torch.cat([s, d.img_lat], dim=-1)
                   for s, d in zip(scaled, dirs)]

        def cfg_pair():
            # one batch-2 CFG forward a direction at the pre-grad latents
            return self._unet_stacked(
                t, [(torch.stack([u, c]), d.clip_emb)
                    for u, c, d in zip(uncond, cond_in, dirs)], (2,) * n)

        if cfg.variant == "prob":
            # no guidance pass; the soft replacement step runs in
            # (F, C, h, w)
            out = []
            for e2, d in zip(cfg_pair(), dirs):
                with span("denoise.update"):
                    eps = e2[0] + guidance * (e2[1] - e2[0])
                    prev, _ = S.step_interp_prob_uncertain(
                        sch, eps.permute(0, 3, 1, 2),
                        d.latents.permute(0, 3, 1, 2), step_i,
                        d.cond.permute(0, 3, 1, 2), d.mask, d.lam)
                out.append(prev.permute(0, 2, 3, 1))
            return out
        if cfg.guidance_through_unet:
            # the gradient through the UNet moves the latents; the CFG
            # pair evaluates the PRE-grad latents, the Euler step starts
            # from the POST-grad ones (one direction: direction_parallel
            # is off)
            (d,) = dirs
            with span("denoise.guidance"):
                grad = self._unet_guidance_grad(
                    d.latents, step_i, d.clip_emb, d.cond, d.mask, d.lam,
                    d.img_lat)
            (e2,) = cfg_pair()
            with span("denoise.update"):
                eps = e2[0] + guidance * (e2[1] - e2[0])
                return [S.step_interp(sch, eps, d.latents - grad,
                                      step_i)[0]]
        if cfg.guidance_reuse_cfg_uncond:
            # opt-in speed knob (documented divergence, see the config):
            # ONE batch-2 CFG forward at the pre-grad latents serves BOTH
            # the guidance x0 (its uncond row) and the CFG combination,
            # dropping the dedicated batch-1 guidance forward. The uncond
            # row differs from the reference's batch-1 pass only through
            # the time-context batch quirk; the per-tile std normalization
            # absorbs the scale shift.
            pairs = cfg_pair()
            guide = [e2[0] for e2 in pairs]
        elif cfg.fused_guidance_cfg:
            # the guidance pass (batch 1, uncond) and the CFG pair (batch
            # 2) evaluate the same PRE-grad latents as one batch-3 forward
            # a direction, batch_groups (1, 2)
            eps3 = self._unet_stacked(
                t, [(torch.stack([u, u, c]),
                     torch.cat([torch.zeros_like(d.clip_emb[:1]),
                                d.clip_emb]))
                    for u, c, d in zip(uncond, cond_in, dirs)], (1, 2) * n)
            guide = [e3[0] for e3 in eps3]
            pairs = [e3[1:] for e3 in eps3]
        else:
            # reference semantics, unfused: one batch-1 uncond forward a
            # direction (zero CLIP context, zero image latents) for the
            # guidance, then the batch-2 CFG pass at the pre-grad latents
            guide = [e[0] for e in self._unet_stacked(
                t, [(u[None], torch.zeros_like(d.clip_emb[:1]))
                    for u, d in zip(uncond, dirs)], (1,) * n)]
            pairs = cfg_pair()
        out = []
        for g_eps, e2, d in zip(guide, pairs, dirs):
            # the closed-form 4-tile guidance gradient moves the latents;
            # the Euler step starts from the POST-grad latents
            with span("denoise.guidance"):
                x0 = S.pred_original_sample(g_eps, d.latents, sigma)
                grad = S.guidance_grad_tiled(
                    x0.permute(0, 3, 1, 2), d.cond.permute(0, 3, 1, 2),
                    d.mask, d.lam[step_i], sigma, lr=cfg.guidance_lr,
                    tile_mode=self._tile_mode(d.latents))
            with span("denoise.update"):
                latents = d.latents - grad.permute(0, 2, 3, 1)
                eps = e2[0] + guidance * (e2[1] - e2[0])
                out.append(S.step_interp(sch, eps, latents, step_i)[0])
        return out

    def _pair_state(self, units, noise_latents, clip_start, clip_end,
                    cond_latents, mask, lambda_ts) -> _PairState:
        """The denoise inputs of one pair (``denoise``'s arguments) as a
        ``_PairState`` on ``units``: the draws and the merge weight on the
        forward unit's device, each direction's constants on its own."""
        f = self.cfg.num_frames
        fu, bu = units
        noise_latents, clip_start, clip_end, cond, mask, lambda_ts = (
            fu._tensor(a) for a in (noise_latents, clip_start, clip_end,
                                    cond_latents, mask, lambda_ts))
        if cond.shape[0] != f:
            raise ValueError(
                f"this completion pipeline runs {f} frames "
                f"(GuidedSVDConfig.num_frames) but got {cond.shape[0]} "
                "conditioning frames; the --svd_weights completion is the "
                "25-frame pipeline whatever --num_frames says")
        weight_fw = torch.linspace(1.0, 0.0, f,
                                   device=fu.device)[:, None, None, None]
        lat_start_f = (cond[:1] * FACTOR_S).repeat(f, 1, 1, 1)
        lat_end_f = (cond[-1:] * FACTOR_S).repeat(f, 1, 1, 1)
        bwd = tuple(bu._tensor(a) for a in (
            clip_end, cond.flip(0), mask.flip(0), lambda_ts.flip(1),
            lat_end_f))
        return _PairState(units=units,
                          fwd=(clip_start, cond, mask, lambda_ts, lat_start_f),
                          bwd=bwd, weight_fw=weight_fw,
                          draws=noise_latents * fu.schedule.init_noise_sigma)

    def _advance(self, states: list, lats: list, step_i: int,
                 stack_pairs: bool = False) -> list:
        """One denoise step of each pair of ``states`` from its latents
        ``lats``; returns the merged latents. Directions that run on one
        unit are stacked into one UNet forward where asked: both
        directions of a pair where ``direction_parallel`` is set without a
        placement, and the pairs where ``stack_pairs``. Every call is
        issued before any merge."""
        cfg = self.cfg
        stack_dirs = cfg.direction_parallel and cfg.direction_sharding is None
        with span("denoise.step"):
            # the directions' UNet calls, in issue order: {key: (unit,
            # items)}
            calls = {}
            for i, (st, lat) in enumerate(zip(states, lats)):
                for which, unit, lt, consts in (
                        (0, st.units[0], lat, st.fwd),
                        (1, st.units[1], to_device(lat.flip(0),
                                                   st.units[1].device),
                         st.bwd)):
                    key = ((id(unit),) + (() if stack_dirs else (which,))
                           + (() if stack_pairs else (i,)))
                    calls.setdefault(key, (unit, []))[1].append(
                        (i, which, _Direction(lt, *consts)))
            outs = [[None, None] for _ in states]
            for unit, items in calls.values():
                if cfg.guidance_through_unet:     # one direction a call
                    groups = [[it] for it in items]
                else:
                    groups = [items]
                for group in groups:
                    res = unit._step([d for _, _, d in group], step_i,
                                     unit.guidance)
                    for (i, which, _), r in zip(group, res):
                        outs[i][which] = r
            with span("denoise.merge"):
                return [st.weight_fw * fwd + (1 - st.weight_fw)
                        * to_device(bwd, fwd.device).flip(0)
                        for st, (fwd, bwd) in zip(states, outs)]

    def _denoise_states(self, states: list,
                        stack_pairs: bool = False) -> list:
        """Every draw of every pair of ``states``, the pairs' steps in
        lock-step; each pair's mean over its draws."""
        outs = [[] for _ in states]
        with span("denoise.call"):
            for li in range(states[0].draws.shape[0]):
                lats = [st.draws[li] for st in states]
                for step_i in range(self.cfg.num_inference_steps):
                    lats = self._advance(states, lats, step_i, stack_pairs)
                for o, lat in zip(outs, lats):
                    o.append(lat)
            return [torch.stack(o).mean(dim=0) for o in outs]

    @torch.no_grad()
    def denoise(self, noise_latents, clip_start, clip_end, cond_latents,
                mask, lambda_ts) -> torch.Tensor:
        """noise_latents: (latent_num, F, h, w, 4) standard normals;
        cond_latents: (F, h, w, 4) (already / FACTOR_S); mask: (F-2, h, w);
        lambda_ts: (num_steps, F). Returns latents (F, h, w, 4), on this
        pipeline's device (pair slot 0's with direction_sharding)."""
        st = self._pair_state(self._units_of(0), noise_latents, clip_start,
                              clip_end, cond_latents, mask, lambda_ts)
        return self._denoise_states([st])[0]

    # -- decode ---------------------------------------------------------

    @torch.no_grad()
    def decode(self, latents) -> torch.Tensor:
        """(F, h, w, 4) -> (F, H, W, 3) in [0, 1], float32."""
        cfg = self.cfg
        z = self._tensor(latents) / self.m.vae.scaling_factor
        c = cfg.decode_chunk_size
        frames = [self.m.vae.decode(z[i:i + c].to(cfg.compute_dtype),
                                    z[i:i + c].shape[0]).float()
                  for i in range(0, z.shape[0], c)]
        return to_01(torch.cat(frames, dim=0))

    def __call__(self, image_start, cond_images, image_end, mask, lambda_ts,
                 generator: Optional[torch.Generator] = None,
                 latents=None) -> torch.Tensor:
        """Full completion: (F, H, W, 3) frames in [0, 1]. The noise
        augmentation and then the initial latents are drawn from
        ``generator`` unless ``latents`` is given."""
        return self.complete_wave(
            [(image_start, cond_images, image_end, mask, lambda_ts)],
            [generator], latents=None if latents is None else [latents])[0]

    @torch.no_grad()
    def complete_wave(self, jobs, generators, placement=None,
                      latents=None) -> list:
        """Complete the pairs ``jobs`` ((image_start, cond_images,
        image_end, mask, lambda_ts) each, with its generator) in lock-step,
        all issued from this thread: every pair's encode, then each denoise
        step of every pair, then every decode. With ``placement`` (the pair
        placement, as many jobs as its slots) pair k runs on slot k's
        devices and its generator must live on slot k's first device;
        without it every pair runs on this pipeline's own units, their
        same-direction batches stacked. Returns each pair's frames on its
        device."""
        units = [self._units_of(k if placement is not None else 0,
                                placement) for k in range(len(jobs))]
        states = []
        for k, ((image_start, cond_images, image_end, mask, lambda_ts),
                gen) in enumerate(zip(jobs, generators)):
            home = units[k][0]
            clip_s, clip_e, cond, _, _ = home.encode_conditioning(
                image_start, cond_images, image_end, gen)
            if latents is None:
                h, w = cond.shape[1:3]
                lat = torch.randn(
                    (self.cfg.latent_num, self.cfg.num_frames, h, w, 4),
                    generator=gen, device=home.device)
            else:
                lat = latents[k]
            states.append(self._pair_state(units[k], lat, clip_s, clip_e,
                                           cond, mask, lambda_ts))
        outs = self._denoise_states(states, stack_pairs=placement is None)
        return [u[0].decode(o) for u, o in zip(units, outs)]


def init_random_weights_(module: torch.nn.Module,
                         generator: torch.Generator) -> torch.nn.Module:
    """Fill ``module`` in place the way the flax initializers of the JAX
    modules would: Linear/conv kernels LeCun-normal (std 1/sqrt(fan_in)),
    biases zero, norm scales one, mix factors 0.5, embeddings normal with
    std 0.02. Only for running without converted checkpoints."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                p.zero_()
            elif leaf == "mix_factor":
                p.fill_(0.5)
            elif name.endswith(("position_embedding.weight",
                                "class_embedding")):
                p.normal_(0.0, 0.02, generator=generator)
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    return module


def replicate_models(models: SVDModels,
                     devices) -> dict[torch.device, SVDModels]:
    """{device: SVDModels}: the UNet, the VAE and CLIP replicated on each
    device of ``devices`` from the same weights (``models`` itself on its
    own device), for ``direction_sharding`` and pair waves."""
    nets = {name: module_replicas(getattr(models, name), devices)
            for name in ("unet", "vae", "clip")}
    return {dev: SVDModels(unet=nets["unet"][dev].eval(),
                           vae=nets["vae"][dev].eval(),
                           clip=nets["clip"][dev].eval())
            for dev in nets["unet"]}


def load_svd_completion(weights_dir: Optional[str] = None,
                        device: str | torch.device = "cuda", seed: int = 0,
                        **config) -> GuidedSVDPipeline:
    """Build the completion unit (the counterpart of ``cli/train.py``'s
    ``_load_svd_completion``). With ``weights_dir`` it loads the converted
    ``unet.npz``, ``vae.npz`` and ``clip.npz`` the JAX package writes; with
    ``None`` the networks get random weights from ``seed`` at SVD-XT's
    full widths. The UNet is held in bf16 (the reference loads the fp16
    checkpoint); CLIP and the VAE keep float32 weights and run CLIP and
    the decode in the compute dtype, the encode in float32. ``config``
    fields go to ``GuidedSVDConfig``; with ``direction_sharding`` the
    networks are replicated on every device of its mesh
    (``replicate_models``)."""
    dev = resolve_device(device)
    cfg = GuidedSVDConfig(**config)
    with torch.device(dev):
        unet = UNetSpatioTemporalConditionModel()
        vae = AutoencoderKLTemporalDecoder()
        clip = CLIPVisionModelWithProjection()
    if weights_dir is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        for net in (unet, vae, clip):
            init_random_weights_(net, gen)
    else:
        for net, fname, rule in ((unet, "unet.npz", "diffusers"),
                                 (vae, "vae.npz", "diffusers"),
                                 (clip, "clip.npz", "clip")):
            load_flax_params(net, load_params(os.path.join(weights_dir,
                                                           fname)), rule)
    models = SVDModels(unet=unet.to(torch.bfloat16).eval(), vae=vae.eval(),
                       clip=clip.eval())
    return GuidedSVDPipeline(models, cfg)
