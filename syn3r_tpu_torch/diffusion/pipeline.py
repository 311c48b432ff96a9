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
    pair at the pre-grad latents; the closed-form 4-tile guidance gradient
    moves the latents, and the Euler step starts from the post-grad
    latents. Prob (``variant="prob"``, ``--diffusion_type
    2PassProbUncertain``): no guidance pass; one batch-2 CFG forward, then
    the soft latent replacement step
    (``scheduler.step_interp_prob_uncertain``). Directions merge with
    w = linspace(1, 0, F); ``latent_num`` draws are averaged.
  - ``decode``: temporal decode in the compute dtype in chunks of
    ``decode_chunk_size`` (the decoder mixes frames within a chunk, so the
    chunk size changes the pixels).

Images are (H, W, 3) in [0, 1], latents (F, h, w, 4), as in JAX.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.clip import CLIPVisionModelWithProjection, clip_normalize
from ..models.convert import load_flax_params
from ..models.svd_unet import UNetSpatioTemporalConditionModel
from ..models.vae import AutoencoderKLTemporalDecoder
from ..utils.image import resize_antialiased, to_01, to_neg1_1
from ..utils.params import load_params
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
    # Not ported yet; each raises NotImplementedError when set.
    direction_parallel: bool = False
    guidance_through_unet: bool = False
    guidance_reuse_cfg_uncond: bool = False

    def __post_init__(self):
        if self.variant not in ("post", "prob"):
            raise ValueError(f"unknown variant {self.variant!r}")
        for name in ("direction_parallel", "guidance_through_unet",
                     "guidance_reuse_cfg_uncond"):
            if getattr(self, name):
                raise NotImplementedError(f"{name}=True is not ported")


class GuidedSVDPipeline:
    def __init__(self, models: SVDModels, config: GuidedSVDConfig):
        self.m = models
        self.cfg = config
        self.device = next(models.unet.parameters()).device
        self.schedule = S.svd_schedule(config.num_inference_steps,
                                       device=self.device)

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

    def _direction_step(self, latents, step_i, clip_emb, cond, msk, lam,
                        img_lat, guidance):
        cfg, sch = self.cfg, self.schedule
        dt = cfg.compute_dtype
        t = sch.timesteps[step_i]
        sigma = sch.sigmas[step_i]
        scaled = S.scale_model_input(sch, latents, step_i)
        if cfg.variant == "prob":
            # one batch-2 CFG forward, no guidance pass; the soft
            # replacement step runs in (F, C, h, w)
            inp2 = torch.stack([
                torch.cat([scaled, torch.zeros_like(img_lat)], dim=-1),
                torch.cat([scaled, img_lat], dim=-1)])
            eps2 = self.m.unet(inp2.to(dt), t, clip_emb.to(dt),
                               self._added_time_ids(2)).float()
            eps = eps2[0] + guidance * (eps2[1] - eps2[0])
            prev, _ = S.step_interp_prob_uncertain(
                sch, eps.permute(0, 3, 1, 2), latents.permute(0, 3, 1, 2),
                step_i, cond.permute(0, 3, 1, 2), msk, lam)
            return prev.permute(0, 2, 3, 1)
        # The guidance pass (batch 1, uncond) and the CFG pair (batch 2)
        # evaluate the same PRE-grad latents as one batch-3 forward; the
        # Euler step then starts from the POST-grad latents.
        uncond = torch.cat([scaled, torch.zeros_like(img_lat)], dim=-1)
        inp3 = torch.stack([uncond, uncond,
                            torch.cat([scaled, img_lat], dim=-1)])
        ehs3 = torch.cat([torch.zeros_like(clip_emb[:1]), clip_emb])
        eps3 = self.m.unet(inp3.to(dt), t, ehs3.to(dt),
                           self._added_time_ids(3), (1, 2)).float()
        x0 = S.pred_original_sample(eps3[0], latents, sigma)
        grad = S.guidance_grad_tiled(
            x0.permute(0, 3, 1, 2), cond.permute(0, 3, 1, 2), msk,
            lam[step_i], sigma, lr=cfg.guidance_lr,
            tile_mode=self._tile_mode(latents))
        latents = latents - grad.permute(0, 2, 3, 1)
        eps = eps3[1] + guidance * (eps3[2] - eps3[1])
        return S.step_interp(sch, eps, latents, step_i)[0]

    @torch.no_grad()
    def denoise(self, noise_latents, clip_start, clip_end, cond_latents,
                mask, lambda_ts) -> torch.Tensor:
        """noise_latents: (latent_num, F, h, w, 4) standard normals;
        cond_latents: (F, h, w, 4) (already / FACTOR_S); mask: (F-2, h, w);
        lambda_ts: (num_steps, F). Returns latents (F, h, w, 4)."""
        cfg = self.cfg
        f = cfg.num_frames
        noise_latents, clip_start, clip_end, cond, mask, lambda_ts = (
            self._tensor(a) for a in (noise_latents, clip_start, clip_end,
                                      cond_latents, mask, lambda_ts))
        guidance = torch.linspace(cfg.min_guidance_scale,
                                  cfg.max_guidance_scale, f,
                                  device=self.device)[:, None, None, None]
        weight_fw = torch.linspace(1.0, 0.0, f,
                                   device=self.device)[:, None, None, None]
        lat_start_f = (cond[:1] * FACTOR_S).repeat(f, 1, 1, 1)
        lat_end_f = (cond[-1:] * FACTOR_S).repeat(f, 1, 1, 1)
        cond_bw = cond.flip(0)
        mask_bw = mask.flip(0)
        lam_bw = lambda_ts.flip(1)

        outs = []
        for latents in noise_latents * self.schedule.init_noise_sigma:
            for step_i in range(cfg.num_inference_steps):
                fwd = self._direction_step(latents, step_i, clip_start, cond,
                                           mask, lambda_ts, lat_start_f,
                                           guidance)
                bwd = self._direction_step(latents.flip(0), step_i, clip_end,
                                           cond_bw, mask_bw, lam_bw,
                                           lat_end_f, guidance)
                latents = weight_fw * fwd + (1 - weight_fw) * bwd.flip(0)
            outs.append(latents)
        return torch.stack(outs).mean(dim=0)

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
        clip_s, clip_e, cond, _, _ = self.encode_conditioning(
            image_start, cond_images, image_end, generator)
        if latents is None:
            h, w = cond.shape[1:3]
            latents = torch.randn(
                (self.cfg.latent_num, self.cfg.num_frames, h, w, 4),
                generator=generator, device=self.device)
        out = self.denoise(latents, clip_s, clip_e, cond, mask, lambda_ts)
        return self.decode(out)


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
    fields go to ``GuidedSVDConfig``."""
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
