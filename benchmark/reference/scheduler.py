"""Plain reference of one guided denoise step of SYN3R's completion unit.

SVD's Euler-discrete scheduler with Karras sigmas (sigma in [0.002, 700],
rho 7, timesteps 0.25 log sigma, v-prediction) as SYN3R modifies it
(``SVD_2pass_prob_uncertain_post.py``): the post variant's detached
closed-form guidance gradient over 4 overlapping latent tiles (per-frame
top-k agreement masks, std normalization, hard stitching), then the Euler
step from the moved latents with classifier-free guidance rising from the
first frame's scale to the last's; the prob variant's soft latent
replacement; the forward and the time-flipped backward direction merged
with weights falling linearly from 1 to 0 over the frames.

Latents are (T, C, H, W) float32 here; the UNet is ``RefUNet``.
"""

from __future__ import annotations

import torch

SIGMA_MIN, SIGMA_MAX, RHO = 0.002, 700.0, 7.0
# the pipeline keys this step reads
READS = ("num_inference_steps", "num_frames", "min_guidance_scale",
         "max_guidance_scale", "fps", "motion_bucket_id",
         "noise_aug_strength", "guidance_lr", "variant")
# keys that choose how the program computes the same step: its dtype (the
# reference is float32), the post variant's two passes as one forward,
# both directions as one forward
HOW = ("compute_dtype", "fused_guidance_cfg", "direction_parallel")
# the frames' size in pixels: the step takes its sizes from its inputs
SIZES = ("height", "width")
# keys this step implements at one value alone: it follows one latent
FIXED = {"latent_num": 1}
DIRECTIONS = 2
FACTOR_S = 5.6
CLAMP_LO = 0.4


def refuse_unknown(pcfg: dict) -> None:
    """Raises ValueError on a pipeline key that this step does not
    implement, or implements at another value."""
    for key, value in pcfg.items():
        if key in READS or key in HOW or key in SIZES:
            continue
        if key not in FIXED:
            raise ValueError(f"the reference step does not implement "
                             f"{key!r}")
        if value != FIXED[key]:
            raise ValueError(f"the reference step implements {key!r} = "
                             f"{FIXED[key]!r}, not {value!r}")
    if pcfg["variant"] not in ("post", "prob"):
        raise ValueError(f"unknown variant {pcfg['variant']!r}")


def unet_rows(pcfg: dict) -> int:
    """UNet rows a step sends through the denoiser, both directions: the
    post variant's guidance pass and CFG pair (3), the prob variant's CFG
    pair (2), a direction."""
    return DIRECTIONS * (3 if pcfg["variant"] == "post" else 2)


def timesteps(num_steps: int, device=None) -> torch.Tensor:
    """(num_steps,) the denoiser's timestep at each step, 0.25 log
    sigma."""
    return 0.25 * torch.log(sigmas(num_steps, device)[:-1])


def sigmas(num_steps: int, device=None) -> torch.Tensor:
    """(num_steps + 1,) Karras sigmas, descending, with a final 0."""
    ramp = torch.linspace(0.0, 1.0, num_steps, device=device)
    lo, hi = SIGMA_MIN ** (1.0 / RHO), SIGMA_MAX ** (1.0 / RHO)
    sig = (hi + ramp * (lo - hi)) ** RHO
    return torch.cat([sig, sig.new_zeros(1)]).float()


def x0_of(eps, x, sigma):
    return eps * (-sigma / torch.sqrt(sigma ** 2 + 1.0)) + x / (sigma ** 2
                                                                + 1.0)


def euler(x, x0, sigma, sigma_next):
    return x + (x - x0) / sigma * (sigma_next - sigma)


def frame_cutoffs(pred, cond, certain, weight):
    """Per-frame |diff| cutoff: sorted |(pred - cond) * certain| over the
    frame at int(clamp(w, 0.4, 1) * (n - zeros)) + zeros - 1, where zeros
    counts the uncertain pixels of (H, W) once (not per channel)."""
    t = pred.shape[0]
    zeros = (~certain).reshape(t, -1).sum(dim=1)
    diff = ((pred - cond) * certain).abs().reshape(t, -1)
    n = diff.shape[1]
    cut = (weight.clamp(CLAMP_LO, 1.0) * (n - zeros)).to(torch.int32) + zeros
    idx = (cut - 1).clamp(0, n - 1).long()
    return diff.sort(dim=1).values.gather(1, idx[:, None])[:, :, None, None]


def tile_grad(pred, cond, mask, lam_row, sigma, lr):
    """Guidance gradient of one tile: the masked MSE's closed-form
    gradient through x / (sigma^2 + 1), normalized by its std."""
    certain = ((1.0 - mask) > 0.5)[:, None]
    inner_p, inner_c = pred[1:-1], cond[1:-1]
    cut = frame_cutoffs(inner_p, inner_c, certain, lam_row[1:-1])
    top = ((inner_p - inner_c) * certain).abs().le(cut) & certain
    ones = torch.ones_like(pred[:1], dtype=torch.bool)
    m = torch.cat([ones, top, ones]).float()
    g = 2.0 * (pred - cond) * m / m.sum() / (sigma ** 2 + 1.0)
    return g / (g.std(correction=0) + 1e-12) * torch.sqrt(sigma) * lr


def guidance_grad(pred, cond, mask, lam_row, sigma, lr):
    """4 overlapping tiles, rows [0, 40) and [24, H), columns [0, 72) and
    [56, W); stitched at row 40 and column 72."""
    h, w = pred.shape[2:]
    h0, h1, w0, w1 = min(40, h), min(24, h), min(72, w), min(56, w)

    def tile(hs, he, ws, we):
        return tile_grad(pred[:, :, hs:he, ws:we], cond[:, :, hs:he, ws:we],
                         mask[:, hs:he, ws:we], lam_row, sigma, lr)

    top = torch.cat([tile(0, h0, 0, w0), tile(0, h0, w1, w)[..., w0 - w1:]],
                    dim=3)
    bottom = torch.cat([tile(h1, h, 0, w0),
                        tile(h1, h, w1, w)[..., w0 - w1:]], dim=3)
    return torch.cat([top, bottom[:, :, h0 - h1:]], dim=2)


def soft_replace(x0, cond, mask, lam_row):
    """The prob variant's x0: inner frames blended toward their
    conditioning latent where certain and within the frame's cutoff,
    endpoints replaced."""
    inner, ci = x0[1:-1], cond[1:-1]
    certain = ((1.0 - mask) > 0.5)[:, None]
    cut = frame_cutoffs(inner, ci, certain, lam_row[1:-1])
    inv = 1.0 / (1.0 - certain.float() + 1e-6)
    w = inv / (1.0 + inv)
    w = torch.where(w >= 0.51, w, torch.zeros_like(w))
    w = w * ((inner - ci) * certain).abs().le(cut).float()
    return torch.cat([cond[:1], (1.0 - w) * inner + w * ci, cond[-1:]])


def direction_inputs(x, clip_start, clip_end, cond, mask, lam):
    """[(latents, clip (2, 1, D), cond, mask, lam, image latent)] of the
    forward and the time-flipped backward direction; x and cond are
    (T, C, H, W), cond already divided by FACTOR_S."""
    t = x.shape[0]
    fwd = (x, clip_start, cond, mask, lam,
           (cond[:1] * FACTOR_S).repeat(t, 1, 1, 1))
    bwd = (x.flip(0), clip_end, cond.flip(0), mask.flip(0), lam.flip(1),
           (cond[-1:] * FACTOR_S).repeat(t, 1, 1, 1))
    return [fwd, bwd]


def denoise_step(unet, pcfg: dict, step_i: int, x, clip_start, clip_end,
                 cond, mask, lam):
    """One step of both directions from x (T, C, H, W), merged. Returns
    (next latents, [each direction's eps rows (B, T, C, H, W)]): the post
    variant's rows are the guidance pass's, then the CFG pair's (uncond,
    cond); the prob variant's the CFG pair's."""
    refuse_unknown(pcfg)
    n = lam.shape[0]
    sig = sigmas(n, x.device)
    sigma, sigma_next = sig[step_i], sig[step_i + 1]
    tstep = 0.25 * torch.log(sigma)
    t = x.shape[0]
    scale = torch.linspace(pcfg["min_guidance_scale"],
                           pcfg["max_guidance_scale"], t,
                           device=x.device)[:, None, None, None]
    tid = torch.tensor([[pcfg["fps"] - 1, pcfg["motion_bucket_id"],
                         pcfg["noise_aug_strength"]]], device=x.device)
    outs, eps_rows = [], []
    for lat, clip, cd, mk, lm, img in direction_inputs(
            x, clip_start, clip_end, cond, mask, lam):
        scaled = lat / torch.sqrt(sigma ** 2 + 1.0)
        uncond = torch.cat([scaled, torch.zeros_like(img)], dim=1)
        cond_in = torch.cat([scaled, img], dim=1)
        pair = unet(torch.stack([uncond, cond_in]), tstep, clip,
                    tid.repeat(2, 1))
        eps = pair[0] + scale * (pair[1] - pair[0])
        if pcfg["variant"] == "prob":
            x0 = soft_replace(x0_of(eps, lat, sigma), cd, mk, lm[step_i])
            outs.append(euler(lat, x0, sigma, sigma_next))
            eps_rows.append(pair)
            continue
        guide = unet(uncond[None], tstep, torch.zeros_like(clip[:1]), tid)
        grad = guidance_grad(x0_of(guide[0], lat, sigma), cd, mk, lm[step_i],
                             sigma, pcfg["guidance_lr"])
        moved = lat - grad
        outs.append(euler(moved, x0_of(eps, moved, sigma), sigma,
                          sigma_next))
        eps_rows.append(torch.cat([guide, pair]))
    w = torch.linspace(1.0, 0.0, t, device=x.device)[:, None, None, None]
    return w * outs[0] + (1.0 - w) * outs[1].flip(0), eps_rows
