"""Guided Euler-discrete scheduler for SVD.

Counterpart of ``syn3r_tpu/diffusion/scheduler.py`` (the reference's
modified ``scheduling_euler_discrete.py``): the Karras sigma schedule with
continuous timesteps, the v-prediction Euler step, the per-frame top-k
latent masks, the reference's closed-form, detached, 4-tile guidance
gradient (the post variant) and the soft latent replacement step of the
prob variant (``step_interp_prob_uncertain``). The reference quirks the
JAX package keeps are kept here too: the ``num_zero`` count over (h, w)
only and the sort-cutoff indexing (``_frame_top_masks``), and the
absolute tile bounds.

Latent tensors in this module are (T, C, H, W) float32.
"""

from __future__ import annotations

import dataclasses

import torch


# SVD-XT's scheduler config: Karras sigmas in [0.002, 700], rho 7
SIGMA_MIN, SIGMA_MAX, RHO = 0.002, 700.0, 7.0


@dataclasses.dataclass(frozen=True)
class EulerSchedule:
    sigmas: torch.Tensor      # (N+1,) descending, last = 0
    timesteps: torch.Tensor   # (N,) continuous: 0.25 * log(sigma)

    @property
    def init_noise_sigma(self) -> torch.Tensor:
        return torch.sqrt(self.sigmas[0] ** 2 + 1.0)


def karras_sigmas(num_steps: int, device=None) -> torch.Tensor:
    ramp = torch.linspace(0.0, 1.0, num_steps, device=device)
    min_inv = SIGMA_MIN ** (1.0 / RHO)
    max_inv = SIGMA_MAX ** (1.0 / RHO)
    return (max_inv + ramp * (min_inv - max_inv)) ** RHO


def svd_schedule(num_steps: int, device=None) -> EulerSchedule:
    sig = karras_sigmas(num_steps, device=device)
    return EulerSchedule(
        sigmas=torch.cat([sig, sig.new_zeros(1)]).float(),
        timesteps=(0.25 * torch.log(sig)).float())


def scale_model_input(schedule: EulerSchedule, sample, step_i):
    sigma = schedule.sigmas[step_i]
    return sample / torch.sqrt(sigma ** 2 + 1.0)


def pred_original_sample(model_output, sample, sigma):
    """x0 from SVD's v-prediction."""
    return (model_output * (-sigma / torch.sqrt(sigma ** 2 + 1.0))
            + sample / (sigma ** 2 + 1.0))


def euler_step(schedule: EulerSchedule, sample, pred_x0, step_i):
    sigma = schedule.sigmas[step_i]
    derivative = (sample - pred_x0) / sigma
    return sample + derivative * (schedule.sigmas[step_i + 1] - sigma)


def _frame_top_masks(pred, cond, certain, weight, clamp_lo: float):
    """Per-frame top-k masks (T', C, H, W) and their cutoffs (T', 1, 1, 1).
    pred/cond: (T', C, H, W); certain: (T', 1, H, W) bool; weight: (T',).
    The reference counts the masked-out zeros over (h, w) only, not times
    C, and cuts the sorted |diff| at
    int(clamp(weight) * (len - num_zero)) + num_zero; both kept."""
    t = pred.shape[0]
    num_zero = (~certain).reshape(t, -1).sum(dim=1)
    masked_diff = (pred - cond) * certain
    flat = masked_diff.abs().reshape(t, -1)
    sorted_diff = flat.sort(dim=1).values
    n = flat.shape[1]
    w = weight.clamp(clamp_lo, 1.0)
    cutoff_e = (w * (n - num_zero)).to(torch.int32) + num_zero
    idx = (cutoff_e - 1).clamp(0, n - 1).long()
    cutoff = sorted_diff.gather(1, idx[:, None])[:, :, None, None]
    return (masked_diff.abs() <= cutoff) & certain, cutoff


def top_k_masks(pred_x0, cond_latents, mask, lambda_row,
                clamp_lo: float = 0.4):
    """Top-k agreement masks for frames 1..T-2, endpoints all-ones.
    mask: (T-2, H, W) uncertainty; lambda_row: (T,). Returns bool
    (T, C, H, W)."""
    certain = ((1.0 - mask) > 0.5)[:, None]
    tops, _ = _frame_top_masks(pred_x0[1:-1], cond_latents[1:-1], certain,
                               lambda_row[1:-1], clamp_lo)
    ones = torch.ones_like(pred_x0[:1], dtype=torch.bool)
    return torch.cat([ones, tops, ones], dim=0)


def normalize_guidance_grad(grad, sigma, lr: float = 0.02):
    """grad / std(grad) * sigma^0.5 * lr, with the population std as
    ``jnp.std`` takes it."""
    return grad / (grad.std(correction=0) + 1e-12) * torch.sqrt(sigma) * lr


def guidance_grad(pred_x0, cond_latents, top_masks, sigma, lr: float = 0.02):
    """Closed-form detached guidance gradient of the masked MSE w.r.t. the
    sample through pred_x0's sample/(sigma^2+1) term, normalized."""
    m = top_masks.to(pred_x0.dtype)
    g = 2.0 * (pred_x0 - cond_latents) * m / m.sum() / (sigma ** 2 + 1.0)
    return normalize_guidance_grad(g, sigma, lr)


def guidance_tile_bounds(h: int, w: int, mode: str = "reference"):
    """The reference's 4 overlapping guidance tiles:
    ((h0_end, h1_start, skip_h), (w0_end, w1_start, skip_w)).
    "reference" takes the absolute 40/24/72/56 bounds (valid for h >= 25,
    w >= 57); "scaled" proportional bounds for small grids."""
    if mode == "reference":
        h0e, h1s, dh = min(40, h), min(24, h), 16
        w0e, w1s, dw = min(72, w), min(56, w), 16
        if h1s >= h or w1s >= w:
            raise ValueError(f"latent grid {h}x{w} too small for the "
                             "reference tile bounds; use mode='scaled'")
    else:
        h0e, h1s = (40 * h) // 72, (24 * h) // 72
        w0e, w1s = (72 * w) // 128, (56 * w) // 128
        dh, dw = h0e - h1s, w0e - w1s
        if not (0 < h1s < h0e < h and 0 < w1s < w0e < w):
            raise ValueError(f"latent grid {h}x{w} too small for 4 tiles")
    return (h0e, h1s, dh), (w0e, w1s, dw)


def guidance_grad_tiled(pred_x0, cond_latents, mask, lambda_row, sigma,
                        lr: float = 0.02, clamp_lo: float = 0.4,
                        tile_mode: str = "reference"):
    """The 4-tile detached guidance gradient: each overlapping tile takes
    its own top-k masks and std normalization; the tiles are hard-stitched
    at the h0_end row and w0_end column."""
    _, _, h, w = pred_x0.shape
    (h0e, h1s, dh), (w0e, w1s, dw) = guidance_tile_bounds(h, w, tile_mode)

    def tile_grad(hs, he, ws, we):
        p = pred_x0[:, :, hs:he, ws:we]
        cd = cond_latents[:, :, hs:he, ws:we]
        tm = top_k_masks(p, cd, mask[:, hs:he, ws:we], lambda_row, clamp_lo)
        return guidance_grad(p, cd, tm, sigma, lr)

    g00 = tile_grad(0, h0e, 0, w0e)
    g10 = tile_grad(h1s, h, 0, w0e)
    g01 = tile_grad(0, h0e, w1s, w)
    g11 = tile_grad(h1s, h, w1s, w)
    left = torch.cat([g00, g10[:, :, dh:, :]], dim=2)
    right = torch.cat([g01, g11[:, :, dh:, :]], dim=2)
    return torch.cat([left, right[:, :, :, dw:]], dim=3)


def step_interp(schedule: EulerSchedule, model_output, sample, step_i):
    """Plain v-prediction Euler step. Returns (prev_sample, pred_x0)."""
    x0 = pred_original_sample(model_output, sample, schedule.sigmas[step_i])
    return euler_step(schedule, sample, x0, step_i), x0


def step_interp_prob_uncertain(schedule: EulerSchedule, model_output,
                               sample, step_i, cond_latents, mask,
                               lambda_ts, clamp_lo: float = 0.4):
    """Soft latent replacement step of the prob variant. sample and
    model_output: (T, C, H, W); cond_latents: (T, C, H, W) warped
    conditioning latents; mask: (T-2, H, W) uncertainty in [0, 1];
    lambda_ts: (num_steps, T). Frame t of 1..T-2 blends x0 toward its
    conditioning latent with w = inv / (1 + inv), inv = 1 / (1 - certain +
    1e-6), zeroed under 0.51 and where |masked diff| passes the frame's
    top-k cutoff; the endpoints are replaced. Returns (prev_sample,
    blended pred_x0)."""
    x0 = pred_original_sample(model_output, sample, schedule.sigmas[step_i])
    inner, cond_in = x0[1:-1], cond_latents[1:-1]
    certain = ((1.0 - mask) > 0.5)[:, None]                # (T-2, 1, H, W)
    _, cutoff = _frame_top_masks(inner, cond_in, certain,
                                 lambda_ts[step_i][1:-1], clamp_lo)
    inv = 1.0 / (1.0 - certain.float() + 1e-6)
    wgt = inv / (1.0 + inv)
    wgt = torch.where(wgt >= 0.51, wgt, 0.0)
    masked_diff = (inner - cond_in) * certain
    wgt = (masked_diff.abs() <= cutoff).float() * wgt
    x0 = torch.cat([cond_latents[:1], (1.0 - wgt) * inner + wgt * cond_in,
                    cond_latents[-1:]])
    return euler_step(schedule, sample, x0, step_i), x0


def undo_step(schedule: EulerSchedule, sample, step_i,
              generator: torch.Generator, ratio: float = 0.49):
    """Partial re-noising: sample + noise x sqrt(sigma_i^2 -
    sigma_{i+1}^2) x ratio, the noise drawn from ``generator``."""
    noise = torch.randn(sample.shape, generator=generator,
                        device=sample.device, dtype=sample.dtype)
    s0, s1 = schedule.sigmas[step_i], schedule.sigmas[step_i + 1]
    return sample + noise * torch.sqrt(s0 ** 2 - s1 ** 2) * ratio


def add_noise(schedule: EulerSchedule, sample, noise, step_i):
    return sample + noise * schedule.sigmas[step_i]
