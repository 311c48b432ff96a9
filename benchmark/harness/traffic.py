"""The general traffic generator: a mix's parameters (``traffic/<name>.json``)
and a seed in, the inputs of one call of the program out.

``denoise_pair``: the inputs of ``GuidedSVDPipeline.denoise`` for pair
``k`` of a run: standard-normal start latents; CLIP image embeddings of
both endpoints (the uncond row zero); conditioning latents, already divided
by the SVD scale factor; soft uncertainty masks of the inner frames, whose
uncertain share rises from the endpoints to ``hole_max`` at the middle
frame over blobs ``hole_block`` latent pixels wide; and their lambda
schedule (SYN3R's ``search_hypers_v2`` over the published
``lambda_from_steps`` steps, its rows taken at the cell's steps). Every
pair of every seed has the same shapes, so seeds change values and not
work.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .weights import sub_seed


def quad_tau(u: torch.Tensor) -> torch.Tensor:
    """SYN3R's per-frame guidance-stop threshold, in steps of 100."""
    a, b, c = -0.22 / 1.4, 2.4 * 0.22 / 1.4, 0.2
    return (a * u ** 2 + b * u + c) * 100.0


def search_hypers_v2(masks: torch.Tensor, num_steps: int) -> torch.Tensor:
    """lambda in {0, 1}^(num_steps x F) from the (F-2, h, w) masks: frame
    tau keeps 1 while num_steps - t > quad_tau(u_tau); the endpoints
    always keep 1."""
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


def denoise_pair(traffic: dict, pcfg: dict, seed: int, k, device) -> dict:
    """The ``denoise`` arguments of pair ``k`` (an int, or a name such as
    "warm") as a dict of float32 tensors on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              f"pair{k}"))
    f = pcfg["num_frames"]
    h, w = pcfg["height"] // 8, pcfg["width"] // 8
    d = traffic["clip_dim"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    emb = randn(2, 1, d) * traffic["clip_std"]
    zero = torch.zeros(1, 1, d, device=device)
    blk = traffic["hole_block"]
    field = randn(f - 2, -(-h // blk), -(-w // blk))
    field = F.interpolate(field[None], scale_factor=blk,
                          mode="nearest")[0, :, :h, :w]
    frac = traffic["hole_max"] * torch.sin(
        math.pi * torch.arange(1, f - 1, device=device) / (f - 1))
    z = math.sqrt(2.0) * torch.erfinv(2.0 * frac - 1.0)
    mask = torch.sigmoid((z[:, None, None] - field)
                         * traffic["hole_sharpness"])
    steps = pcfg["num_inference_steps"]
    full = traffic["lambda_from_steps"]
    rows = torch.linspace(0, full - 1, steps, device=device).round().long()
    return dict(noise_latents=randn(pcfg["latent_num"], f, h, w, 4),
                clip_start=torch.cat([zero, emb[:1]]),
                clip_end=torch.cat([zero, emb[1:]]),
                cond_latents=randn(f, h, w, 4) * traffic["cond_std"],
                mask=mask,
                lambda_ts=search_hypers_v2(mask, full)[rows])

