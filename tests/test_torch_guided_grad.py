"""The post variant's grad-through-UNet guidance
(``GuidedSVDConfig(guidance_through_unet=True)``) against the JAX package
on the CPU, on a tiny UNet bridged from JAX's with ``load_flax_params``.

The port's per-block checkpointed UNet (``remat_blocks=True``) runs the
same operations as the plain one, so its forward and its gradient equal
the plain UNet's bit for bit. Against JAX everything is float32 and
differs in summation order: the normalized guidance gradient (divided by
its std, so relative differences stay relative) is held to 1e-4 absolute
and relative, as ``test_torch_pipeline.py`` holds the default variant.
The latents after 2 guided steps and one draw are held to 3e-4 absolute
(1e-4 relative): float32 rounding alone moves them that far on this path.
The same port run in float64 lies 1.6e-4 from the port's float32 result
and 1.2e-4 from JAX's (latents up to 3.1), and the two float32 results lie
1.2e-4 apart, so 1e-4 would hold float32 noise, not the port.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.diffusion import scheduler as JS
from syn3r_tpu.diffusion.pipeline import (GuidedSVDConfig as JConfig,
                                          GuidedSVDPipeline as JPipeline,
                                          SVDModels as JModels)
from syn3r_tpu.models.svd_unet import (UNetSpatioTemporalConditionModel as
                                       JUNet)
from syn3r_tpu_torch.diffusion.pipeline import (GuidedSVDConfig,
                                                GuidedSVDPipeline, SVDModels)
from syn3r_tpu_torch.models.convert import load_flax_params
from syn3r_tpu_torch.models.svd_unet import UNetSpatioTemporalConditionModel

TOL = dict(rtol=1e-4, atol=1e-4)
DENOISE_TOL = dict(rtol=1e-4, atol=3e-4)
F, LH, LW = 5, 8, 16
STEPS = 2
UNET_KW = dict(block_out_channels=(32, 64), num_attention_heads=(2, 4),
               layers_per_block=1, addition_time_embed_dim=32)


@pytest.fixture(scope="module")
def guided():
    """(JAX pipeline, port pipeline, inputs) with guidance_through_unet on
    the same tiny UNet; denoise touches neither VAE nor CLIP."""
    ju = JUNet(**UNET_KW)
    up = jax.jit(lambda k: ju.init(
        k, jnp.zeros((1, F, LH, LW, 8)), 1.0, jnp.zeros((1, 1, 1024)),
        jnp.zeros((1, 3))))(jax.random.PRNGKey(0))
    jpipe = JPipeline(
        JModels(unet=ju, unet_params=up, vae=None, vae_params=None,
                clip=None, clip_params=None),
        JConfig(num_inference_steps=STEPS, num_frames=F,
                compute_dtype=jnp.float32, guidance_through_unet=True))
    tu = UNetSpatioTemporalConditionModel(**UNET_KW)
    load_flax_params(tu, up)
    tpipe = GuidedSVDPipeline(
        SVDModels(unet=tu.eval(), vae=None, clip=None),
        GuidedSVDConfig(num_inference_steps=STEPS, num_frames=F,
                        compute_dtype=torch.float32,
                        guidance_through_unet=True))
    rng = np.random.default_rng(60)
    clip_s, clip_e = (np.concatenate([np.zeros((1, 1, 1024), np.float32),
                                      rng.normal(size=(1, 1, 1024))
                                      .astype(np.float32)]) for _ in "se")
    inputs = dict(
        lat=rng.normal(size=(1, F, LH, LW, 4)).astype(np.float32),
        clip_s=clip_s, clip_e=clip_e,
        cond=rng.uniform(-1, 1, (F, LH, LW, 4)).astype(np.float32),
        mask=rng.uniform(0, 1, (F - 2, LH, LW)).astype(np.float32),
        lam=(rng.uniform(0, 1, (STEPS, F)) > 0.4).astype(np.float32))
    return jpipe, tpipe, inputs


def test_remat_unet_equals_plain(guided):
    """Forward and d(sum of out * w)/d sample, remat against plain, bit for
    bit; the batch-groups path (1, 2) as the default variant calls it."""
    _, tpipe, _ = guided
    unet = tpipe.m.unet
    rng = np.random.default_rng(61)
    sample = torch.from_numpy(
        rng.normal(size=(3, F, LH, LW, 8)).astype(np.float32))
    ehs = torch.from_numpy(rng.normal(size=(3, 1, 1024)).astype(np.float32))
    tids = torch.tensor([[6.0, 127.0, 0.02]]).repeat(3, 1)
    w = torch.from_numpy(rng.normal(size=(3, F, LH, LW, 4))
                         .astype(np.float32))
    outs, grads = [], []
    for remat in (False, True):
        x = sample.clone().requires_grad_(True)
        out = unet(x, torch.tensor(1.3), ehs, tids, (1, 2),
                   remat_blocks=remat)
        (g,) = torch.autograd.grad((out * w).sum(), x)
        outs.append(out.detach())
        grads.append(g)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(grads[0], grads[1])
    assert grads[0].abs().max() > 0
    assert all(p.grad is None for p in unet.parameters())


def _jax_unet_grad(jpipe, lat, step_i, clip_emb, cond, msk, lam, img_lat):
    """JAX's guidance gradient of one direction step, normalized: the
    ``gloss`` closure of ``_denoise_impl`` as it is written there."""
    sch = jpipe.schedule
    t, sigma = sch.timesteps[step_i], sch.sigmas[step_i]

    def gloss(lat):
        scaled = JS.scale_model_input(sch, lat, step_i)
        inp = jnp.concatenate([scaled, jnp.zeros_like(img_lat)],
                              axis=-1)[None]
        eps = jpipe._unet_remat(jpipe.m.unet_params, inp, t,
                                jnp.zeros_like(clip_emb[:1]),
                                jpipe._added_time_ids(1))[0]
        x0 = JS.pred_original_sample(eps, lat, sigma)
        tm = jax.lax.stop_gradient(
            JS.top_k_masks(x0.transpose(0, 3, 1, 2),
                           cond.transpose(0, 3, 1, 2), msk, lam[step_i]))
        return JS.guidance_loss(x0.transpose(0, 3, 1, 2),
                                cond.transpose(0, 3, 1, 2), tm)

    grad = jax.jit(jax.grad(gloss))(lat)
    return JS.normalize_guidance_grad(grad, sigma, lr=jpipe.cfg.guidance_lr)


def test_guidance_grad_through_remat_unet_matches_jax(guided):
    jpipe, tpipe, d = guided
    step_i = 1
    lat = d["lat"][0] * float(jpipe.schedule.init_noise_sigma)
    img_lat = np.repeat(d["cond"][:1] * 5.6, F, axis=0)
    want = _jax_unet_grad(jpipe, *(jnp.asarray(a) for a in (
        lat, step_i, d["clip_s"], d["cond"], d["mask"], d["lam"], img_lat)))
    got = tpipe._unet_guidance_grad(*(
        torch.from_numpy(np.asarray(a)) for a in (
            lat, step_i, d["clip_s"], d["cond"], d["mask"], d["lam"],
            img_lat)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the gradient is not cut on its way to the latents
    assert float(np.abs(np.asarray(want)).max()) > 1e-4
    assert got.abs().max() > 1e-4
    assert all(p.grad is None for p in tpipe.m.unet.parameters())


def test_guided_denoise_matches_jax(guided):
    """Two guided steps, one latent draw: the latents, finite and apart
    from the default (closed-form) variant's."""
    jpipe, tpipe, d = guided
    args = (d["lat"], d["clip_s"], d["clip_e"], d["cond"], d["mask"],
            d["lam"])
    want = np.asarray(jpipe.denoise(*(jnp.asarray(a) for a in args)))
    got = tpipe.denoise(*args)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **DENOISE_TOL)
    default = GuidedSVDPipeline(tpipe.m, GuidedSVDConfig(
        num_inference_steps=STEPS, num_frames=F,
        compute_dtype=torch.float32)).denoise(*args)
    assert np.abs(got.numpy() - default.numpy()).max() > 1e-4
