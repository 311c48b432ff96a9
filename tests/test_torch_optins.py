"""The completion unit's forward-only opt-ins against the JAX package on
the CPU: ``direction_parallel`` (post, prob and with
``guidance_reuse_cfg_uncond``; ``fused_guidance_cfg=False`` and the
reuse step alone are in tests/test_torch_optins_cfg.py), on the tiny
networks of tests/test_torch_pipeline.py in float32 over 3 steps and 2
latent draws.

Tolerances:
- port against JAX: 1e-4 absolute and relative, the denoise bound of
  tests/test_torch_pipeline.py (float32 on both sides, sums in another
  order, amplified by the per-tile std normalization and top-k cutoffs);
- the port's direction-parallel denoise against its sequential one: JAX's
  own bound for the same pair, rtol 2e-4, atol 2e-5 (tests/test_pipeline.py:
  the stacked forward sums in another order than two calls);
- the unfused post step against the fused one, and the reuse step against
  the default with zero CLIP embeddings: JAX's rtol 1e-3, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
PAR_TOL = dict(rtol=2e-4, atol=2e-5)
VARIANT_TOL = dict(rtol=1e-3, atol=1e-5)
F, LH, LW = 5, 8, 16
STEPS = 3
UNET_KW = dict(block_out_channels=(32, 64), num_attention_heads=(2, 4),
               layers_per_block=1, addition_time_embed_dim=32)


@pytest.fixture(scope="module")
def unets():
    """The tiny UNet of both packages with the same weights (denoise runs
    only the UNet: the VAE and CLIP slots stay empty)."""
    ju = JUNet(**UNET_KW)
    up = jax.jit(lambda k: ju.init(
        k, jnp.zeros((1, F, LH, LW, 8)), 1.0, jnp.zeros((1, 1, 1024)),
        jnp.zeros((1, 3))))(jax.random.PRNGKey(0))
    tu = UNetSpatioTemporalConditionModel(**UNET_KW)
    load_flax_params(tu, up)
    return (JModels(unet=ju, unet_params=up, vae=None, vae_params=None,
                    clip=None, clip_params=None),
            SVDModels(unet=tu.eval(), vae=None, clip=None))


def _inputs(seed, zero_clip=False):
    """Noise latents of 2 draws, CFG-stacked CLIP embeddings of both
    endpoints (zeros, or a zero row and a random one), cond latents, an
    uncertainty mask and a 0/1 lambda schedule."""
    rng = np.random.default_rng(seed)
    clips = [np.zeros((2, 1, 1024), np.float32) if zero_clip else
             np.concatenate([np.zeros((1, 1, 1024), np.float32),
                             rng.normal(size=(1, 1, 1024)).astype(
                                 np.float32)]) for _ in "se"]
    return (rng.normal(size=(2, F, LH, LW, 4)).astype(np.float32), *clips,
            rng.uniform(-1, 1, (F, LH, LW, 4)).astype(np.float32),
            rng.uniform(0, 1, (F - 2, LH, LW)).astype(np.float32),
            (rng.uniform(0, 1, (STEPS, F)) > 0.4).astype(np.float32))


def _run(unets, args, **kw):
    """(port, JAX) latents of the denoise with config fields ``kw``."""
    jm, tm = unets
    jp = JPipeline(jm, JConfig(num_inference_steps=STEPS, num_frames=F,
                               compute_dtype=jnp.float32, **kw))
    tp = GuidedSVDPipeline(tm, GuidedSVDConfig(
        num_inference_steps=STEPS, num_frames=F,
        compute_dtype=torch.float32, **kw))
    want = np.asarray(jp.denoise(*(jnp.asarray(a) for a in args)))
    return tp.denoise(*args).numpy(), want


def _port(unets, args, **kw):
    tp = GuidedSVDPipeline(unets[1], GuidedSVDConfig(
        num_inference_steps=STEPS, num_frames=F,
        compute_dtype=torch.float32, **kw))
    return tp.denoise(*args).numpy()


@pytest.mark.parametrize("variant", ["post", "prob"])
def test_direction_parallel_matches_jax(unets, variant):
    """Both directions as one stacked forward (batch_groups (1, 2, 1, 2)
    post, (2, 2) prob) against JAX's vmapped directions, and against the
    port's sequential directions."""
    args = _inputs(60)
    got, want = _run(unets, args, variant=variant, direction_parallel=True)
    np.testing.assert_allclose(got, want, **TOL)
    seq = _port(unets, args, variant=variant)
    np.testing.assert_allclose(got, seq, **PAR_TOL)


def test_direction_parallel_stacks_one_forward(unets, monkeypatch):
    """One UNet forward a step, with the per-direction groups repeated:
    batch 6 (1, 2, 1, 2) fused, 4 (2, 2) for reuse and prob, and the
    unfused step's batch-2 (1, 1) guidance and batch-4 (2, 2) CFG pass."""
    unet = unets[1].unet
    seen = []
    forward = unet.forward

    def record(sample, t, ehs, tids, batch_groups=None, **kw):
        seen.append((sample.shape[0], tuple(batch_groups)))
        return forward(sample, t, ehs, tids, batch_groups, **kw)
    monkeypatch.setattr(unet, "forward", record)
    args = _inputs(61)
    for kw, want in ((dict(), [(6, (1, 2, 1, 2))]),
                     (dict(guidance_reuse_cfg_uncond=True), [(4, (2, 2))]),
                     (dict(variant="prob"), [(4, (2, 2))]),
                     (dict(fused_guidance_cfg=False),
                      [(2, (1, 1)), (4, (2, 2))])):
        seen.clear()
        _port(unets, args, direction_parallel=True, **kw)
        assert seen == want * 2 * STEPS, (kw, seen)
    seen.clear()
    _port(unets, args, fused_guidance_cfg=False)
    assert seen == [(1, (1,)), (2, (2,))] * 2 * 2 * STEPS


def test_direction_parallel_with_reuse_matches_jax(unets):
    """The two opt-ins together: one batch-4 (2, 2) forward a step."""
    args = _inputs(64)
    got, want = _run(unets, args, guidance_reuse_cfg_uncond=True,
                     direction_parallel=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_config_rules():
    """JAX's __post_init__ rule (guidance_through_unet turns
    direction_parallel off) and the one multi-GPU field, which raises."""
    assert not GuidedSVDConfig(guidance_through_unet=True,
                               direction_parallel=True).direction_parallel
    assert GuidedSVDConfig(direction_parallel=True).direction_parallel
    assert GuidedSVDConfig().fused_guidance_cfg
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        GuidedSVDConfig(direction_sharding=object())
