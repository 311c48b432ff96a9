"""Parity of the port's scheduler, image helpers, lambda schedule and the
whole tiny completion unit (post variant; the prob variant's denoise)
against the JAX package on the CPU.

Inputs are uniform random numpy arrays from a seed (so top-k sorts meet no
ties) fed to both packages. Tolerances: every function and stage computes
in float32 on both sides and differs only in summation order, so 1e-4
absolute and relative; the decoded frames, after 3 guided steps whose
per-tile std normalization and top-k cutoffs amplify last-bit differences
and a decoder several layers deep, are held to 2e-3 absolute.
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
from syn3r_tpu.models.clip import CLIPVisionModelWithProjection as JCLIP
from syn3r_tpu.models.svd_unet import (UNetSpatioTemporalConditionModel as
                                       JUNet)
from syn3r_tpu.models.vae import AutoencoderKLTemporalDecoder as JVAE
from syn3r_tpu.pipeline.completion import search_hypers_v2 as j_search
from syn3r_tpu.utils import image as JI
from syn3r_tpu_torch.diffusion import scheduler as TS
from syn3r_tpu_torch.diffusion.pipeline import (GuidedSVDConfig,
                                                GuidedSVDPipeline, SVDModels)
from syn3r_tpu_torch.models.clip import CLIPVisionModelWithProjection
from syn3r_tpu_torch.models.convert import load_flax_params
from syn3r_tpu_torch.models.svd_unet import UNetSpatioTemporalConditionModel
from syn3r_tpu_torch.models.vae import AutoencoderKLTemporalDecoder
from syn3r_tpu_torch.pipeline.completion import search_hypers_v2
from syn3r_tpu_torch.utils import image as TI

TOL = dict(rtol=1e-4, atol=1e-4)
F, H, W = 5, 32, 64
LH, LW = H // 4, W // 4
STEPS = 3


def _u(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _close(got, want, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


# -- scheduler ---------------------------------------------------------------

def test_schedule_and_euler_step():
    js, ts = JS.svd_schedule(25), TS.svd_schedule(25)
    _close(ts.sigmas, js.sigmas, rtol=1e-5, atol=1e-6)
    _close(ts.timesteps, js.timesteps, rtol=1e-5, atol=1e-6)
    _close(ts.init_noise_sigma, js.init_noise_sigma, rtol=1e-5)
    sample, out = _u((F, LH, LW, 4), 1, -1, 1), _u((F, LH, LW, 4), 2, -1, 1)
    for i in (0, 7, 24):
        _close(TS.scale_model_input(ts, torch.from_numpy(sample), i),
               JS.scale_model_input(js, jnp.asarray(sample), i))
        got = TS.step_interp(ts, torch.from_numpy(out),
                             torch.from_numpy(sample), i)
        want = JS.step_interp(js, jnp.asarray(out), jnp.asarray(sample), i)
        _close(got[0], want[0])
        _close(got[1], want[1])


def test_top_k_masks_and_guidance_grad():
    pred, cond = _u((F, 4, LH, LW), 3, -1, 1), _u((F, 4, LH, LW), 4, -1, 1)
    mask, lam = _u((F - 2, LH, LW), 5), _u((F,), 6)
    sigma = np.float32(3.7)
    jm = JS.top_k_masks(jnp.asarray(pred), jnp.asarray(cond),
                        jnp.asarray(mask), jnp.asarray(lam))
    tm = TS.top_k_masks(*(torch.from_numpy(a) for a in (pred, cond, mask,
                                                         lam)))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(TS.guidance_grad(torch.from_numpy(pred), torch.from_numpy(cond),
                            tm, torch.tensor(sigma)),
           JS.guidance_grad(jnp.asarray(pred), jnp.asarray(cond), jm,
                            jnp.asarray(sigma)))


@pytest.mark.parametrize("h,w,mode", [(72, 128, "reference"),
                                      (LH, LW, "scaled")])
def test_guidance_grad_tiled(h, w, mode):
    assert (TS.guidance_tile_bounds(h, w, mode)
            == JS.guidance_tile_bounds(h, w, mode))
    pred, cond = _u((F, 4, h, w), 7, -1, 1), _u((F, 4, h, w), 8, -1, 1)
    mask, lam = _u((F - 2, h, w), 9), _u((F,), 10)
    args = (pred, cond, mask, lam, np.float32(12.5))
    want = JS.guidance_grad_tiled(*(jnp.asarray(a) for a in args),
                                  tile_mode=mode)
    got = TS.guidance_grad_tiled(*(torch.as_tensor(a) for a in args),
                                 tile_mode=mode)
    _close(got, want)


@pytest.mark.parametrize("step_i", [0, 3, 11, 24])
def test_step_interp_prob_uncertain(step_i):
    """The prob variant's soft replacement step over several steps of a
    25-step schedule: a mask with certain and uncertain pixels and
    lambdas on both sides of the 0.4 clamp."""
    js, ts = JS.svd_schedule(25), TS.svd_schedule(25)
    out, sample = _u((F, 4, LH, LW), 40, -1, 1), _u((F, 4, LH, LW), 41, -1, 1)
    cond = _u((F, 4, LH, LW), 42, -1, 1)
    mask, lam = _u((F - 2, LH, LW), 43), _u((25, F), 44)
    args = (out, sample, step_i, cond, mask, lam)
    want = JS.step_interp_prob_uncertain(
        js, *(a if isinstance(a, int) else jnp.asarray(a) for a in args))
    got = TS.step_interp_prob_uncertain(
        ts, *(a if isinstance(a, int) else torch.from_numpy(a)
              for a in args))
    _close(got[0], want[0])
    _close(got[1], want[1])
    x0 = got[1].numpy()
    np.testing.assert_array_equal(x0[[0, -1]], cond[[0, -1]])
    plain = TS.pred_original_sample(torch.from_numpy(out),
                                    torch.from_numpy(sample),
                                    ts.sigmas[step_i]).numpy()
    moved = np.abs(x0[1:-1] - plain[1:-1]) > 1e-6
    assert moved.any() and not moved.all()


def test_undo_step_and_add_noise():
    """add_noise against JAX's; undo_step re-noises by
    sqrt(sigma_i^2 - sigma_{i+1}^2) x ratio with the noise of its
    generator (JAX's draws from its own key: only the formula compares)."""
    js, ts = JS.svd_schedule(25), TS.svd_schedule(25)
    sample = _u((F, 4, LH, LW), 45, -1, 1)
    noise = np.random.default_rng(46).normal(size=sample.shape).astype(
        np.float32)
    for i in (0, 9, 24):
        _close(TS.add_noise(ts, torch.from_numpy(sample),
                            torch.from_numpy(noise), i),
               JS.add_noise(js, jnp.asarray(sample), jnp.asarray(noise), i))
        got = TS.undo_step(ts, torch.from_numpy(sample), i,
                           torch.Generator().manual_seed(7), ratio=0.3)
        draw = torch.randn(sample.shape,
                           generator=torch.Generator().manual_seed(7)).numpy()
        s0, s1 = (float(js.sigmas[i]), float(js.sigmas[i + 1]))
        _close(got, sample + draw * np.sqrt(s0 ** 2 - s1 ** 2) * 0.3)
        key = jax.random.PRNGKey(7)
        want_scale = np.asarray(JS.undo_step(js, jnp.zeros_like(sample), i,
                                             key, ratio=0.3)) / np.asarray(
            jax.random.normal(key, sample.shape))
        _close(np.full_like(sample, np.sqrt(s0 ** 2 - s1 ** 2) * 0.3),
               want_scale)


def test_search_hypers_v2():
    for seed, steps in ((11, 40), (12, 100)):
        masks = _u((F - 2, LH, LW), seed)
        np.testing.assert_array_equal(
            search_hypers_v2(torch.from_numpy(masks), steps).numpy(),
            np.asarray(j_search(jnp.asarray(masks), steps)))


def test_image_resize_helpers():
    img = _u((H, W, 3), 12)
    _close(TI.resize_antialiased(torch.from_numpy(img), 24, 24),
           JI.resize_antialiased(jnp.asarray(img), 24, 24))
    _close(TI.resize_bicubic(torch.from_numpy(img), 50, 20),
           JI.resize_bicubic(jnp.asarray(img), 50, 20))
    _close(TI.gaussian_blur(torch.from_numpy(img), (5, 3), (1.2, 0.7)),
           JI.gaussian_blur(jnp.asarray(img), (5, 3), (1.2, 0.7)))
    _close(TI.to_01(TI.to_neg1_1(torch.from_numpy(img)) * 1.5),
           JI.to_01(JI.to_neg1_1(jnp.asarray(img)) * 1.5))


# -- the whole tiny completion unit -------------------------------------------

@pytest.fixture(scope="module")
def pipelines():
    rng = jax.random.PRNGKey(0)
    ju = JUNet(block_out_channels=(32, 64), num_attention_heads=(2, 4),
               layers_per_block=1, addition_time_embed_dim=32)
    jv = JVAE(block_out_channels=(32, 32, 32), layers_per_block=1)
    jc = JCLIP(hidden=64, layers=2, heads=4, mlp_dim=128, patch=32,
               image_size=224, projection_dim=1024)
    up = jax.jit(lambda k: ju.init(
        k, jnp.zeros((1, F, LH, LW, 8)), 1.0, jnp.zeros((1, 1, 1024)),
        jnp.zeros((1, 3))))(rng)
    vp = jax.jit(lambda k: jv.init(k, jnp.zeros((1, H, W, 3)), 1))(rng)
    cp = jax.jit(lambda k: jc.init(k, jnp.zeros((1, 224, 224, 3))))(rng)
    jpipe = JPipeline(
        JModels(unet=ju, unet_params=up, vae=jv, vae_params=vp, clip=jc,
                clip_params=cp),
        JConfig(num_inference_steps=STEPS, num_frames=F, decode_chunk_size=4,
                compute_dtype=jnp.float32))

    tu = UNetSpatioTemporalConditionModel(
        block_out_channels=(32, 64), num_attention_heads=(2, 4),
        layers_per_block=1, addition_time_embed_dim=32)
    tv = AutoencoderKLTemporalDecoder(block_out_channels=(32, 32, 32),
                                      layers_per_block=1)
    tc = CLIPVisionModelWithProjection(hidden=64, layers=2, heads=4,
                                       mlp_dim=128, patch=32, image_size=224,
                                       projection_dim=1024)
    load_flax_params(tu, up)
    load_flax_params(tv, vp)
    load_flax_params(tc, cp, rule="clip")
    tpipe = GuidedSVDPipeline(
        SVDModels(unet=tu.eval(), vae=tv.eval(), clip=tc.eval()),
        GuidedSVDConfig(num_inference_steps=STEPS, num_frames=F,
                        decode_chunk_size=4, compute_dtype=torch.float32))
    return jpipe, tpipe


def test_pipeline_stages_match_jax(pipelines):
    jpipe, tpipe = pipelines
    imgs = [_u((H, W, 3), 20 + i) for i in range(F)]
    noise = np.random.default_rng(30).normal(size=(H, W, 3)).astype(
        np.float32)
    jenc = jpipe.encode_conditioning(
        jnp.asarray(imgs[0]), [jnp.asarray(a) for a in imgs[1:-1]],
        jnp.asarray(imgs[-1]), noise=jnp.asarray(noise))
    tenc = tpipe.encode_conditioning(
        torch.from_numpy(imgs[0]), [torch.from_numpy(a) for a in imgs[1:-1]],
        torch.from_numpy(imgs[-1]), noise=torch.from_numpy(noise))
    for got, want in zip(tenc, jenc):
        _close(got, want)

    clip_s, clip_e, cond = (np.asarray(a) for a in jenc[:3])
    lat = np.random.default_rng(31).normal(size=(2, F, LH, LW, 4)).astype(
        np.float32)
    mask = _u((F - 2, LH, LW), 32)
    lam = (_u((STEPS, F), 33) > 0.4).astype(np.float32)
    want_lat = jpipe.denoise(*(jnp.asarray(a) for a in (lat, clip_s, clip_e,
                                                        cond, mask, lam)))
    got_lat = tpipe.denoise(lat, clip_s, clip_e, cond, mask, lam)
    _close(got_lat, want_lat)

    got = tpipe.decode(got_lat)
    want = jpipe.decode(want_lat)
    assert got.shape == (F, H, W, 3)
    _close(got, want, rtol=0, atol=2e-3)
    assert np.abs(got.numpy()[0] - got.numpy()[-1]).max() > 1e-5


def test_prob_denoise_matches_jax(pipelines):
    """variant="prob" (one batch-2 CFG forward a direction and step, the
    soft replacement step) on the tiny networks: the latents after 3 steps
    and 2 draws."""
    jpipe, tpipe = pipelines
    jprob = JPipeline(jpipe.m, JConfig(
        num_inference_steps=STEPS, num_frames=F, decode_chunk_size=4,
        compute_dtype=jnp.float32, variant="prob"))
    tprob = GuidedSVDPipeline(tpipe.m, GuidedSVDConfig(
        num_inference_steps=STEPS, num_frames=F, decode_chunk_size=4,
        compute_dtype=torch.float32, variant="prob"))
    rng = np.random.default_rng(50)
    clip_s, clip_e = (np.concatenate([np.zeros((1, 1, 1024), np.float32),
                                      rng.normal(size=(1, 1, 1024))
                                      .astype(np.float32)]) for _ in "se")
    cond = _u((F, LH, LW, 4), 51, -1, 1)
    lat = rng.normal(size=(2, F, LH, LW, 4)).astype(np.float32)
    mask = _u((F - 2, LH, LW), 52)
    lam = (_u((STEPS, F), 53) > 0.4).astype(np.float32)
    args = (lat, clip_s, clip_e, cond, mask, lam)
    want = jprob.denoise(*(jnp.asarray(a) for a in args))
    got = tprob.denoise(*args)
    _close(got, want)
    post = tpipe.denoise(*args)
    assert np.abs(got.numpy() - post.numpy()).max() > 1e-3


def test_deferred_options_raise():
    """direction_sharding, once deferred, turns direction_parallel on as
    JAX's does; an unknown variant still raises."""
    from syn3r_tpu_torch.parallel.mesh import make_scene_topology
    _, dir_sh = make_scene_topology(["cpu"] * 2)
    cfg = GuidedSVDConfig(direction_sharding=dir_sh)
    assert cfg.direction_parallel and dir_sh.mesh.shape == {"pair": 1,
                                                            "dir": 2}
    with pytest.raises(ValueError, match="unknown variant"):
        GuidedSVDConfig(variant="pro")


def test_load_svd_completion_from_npz(pipelines, tmp_path, monkeypatch):
    """load_svd_completion reads the unet/vae/clip npz files the JAX
    package's save_params writes (here of the tiny networks) and holds the
    UNet in bf16, CLIP and the VAE in float32."""
    import functools

    from syn3r_tpu.utils.params import save_params
    from syn3r_tpu_torch.diffusion import pipeline as P

    jpipe, tpipe = pipelines
    for name, params in (("unet", jpipe.m.unet_params),
                         ("vae", jpipe.m.vae_params),
                         ("clip", jpipe.m.clip_params)):
        save_params(params, str(tmp_path / f"{name}.npz"))
    for attr, net in (("UNetSpatioTemporalConditionModel", tpipe.m.unet),
                      ("AutoencoderKLTemporalDecoder", tpipe.m.vae),
                      ("CLIPVisionModelWithProjection", tpipe.m.clip)):
        kw = {"UNetSpatioTemporalConditionModel": dict(
                  block_out_channels=(32, 64), num_attention_heads=(2, 4),
                  layers_per_block=1, addition_time_embed_dim=32),
              "AutoencoderKLTemporalDecoder": dict(
                  block_out_channels=(32, 32, 32), layers_per_block=1),
              "CLIPVisionModelWithProjection": dict(
                  hidden=64, layers=2, heads=4, mlp_dim=128, patch=32,
                  image_size=224, projection_dim=1024)}[attr]
        monkeypatch.setattr(P, attr, functools.partial(getattr(P, attr),
                                                       **kw))
    pipe = P.load_svd_completion(str(tmp_path), device="cpu",
                                 num_inference_steps=STEPS, num_frames=F)
    for got_net, want_net, dtype in ((pipe.m.unet, tpipe.m.unet,
                                      torch.bfloat16),
                                     (pipe.m.vae, tpipe.m.vae, torch.float32),
                                     (pipe.m.clip, tpipe.m.clip,
                                      torch.float32)):
        want = want_net.state_dict()
        for key, val in got_net.state_dict().items():
            assert val.dtype == dtype, key
            torch.testing.assert_close(val, want[key].to(dtype), rtol=0,
                                       atol=0)


def test_svd_weights_completion_is_25_frames(pipelines, tmp_path,
                                            monkeypatch):
    """--svd_weights with --num_frames 5: JAX's _load_svd_completion builds
    its config without num_frames (the 25-frame pipeline), and its denoise
    of 5-frame conditioning raises ValueError (a shape mismatch in the
    guidance tiles). The port's cli.train.svd_config builds the same
    config, and its denoise raises ValueError naming the 25-frame
    pipeline."""
    import argparse
    import functools

    from syn3r_tpu.cli import train as JT
    from syn3r_tpu.models import clip as JC, svd_unet as JSU, vae as JV
    from syn3r_tpu.utils.params import save_params
    from syn3r_tpu_torch.cli import train as CLI
    from syn3r_tpu_torch.diffusion import pipeline as P

    jpipe, _ = pipelines
    for name, params in (("unet", jpipe.m.unet_params),
                         ("vae", jpipe.m.vae_params),
                         ("clip", jpipe.m.clip_params)):
        save_params(params, str(tmp_path / f"{name}.npz"))
    ukw = dict(block_out_channels=(32, 64), num_attention_heads=(2, 4),
               layers_per_block=1, addition_time_embed_dim=32)
    vkw = dict(block_out_channels=(32, 32, 32), layers_per_block=1)
    ckw = dict(hidden=64, layers=2, heads=4, mlp_dim=128, patch=32,
               image_size=224, projection_dim=1024)
    for mod, attr, kw in ((JSU, "UNetSpatioTemporalConditionModel", ukw),
                          (JV, "AutoencoderKLTemporalDecoder", vkw),
                          (JC, "CLIPVisionModelWithProjection", ckw),
                          (P, "UNetSpatioTemporalConditionModel", ukw),
                          (P, "AutoencoderKLTemporalDecoder", vkw),
                          (P, "CLIPVisionModelWithProjection", ckw)):
        monkeypatch.setattr(mod, attr, functools.partial(getattr(mod, attr),
                                                         **kw))
    args = CLI.build_parser().parse_args(
        ["-s", str(tmp_path), "-m", str(tmp_path), "--svd_weights",
         str(tmp_path), "--num_frames", str(F), "--num_inference_steps",
         str(STEPS)])
    jargs = argparse.Namespace(
        svd_weights=args.svd_weights, num_frames=args.num_frames,
        num_inference_steps=STEPS, diffusion_type=args.diffusion_type,
        guidance_reuse_cfg_uncond=0)
    jp = JT._load_svd_completion(jargs)
    tp = P.load_svd_completion(args.svd_weights, device="cpu",
                               **CLI.svd_config(args))
    assert jp.cfg.num_frames == tp.cfg.num_frames == 25
    assert tp.cfg.num_inference_steps == STEPS

    # as __call__ hands them to denoise: noise latents of the config's 25
    # frames, conditioning of the pair's 5
    rng = np.random.default_rng(70)
    inputs = (rng.normal(size=(1, 25, LH, LW, 4)).astype(np.float32),
              np.zeros((2, 1, 1024), np.float32),
              np.zeros((2, 1, 1024), np.float32),
              _u((F, LH, LW, 4), 71, -1, 1), _u((F - 2, LH, LW), 72),
              np.ones((STEPS, F), np.float32))
    with pytest.raises(ValueError):
        jp.denoise(*(jnp.asarray(a) for a in inputs))
    with pytest.raises(ValueError, match="25-frame pipeline"):
        tp.denoise(*inputs)
