"""Parity of the port's SVD model stack against the flax modules on the CPU.

The flax modules are initialised from a seed, their param trees are bridged
into the torch modules (models/convert.py), and both run the same numpy
inputs at the tiny sizes of tests/test_pipeline.py. Tolerance: f32 on both
sides, the same operations in another summation order; 1e-4 absolute and
relative bounds that with margin at these depths.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.models import layers as JL
from syn3r_tpu.models.clip import (CLIPVisionModelWithProjection as JCLIP,
                                   convert_clip_torch)
from syn3r_tpu.models.convert import assert_tree_match, torch_to_flax
from syn3r_tpu.models.svd_unet import (UNetSpatioTemporalConditionModel as
                                       JUNet)
from syn3r_tpu.models.vae import AutoencoderKLTemporalDecoder as JVAE
from syn3r_tpu_torch.models import layers as TL
from syn3r_tpu_torch.models.clip import CLIPVisionModelWithProjection
from syn3r_tpu_torch.models.convert import load_flax_params
from syn3r_tpu_torch.models.svd_unet import UNetSpatioTemporalConditionModel
from syn3r_tpu_torch.models.vae import AutoencoderKLTemporalDecoder

TOL = dict(rtol=1e-4, atol=1e-4)
F, LH, LW = 5, 8, 16


def _u(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def unet_pair():
    fu = JUNet(block_out_channels=(32, 64), num_attention_heads=(2, 4),
               layers_per_block=1, addition_time_embed_dim=32)
    params = jax.jit(lambda k: fu.init(
        k, jnp.zeros((1, F, LH, LW, 8)), 1.0, jnp.zeros((1, 1, 1024)),
        jnp.zeros((1, 3))))(jax.random.PRNGKey(0))
    tu = UNetSpatioTemporalConditionModel(
        block_out_channels=(32, 64), num_attention_heads=(2, 4),
        layers_per_block=1, addition_time_embed_dim=32).eval()
    load_flax_params(tu, params)
    return fu, params, tu


@pytest.fixture(scope="module")
def vae_pair():
    fv = JVAE(block_out_channels=(32, 32, 32), layers_per_block=1)
    params = jax.jit(lambda k: fv.init(k, jnp.zeros((1, 32, 64, 3)), 1))(
        jax.random.PRNGKey(1))
    tv = AutoencoderKLTemporalDecoder(block_out_channels=(32, 32, 32),
                                      layers_per_block=1).eval()
    load_flax_params(tv, params)
    return fv, params, tv


@pytest.fixture(scope="module")
def clip_pair():
    kw = dict(hidden=64, layers=2, heads=4, mlp_dim=128, patch=32,
              image_size=224, projection_dim=1024)
    fc = JCLIP(**kw)
    params = jax.jit(lambda k: fc.init(k, jnp.zeros((1, 224, 224, 3))))(
        jax.random.PRNGKey(2))
    tc = CLIPVisionModelWithProjection(**kw).eval()
    load_flax_params(tc, params, rule="clip")
    return fc, params, tc


def test_bridge_covers_every_key_both_ways(unet_pair, vae_pair, clip_pair):
    """load_flax_params (in the fixtures) raised unless every torch key
    found a flax leaf and every flax leaf was used; here the JAX package's
    own torch->flax converters map the torch state dicts back onto the
    flax trees with no missing or extra key."""
    for (_, params, mod), conv in ((unet_pair, torch_to_flax),
                                   (vae_pair, torch_to_flax),
                                   (clip_pair, convert_clip_torch)):
        sd = {k: _np(v) for k, v in mod.state_dict().items()}
        assert_tree_match(conv(sd), params["params"])
    _, params, tu = unet_pair
    params = jax.tree.map(np.asarray, params)
    params["params"]["conv_in"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unused flax leaves"):
        load_flax_params(tu, params)


def _layer_case(name):
    """(flax module, torch module, flax init args, call args (numpy))."""
    x4 = _u((2, 8, 8, 32), 1)
    x3 = _u((2, 12, 32), 2)
    if name == "group_norm_silu":
        return (JL.GroupNorm(num_groups=32, epsilon=1e-6, silu=True),
                TL.GroupNorm(32, 32, 1e-6, silu=True), (x4,))
    if name == "layer_norm":
        return JL.LayerNorm(), TL.LayerNorm(32), (x3,)
    if name == "self_attention":
        return JL.Attention(2, 16), TL.Attention(32, 2, 16), (x3,)
    if name == "single_token_cross_attention":
        return (JL.Attention(2, 16), TL.Attention(32, 2, 16, 48),
                (x3, _u((2, 1, 48), 3)))
    if name == "vae_mid_attention":
        return (JL.Attention(1, 32, qkv_bias=True, norm_num_groups=32,
                             residual_connection=True),
                TL.Attention(32, 1, 32, qkv_bias=True, norm_num_groups=32,
                             residual_connection=True), (x4,))
    if name == "feed_forward":
        return JL.FeedForward(), TL.FeedForward(32), (x3,)
    if name == "resnet2d_temb":
        return (JL.ResnetBlock2D(64), TL.ResnetBlock2D(32, 64, 20),
                (x4, _u((2, 20), 4)))
    if name == "temporal_resnet":
        return (JL.TemporalResnetBlock(32), TL.TemporalResnetBlock(32, 32, 20),
                (_u((1, 3, 4, 4, 32), 5), _u((1, 3, 20), 6)))
    if name == "upsample":
        return JL.Upsample2D(32), TL.Upsample2D(32), (x4,)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "group_norm_silu", "layer_norm", "self_attention",
    "single_token_cross_attention", "vae_mid_attention", "feed_forward",
    "resnet2d_temb", "temporal_resnet", "upsample"])
def test_layer_matches_flax(name):
    fm, tm, args = _layer_case(name)
    params = fm.init(jax.random.PRNGKey(3), *(jnp.asarray(a) for a in args))
    # random non-trivial norm affines and biases, not flax's ones/zeros
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(p))), v.shape), params)
    load_flax_params(tm, params)
    want = np.asarray(fm.apply(params, *(jnp.asarray(a) for a in args)))
    with torch.no_grad():
        got = _np(tm(*(_t(a) for a in args)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("batch,groups", [(1, None), (2, None), (3, (1, 2))])
def test_unet_matches_flax(unet_pair, batch, groups):
    fu, params, tu = unet_pair
    sample = _u((batch, F, LH, LW, 8), 10 + batch)
    ehs = _u((batch, 1, 1024), 20 + batch)
    tids = np.tile(np.array([[6.0, 127.0, 0.02]], np.float32), (batch, 1))
    t = 1.3
    apply = jax.jit(fu.apply, static_argnames=("batch_groups",))
    want = np.asarray(apply(params, jnp.asarray(sample), t,
                            jnp.asarray(ehs), jnp.asarray(tids),
                            batch_groups=groups))
    with torch.no_grad():
        got = _np(tu(_t(sample), torch.tensor(t), _t(ehs), _t(tids), groups))
    assert got.shape == (batch, F, LH, LW, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_vae_encode_decode_match_flax(vae_pair):
    fv, params, tv = vae_pair
    img = _u((2, 32, 64, 3), 30)
    want_mode = np.asarray(jax.jit(functools.partial(
        fv.apply, method="encode_mode"))(params, jnp.asarray(img)))
    z = _u((4, 8, 16, 4), 31)
    with torch.no_grad():
        got_mode = _np(tv.encode_mode(_t(img)))
        # 4 latents decoded as 2 temporal chunks of 2 and as one of 4: the
        # decoder mixes frames within a chunk, so the two differ
        got_2 = _np(tv.decode(_t(z), 2))
        got_4 = _np(tv.decode(_t(z), 4))
    np.testing.assert_allclose(got_mode, want_mode, **TOL)
    for got, nf in ((got_2, 2), (got_4, 4)):
        want = np.asarray(jax.jit(functools.partial(
            fv.apply, method="decode"), static_argnums=2)(
                params, jnp.asarray(z), nf))
        np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got_2 - got_4).max() > 1e-4


def test_clip_matches_flax(clip_pair):
    fc, params, tc = clip_pair
    px = _u((2, 224, 224, 3), 40)
    want = np.asarray(jax.jit(fc.apply)(params, jnp.asarray(px)))
    with torch.no_grad():
        got = _np(tc(_t(px)))
    np.testing.assert_allclose(got, want, **TOL)
