"""The port's GMFlow (``vision/gmflow_public.py``, ``vision/gmflow.py``)
against the JAX package on the CPU.

The same numpy inputs from a seed and the same weights (a flax init,
bridged by ``models.convert.gmflow_state_from_flax`` or, for the fallback
net, ``models.convert.load_flax_params``). Tolerances, float32 on both
sides: the window and position helpers exact; instance norm and
attention 1e-5 absolute; flows 1e-3 px (three softmaxes over
correlations, sums in another order); the cycle-consistency masks
identical, their means exact; the bridge round trip exact.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.vision import gmflow as JF
from syn3r_tpu.vision import gmflow_public as JP
from syn3r_tpu_torch.models.convert import (gmflow_state_from_flax,
                                            load_flax_params)
from syn3r_tpu_torch.vision import gmflow as TF
from syn3r_tpu_torch.vision import gmflow_public as TP
from scripts.vision_weights import random_gmflow_params

FLOW = dict(rtol=0, atol=1e-3)
SMALL = dict(rtol=0, atol=1e-5)


def _t(x):
    return torch.tensor(np.asarray(x))


def test_window_helpers_match_jax():
    """split/merge, the shift mask, the sine embedding and instance norm."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 12, 5)).astype(np.float32)
    s = TP.split_feature(_t(x), 2)
    np.testing.assert_array_equal(s.numpy(),
                                  np.asarray(JP.split_feature(x, 2)))
    np.testing.assert_array_equal(TP.merge_splits(s, 2).numpy(), x)
    for h, w in ((8, 8), (6, 12)):
        np.testing.assert_array_equal(
            TP.shift_window_attn_mask(h, w, 2).numpy(),
            np.asarray(JP.shift_window_attn_mask(h, w, 2)))
    np.testing.assert_array_equal(
        TP.position_embedding_sine(3, 5, 8).numpy(),
        np.asarray(JP.position_embedding_sine(3, 5, 8)))
    f0, f1 = (rng.normal(size=(1, 6, 10, 16)).astype(np.float32)
              for _ in range(2))
    for splits in (1, 2):
        for g, w in zip(TP.feature_add_position(_t(f0), _t(f1), splits, 16),
                        JP.feature_add_position(jnp.asarray(f0),
                                                jnp.asarray(f1), splits, 16)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **SMALL)
    got = TP.instance_norm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(JP.instance_norm(x)),
                               **SMALL)


@pytest.mark.parametrize("with_shift", [False, True])
def test_swin_attention_matches_jax(with_shift):
    rng = np.random.default_rng(1)
    h, w, c = 6, 8, 16
    q, k, v = (rng.normal(size=(2, h * w, c)).astype(np.float32)
               for _ in range(3))
    want = JP.swin_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             2, with_shift, h, w,
                             JP.shift_window_attn_mask(h, w, 2))
    got = TP.swin_attention(_t(q), _t(k), _t(v), 2, with_shift, h, w,
                            TP.shift_window_attn_mask(h, w, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SMALL)


def test_matching_and_upsampling_match_jax():
    """The bidirectional correlation softmax and the convex upsampling
    (the F.unfold neighbour order)."""
    rng = np.random.default_rng(2)
    f0, f1 = (rng.normal(size=(1, 4, 6, 8)).astype(np.float32)
              for _ in range(2))
    want = JP.global_correlation_softmax(jnp.asarray(f0), jnp.asarray(f1),
                                         bidir=True)
    got = TP.global_correlation_softmax(_t(f0), _t(f1), bidir=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SMALL)
    flow = rng.normal(size=(1, 3, 4, 2)).astype(np.float32)
    logits = rng.normal(size=(1, 3, 4, 9 * 16)).astype(np.float32)
    want = JP.convex_upsample(jnp.asarray(flow), jnp.asarray(logits), 4)
    got = TP.convex_upsample(_t(flow), _t(logits), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SMALL)


@pytest.fixture(scope="module")
def tiny_public():
    """A tiny GMFlowPublic (64 channels, 2 layers): the flax module, its
    init and the port's bridged copy."""
    model = JP.GMFlowPublic(feature_channels=64, num_transformer_layers=2)
    a = jnp.zeros((1, 60, 64, 3))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), a, a)
    return model, params, TP.load_gmflow(params, "cpu")


def test_gmflow_public_matches_jax(tiny_public):
    """60 rows, which 8 does not divide: 30, 15 and 8 rows at 1/8, so the
    flow has 64 rows, as in JAX; one direction and both (bidir)."""
    model, params, port = tiny_public
    assert TP.gmflow_config(params) == dict(
        feature_channels=64, num_transformer_layers=2, upsample_factor=8)
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(size=(1, 60, 64, 3)).astype(np.float32)
            for _ in range(2))
    want = model.apply(params, jnp.asarray(a), jnp.asarray(b), bidir=True)
    with torch.no_grad():
        got = port(_t(a), _t(b), bidir=True)
        one = port(_t(a), _t(b))
    assert got[0].shape == (1, 64, 64, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FLOW)
    np.testing.assert_allclose(one.numpy(), np.asarray(want[0]), **FLOW)
    assert float(got[0].abs().max()) > 1.0        # not a trivial field


def test_correspondence_mask_matches_jax(tiny_public):
    """The gate through make_flow_fn at 60 rows (flows of 64): the same
    mask and mean as JAX's correspondence_mask."""
    model, params, port = tiny_public
    rng = np.random.default_rng(4)
    a = rng.uniform(size=(60, 64, 3)).astype(np.float32)
    b = np.roll(a, 2, axis=1) + rng.normal(0, 0.02, a.shape).astype(
        np.float32)
    want = JF.correspondence_mask(JP.make_flow_fn(model, params),
                                  jnp.asarray(a), jnp.asarray(b))
    got = TF.correspondence_mask(TP.make_flow_fn(port), _t(a), _t(b))
    assert got[0].shape == (64, 64)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert float(got[2]) == float(want[2])


def test_fb_consistency_matches_jax():
    """warp_flow and the 3 px mask on random flows (targets outside the
    image sample zeros)."""
    rng = np.random.default_rng(5)
    fw = rng.normal(0, 3, (12, 16, 2)).astype(np.float32)
    bw = (-fw + rng.normal(0, 2, fw.shape)).astype(np.float32)
    np.testing.assert_allclose(TF.warp_flow(_t(bw), _t(fw)).numpy(),
                               np.asarray(JF.warp_flow(jnp.asarray(bw),
                                                       jnp.asarray(fw))),
                               **SMALL)
    got = TF.fb_consistency_mask(_t(fw), _t(bw))
    want = JF.fb_consistency_mask(jnp.asarray(fw), jnp.asarray(bw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()


def test_gmflow_bridge_round_trip():
    """A public-layout state dict (tests/test_gmflow_public.py's) ->
    JAX's convert_gmflow_torch -> gmflow_state_from_flax is the same state
    dict exactly, the port's module takes it (strict), and the random
    tree of scripts/vision_weights.py has the flax module's structure."""
    import test_gmflow_public as O
    sd = O._public_state_dict(np.random.default_rng(0), d=64, layers=2)
    back = gmflow_state_from_flax(JP.convert_gmflow_torch(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    TP.GMFlowPublic(feature_channels=64, num_transformer_layers=2) \
        .load_state_dict({k: _t(v) for k, v in back.items()})
    from syn3r_tpu.models.convert import assert_tree_match
    a = jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(JP.GMFlowPublic().init, jax.random.PRNGKey(0),
                            a, a)
    assert_tree_match(random_gmflow_params(0)["params"], shapes["params"])


def test_gmflow_fallback_matches_jax():
    """JAX's fallback GMFlow (dim 32, 2 blocks) at 36 x 40 through
    load_flax_params."""
    model = JF.GMFlow(dim=32, num_blocks=2)
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(size=(1, 36, 40, 3)).astype(np.float32)
            for _ in range(2))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(a),
                                 jnp.asarray(b))
    port = load_flax_params(TF.GMFlow(dim=32, num_blocks=2), params)
    want = model.apply(params, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = port(_t(a), _t(b))
    assert got.shape == (1, 36, 40, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOW)
