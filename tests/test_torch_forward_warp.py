"""The forward (splat) warp of the port against the JAX package on the
CPU: ``bilinear_splat`` (integral target positions, where ``ceil`` equals
``floor``, flows that leave the frame, a mask), ``forward_warp``,
``dilate_mask`` and ``prepare_pair_conditioning(...,
warp_mode="forward_warp")``; and the numpy helpers ``split_point``,
``normalized_endpoint_dists`` and ``covisibility_weight``.

Inputs are numpy from seeds and renders of the small Gaussian scene of
tests/test_torch_warp.py, handed to both packages as arrays. Tolerances:
the splat sums float32 weights in the same order on both sides, so the
warped images within 1e-5 absolute (the soft z-buffer's exp of up to
e^50 cancels in the normalization) and the validity masks, the dilation
and the binary latent masks exactly; geometry 1e-5; the numpy helpers
exactly, and the covisibility weight (float32) within 1e-6.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.ops import warp as JW
from syn3r_tpu.pipeline import completion as JC
from syn3r_tpu.utils import camera as JCam
from syn3r_tpu_torch.ops import warp as TW
from syn3r_tpu_torch.pipeline import completion as TC
from syn3r_tpu_torch.utils import camera as TCam
from test_torch_warp import H, W, _render_fns, _t, scene  # noqa: F401

IMG = dict(rtol=0, atol=1e-5)


def _splat_inputs(seed, integral=False, h=12, w=16):
    rng = np.random.default_rng(seed)
    frame = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 30.0, (h, w)).astype(np.float32)
    # flows of up to 4 px, some leaving the frame by up to 6 px
    flow = rng.uniform(-4, 4, (h, w, 2)).astype(np.float32)
    flow[:2] -= 6.0
    flow[-2:, :, 0] += 6.0
    if integral:
        flow = np.round(flow).astype(np.float32)
    return frame, depth, flow


@pytest.mark.parametrize("integral", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bilinear_splat_matches_jax(integral, masked):
    frame, depth, flow = _splat_inputs(1, integral)
    mask = (np.random.default_rng(2).uniform(size=depth.shape) > 0.3
            if masked else None)
    want, wvalid = JW.bilinear_splat(
        jnp.asarray(frame), jnp.asarray(depth), jnp.asarray(flow),
        None if mask is None else jnp.asarray(mask))
    got, gvalid = TW.bilinear_splat(
        _t(frame), _t(depth), _t(flow),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **IMG)
    assert not gvalid.all() and gvalid.any()     # holes and hits both


def test_splat_integral_positions_keep_one_neighbour():
    """At an integral target position ceil == floor: the whole weight
    lands on one pixel, and a zero flow reproduces the frame."""
    frame, depth, _ = _splat_inputs(3)
    got, valid = TW.bilinear_splat(_t(frame), _t(depth),
                                   torch.zeros(depth.shape + (2,)))
    assert valid.all()
    np.testing.assert_allclose(got.numpy(), frame, rtol=1e-6, atol=1e-6)


def test_forward_warp_matches_jax(scene):
    cams, K, render_np = scene
    img, depth = render_np(np.asarray(cams[0].w2c))
    args = (img, depth, np.asarray(cams[0].w2c), np.asarray(cams[2].w2c), K)
    want = JW.forward_warp(*(jnp.asarray(a) for a in args))
    got = TW.forward_warp(*(_t(a) for a in args))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **IMG)


@pytest.mark.parametrize("size", [3, 5])
def test_dilate_mask_matches_jax(size):
    mask = np.random.default_rng(4).uniform(size=(13, 17)) > 0.9
    mask[0, 0] = mask[-1, -1] = True              # at the borders
    got = TW.dilate_mask(torch.from_numpy(mask), size)
    want = JW.dilate_mask(jnp.asarray(mask), size)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prepare_pair_conditioning_forward_warp_matches_jax(scene):
    """The forward-warp conditioning of a 13-frame pair (the source
    switches to the right endpoint at interior index 12): cond images,
    binary latent masks and the lambda schedule; no render is asked for."""
    cams, K, render_np = scene
    j_one, _, _, _ = _render_fns(render_np)
    poses = JC.interpolate_pair_poses(np.asarray(cams[0].w2c),
                                      np.asarray(cams[1].w2c), 13)
    img_l, depth_l = render_np(poses[0])
    img_r, depth_r = render_np(poses[-1])
    want = JC.prepare_pair_conditioning(
        j_one, jnp.asarray(K), jnp.asarray(poses), jnp.asarray(img_l),
        jnp.asarray(depth_l), jnp.asarray(img_r), jnp.asarray(depth_r),
        num_steps=20, warp_mode="forward_warp")

    def no_render(*a):
        raise AssertionError("the forward warp rendered")
    got = TC.prepare_pair_conditioning(
        no_render, _t(K), poses, _t(img_l), _t(depth_l), _t(img_r),
        _t(depth_r), num_steps=20, warp_mode="forward_warp",
        render_many_fn=no_render)
    assert got.cond_images.shape == (11, H, W, 3)
    assert got.masks.shape == (11, 6, 8)
    assert set(np.unique(got.masks.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    np.testing.assert_allclose(got.cond_images.numpy(),
                               np.asarray(want.cond_images), **IMG)
    np.testing.assert_array_equal(got.lambda_ts.numpy(),
                                  np.asarray(want.lambda_ts))


def test_split_point_and_endpoint_dists_match_jax():
    rng = np.random.default_rng(5)
    for n in (3, 7, 25):
        poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(n)])
        poses[:, :3, 3] = np.cumsum(rng.normal(size=(n, 3)), axis=0)
        assert TC.split_point(poses) == JC.split_point(poses)
        np.testing.assert_array_equal(TC.normalized_endpoint_dists(poses),
                                      JC.normalized_endpoint_dists(poses))


def test_covisibility_weight_matches_jax(scene):
    cams, _, _ = scene
    for a, b in ((0, 1), (0, 2), (1, 1)):
        want = JCam.covisibility_weight(cams[a], cams[b])
        got = TCam.covisibility_weight(TCam.camera_from_numpy(cams[a]),
                                       TCam.camera_from_numpy(cams[b]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
