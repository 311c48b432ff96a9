"""Parity of the port's warp path against the JAX package on the CPU:
grid sampling, the backward warp and its masks, the image resizes, the pair
conditioning and the pose perturbation (pipeline/completion.py).

Both packages get identical inputs: numpy from a seed, and renders of a
small Gaussian scene made once by the JAX renderer and handed to both as
arrays. Tolerances: exact (atol 1e-6) for gathers at the same float32
coordinates; 1e-5 absolute for float32 geometry (reprojection errors in
pixels: 1e-3 absolute, 1e-4 relative, since ~1e2-pixel cycle errors carry
float32 rounding of the transforms); 2e-6 for the resizes against
jax.image.resize; conditioning frames and masks 1e-5; lambda schedules and
selected poses exact.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.models import gaussians as JG
from syn3r_tpu.ops import grid_sample as JGS
from syn3r_tpu.ops import warp as JW
from syn3r_tpu.ops.rasterize import render as j_render
from syn3r_tpu.pipeline import completion as JC
from syn3r_tpu.utils import image as JI
from syn3r_tpu.utils.camera import camera_from_fov, look_at_w2c, make_camera
from syn3r_tpu_torch.ops import grid_sample as TGS
from syn3r_tpu_torch.ops import warp as TW
from syn3r_tpu_torch.pipeline import completion as TC
from syn3r_tpu_torch.utils import camera as TCam
from syn3r_tpu_torch.utils import image as TI

W, H = 64, 48
GEO = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def scene():
    """Three look-at cameras around a small Gaussian cloud and a numpy
    render function (the JAX dense renderer)."""
    rng = np.random.default_rng(0)
    n = 120
    xyz = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                          rng.uniform(1.8, 2.6, (n, 1))], 1).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    gt = JG.from_points(jnp.asarray(xyz), jnp.asarray(rgb), capacity=128)
    gt = gt.replace(log_scales=gt.log_scales + 0.7,
                    opacity_logits=jnp.where(gt.active[:, None], 2.0, -100.0))
    cams = [camera_from_fov(0.9, 0.7, W, H, look_at_w2c(
        jnp.asarray([0.3 * (i - 1), 0.02 * i, 0.0]),
        jnp.asarray([0.0, 0.0, 2.2]))) for i in range(3)]
    K = np.asarray(cams[0].K)

    def render_np(pose):
        out = j_render(gt, make_camera(K, np.asarray(pose), W, H), chunk=64,
                       group=1)
        depth = jnp.where(out.alpha > 1e-6,
                          out.depth / jnp.maximum(out.alpha, 1e-6), 0.0)
        return np.asarray(out.rgb), np.asarray(depth)

    return cams, K, render_np


def _render_fns(render_np):
    """(JAX render, JAX render_many, port render, port render_many), all
    from the same numpy renders."""
    def j_one(pose):
        r, d = render_np(pose)
        return jnp.asarray(r), jnp.asarray(d)

    def j_many(poses):
        outs = [render_np(p) for p in np.asarray(poses)]
        return (jnp.asarray(np.stack([o[0] for o in outs])),
                jnp.asarray(np.stack([o[1] for o in outs])))

    def t_one(pose):
        r, d = render_np(torch.as_tensor(pose).numpy())
        return _t(r), _t(d)

    def t_many(poses):
        outs = [render_np(p) for p in torch.as_tensor(poses).numpy()]
        return (_t(np.stack([o[0] for o in outs])),
                _t(np.stack([o[1] for o in outs])))

    return j_one, j_many, t_one, t_many


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_grid_sample_matches_jax(mode, align_corners):
    rng = np.random.default_rng(1)
    # widths for which the tie grid values below map to exact pixel .5s
    h, w = 7, (9 if align_corners else 8)
    img = rng.uniform(size=(h, w, 3)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (5, 6, 2)).astype(np.float32)
    # exact .5 ties in pixel space: floor(x + 0.5) rounds them up
    ties = np.array([0.5, 2.5, 3.5, 6.5], np.float32)
    if align_corners:
        gx = ties * 2.0 / (w - 1) - 1.0
    else:
        gx = (2.0 * ties + 1.0) / w - 1.0
    grid[0, :4, 0] = gx
    grid[0, :4, 1] = 0.0                        # pixel row 3 either way
    want = np.asarray(JGS.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                      mode=mode, align_corners=align_corners))
    got = TGS.grid_sample(_t(img), _t(grid), mode=mode,
                          align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if mode == "nearest":
        # the tie columns took the upper neighbour
        x = np.floor(ties + 0.5).astype(int)
        np.testing.assert_array_equal(got[0, :4], img[3, x])


def test_camera_geometry_matches_jax(scene):
    from syn3r_tpu.utils import camera as JCam
    cams, K, render_np = scene
    _, depth = render_np(np.asarray(cams[0].w2c))
    w2c0, w2c1 = np.asarray(cams[0].w2c), np.asarray(cams[1].w2c)
    pts_j = JCam.unproject(jnp.asarray(depth), jnp.asarray(K))
    pts_t = TCam.unproject(_t(depth), _t(K))
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), **GEO)
    moved_j = JCam.transform_points(pts_j, jnp.asarray(w2c0),
                                    jnp.asarray(w2c1))
    moved_t = TCam.transform_points(pts_t, _t(w2c0), _t(w2c1))
    np.testing.assert_allclose(moved_t.numpy(), np.asarray(moved_j), **GEO)
    uv_j, z_j = JCam.project(moved_j, jnp.asarray(K))
    uv_t, z_t = TCam.project(moved_t, _t(K))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **GEO)


def test_inverse_warp_and_consistency_match_jax(scene):
    cams, K, render_np = scene
    src, dst = np.asarray(cams[0].w2c), np.asarray(cams[1].w2c)
    img, depth_src = render_np(src)
    _, depth_dst = render_np(dst)
    jargs = [jnp.asarray(a) for a in (img, depth_src, depth_dst, src, dst, K)]
    want = JW.inverse_warp(*jargs)
    got = TW.inverse_warp(*(_t(a) for a in (img, depth_src, depth_dst, src,
                                            dst, K)))
    for field in JW.InverseWarpResult._fields:
        w_, g_ = np.asarray(getattr(want, field)), \
            getattr(got, field).numpy()
        if w_.dtype == bool:
            np.testing.assert_array_equal(g_, w_, err_msg=field)
        elif field == "soft_mask_reproj":
            # exp(-(err / 20)^3) of the reprojection error below (held to
            # 1e-3 px): its slope is at most 0.059 a pixel
            np.testing.assert_allclose(g_, w_, atol=1e-4, rtol=0,
                                       err_msg=field)
        else:
            np.testing.assert_allclose(g_, w_, atol=1e-5, rtol=1e-5,
                                       err_msg=field)
    assert np.asarray(want.mask).mean() > 0.3   # the warp lands somewhere
    err_j = JW.consistency_check_with_depth(
        jnp.asarray(depth_dst), jnp.asarray(dst), jnp.asarray(K),
        jnp.asarray(depth_src), jnp.asarray(src), jnp.asarray(K))
    err_t = TW.consistency_check_with_depth(_t(depth_dst), _t(dst), _t(K),
                                            _t(depth_src), _t(src), _t(K))
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), atol=1e-3,
                               rtol=1e-4)
    mask = np.random.default_rng(2).uniform(size=(H, W)).astype(np.float32)
    np.testing.assert_allclose(
        TW.downsample_mask_to_latent(_t(mask), 6, 8).numpy(),
        np.asarray(JW.downsample_mask_to_latent(jnp.asarray(mask), 6, 8)),
        atol=1e-6)


@pytest.mark.parametrize("src,dst", [((378, 504), (576, 1024)),
                                     ((37, 51), (72, 128))])
def test_resize_nearest_matches_jax(src, dst):
    img = np.random.default_rng(3).uniform(size=src + (3,)).astype(
        np.float32)
    want = np.asarray(JI.resize_nearest(jnp.asarray(img), *dst))
    got = TI.resize_nearest(_t(img), *dst).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((576, 1024), (378, 504)),
                                     ((72, 128), (37, 51))])
def test_resize_cubic_antialiased_matches_jax(src, dst):
    img = np.random.default_rng(4).uniform(size=src + (3,)).astype(
        np.float32)
    want = np.asarray(JI.resize_cubic_antialiased(jnp.asarray(img), *dst))
    got = TI.resize_cubic_antialiased(_t(img), *dst).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_interpolate_pair_poses_matches_jax(scene):
    cams, _, _ = scene
    a, b = np.asarray(cams[0].w2c), np.asarray(cams[2].w2c)
    want = JC.interpolate_pair_poses(a, b, 25)
    got = TC.interpolate_pair_poses(a, b, 25)
    assert got.dtype == np.float32 and got.shape == (25, 4, 4)
    np.testing.assert_allclose(got, want, **GEO)


def test_prepare_pair_conditioning_matches_jax(scene):
    """The batched backward-warp conditioning from identical renders: cond
    images, latent masks and the lambda schedule. 13 frames, so the source
    switch at interior index 12 takes the right endpoint for the last."""
    cams, K, render_np = scene
    j_one, j_many, t_one, t_many = _render_fns(render_np)
    poses = JC.interpolate_pair_poses(np.asarray(cams[0].w2c),
                                      np.asarray(cams[1].w2c), 13)
    img_l, depth_l = render_np(poses[0])
    img_r, depth_r = render_np(poses[-1])
    want = JC.prepare_pair_conditioning(
        j_one, jnp.asarray(K), jnp.asarray(poses), jnp.asarray(img_l),
        jnp.asarray(depth_l), jnp.asarray(img_r), jnp.asarray(depth_r),
        num_steps=20, render_many_fn=j_many)
    got = TC.prepare_pair_conditioning(
        t_one, _t(K), poses, _t(img_l), _t(depth_l), _t(img_r),
        _t(depth_r), num_steps=20, render_many_fn=t_many)
    assert got.cond_images.shape == (11, H, W, 3)
    assert got.masks.shape == (11, 6, 8)
    np.testing.assert_allclose(got.cond_images.numpy(),
                               np.asarray(want.cond_images), atol=1e-5)
    np.testing.assert_allclose(got.masks.numpy(), np.asarray(want.masks),
                               atol=1e-5)
    np.testing.assert_array_equal(got.lambda_ts.numpy(),
                                  np.asarray(want.lambda_ts))
    # the one-pose render path gives the same conditioning
    seq = TC.prepare_pair_conditioning(
        t_one, _t(K), poses, _t(img_l), _t(depth_l), _t(img_r),
        _t(depth_r), num_steps=20)
    assert torch.equal(seq.cond_images, got.cond_images)
    # the forward warp runs (tests/test_torch_forward_warp.py holds it to
    # JAX); an unknown mode raises
    with pytest.raises(ValueError):
        TC.prepare_pair_conditioning(t_one, _t(K), poses, _t(img_l),
                                     _t(depth_l), _t(img_r), _t(depth_r),
                                     warp_mode="splat")


def test_perturb_and_select_poses_matches_jax(scene):
    """Same numpy seed, same renders: the same candidates, scores within
    float32 geometry noise, and the same picks (no two top scores within
    100x that noise)."""
    cams, K, render_np = scene
    j_one, j_many, t_one, t_many = _render_fns(render_np)
    poses = JC.interpolate_pair_poses(np.asarray(cams[0].w2c),
                                      np.asarray(cams[2].w2c), 7)
    refs = [poses[0], poses[-1]]
    want = JC.perturb_and_select_poses(j_one, jnp.asarray(K), poses[1:-1],
                                       refs, np.random.default_rng(7),
                                       perturb_num=4, trans_frac=0.3,
                                       rot_std_deg=2.0,
                                       render_many_fn=j_many)
    got = TC.perturb_and_select_poses(t_one, _t(K), poses[1:-1], refs,
                                      np.random.default_rng(7),
                                      perturb_num=4, trans_frac=0.3,
                                      rot_std_deg=2.0, render_many_fn=t_many)
    np.testing.assert_array_equal(got, want)
    # the scores behind the picks: same values, no near tie at the top
    rng = np.random.default_rng(7)
    cands = [TC.perturb_and_select_poses(
        t_one, _t(K), poses[1 + i:2 + i], refs, rng, perturb_num=0)
        for i in range(1)]
    assert cands[0].shape == (1, 4, 4)
    ref_imgs, ref_depths = t_many(np.stack(refs))
    flat = np.stack(list(poses[1:-1]))
    nn = np.array([int(np.linalg.norm(np.stack(refs)[:, :3, 3]
                                      - p[:3, 3], axis=1).argmin())
                   for p in flat])
    _, cand_depths = t_many(flat)
    s_t = TC._warp_uncertainty_batch(ref_imgs, ref_depths, _t(np.stack(refs)),
                                     nn, cand_depths, _t(flat), _t(K))
    s_j = JC._warp_uncertainty_batch(
        jnp.asarray(ref_imgs.numpy()), jnp.asarray(ref_depths.numpy()),
        jnp.asarray(np.stack(refs)), jnp.asarray(nn),
        jnp.asarray(cand_depths.numpy()), jnp.asarray(flat), jnp.asarray(K))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)


def test_fps_keyframes_and_covisibility_match_jax():
    rng = np.random.default_rng(5)
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(9)])
    for i in range(9):
        poses[i, :3, 3] = rng.normal(size=3)
        a = rng.normal(0, 0.3)
        poses[i, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    assert TC.fps_keyframes(poses, 4) == JC.fps_keyframes(poses, 4)
    np.testing.assert_allclose(TC.covisibility_distance(poses[0], poses[3]),
                               JC.covisibility_distance(poses[0], poses[3]),
                               rtol=1e-12)


def test_intensity_confidence_matches_jax():
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(size=(2, 5, 7, 3)).astype(np.float32)
            for _ in range(2))
    hole = (rng.uniform(size=(2, 5, 7, 1)) > 0.7).astype(np.float32)
    want = JC.intensity_confidence(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(hole))
    got = TC.intensity_confidence(_t(a), _t(b), _t(hole))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
