"""Parity of the port's GS pieces (Gaussian state, SH, KNN, SSIM, losses,
densify/prune, the train step and loop, checkpoints) against the JAX
package on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the split
noise of densify/prune is JAX's own ``jax.random.normal`` draw, fed to the
port. The port's trainer runs rasterizer="kernel" on CPU tensors (the
composite's plain versions), JAX's rasterizer="tiled". Tolerance: float32
on both sides, sums in another order: 1e-5 relative (1e-6 absolute) for
values and one Adam step (1e-5 absolute for KNN distances, see KNN), the
gradient rule of tests/test_pallas_rasterize.py
(atol 1e-6 + 1e-3 max|g|, rtol 2e-3) for densify statistics and Adam
moments, and 1e-4 for five steps and for renders.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.gs import densify as JD
from syn3r_tpu.gs import losses as JL
from syn3r_tpu.gs import trainer as JT
from syn3r_tpu.models import gaussians as JG
from syn3r_tpu.ops import knn as JK
from syn3r_tpu.utils import image as JI
from syn3r_tpu.utils.camera import camera_from_fov as j_camera_from_fov
from syn3r_tpu.utils.camera import look_at_w2c as j_look_at_w2c
from syn3r_tpu_torch.gs import densify as TD
from syn3r_tpu_torch.gs import losses as TL
from syn3r_tpu_torch.gs import trainer as TT
from syn3r_tpu_torch.models import gaussians as TG
from syn3r_tpu_torch.ops import knn as TK
from syn3r_tpu_torch.utils import image as TI
from syn3r_tpu_torch.utils.camera import camera_from_numpy

VAL = dict(rtol=1e-5, atol=1e-6)
# squared distances by |q|^2 + |p|^2 - 2 q.p in float32 (both packages):
# the cancellation leaves ~8 ulp of |p|^2 ~ 10, about 1e-5 absolute
KNN = dict(rtol=1e-5, atol=1e-5)
FIELDS = list(TG.PARAM_FIELDS)


def _grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=1e-6 + 1e-3 * np.abs(want).max())


def _t(x):
    return torch.tensor(np.asarray(x))


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-1.0, 1.0, (n, 2)),
                          rng.uniform(1.5, 3.0, (n, 1))], 1).astype(np.float32)
    return xyz, rng.uniform(0, 1, (n, 3)).astype(np.float32), rng


@pytest.mark.parametrize("n,cap", [(300, 512), (2, None)])
def test_from_points_matches_jax(n, cap):
    xyz, rgb, _ = _cloud(n, seed=n)
    want = JG.from_points(jnp.asarray(xyz), jnp.asarray(rgb), capacity=cap)
    got = TG.from_points(xyz, rgb, capacity=cap)
    for f in FIELDS:
        # log-scales come from KNN distances: 0.5 x their relative error
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   **(dict(rtol=1e-5, atol=1e-4)
                                      if f == "log_scales" else VAL),
                                   err_msg=f)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))


def test_random_init_is_from_points_of_its_draws():
    got = TG.random_init(torch.Generator().manual_seed(1), 100, extent=1.3,
                         capacity=128)
    g = torch.Generator().manual_seed(1)
    xyz = (torch.rand((100, 3), generator=g) * 2 - 1) * 1.3
    want = TG.from_points(xyz, torch.rand((100, 3), generator=g),
                          capacity=128)
    for f in FIELDS + ["active"]:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.num_active == 100 and got.capacity == 128
    assert float(got.means[:100].abs().max()) <= 1.3


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(0, 1, (64, 16, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = JG.eval_sh(jnp.asarray(sh), jnp.asarray(dirs), degree)
    got = TG.eval_sh(_t(sh), _t(dirs), degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


def test_covariance_matches_jax():
    rng = np.random.default_rng(4)
    ls = rng.normal(-2, 0.5, (64, 3)).astype(np.float32)
    q = rng.normal(0, 1, (64, 4)).astype(np.float32)
    q[0] = 0.0                      # padding-like zero quaternion
    want = JG.covariance_3d(jnp.asarray(ls), jnp.asarray(q))
    got = TG.covariance_3d(_t(ls), _t(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


@pytest.mark.parametrize("n,k", [(700, 3), (3, 3)])
def test_knn_matches_jax(n, k):
    xyz, _, rng = _cloud(n, seed=5)
    valid = rng.uniform(size=n) > 0.2
    want = JK.knn_with_indices(jnp.asarray(xyz), k=k, query_block=256,
                               db_chunk=256, valid=jnp.asarray(valid))
    got = TK.knn_with_indices(_t(xyz), k=k, query_block=128, db_chunk=300,
                              valid=_t(valid))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **KNN)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(
        TK.knn_mean_sq_dist(_t(xyz), k=k).numpy(),
        np.asarray(JK.knn_mean_sq_dist(jnp.asarray(xyz), k=k)), **KNN)
    np.testing.assert_allclose(
        TK.knn_sq_dists(_t(xyz), k=k, valid=_t(valid)).numpy(),
        np.asarray(JK.knn_sq_dists(jnp.asarray(xyz), k=k,
                                   valid=jnp.asarray(valid))), **KNN)


def test_ssim_psnr_pearson_match_jax():
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(TI.ssim(_t(a), _t(b))),
                               float(JI.ssim(jnp.asarray(a), jnp.asarray(b))),
                               **VAL)
    np.testing.assert_allclose(float(TI.psnr(_t(a), _t(b))),
                               float(JI.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(TL.photometric_loss(_t(a), _t(b), 0.2, 0.7)),
        float(JL.photometric_loss(jnp.asarray(a), jnp.asarray(b), 0.2, 0.7)),
        **VAL)
    d = rng.uniform(1, 3, (37, 53)).astype(np.float32)
    t = (2 * d + rng.normal(0, 0.3, d.shape)).astype(np.float32)
    for valid in (t > 3.5, np.zeros_like(t, bool), None):
        want = JL.pearson_depth_loss(jnp.asarray(d), jnp.asarray(t),
                                     None if valid is None
                                     else jnp.asarray(valid))
        got = TL.pearson_depth_loss(_t(d), _t(t),
                                    None if valid is None else _t(valid))
        np.testing.assert_allclose(float(got), float(want), **VAL)


@pytest.mark.parametrize("proximity", [False, True])
def test_densify_and_prune_matches_jax(proximity):
    """Clone, split (JAX's split noise fed in), prune, big-point prune and
    proximity unpooling: the same active set, written mask and slots."""
    xyz, rgb, rng = _cloud(200, seed=7)
    cap = 256
    st = JG.from_points(jnp.asarray(xyz), jnp.asarray(rgb), capacity=cap)
    ls = np.asarray(st.log_scales) + rng.uniform(-1.5, 1.5, (cap, 1))
    op = np.where(rng.uniform(size=(cap, 1)) < 0.1, -8.0, 0.5)
    st = st.replace(log_scales=jnp.asarray(ls, jnp.float32),
                    opacity_logits=jnp.asarray(op, jnp.float32),
                    quats=jnp.asarray(rng.normal(0, 1, (cap, 4)),
                                      jnp.float32))
    stats = JD.DensifyStats(
        grad_accum=jnp.asarray(rng.uniform(0, 2e-3, cap), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 4, cap), jnp.float32),
        max_radii=jnp.asarray(rng.uniform(0, 30, cap), jnp.float32))
    kw = dict(grad_threshold=2e-4, percent_dense=0.05, extent=1.0,
              min_opacity=0.005, max_world_scale=0.5, max_screen_size=25.0,
              big_point_gate=True, use_proximity=proximity,
              proximity_threshold=0.05)
    key = jax.random.PRNGKey(3)
    want, want_written = JD.densify_and_prune(st, stats, key, **kw)
    k1, k2 = jax.random.split(key)
    noise = tuple(_t(jax.random.normal(k, (cap, 3))) for k in (k1, k2))
    got, written = TD.densify_and_prune(
        TG.gaussians_from_numpy(st),
        TD.DensifyStats(*(_t(x) for x in (stats.grad_accum, stats.denom,
                                          stats.max_radii))),
        noise=noise, **kw)
    np.testing.assert_array_equal(written.numpy(), np.asarray(want_written))
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    assert 0 < int(written.sum()) < cap
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **VAL,
                                   err_msg=f)
    np.testing.assert_allclose(
        TD.reset_opacity(got).opacity_logits.numpy(),
        np.asarray(JD.reset_opacity(want).opacity_logits), **VAL)


H, W = 64, 128


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """One JAX trainer (its jitted step compiles once for the module) and
    the matching port trainer on the CPU, on a 2-view scene."""
    xyz, rgb, rng = _cloud(300, seed=8)
    cap = 512
    st = JG.from_points(jnp.asarray(xyz), jnp.asarray(rgb), capacity=cap)
    # anisotropic, rotated, view-dependent colour, half transparent and
    # sparse enough that no Gaussian is buried (transmittance ~0): every
    # gradient stays far above roundoff, so one Adam step (which moves an
    # entry by about lr x sign(grad)) has no sign to lose
    st = st.replace(
        log_scales=st.log_scales + jnp.asarray(
            rng.uniform(-0.7, -0.2, (cap, 3)), jnp.float32),
        quats=jnp.asarray(rng.normal(0, 1, (cap, 4)), jnp.float32),
        sh_rest=jnp.asarray(rng.normal(0, 0.05, (cap, 45)), jnp.float32),
        opacity_logits=jnp.where(st.active[:, None], 0.0, -100.0))
    cams = [j_camera_from_fov(0.9, 0.7, W, H, j_look_at_w2c(
        jnp.asarray([x, 0.0, 0.0]), jnp.asarray([0.0, 0.0, 2.2])))
        for x in (-0.2, 0.2)]
    imgs = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    jcfg = JT.TrainConfig(rasterizer="tiled", tile_cap=256, chunk=128,
                          densify_from_iter=10 ** 9, seed=3)
    tcfg = TT.TrainConfig(rasterizer="kernel", tile_cap=256, chunk=128,
                          densify_from_iter=10 ** 9, seed=3)
    jtr = JT.GSTrainer(JT.make_viewset(cams, imgs), jcfg, st,
                       model_path=str(tmp_path_factory.mktemp("jax")))
    ttr = TT.GSTrainer(TT.make_viewset([camera_from_numpy(c) for c in cams],
                                       imgs), tcfg,
                       TG.gaussians_from_numpy(st),
                       model_path=str(tmp_path_factory.mktemp("port")),
                       device="cpu")
    return jtr, ttr, jtr.state, ttr.state


def _same_state(got, want, tol):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got.gaussians, f).numpy(),
                                   np.asarray(getattr(want.gaussians, f)),
                                   **tol, err_msg=f)
    for f in ("grad_accum", "denom", "max_radii"):
        _grad_close(getattr(got.stats, f).numpy(),
                    np.asarray(getattr(want.stats, f)))
    assert got.step == int(want.step)


@pytest.mark.parametrize("use_depth", [False, True])
def test_train_step_matches_jax(trainers, use_depth):
    jtr, ttr, js0, ts0 = trainers
    jcam, jimg = jtr.train_views.view(0)
    cam, img = ttr.train_views.view(0)
    depth = None
    if use_depth:
        rng = np.random.default_rng(9)
        depth = rng.uniform(1.5, 3.0, (H, W)).astype(np.float32)
        depth[:8] = 0.0                             # invalid target rows
    want_ts, want_m = jtr._train_step(
        js0, jcam, jimg, None if depth is None else jnp.asarray(depth), None,
        use_lpips=False, use_depth=use_depth)
    got_ts, got_m = ttr._train_step(ts0, cam, img,
                                    None if depth is None else _t(depth),
                                    use_depth=use_depth)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    _same_state(got_ts, want_ts, VAL)
    for f in FIELDS:
        _grad_close(got_ts.adam.mu[f].numpy(),
                    np.asarray(want_ts.adam.mu[f]))


def test_run_loop_trajectory_matches_jax(trainers):
    """Five steps of the loop: the same view picks (numpy stream from the
    seed), the same parameters after them."""
    jtr, ttr, js0, ts0 = trainers
    jtr.state, ttr.state = js0, ts0
    jtr._rng, ttr._rng = (np.random.default_rng(3),
                          np.random.default_rng(3))
    # log_every=1 keeps JAX on its per-step path (the step compiled above)
    want = jtr._run_loop(0, 5, densify=False, log_every=1)
    got = ttr._run_loop(0, 5, densify=False, log_every=1)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _same_state(ttr.state, jtr.state, dict(rtol=1e-4, atol=1e-4))


def test_jax_checkpoint_renders_the_same(trainers, tmp_path):
    jtr, ttr, js0, ts0 = trainers
    jtr.state = js0
    jtr.model_path = str(tmp_path)
    path = jtr.save_checkpoint(7, epoch=1)
    assert path.endswith("refine_1_chkpnt7.npz")
    ttr.load_checkpoint(path)
    assert ttr.state.step == int(js0.step)
    jcam, _ = jtr.train_views.view(1)
    want = jtr.render_view(jcam)
    got = ttr.render_view(ttr.train_views.cameras.at(1))
    for k in ("render", "depth", "alpha"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert float(got["alpha"].max()) > 0.5
    # the port's own checkpoint names and keys, read back by JAX
    ttr.model_path = str(tmp_path / "port")
    import os
    os.makedirs(ttr.model_path)
    back = JT.GSTrainer.__new__(JT.GSTrainer)
    back.state = jtr.state
    back.load_checkpoint(ttr.save_checkpoint(5))
    np.testing.assert_array_equal(np.asarray(back.gaussians.means),
                                  ttr.gaussians.means.numpy())


def test_camera_and_se3_match_jax():
    from syn3r_tpu.utils import se3 as JS
    from syn3r_tpu.utils.camera import stack_cameras as j_stack
    from syn3r_tpu_torch.utils import se3 as TS
    from syn3r_tpu_torch.utils.camera import look_at_w2c, stack_cameras
    eyes = [[0.3, -0.1, 0.0], [-0.4, 0.2, 0.5]]
    jc = [j_camera_from_fov(0.9, 0.7, W, H, j_look_at_w2c(
        jnp.asarray(e), jnp.asarray([0.0, 0.0, 2.5])), confidence=0.5)
        for e in eyes]
    tc = [camera_from_numpy(c) for c in jc]
    np.testing.assert_allclose(
        look_at_w2c(eyes[1], [0.0, 0.0, 2.5]).numpy(), np.asarray(jc[1].w2c),
        **VAL)
    jb, tb = j_stack(jc), stack_cameras(tc)
    np.testing.assert_allclose(tb.position.numpy(), np.asarray(jb.position),
                               **VAL)
    np.testing.assert_allclose(tc[0].resized(64, 32).K.numpy(),
                               np.asarray(jc[0].resized(64, 32).K), **VAL)
    np.testing.assert_allclose(
        TS.interpolate_poses(tc[0].w2c, tc[1].w2c, 7).numpy(),
        np.asarray(JS.interpolate_poses(jc[0].w2c, jc[1].w2c, 7)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(TS.rotation_angle_deg(tc[0].R, tc[1].R)),
        float(JS.rotation_angle_deg(jc[0].R, jc[1].R)), rtol=1e-4)


def test_pseudo_view_loop_matches_jax(trainers):
    """SVD pseudo views installed by update_cameras (confidence-weighted,
    with depth targets): the loop picks them on eligible iterations and adds
    the Pearson depth term, as in JAX."""
    jtr, ttr, js0, ts0 = trainers
    rng = np.random.default_rng(10)
    views = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    depths = rng.uniform(1.5, 3.0, (2, H, W)).astype(np.float32)
    poses = np.stack([np.asarray(jtr.train_views.cameras.w2c[i])
                      for i in (1, 0)])
    K = np.asarray(jtr.train_views.cameras.K[0])
    try:
        for tr in (jtr, ttr):
            tr.cfg.svd_depth_warmup = 1
            tr.update_cameras(views[:1], poses[:1], K, cam_confidences=0.5,
                              depths=depths[:1])
            tr.update_cameras(views[1:], poses[1:], K, cam_confidences=[0.3],
                              depths=depths[1:])
        assert len(ttr.pseudo_views) == 2
        np.testing.assert_allclose(
            ttr.pseudo_views.cameras.confidence.numpy(), [0.5, 0.3])
        jtr.state, ttr.state = js0, ts0
        jtr._rng, ttr._rng = (np.random.default_rng(4),
                              np.random.default_rng(4))
        # from iteration 2000 every even iteration picks a pseudo view
        want = jtr._run_loop(2000, 2004, densify=False, log_every=1)
        got = ttr._run_loop(2000, 2004, densify=False, log_every=1)
        np.testing.assert_allclose(got, want, rtol=1e-4)
        _same_state(ttr.state, jtr.state, dict(rtol=1e-4, atol=1e-4))
        rgb, depth = ttr.render_views_batch(ttr.pseudo_views.cameras)
        want_rgb, want_depth = jtr.render_views_batch(
            jtr.pseudo_views.cameras)
        np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(depth.numpy(), np.asarray(want_depth),
                                   rtol=1e-4, atol=1e-4)
    finally:
        for tr in (jtr, ttr):
            tr.cfg.svd_depth_warmup = 0
            tr.pseudo_views = tr.pseudo_depths = None


def test_scene_surface_matches_jax(trainers):
    """find_nearest_cam with and without its angle/distance window, and
    reset_gaussians_from_pcd appending to the live Gaussians."""
    jtr, ttr, js0, ts0 = trainers
    jcams, tcams = jtr.train_views.cameras, ttr.train_views.cameras
    jq = jax.tree.map(lambda x: x[1], jcams)
    tq = tcams.at(1)
    for kw in ({}, dict(multi_view_min_dis=0.01),
               dict(multi_view_max_angle=1.0, multi_view_max_dis=10.0)):
        assert ttr.find_nearest_cam(tq, tcams, **kw) == \
            jtr.find_nearest_cam(jq, jcams, **kw), kw
    xyz, rgb, _ = _cloud(40, seed=11)
    jtr.state, ttr.state = js0, ts0
    try:
        for tr in (jtr, ttr):
            tr.reset_gaussians_from_pcd(xyz, rgb,
                                        append_to_old_gaussians=True)
        for f in FIELDS + ["active"]:
            np.testing.assert_allclose(
                getattr(ttr.gaussians, f).numpy(),
                np.asarray(getattr(jtr.gaussians, f)),
                **(dict(rtol=1e-5, atol=1e-4) if f == "log_scales" else VAL),
                err_msg=f)
        assert ttr.gaussians.num_active == 340
        assert ttr.state.step == 0 and ttr.state.adam.count == 0
    finally:
        jtr.state, ttr.state = js0, ts0
