"""The port's GS loop by segments against the JAX package's, on the CPU.

``_next_boundary``, a segment's pre-picked view indices and depth flags
and ``_merged_views`` must equal JAX's exactly. The port's segmented loop
(the static step, eager on the CPU) is held to JAX's scan path
(``_train_steps``) and to the port's own per-step path, on the setup of
JAX's ``test_segment_scan_matches_per_step`` (tests/test_gs_trainer.py):
two 48x36 views, three pseudo views with depth targets, 24 iterations with
densify at 8 and 16. JAX's split noise is fed to the port's densify.

Tolerances, float32 on both sides:
- port against JAX: sums in another order and 24 Adam steps, each of which
  moves an entry by about lr x sign(grad); 1e-4 relative, 1e-5 absolute
  (the five-step bound of tests/test_torch_gs.py; the largest difference
  seen is 6e-6, on the opacity logits);
- segmented against per-step, both in the port: bit for bit. Both run
  the same operations on the same float32 values: the static step takes
  the position learning rate and Adam's bias corrections from host floats
  computed by the per-step path's code, and a train view inside a segment
  adds 0 x the depth term.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.gs import trainer as JT
from syn3r_tpu.models import gaussians as JG
from syn3r_tpu.ops.rasterize import render as j_render
from syn3r_tpu.utils.camera import camera_from_fov as j_camera_from_fov
from syn3r_tpu.utils.camera import look_at_w2c as j_look_at_w2c
from syn3r_tpu_torch.gs import densify as TD
from syn3r_tpu_torch.gs import trainer as TT
from syn3r_tpu_torch.models import gaussians as TG
from syn3r_tpu_torch.utils.camera import camera_from_numpy

FIELDS = list(TG.PARAM_FIELDS)
TO_JAX = dict(rtol=1e-4, atol=1e-5)
TO_PER_STEP = dict(rtol=0, atol=0)


# -- _next_boundary -----------------------------------------------------------

@pytest.mark.parametrize("mono", [False, True])
@pytest.mark.parametrize("intervals", [(100, 3000, 10 ** 20),
                                       (8, 10 ** 9, 10 ** 20),
                                       (0, 7, 5), (30, 45, 12)])
@pytest.mark.parametrize("log_every", [0, 1, 50])
@pytest.mark.parametrize("densify", [False, True])
def test_next_boundary_matches_jax(densify, log_every, intervals, mono):
    dens, reset, pseudo = intervals
    kw = dict(densification_interval=dens, opacity_reset_interval=reset,
              sample_pseudo_interval=pseudo)
    # the mono-depth clause is ported line for line; the port's trainer
    # keeps _mono_depth_fn None (set_mono_depth_fn raises)
    fn = (lambda rgb: rgb) if mono else None
    jt = types.SimpleNamespace(cfg=JT.TrainConfig(**kw), _mono_depth_fn=fn)
    tt = types.SimpleNamespace(cfg=TT.TrainConfig(**kw), _mono_depth_fn=fn)
    for it in (0, 1, 7, 8, 11, 49, 50, 99, 100, 2999, 3000, 9999):
        for end in (it + 1, 24, 300, 10_000):
            if end <= it:
                continue
            want = JT.GSTrainer._next_boundary(jt, it, end, densify,
                                               log_every)
            got = TT.GSTrainer._next_boundary(tt, it, end, densify,
                                              log_every)
            assert got == want, (it, end)


# -- the two trainers ---------------------------------------------------------

def _toy_scene(n_views=2, w=48, h=36):
    """JAX's toy scene: ground-truth Gaussians rendered from a few
    cameras are the training images."""
    rng = np.random.default_rng(0)
    n = 60
    xyz = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                          rng.uniform(1.8, 2.6, (n, 1))], 1).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    gt = JG.from_points(jnp.asarray(xyz), jnp.asarray(rgb), capacity=64)
    gt = gt.replace(log_scales=gt.log_scales + 0.7,
                    opacity_logits=jnp.where(gt.active[:, None], 2.0, -100.0))
    cams, imgs = [], []
    for i in range(n_views):
        eye = jnp.asarray([0.35 * (i - 1), 0.05 * i, 0.0])
        cam = j_camera_from_fov(0.9, 0.7, w, h, j_look_at_w2c(
            eye, jnp.asarray([0.0, 0.0, 2.2])))
        cams.append(cam)
        imgs.append(np.asarray(j_render(gt, cam, chunk=64, group=1).rgb))
    return cams, np.stack(imgs)


def _simple_state(cap=8):
    """JAX's four Gaussians of the segment test, made anisotropic and
    rotated: an isotropic Gaussian's quaternion gradient is 0 up to
    roundoff, and Adam moves such an entry by +-lr whatever its sign, so
    the two packages could not be compared there."""
    rng = np.random.default_rng(12)
    means = np.array([[0, 0, 2], [0.5, 0, 2], [-0.5, 0, 2], [0, 0.5, 2]],
                     np.float32)
    st = JG.from_points(jnp.asarray(means),
                        jnp.asarray(np.full((4, 3), 0.5, np.float32)),
                        capacity=cap)
    return st.replace(
        log_scales=st.log_scales + jnp.asarray(
            rng.uniform(-0.5, 0.5, (cap, 3)), jnp.float32),
        quats=jnp.asarray(rng.normal(0, 1, (cap, 4)), jnp.float32))


SCAN_KW = dict(iterations=24, chunk=8, group=1, densify_from_iter=8,
               densify_until_iter=20, densification_interval=8,
               opacity_reset_interval=10 ** 9, sample_svd_pseudo_interval=2,
               start_sample_svd_iter=4, pseudo_cam_sampling_rate=0.5,
               svd_depth_warmup=1, seed=3)


@pytest.fixture(scope="module")
def toy():
    return _toy_scene()


def _pair(tmp_path, toy, pseudo=True, **over):
    """JAX's and the port's trainer on the toy scene with the setup of
    JAX's segment test: three pseudo views (copies of view 0) with depth
    targets of 2."""
    cams, imgs = toy
    kw = dict(SCAN_KW, **over)
    jtr = JT.GSTrainer(JT.make_viewset(cams, imgs), JT.TrainConfig(**kw),
                       _simple_state(), model_path=str(tmp_path / "jax"))
    ttr = TT.GSTrainer(TT.make_viewset([camera_from_numpy(c) for c in cams],
                                       imgs), TT.TrainConfig(**kw),
                       TG.gaussians_from_numpy(_simple_state()),
                       model_path=str(tmp_path / "port"), device="cpu")
    if pseudo:
        poses = np.stack([np.asarray(cams[0].w2c)] * 3)
        for tr in (jtr, ttr):
            tr.update_cameras(imgs[:1].repeat(3, axis=0), poses,
                              np.asarray(cams[0].K), append=False)
        jtr.pseudo_depths = jnp.ones((3, 36, 48), jnp.float32) * 2.0
        ttr.pseudo_depths = torch.full((3, 36, 48), 2.0)
    return jtr, ttr


def _jax_split_noise(monkeypatch):
    """Feed the port's densify JAX's split noise: the trainer's key
    chain from PRNGKey(seed), one split a densify step."""
    key = [jax.random.PRNGKey(SCAN_KW["seed"])]

    def densify(state, stats, generator=None, **kw):
        key[0], sub = jax.random.split(key[0])
        noise = tuple(torch.tensor(np.asarray(jax.random.normal(
            k, (state.capacity, 3)))) for k in jax.random.split(sub))
        return TD.densify_and_prune(state, stats, noise=noise, **kw)
    monkeypatch.setattr(TT, "densify_and_prune", densify)


def _assert_states(got, want, tol):
    for f in FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(got.gaussians, f)),
                                   np.asarray(getattr(want.gaussians, f)),
                                   **tol, err_msg=f)
    np.testing.assert_array_equal(np.asarray(got.gaussians.active),
                                  np.asarray(want.gaussians.active))
    for f in FIELDS:
        # Adam's first moment, 0.1 x the gradient's running sum: the
        # gradient rule of tests/test_torch_gs.py (exact when tol is)
        g, w = np.asarray(got.adam.mu[f]), np.asarray(want.adam.mu[f])
        np.testing.assert_allclose(
            g, w, rtol=tol["rtol"] and 2e-3,
            atol=tol["atol"] and 1e-6 + 1e-3 * np.abs(w).max(),
            err_msg=f"mu {f}")
    assert int(got.step) == int(want.step)
    assert int(got.adam.count) == int(want.adam.count)


# -- _merged_views ------------------------------------------------------------

@pytest.mark.parametrize("case", ["train_only", "pseudo_depths",
                                  "pseudo_no_depths", "other_resolution"])
def test_merged_views_match_jax(tmp_path, toy, case):
    jtr, ttr = _pair(tmp_path, toy, pseudo=case != "train_only")
    if case == "pseudo_no_depths":
        jtr.pseudo_depths = ttr.pseudo_depths = None
    if case == "other_resolution":
        cams, imgs = toy
        small = np.zeros((2, 18, 24, 3), np.float32)
        poses = np.stack([np.asarray(cams[0].w2c)] * 2)
        for tr in (jtr, ttr):
            tr.update_cameras(small, poses, np.asarray(cams[0].K),
                              append=False)
        assert jtr._merged_views() is None and ttr._merged_views() is None
        return
    (jc, ji, jd), (tc, ti, td) = jtr._merged_views(), ttr._merged_views()
    for want, got in ((jc.K, tc.K), (jc.w2c, tc.w2c),
                      (jc.confidence, tc.confidence), (ji, ti), (jd, td)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (tc.width, tc.height) == (jc.width, jc.height)


# -- segment picks ------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.5, 0.0])
def test_segment_picks_match_jax(tmp_path, toy, rate):
    """The view indices and depth flags each segment uploads, and where the
    segments end: JAX's ``_train_steps`` arguments, through its loop."""
    jtr, ttr = _pair(tmp_path, toy, pseudo_cam_sampling_rate=rate,
                     start_sample_svd_iter=2000)
    got, want = [], []

    def j_steps(ts, cams, images, depths, idx, flags, lpips_params=None,
                use_lpips=False, use_depth=False):
        want.append((np.asarray(idx), np.asarray(flags), use_depth,
                     use_lpips))
        return ts, jnp.zeros(len(idx))

    def t_segment(merged, idx, flags, use_depth, use_lpips):
        got.append((idx, flags, use_depth, use_lpips))
        return torch.zeros(())
    jtr._train_steps, ttr._run_segment = j_steps, t_segment
    for tr in (jtr, ttr):
        tr._run_loop(1990, 2100, densify=False, log_every=25)
    assert len(got) == len(want) == 5
    for (gi, gf, gd, gl), (wi, wf, wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gf, wf)
        assert gd == wd is True
        assert gl == wl is False
    flags = np.concatenate([f for _, f, _, _ in got])
    assert 0 < flags.sum() < len(flags)       # both kinds of view picked


# -- the segmented loop -------------------------------------------------------

def test_segmented_training_matches_jax_scan(tmp_path, toy, monkeypatch):
    """JAX's scan path and the port's segmented loop (the static step,
    eager on the CPU) over 24 iterations with pseudo views, the depth term
    and densify/prune at 8 and 16."""
    _jax_split_noise(monkeypatch)
    jtr, ttr = _pair(tmp_path, toy)
    capacities = []
    run_segment = ttr._run_segment

    def segment(merged, idx, flags, use_depth, use_lpips):
        capacities.append(ttr.state.gaussians.capacity)
        return run_segment(merged, idx, flags, use_depth, use_lpips)
    ttr._run_segment = segment
    jtr.training(log_every=0)
    ttr.training(log_every=0)
    _assert_states(ttr.state, jtr.state, TO_JAX)
    assert int(ttr.state.step) == 24
    assert ttr.gaussians.num_active > 4          # densify wrote slots
    # one holder a capacity: rebuilt only when the key changes
    assert len(capacities) == 3
    assert ttr.graph_builds["step"] == len(set(capacities))


@pytest.mark.parametrize("upload", [None, 5])
def test_segmented_run_matches_per_step(tmp_path, toy, monkeypatch, upload):
    """The port's segmented loop against its own per-step path
    (``_merged_views`` None), from the same state and seed; with
    ``upload`` steps a pick upload, each 8-step segment uploads twice."""
    if upload:
        monkeypatch.setattr(TT, "SEGMENT_STEPS", upload)
    _jax_split_noise(monkeypatch)
    _, seg = _pair(tmp_path, toy)
    seg.training(log_every=0)
    _jax_split_noise(monkeypatch)
    _, step = _pair(tmp_path, toy)
    step._merged_views = lambda: None      # force the per-step path
    step.training(log_every=0)
    _assert_states(seg.state, step.state, TO_PER_STEP)
    assert step.graph_builds["step"] == 0


def test_segment_leaves_saved_states_alone(tmp_path, toy):
    """A state saved before a segment, and the state a segment hands
    back, are not written by a later segment (no aliasing of the static
    buffers)."""
    _, tr = _pair(tmp_path, toy, pseudo=False)
    s0 = tr.state
    copy0 = {f: getattr(s0.gaussians, f).clone() for f in FIELDS}
    loss = tr._run_loop(0, 6, densify=False, log_every=3)
    s1 = tr.state
    copy1 = {f: getattr(s1.gaussians, f).clone() for f in FIELDS}
    mu1 = {f: v.clone() for f, v in s1.adam.mu.items()}
    assert np.isfinite(loss) and s1.step == 6 and s1.adam.count == 6
    tr._run_loop(6, 12, densify=False, log_every=3)
    assert tr.state.step == 12
    for f in FIELDS:
        assert torch.equal(getattr(s0.gaussians, f), copy0[f]), f
        assert torch.equal(getattr(s1.gaussians, f), copy1[f]), f
        assert torch.equal(s1.adam.mu[f], mu1[f]), f
        assert not torch.equal(getattr(tr.state.gaussians, f), copy1[f]) \
            or f == "sh_rest", f
    assert tr.graph_builds["step"] == 1


def test_render_views_batch_equals_render_view(tmp_path, toy, monkeypatch):
    """The replayed static render, in several uploads of cameras, gives
    each camera's ``render_view`` frame bit for bit."""
    monkeypatch.setattr(TT, "RENDER_FRAMES", 2)
    _, tr = _pair(tmp_path, toy)
    cams = tr.pseudo_views.cameras
    cams = type(cams)(K=torch.cat([cams.K, tr.train_views.cameras.K]),
                      w2c=torch.cat([cams.w2c, tr.train_views.cameras.w2c]),
                      confidence=torch.ones(5), width=cams.width,
                      height=cams.height)
    for _ in range(2):
        rgb, depth = tr.render_views_batch(cams)
        assert rgb.shape == (5, 36, 48, 3) and depth.shape == (5, 36, 48)
        for i in range(5):
            want = tr.render_view(cams.at(i))
            assert torch.equal(rgb[i], want["render"]), i
            assert torch.equal(depth[i], want["depth"]), i
        tr._run_loop(0, 4, densify=False, log_every=0)
    assert tr.graph_builds["render"] == 1
    empty = tr.render_views_batch(type(cams)(
        K=cams.K[:0], w2c=cams.w2c[:0], confidence=cams.confidence[:0],
        width=48, height=36))
    assert empty[0].shape == (0, 36, 48, 3)
