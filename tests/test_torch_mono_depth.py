"""The monocular-depth pseudo step of the port's GS trainer
(``set_mono_depth_fn``, ``_get_mono_pseudo_cams``, ``_maybe_mono_pseudo``,
``_mono_pseudo_step``) against the JAX package's on the CPU.

The setup is JAX's tests/test_gs_trainer.py::test_mono_depth_pseudo_
regularization: the toy scene's 3 views, a perturbed cloud of its
Gaussians (capacity 64), 30 iterations with densify off,
``sample_pseudo_interval`` 5 from iteration 10, 3 virtual cameras a pair of
TSP-adjacent views, and a fixed estimator (JAX's constant depth of 2.2;
a fixed ramp where the two packages are compared).

Tolerances: the virtual cameras float32 slerp 1e-5 absolute; the view
and pseudo-camera picks exactly; the trainer state after 30 iterations (35
Adam steps) against JAX's 1e-4 relative, 2e-5 absolute: the GS bound of
tests/test_torch_gs_segments.py (24 steps) is 1e-5 absolute, and on this
scene the 30 train steps alone, without the estimator, already move one
sh_dc entry 1.49e-5 apart (float32 sums in another order through 30 Adam
steps); the 5 pseudo steps add 1.1e-6 there. The port's segmented loop
against its per-step loop bit for bit (both run the same operations on the
same float32 values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.gs import trainer as JT
from syn3r_tpu.models import gaussians as JG
from syn3r_tpu_torch.gs import trainer as TT
from syn3r_tpu_torch.models import gaussians as TG
from syn3r_tpu_torch.ops.composite import composite_tiles
from syn3r_tpu_torch.utils.camera import camera_from_numpy
from test_torch_gs_segments import (FIELDS, TO_PER_STEP, _assert_states,
                                    _toy_scene)

KW = dict(iterations=30, chunk=8, group=1, densify_from_iter=10 ** 9,
          sample_pseudo_interval=5, start_sample_pseudo=10,
          mono_pseudo_per_pair=3, mono_depth_weight=0.1)
DEPTH = 2.2
TO_JAX = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(scope="module")
def toy3():
    return _toy_scene(n_views=3)


def _init(aniso=False):
    """JAX's test's initial state: the scene's points moved by N(0, 0.05),
    colour 0.5. ``aniso``: made anisotropic and rotated, as
    tests/test_torch_gs_segments.py's ``_simple_state`` for the same
    reason (an isotropic Gaussian's quaternion gradient is roundoff, which
    Adam turns into +-lr of either sign)."""
    rng = np.random.default_rng(0)
    n = 60
    xyz = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                          rng.uniform(1.8, 2.6, (n, 1))], 1).astype(np.float32)
    xyz = xyz + np.random.default_rng(2).normal(0, 0.05, xyz.shape).astype(
        np.float32)
    st = JG.from_points(jnp.asarray(xyz),
                        jnp.asarray(np.full_like(xyz, 0.5)), capacity=64)
    if aniso:
        rng = np.random.default_rng(12)
        st = st.replace(
            log_scales=st.log_scales + jnp.asarray(
                rng.uniform(-0.5, 0.5, (64, 3)), jnp.float32),
            quats=jnp.asarray(rng.normal(0, 1, (64, 4)), jnp.float32))
    return st


def _trainers(tmp_path, toy3, aniso=False, **over):
    cams, imgs = toy3
    kw = dict(KW, **over)
    init = _init(aniso)
    jtr = JT.GSTrainer(JT.make_viewset(cams, imgs), JT.TrainConfig(**kw),
                       init, model_path=str(tmp_path / "jax"))
    ttr = TT.GSTrainer(TT.make_viewset([camera_from_numpy(c) for c in cams],
                                       imgs), TT.TrainConfig(**kw),
                       TG.gaussians_from_numpy(init),
                       model_path=str(tmp_path / "port"), device="cpu")
    return jtr, ttr


def _ramp(h, w):
    """A fixed depth map, 1.8 to 2.8 down the rows and 0.2 across: a
    constant (JAX's test's estimator) has no Pearson correlation to fit, so
    its gradient is roundoff, which Adam turns into +-lr of either sign."""
    y, x = np.mgrid[:h, :w].astype(np.float32)
    return (1.8 + y / h + 0.2 * x / w).astype(np.float32)


def _record(tr, log, to_np):
    """Wrap the trainer's pick and pseudo step to log the view picks and
    the pseudo cameras' poses."""
    pick, step = tr._pick_view_index, tr._mono_pseudo_step

    def pick_rec(it):
        out = pick(it)
        log.append(("view", it, out))
        return out

    def step_rec(ts, cam, est):
        log.append(("pseudo", to_np(cam.w2c)))
        return step(ts, cam, est)
    tr._pick_view_index, tr._mono_pseudo_step = pick_rec, step_rec


def test_mono_pseudo_step_runs_at_its_cadence(tmp_path, toy3):
    """JAX's test, in the port: inert without an estimator; 5 estimator
    calls (iterations 10, 15, 20, 25, 30), 6 virtual cameras (2 pairs x
    3), the means moved and finite; each pseudo step launches the
    composite forward and backward once more than the train steps do."""
    _, tr = _trainers(tmp_path, toy3)
    tr._maybe_mono_pseudo(20)
    assert tr.state.step == 0 and tr.state.adam.count == 0
    calls = []

    def estimator(rgb):
        calls.append(tuple(rgb.shape))
        return torch.full(rgb.shape[:2], DEPTH)
    tr.set_mono_depth_fn(estimator)
    before = tr.state.gaussians.means.clone()
    composite_tiles.launches.update(fwd=0, bwd=0)
    tr.training(log_every=0)
    assert calls == [(36, 48, 3)] * 5
    assert len(tr._get_mono_pseudo_cams()) == 6
    assert torch.isfinite(tr.state.gaussians.means).all()
    assert not torch.equal(before, tr.state.gaussians.means)
    assert tr.state.step == 30 and tr.state.adam.count == 35
    # the CPU takes the plain composite, which counts no launch (the
    # card's launches per pseudo step are held in chip_smoke.py)
    assert composite_tiles.launches == {"fwd": 0, "bwd": 0}


def test_mono_pseudo_cams_match_jax(tmp_path, toy3):
    jtr, ttr = _trainers(tmp_path, toy3)
    for tr in (jtr, ttr):
        tr.set_mono_depth_fn(lambda rgb: rgb[..., 0])
    want, got = jtr._get_mono_pseudo_cams(), ttr._get_mono_pseudo_cams()
    assert got is ttr._get_mono_pseudo_cams()            # built once
    np.testing.assert_allclose(got.w2c.numpy(), np.asarray(want.w2c),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.K.numpy(), np.asarray(want.K))
    np.testing.assert_array_equal(got.confidence.numpy(),
                                  np.asarray(want.confidence))
    assert (got.width, got.height) == (want.width, want.height)


def test_mono_training_matches_jax(tmp_path, toy3):
    """30 iterations with the fixed estimator installed in both trainers:
    the same view picks and pseudo cameras in the same order, and the
    state within the GS parity tolerance."""
    jtr, ttr = _trainers(tmp_path, toy3, aniso=True)
    ramp = _ramp(*toy3[1].shape[1:3])
    jtr.set_mono_depth_fn(lambda rgb: jnp.asarray(ramp))
    ttr.set_mono_depth_fn(lambda rgb: torch.from_numpy(ramp))
    jlog, tlog = [], []
    _record(jtr, jlog, np.asarray)
    _record(ttr, tlog, lambda t: t.numpy())
    jtr.training(log_every=0)
    ttr.training(log_every=0)
    assert [e[:3] for e in tlog if e[0] == "view"] == \
        [e[:3] for e in jlog if e[0] == "view"]
    tp = [e[1] for e in tlog if e[0] == "pseudo"]
    jp = [e[1] for e in jlog if e[0] == "pseudo"]
    assert len(tp) == len(jp) == 5
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    _assert_states(ttr.state, jtr.state, TO_JAX)
    assert int(ttr.state.adam.count) == 35


def test_mono_segments_match_per_step(tmp_path, toy3):
    """With the estimator installed the loop ends a segment at each due
    iteration; the segmented run equals the per-step run bit for bit."""
    runs = []
    for per_step in (False, True):
        _, tr = _trainers(tmp_path / str(per_step), toy3)
        tr.set_mono_depth_fn(lambda rgb: rgb.mean(-1) + 1.8)
        if per_step:
            tr._merged_views = lambda: None
        segments = []
        run_segment = tr._run_segment

        def seg(merged, idx, flags, use_depth, use_lpips,
                run_segment=run_segment, segments=segments):
            segments.append(len(idx))
            return run_segment(merged, idx, flags, use_depth, use_lpips)
        tr._run_segment = seg
        tr.training(log_every=0)
        runs.append((tr, segments))
    (seg_tr, segs), (step_tr, none) = runs
    assert segs == [5] * 6 and none == []
    _assert_states(seg_tr.state, step_tr.state, TO_PER_STEP)
    for f in FIELDS:
        assert torch.equal(getattr(seg_tr.state.gaussians, f),
                           getattr(step_tr.state.gaussians, f)), f
