"""The DL3DV preset's vision branch in the port's scene loop against the
JAX package on the CPU: ``DiffusionGS.densify_pcds`` (keyframes, the flow
gate, DUSt3R on the 512-wide frames, the outlier removal, the cycle's
ply) and ``cli.train.main`` with ``--dust3r_weights`` and
``--gmflow_weights`` over two cycles, with the GS segment captures made
again after each capacity change. The scene helpers are
tests/test_torch_scene.py's.

Tolerances: the gate's mask means within two flow pixels and identical
decisions; DUSt3R's inputs (the resized frames, c2w, K) 1e-4 absolute;
the cloud 1e-3 (30 alignment steps of float32 Adam) with identical counts
and colours.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.pipeline import orchestrator as JO
from syn3r_tpu_torch.cli import train as CLI
from syn3r_tpu_torch.gs import trainer as TT
from syn3r_tpu_torch.pipeline import orchestrator as TO
from syn3r_tpu.pipeline.completion import interpolate_pair_poses
from syn3r_tpu.utils.params import save_params
from syn3r_tpu.vision import dust3r as JD
from syn3r_tpu.vision import gmflow as JF
from syn3r_tpu.vision import gmflow_public as JP
from syn3r_tpu_torch.utils.ply import read_ply_points
from syn3r_tpu_torch.vision import dust3r as TD
from syn3r_tpu_torch.vision import gmflow_public as TP
from test_torch_scene import H, W, _trainers, _write_scene, cloud  # noqa: F401

# the DL3DV vision branch: GS views 256 x 28, so DUSt3R sees 512 x 56
# (patch 8) and GMFlow's 1/8 grid has 4 rows (14, 7, 4): its flows have 32
# rows, not 28, as in JAX
WIDE = (256, 28)
TINY_DUST3R = dict(patch=8, enc_dim=64, enc_depth=1, enc_heads=1,
                   dec_dim=64, dec_depth=1, dec_heads=1)


@pytest.fixture(scope="module")
def vision_nets():
    """Tiny JAX DUSt3R (one 64-wide block a stream, a head of 64 as the
    CLI reads the widths) and GMFlowPublic (64 channels, one layer): the
    flax modules and their inits."""
    dm = JD.Dust3R(**TINY_DUST3R)
    a = jnp.zeros((1, 56, 512, 3))
    dp = jax.jit(dm.init)(jax.random.PRNGKey(1), a, a)
    fm = JP.GMFlowPublic(feature_channels=64, num_transformer_layers=1)
    b = jnp.zeros((1, WIDE[1], WIDE[0], 3))
    fp = jax.jit(fm.init)(jax.random.PRNGKey(2), b, b)
    return dm, dp, fm, fp


class _Jitted:
    """A flax module whose ``apply`` is jitted (one compile of the network
    in place of one a primitive)."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply)


def test_densify_pcds_matches_jax(cloud, vision_nets, tmp_path,
                                  monkeypatch):
    """From the same pairs of frames and poses, FPS keyframes (3 a pair,
    the last dropped), the flow gate against the GS
    render, the 512-wide resize, DUSt3R (30 alignment steps, stride 4),
    the outlier removal and the cycle's ply: the same gate means and
    decisions, the same DUSt3R inputs and the same cloud as JAX's."""
    dm, dp, fm, fp = vision_nets
    jtr, ttr, _ = _trainers(cloud, tmp_path, size=WIDE)
    # a gate threshold between the random flow net's means, so that the
    # gate keeps one rendered frame and drops the others
    kw = dict(diffusion_width=W, diffusion_height=H, num_frames=5,
              num_inference_steps=5, num_views_for_pcd_densification=3,
              fps_keyframe_sampling=True, pcd_frame_quality_thresh=0.003)
    calls = {"jax": [], "port": []}

    def spy(name, fn):
        def wrapped(frames, c2w, K):
            calls[name].append([np.array(x) for x in (frames, c2w, K)])
            return fn(frames, c2w, K)
        return wrapped

    means = []
    gate = JF.correspondence_mask

    def jax_gate(*a, **k):
        out = gate(*a, **k)
        means.append(float(out[2]))
        return out
    monkeypatch.setattr(JF, "correspondence_mask", jax_gate)

    jrun = JO.DiffusionGS(
        jtr, JO.DiffusionGSConfig(**kw), save_dir=str(tmp_path / "jd"),
        dust3r_fn=spy("jax", JD.make_dust3r_fn(_Jitted(dm), dp,
                                               align_iters=30, stride=4)),
        flow_fn=JP.make_flow_fn(fm, fp))
    trun = TO.DiffusionGS(
        ttr, TO.DiffusionGSConfig(**kw), save_dir=str(tmp_path / "td"),
        dust3r_fn=spy("port", TD.make_dust3r_fn(
            TD.load_dust3r(dp, "cpu"), align_iters=30, stride=4)),
        flow_fn=TP.make_flow_fn(TP.load_gmflow(fp, "cpu")))
    # three pairs of five frames: interpolated poses between the views,
    # random frames
    w2c = np.asarray(jtr.train_views.cameras.w2c)
    poses = jnp.asarray(np.stack([interpolate_pair_poses(
        w2c[i], w2c[(i + 1) % 3], 5) for i in range(3)]))
    frames = jnp.asarray(np.random.default_rng(11).uniform(
        size=(3, 5, WIDE[1], WIDE[0], 3)).astype(np.float32))
    want = jrun.densify_pcds(frames, poses, 0)
    got = trun.densify_pcds(torch.tensor(np.asarray(frames)),
                            torch.tensor(np.asarray(poses)), 0)

    log = trun.pcd_logs[0]
    assert log["key_idx"] == [0, 2, 5, 7, 10, 12]
    assert log["input_flags"] == [True, False] * 3
    gated = [m for m in log["gate_means"] if m is not None]
    # within two of the 32 x 256 flow pixels
    np.testing.assert_allclose(gated, means, rtol=0, atol=2.5e-4)
    assert log["gate_keep"] == [True, False, True, True, True, False]
    (jf, jc, jk), (tf, tc, tk) = calls["jax"][0], calls["port"][0]
    assert tf.shape == jf.shape and tf.shape[1:] == (56, 512, 3)
    assert len(tf) == log["frames"] == 4
    for g, w in ((tf, jf), (tc, jc), (tk, jk)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    assert 0 < len(got[0]) == len(want[0]) == log["kept"]
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    xyz, _ = read_ply_points(str(tmp_path / "jd" / "dense_views_cyc0.ply"))
    np.testing.assert_allclose(
        read_ply_points(str(tmp_path / "td" / "dense_views_cyc0.ply"))[0],
        xyz, rtol=1e-3, atol=1e-3)
    assert set(trun.timer.summary()) >= {"pcd_flow_gate", "pcd_outliers"}


@pytest.fixture(scope="module")
def wide_scene_dir(cloud, tmp_path_factory):
    return _write_scene(str(tmp_path_factory.mktemp("wide")), *cloud, *WIDE)


def test_cli_train_dl3dv_on_cpu(wide_scene_dir, vision_nets, tmp_path,
                                monkeypatch):
    """The DL3DV preset's flags with --dust3r_weights and --gmflow_weights
    (the JAX package's npz of the flax trees, widths read from them): two
    cycles, each with densify_pcds (FPS keyframes, the flow gate) and a
    dense_views_cyc{c}.ply, the Gaussians reset from the cloud in cycle 0
    and appended in cycle 1. Every segment replays a capture of the
    capacity it runs at: the capacity changes at each reset, and each
    change captures afresh."""
    dm, dp, fm, fp = vision_nets
    save_params(dp, str(tmp_path / "dust3r.npz"))
    save_params(fp, str(tmp_path / "gmflow.npz"))
    segments = []
    run_segment = TT.GSTrainer._run_segment

    def recorded(tr, *a, **k):
        cap = tr.state.gaussians.capacity
        out = run_segment(tr, *a, **k)
        segments.append((cap, tr._segments.key[0], tr.graph_builds["step"]))
        return out
    monkeypatch.setattr(TT.GSTrainer, "_run_segment", recorded)
    resets = []
    reset = TT.GSTrainer.reset_gaussians_from_pcd

    def recorded_reset(tr, xyz, rgb, append_to_old_gaussians=False):
        reset(tr, xyz, rgb, append_to_old_gaussians)
        resets.append((len(xyz), append_to_old_gaussians,
                       tr.state.gaussians.capacity,
                       tr.state.gaussians.num_active))
    monkeypatch.setattr(TT.GSTrainer, "reset_gaussians_from_pcd",
                        recorded_reset)

    out = tmp_path / "model"
    runner = CLI.main([
        "-s", wide_scene_dir, "-m", str(out), "--n_views", "2",
        "--dataset", "dl3dv", "--cam_confidence", "0.2",
        "--num_views_for_pcd_densification", "3",
        "--fps_keyframe_sampling", "1", "--sample_svd_pseudo_interval", "1",
        "--svd_depth_warmup", "1", "--use_proximity_densify", "0",
        "--percent_dense", "0.001", "--refine_cycle_num", "2",
        "--iterations", "6", "--start_sample_svd_frame", "2",
        "--diffusion_width", str(W), "--diffusion_height", str(H),
        "--num_frames", "5", "--num_inference_steps", "4",
        "--tile_cap", "256", "--dust3r_weights", str(tmp_path / "dust3r.npz"),
        "--gmflow_weights", str(tmp_path / "gmflow.npz"), "--device", "cpu",
        "--log_every", "0"])
    tr = runner.trainer
    assert sorted(runner.pcd_logs) == [0, 1]
    for c in (0, 1):
        log = runner.pcd_logs[c]
        assert log["input_flags"] == [True, False] * 2
        assert len(log["gate_means"]) == 4 and log["frames"] >= 2
        xyz, rgb = read_ply_points(str(out / "dense_views"
                                       / f"dense_views_cyc{c}.ply"))
        assert len(xyz) == log["kept"] > 0 and rgb.shape == xyz.shape
        assert np.isfinite(xyz).all()
    assert [r[:2] for r in resets] == [
        (runner.pcd_logs[0]["kept"], False), (runner.pcd_logs[1]["kept"],
                                              True)]
    assert resets[0][3] == resets[0][0]
    assert resets[1][3] >= resets[1][0]
    # every replayed capture was made at the capacity it ran at, and each
    # reset's new capacity got its own capture
    assert all(cap == key for cap, key, _ in segments)
    caps = [cap for cap, _, _ in segments]
    assert {4096, resets[0][2], resets[1][2]} <= set(caps)
    assert len({4096, resets[0][2], resets[1][2]}) == 3
    for (c0, _, b0), (c1, _, b1) in zip(segments, segments[1:]):
        if c1 != c0:
            assert b1 == b0 + 1
    assert len(tr.pseudo_views) == 2 * 4
    np.testing.assert_allclose(tr.pseudo_views.cameras.confidence.numpy(),
                               0.2)
    assert os.path.exists(out / "refine_1_chkpnt6.npz")
    rgb = tr.render_view(tr.train_views.cameras.at(0))["render"]
    assert torch.isfinite(rgb).all() and rgb.shape == (WIDE[1], WIDE[0], 3)
