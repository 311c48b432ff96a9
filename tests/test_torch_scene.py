"""The port's scene loop against the JAX package on the CPU: COLMAP I/O,
scene loading, ``DiffusionGS.densify_views`` and the structure of a
one-cycle ``run``, the DTU preset's branches (the N - 1-pair
``interpolate_loop0_gs`` chain, ``reorg_train_views=False``, ``refine_GS``
with ``svd_depth_warmup=1``), the ``cli.train`` entry point end to end
(also with the DTU flags and ``--lpips_weights``), and the flags whose
paths are not ported.

Both packages get identical inputs: a tiny COLMAP scene written to
``tmp_path`` (PNG renders of a small Gaussian cloud by the JAX renderer)
and the same Gaussian state. Tolerances: COLMAP values exact (float64
binary) or to 1e-12 (text); loaded images exact, intrinsics and poses
1e-6; densify poses and frames 1e-5 absolute (float32 slerp; the renders
behind the warp come from JAX's tiled composite and the port's plain one,
the same formulas in another order); the refine view stack exact; a
refine with pseudo depths: the depths 1e-5 absolute but at 0.1% of the
pixels, where a Gaussian at the 1/255 alpha cutoff passes it in one
package only (up to 1e-2 there), then 12 steps 1e-4 relative and 1e-5
absolute (the bound of tests/test_torch_gs_segments.py).
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.gs import scene as JS
from syn3r_tpu.gs import trainer as JT
from syn3r_tpu.models import gaussians as JG
from syn3r_tpu.ops.rasterize import render as j_render
from syn3r_tpu.pipeline import orchestrator as JO
from syn3r_tpu.utils import colmap as JCM
from syn3r_tpu.utils.camera import camera_from_fov, look_at_w2c
from syn3r_tpu_torch.cli import train as CLI
from syn3r_tpu_torch.gs import scene as TS
from syn3r_tpu_torch.gs import trainer as TT
from syn3r_tpu_torch.models import gaussians as TG
from syn3r_tpu_torch.pipeline import orchestrator as TO
from syn3r_tpu_torch.utils import colmap as TCM
from syn3r_tpu_torch.utils.camera import camera_from_numpy

W, H, N_IMG = 64, 48, 10
POSE = dict(rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def cloud():
    """A small Gaussian cloud (the JAX state) and its point cloud."""
    rng = np.random.default_rng(0)
    n = 120
    xyz = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                          rng.uniform(1.8, 2.6, (n, 1))], 1).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    gt = JG.from_points(jnp.asarray(xyz), jnp.asarray(rgb), capacity=128)
    gt = gt.replace(log_scales=gt.log_scales + 0.7,
                    opacity_logits=jnp.where(gt.active[:, None], 2.0, -100.0))
    return gt, xyz, rgb


def _cameras(n, w=W, h=H):
    return [camera_from_fov(0.9, 0.7, w, h, look_at_w2c(
        jnp.asarray([0.6 * (i / (n - 1) - 0.5), 0.02 * i, 0.0]),
        jnp.asarray([0.0, 0.0, 2.2]))) for i in range(n)]


def _write_scene(root, gt, xyz, rgb, w=W, h=H):
    """A COLMAP scene of N_IMG PNG renders: sparse/0/{cameras,images,
    points3D}.bin and images/img_XX.png."""
    from PIL import Image
    os.makedirs(os.path.join(root, "sparse", "0"))
    os.makedirs(os.path.join(root, "images"))
    cams = _cameras(N_IMG, w, h)
    K = np.asarray(cams[0].K, np.float64)
    ccam = {1: TCM.ColmapCamera(1, "PINHOLE", w, h, np.array(
        [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))}
    imgs = {}
    for i, cam in enumerate(cams):
        w2c = np.asarray(cam.w2c, np.float64)
        name = f"img_{i:02d}.png"
        imgs[i + 1] = TCM.ColmapImage(
            i + 1, TCM.rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], 1, name,
            np.zeros((0, 2)), np.zeros((0,), np.int64))
        out = np.asarray(j_render(gt, cam, chunk=64, group=1).rgb)
        Image.fromarray(np.round(np.clip(out, 0, 1) * 255).astype(np.uint8)
                        ).save(os.path.join(root, "images", name))
    sparse = os.path.join(root, "sparse", "0")
    TCM.write_cameras_binary(ccam, os.path.join(sparse, "cameras.bin"))
    TCM.write_images_binary(imgs, os.path.join(sparse, "images.bin"))
    TCM.write_points3d_binary(TCM.ColmapPoints3D(
        xyz.astype(np.float64), np.round(rgb * 255).astype(np.uint8),
        np.zeros(len(xyz))), os.path.join(sparse, "points3D.bin"))
    return root


@pytest.fixture(scope="module")
def scene_dir(cloud, tmp_path_factory):
    return _write_scene(str(tmp_path_factory.mktemp("scene")), *cloud)


def _same_model(got, want):
    (gc, gi, gp), (wc, wi, wp) = got, want
    assert sorted(gc) == sorted(wc) and sorted(gi) == sorted(wi)
    for k in wc:
        assert (gc[k].model, gc[k].width, gc[k].height) == \
            (wc[k].model, wc[k].width, wc[k].height)
        np.testing.assert_allclose(gc[k].params, wc[k].params, rtol=1e-12)
        np.testing.assert_allclose(gc[k].K(), wc[k].K(), rtol=1e-12)
    for k in wi:
        assert (gi[k].name, gi[k].camera_id) == (wi[k].name, wi[k].camera_id)
        for f in ("qvec", "tvec", "xys"):
            np.testing.assert_allclose(getattr(gi[k], f), getattr(wi[k], f),
                                       rtol=1e-12, err_msg=f)
        np.testing.assert_array_equal(gi[k].point3d_ids, wi[k].point3d_ids)
        np.testing.assert_allclose(gi[k].w2c(), wi[k].w2c(), rtol=1e-12)
    np.testing.assert_allclose(gp.xyz, wp.xyz, rtol=1e-12)
    np.testing.assert_array_equal(gp.rgb, wp.rgb)
    np.testing.assert_allclose(gp.error, wp.error, rtol=1e-12)


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_colmap_round_trip_read_by_both(tmp_path, fmt):
    """A model written by either package (binary) or as COLMAP text reads
    back the same through both packages' read_model."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=4)
    cams = {1: TCM.ColmapCamera(1, "PINHOLE", 640, 480,
                                np.array([500.5, 501.25, 320.0, 240.5])),
            2: TCM.ColmapCamera(2, "SIMPLE_RADIAL", 320, 240,
                                np.array([250.0, 160.0, 120.0, 0.01]))}
    imgs = {3: TCM.ColmapImage(3, q / np.linalg.norm(q), rng.normal(size=3),
                               1, "a.png", rng.uniform(0, 600, (4, 2)),
                               np.array([-1, 2, 5, 7])),
            5: TCM.ColmapImage(5, np.array([1.0, 0.0, 0.0, 0.0]),
                               np.zeros(3), 2, "b.jpg",
                               np.array([[1.5, 2.25]]), np.array([-1]))}
    pts = TCM.ColmapPoints3D(rng.normal(size=(6, 3)),
                             rng.integers(0, 256, (6, 3)).astype(np.uint8),
                             rng.uniform(0, 2, 6))
    for writer, sub in ((TCM, "port"), (JCM, "jax")):
        d = tmp_path / sub
        d.mkdir()
        if fmt == "binary":
            writer.write_cameras_binary(cams, str(d / "cameras.bin"))
            writer.write_images_binary(imgs, str(d / "images.bin"))
            writer.write_points3d_binary(pts, str(d / "points3D.bin"))
        else:
            writer.write_cameras_text(cams, str(d / "cameras.txt"))
            with open(d / "images.txt", "w") as f:
                f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, "
                        "NAME\n")
                for im in imgs.values():
                    pose = " ".join(repr(float(v))
                                    for v in [*im.qvec, *im.tvec])
                    f.write(f"{im.id} {pose} {im.camera_id} {im.name}\n")
                    f.write(" ".join(f"{x!r} {y!r} {int(p)}" for (x, y), p in
                                     zip(im.xys.tolist(), im.point3d_ids))
                            + "\n")
            with open(d / "points3D.txt", "w") as f:
                for i in range(len(pts.xyz)):
                    f.write(f"{i + 1} " + " ".join(
                        repr(float(v)) for v in pts.xyz[i]) + " "
                        + " ".join(str(int(v)) for v in pts.rgb[i])
                        + f" {float(pts.error[i])!r}\n")
        got = TCM.read_model(str(d))
        want = JCM.read_model(str(d))
        _same_model(got, want)
        np.testing.assert_allclose(got[0][1].params, cams[1].params)
        np.testing.assert_allclose(got[1][3].qvec, imgs[3].qvec)
        np.testing.assert_array_equal(got[1][3].point3d_ids, [-1, 2, 5, 7])
        np.testing.assert_array_equal(got[2].rgb, pts.rgb)
    w2c = imgs[3].w2c()
    np.testing.assert_allclose(TCM.rotmat_to_qvec(w2c[:3, :3]),
                               JCM.rotmat_to_qvec(w2c[:3, :3]), rtol=1e-12)


@pytest.mark.parametrize("kw", [dict(n_views=3), dict(n_views=0,
                                                      resolution=2),
                                dict(n_views=3, rand_pcd=True)])
def test_load_colmap_scene_matches_jax(scene_dir, kw):
    """The llffhold split, the n_views selection, the resolution downscale
    with its intrinsics, the images and the initial point cloud."""
    want = JS.load_colmap_scene(scene_dir, rand_points=500, **kw)
    got = TS.load_colmap_scene(scene_dir, rand_points=500, **kw)
    for g_cams, w_cams in ((got.train_cameras, want.train_cameras),
                           (got.test_cameras, want.test_cameras)):
        assert len(g_cams) == len(w_cams)
        for g, w in zip(g_cams, w_cams):
            assert (g.width, g.height) == (w.width, w.height)
            np.testing.assert_allclose(g.K.numpy(), np.asarray(w.K), **POSE)
            np.testing.assert_allclose(g.w2c.numpy(), np.asarray(w.w2c),
                                       **POSE)
    np.testing.assert_array_equal(got.train_images, want.train_images)
    np.testing.assert_array_equal(got.test_images, want.test_images)
    np.testing.assert_array_equal(got.points_xyz, want.points_xyz)
    np.testing.assert_array_equal(got.points_rgb, want.points_rgb)
    assert len(got.test_cameras) == 2            # images 0 and 8
    if kw.get("n_views"):
        assert len(got.train_cameras) == 3
    if kw.get("rand_pcd"):
        assert got.points_xyz.shape == (500, 3)


def _trainers(cloud, tmp_path, iterations=0, size=(W, H), **over):
    """A JAX and a port trainer on the same three views (of ``size``) and
    state; ``over``: further ``TrainConfig`` fields of both."""
    gt, xyz, _ = cloud
    cams = _cameras(3, *size)
    imgs = np.stack([np.asarray(j_render(gt, c, chunk=64, group=1).rgb)
                     for c in cams])
    init = JG.from_points(jnp.asarray(xyz), jnp.asarray(np.full_like(xyz,
                                                                     0.5)),
                          capacity=128)
    kw = dict(iterations=iterations, densify_from_iter=10 ** 9, tile_cap=256,
              chunk=64, **over)
    jtr = JT.GSTrainer(JT.make_viewset(cams, imgs),
                       JT.TrainConfig(rasterizer="tiled", group=1, **kw),
                       init, model_path=str(tmp_path / "jax"))
    ttr = TT.GSTrainer(TT.make_viewset([camera_from_numpy(c) for c in cams],
                                       imgs), TT.TrainConfig(**kw),
                       TG.gaussians_from_numpy(init),
                       model_path=str(tmp_path / "port"), device="cpu")
    return jtr, ttr, imgs


def test_densify_views_matches_jax(cloud, tmp_path):
    """From the same Gaussian state, the warp-only completion: the
    perturbed poses and the completed frames of every wrap-around pair, the
    endpoints the original photos."""
    jtr, ttr, imgs = _trainers(cloud, tmp_path)
    kw = dict(diffusion_width=W, diffusion_height=H, num_frames=5,
              num_inference_steps=5)
    want_f, want_p = JO.DiffusionGS(
        jtr, JO.DiffusionGSConfig(**kw),
        save_dir=str(tmp_path / "jd")).densify_views(0)
    runner = TO.DiffusionGS(ttr, TO.DiffusionGSConfig(**kw),
                            save_dir=str(tmp_path / "td"))
    got_f, got_p = runner.densify_views(0)
    assert got_f.shape == (3, 5, H, W, 3) and got_p.shape == (3, 5, 4, 4)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=1e-5)
    order = runner._ordered_train_indices()
    for pi in range(3):
        np.testing.assert_allclose(got_f[pi, 0].numpy(), imgs[order[pi]],
                                   atol=1e-5)
        np.testing.assert_allclose(got_f[pi, -1].numpy(),
                                   imgs[order[(pi + 1) % 3]], atol=1e-5)


@pytest.mark.parametrize("densify_type,reorg", [
    ("interpolate_loop0_gs", True), ("interpolate_gs_v2", False),
    ("interpolate_loop0_gs", False)])
def test_dtu_densify_branches_match_jax(cloud, tmp_path, densify_type,
                                        reorg):
    """The DTU preset's pair topology (the N - 1-pair chain of
    'interpolate_loop0_gs') and train-view order (reorg_train_views=False:
    the loaded order, no TSP): the same pairs, poses and frames as JAX."""
    jtr, ttr, imgs = _trainers(cloud, tmp_path)
    kw = dict(diffusion_width=W, diffusion_height=H, num_frames=5,
              num_inference_steps=5, densify_type=densify_type,
              reorg_train_views=reorg)
    jrun = JO.DiffusionGS(jtr, JO.DiffusionGSConfig(**kw),
                          save_dir=str(tmp_path / "jd"))
    trun = TO.DiffusionGS(ttr, TO.DiffusionGSConfig(**kw),
                          save_dir=str(tmp_path / "td"))
    order = trun._ordered_train_indices()
    assert order == jrun._ordered_train_indices()
    if not reorg:
        assert order == [0, 1, 2]
    want_f, want_p = jrun.densify_views(0)
    got_f, got_p = trun.densify_views(0)
    pairs = 2 if densify_type == "interpolate_loop0_gs" else 3
    assert got_f.shape == (pairs, 5, H, W, 3)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=1e-5)
    for pi in range(pairs):
        np.testing.assert_allclose(got_f[pi, -1].numpy(),
                                   imgs[order[(pi + 1) % 3]], atol=1e-5)


@pytest.mark.parametrize("densify_type", ["interpolate_gs_v2",
                                          "interpolate_loop0_gs"])
def test_refine_view_stack_matches_jax(cloud, tmp_path, densify_type):
    """Each pair's frames[:-1]; the chain appends its last frame."""
    jtr, ttr, _ = _trainers(cloud, tmp_path)
    rng = np.random.default_rng(5)
    frames = rng.uniform(0, 1, (2, 5, H, W, 3)).astype(np.float32)
    poses = rng.normal(size=(2, 5, 4, 4)).astype(np.float32)
    cfg = dict(densify_type=densify_type)
    want = JO.DiffusionGS(jtr, JO.DiffusionGSConfig(**cfg),
                          save_dir=str(tmp_path / "jd"))._refine_view_stack(
        jnp.asarray(frames), jnp.asarray(poses))
    got = TO.DiffusionGS(ttr, TO.DiffusionGSConfig(**cfg),
                         save_dir=str(tmp_path / "td"))._refine_view_stack(
        torch.from_numpy(frames), torch.from_numpy(poses))
    n = 8 + (densify_type == "interpolate_loop0_gs")
    for g, w in zip(got, want):
        assert g.shape[0] == n
        np.testing.assert_array_equal(g, np.asarray(w))


def test_refine_gs_with_depth_warmup_matches_jax(cloud, tmp_path):
    """refine_GS with svd_depth_warmup=1 on the same frames and poses: the
    pseudo views at their confidence, the GS-resolution depths rendered at
    the pseudo poses, then 12 finetune steps (pseudo picks with the depth
    term) from the same state."""
    over = dict(svd_depth_warmup=1, start_sample_svd_iter=2,
                sample_svd_pseudo_interval=1)
    jtr, ttr, imgs = _trainers(cloud, tmp_path, iterations=12, **over)
    # anisotropic and rotated: an isotropic Gaussian's quaternion gradient
    # is 0 up to roundoff, which Adam turns into a step of +-lr
    rng = np.random.default_rng(6)
    g = jtr.state.gaussians
    g = g.replace(log_scales=g.log_scales + jnp.asarray(
                      rng.uniform(-0.5, 0.5, g.log_scales.shape), jnp.float32),
                  quats=jnp.asarray(rng.normal(size=g.quats.shape),
                                    jnp.float32))
    jtr.state = dataclasses.replace(jtr.state, gaussians=g)
    ttr.state = dataclasses.replace(ttr.state,
                                    gaussians=TG.gaussians_from_numpy(g))
    kw = dict(diffusion_width=W, diffusion_height=H, num_frames=5,
              num_inference_steps=5, pseudo_cam_sampling_rate=0.5,
              densify_type="interpolate_loop0_gs")
    jrun = JO.DiffusionGS(jtr, JO.DiffusionGSConfig(**kw),
                          save_dir=str(tmp_path / "jd"))
    trun = TO.DiffusionGS(ttr, TO.DiffusionGSConfig(**kw),
                          save_dir=str(tmp_path / "td"))
    frames, poses = jrun.densify_views(0)
    want = jrun.refine_GS(frames, poses, cycle=0)
    got = trun.refine_GS(torch.tensor(np.asarray(frames)),
                         torch.tensor(np.asarray(poses)), cycle=0)
    assert len(ttr.pseudo_views) == len(jtr.pseudo_views) == 2 * 4 + 1
    # a Gaussian whose alpha sits at the 1/255 cutoff may pass it in one
    # package and not in the other: a step of up to ~depth / 255 there
    d = np.abs(ttr.pseudo_depths.numpy() - np.asarray(jtr.pseudo_depths))
    assert (d > 1e-5).mean() <= 1e-3 and d.max() < 1e-2
    assert float(ttr.pseudo_depths.max()) > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    tol = dict(rtol=1e-4, atol=1e-5)
    for f in TG.PARAM_FIELDS:
        np.testing.assert_allclose(getattr(ttr.gaussians, f).numpy(),
                                   np.asarray(getattr(jtr.gaussians, f)),
                                   **tol, err_msg=f)
    assert ttr.state.step == int(jtr.state.step) == 12
    assert ttr.latest_checkpoint().endswith("refine_0_chkpnt12.npz")


def test_run_one_cycle_structure(cloud, tmp_path):
    """One cycle of run with a counting completion: 3 x (F - 1) pseudo
    views at confidence 0.05, one cache file a pair and a cache hit on the
    second call, a checkpoint under the reference's name; a stale cache is
    recomputed."""
    _, ttr, _ = _trainers(cloud, tmp_path, iterations=12)
    calls = []

    def completion(image_start, cond_images, image_end, mask, lambda_ts,
                   generator):
        calls.append(generator.initial_seed())
        assert mask.shape == (3, H // 8, W // 8)
        assert lambda_ts.shape == (5, 5)
        return torch.cat([image_start[None], cond_images, image_end[None]])

    cfg = TO.DiffusionGSConfig(diffusion_width=W, diffusion_height=H,
                               num_frames=5, num_inference_steps=5,
                               refine_cycle_num=1, seed=4)
    dense = tmp_path / "dense"
    runner = TO.DiffusionGS(ttr, cfg, completion_fn=completion,
                            save_dir=str(dense))
    runner.run()
    assert calls == [4, 5, 6]                    # seed + 1000 cycle + pair
    assert len(ttr.pseudo_views) == 3 * 4
    np.testing.assert_allclose(ttr.pseudo_views.cameras.confidence.numpy(),
                               0.05)
    assert sorted(os.listdir(dense)) == [
        f"interpolated_dense_views_cyc0_view{p}.npz" for p in range(3)]
    frames, poses = runner.densify_views(0)      # every pair from its cache
    assert calls == [4, 5, 6] and frames.shape == (3, 5, H, W, 3)
    assert ttr.latest_checkpoint().endswith("refine_0_chkpnt12.npz")
    assert os.path.exists(tmp_path / "port" / "chkpnt12.npz")
    assert set(runner.timer.summary()) == {"init_gs", "densify",
                                           "densify_pcd", "refine"}
    np.savez(dense / "interpolated_dense_views_cyc0_view1.npz",
             frames=np.zeros((9, H, W, 3), np.float32),
             poses=np.zeros((9, 4, 4), np.float32))
    frames2, _ = runner.densify_views(0)
    assert calls == [4, 5, 6, 5] and frames2.shape == frames.shape
    for pi in (0, 2):                            # still from their caches
        torch.testing.assert_close(frames2[pi], frames[pi], rtol=0, atol=0)


def test_cli_train_main_on_cpu(scene_dir, tmp_path):
    """parse -> load_colmap_scene -> build_runner -> run, on the tiny scene
    with the warp-only completion."""
    out = tmp_path / "model"
    runner = CLI.main([
        "-s", scene_dir, "-m", str(out), "--n_views", "3",
        "--iterations", "10", "--refine_cycle_num", "1",
        "--diffusion_width", str(W), "--diffusion_height", str(H),
        "--num_frames", "5", "--num_inference_steps", "4",
        "--start_sample_svd_frame", "2", "--pseudo_cam_sampling_rate", "0.5",
        "--tile_cap", "256", "--device", "cpu", "--log_every", "0"])
    tr = runner.trainer
    assert tr.device.type == "cpu" and tr.cfg.rasterizer == "kernel"
    assert len(tr.pseudo_views) == 3 * 4
    assert sorted(os.listdir(out / "dense_views")) == [
        f"interpolated_dense_views_cyc0_view{p}.npz" for p in range(3)]
    assert os.path.exists(out / "chkpnt10.npz")
    assert os.path.exists(out / "refine_0_chkpnt10.npz")
    with np.load(out / "dense_views"
                 / "interpolated_dense_views_cyc0_view0.npz") as d:
        assert d["frames"].shape == (5, H, W, 3)
        assert np.isfinite(d["frames"]).all()
    rgb = tr.render_view(tr.train_views.cameras.at(0))["render"]
    assert torch.isfinite(rgb).all() and rgb.shape == (H, W, 3)


def test_cli_train_dtu_flags_on_cpu(scene_dir, tmp_path):
    """The DTU preset's flags with --lpips_weights (the JAX package's
    converted VGG npz): 2 chained pairs in the loaded order, the trainer
    holds LPIPS, and refine's segment ran with it; the prob variant is
    what --diffusion_type 2PassProbUncertain gives load_svd_completion."""
    from syn3r_tpu.utils.params import save_params
    from scripts.kernel_timing import random_lpips_params
    
    weights = str(tmp_path / "lpips.npz")
    save_params(random_lpips_params(0), weights)
    out = tmp_path / "model"
    runner = CLI.main([
        "-s", scene_dir, "-m", str(out), "--n_views", "3",
        "--diffusion_type", "2PassProbUncertain",
        "--densify_type", "interpolate_loop0_gs", "--reorg_train_views", "0",
        "--cam_confidence", "0.05", "--lambda_dssim", "0.5",
        "--sample_svd_pseudo_interval", "1", "--refine_cycle_num", "1",
        "--iterations", "6", "--start_sample_svd_frame", "2",
        "--diffusion_width", str(W), "--diffusion_height", str(H),
        "--num_frames", "5", "--num_inference_steps", "4",
        "--tile_cap", "256", "--lpips_weights", weights, "--device", "cpu",
        "--log_every", "0"])
    tr = runner.trainer
    assert runner.cfg.use_lpips_loss and tr._lpips is not None
    assert not tr.use_lpips_loss             # on only inside refine_GS
    assert tr._segments.key[-1] is True      # refine ran the LPIPS step
    assert tr.cfg.lambda_dssim == 0.5
    assert len(tr.pseudo_views) == 2 * 4 + 1
    assert sorted(os.listdir(out / "dense_views")) == [
        f"interpolated_dense_views_cyc0_view{p}.npz" for p in range(2)]
    assert os.path.exists(out / "refine_0_chkpnt6.npz")
    args = CLI.build_parser().parse_args(
        ["-s", "x", "-m", "y", "--diffusion_type", "2PassProbUncertain"])
    assert CLI.svd_config(args)["variant"] == "prob"
    args.diffusion_type = "2PassProbUncertainPost"
    assert CLI.svd_config(args)["variant"] == "post"


@pytest.mark.parametrize("flags", [["--scene_parallel", "on"]])
def test_deferred_flags_raise(tmp_path, flags):
    """Each deferred flag raises before the scene is read."""
    with pytest.raises(NotImplementedError, match="not ported"):
        CLI.main(["-s", str(tmp_path / "missing"), "-m", str(tmp_path / "m"),
                  "--device", "cpu", *flags])


def test_deferred_options_raise(cloud, tmp_path):
    _, ttr, _ = _trainers(cloud, tmp_path)
    with pytest.raises(NotImplementedError):
        TO.DiffusionGSConfig(pair_parallel=True)
    runner = TO.DiffusionGS(ttr, TO.DiffusionGSConfig(),
                            save_dir=str(tmp_path / "d"))
    assert runner.densify_pcds(None, None, 0) is None
    # a dust3r_fn with one keyframe a pair (the LLFF setting) runs nothing
    runner = TO.DiffusionGS(
        ttr, TO.DiffusionGSConfig(num_views_for_pcd_densification=1),
        save_dir=str(tmp_path / "d"), dust3r_fn=lambda *a: 1 / 0)
    assert runner.densify_pcds(None, None, 0) is None

