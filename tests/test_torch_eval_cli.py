"""The port's evaluation protocol against the JAX package on the CPU:
``cli/render`` (test views and the ``--video`` path), ``cli/metrics``
(PSNR, SSIM, the DTU ``--masks`` protocol, LPIPS from ``--lpips_weights``)
and ``cli/summarize``, on the on-disk COLMAP scene of JAX's
tests/test_cli.py flow and one checkpoint that both packages read.

Tolerances:
- PNGs: within 1 LSB (the renders agree to ~1e-5; the 8-bit truncation
  of a value within that of a multiple of 1/255 may land one step apart);
- PSNR and LPIPS of the same PNGs: 1e-5 relative (float32 on both sides,
  sums in another order); SSIM 1e-4 relative: its variances
  E[x^2] - E[x]^2 cancel in float32 where the images are flat (seen:
  1.2e-5 relative);
- PSNR and SSIM of each package's own renders: 1e-3 relative, from the
  1-LSB pixels;
- the eval_res.txt blocks to 7 decimals and the summary table: as strings,
  the same when the numbers are.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from syn3r_tpu.cli import metrics as JM
from syn3r_tpu.cli import render as JR
from syn3r_tpu.cli import summarize as JSUM
from syn3r_tpu.gs import trainer as JT
from syn3r_tpu.models import gaussians as JG
from syn3r_tpu.ops.rasterize import render as j_render
from syn3r_tpu.utils import colmap as JCM
from syn3r_tpu.utils.camera import camera_from_fov, look_at_w2c
from syn3r_tpu.utils.params import save_params
from scripts.kernel_timing import random_lpips_params
from syn3r_tpu_torch.cli import metrics as TM
from syn3r_tpu_torch.cli import render as TR
from syn3r_tpu_torch.cli import summarize as TSUM

W, H = 64, 48
SAME = {"PSNR": 1e-5, "SSIM": 1e-4, "LPIPS": 1e-5}


def _write_scene(root):
    """JAX's tests/test_cli.py scene: a Gaussian cloud rendered from 10
    poses, as a COLMAP directory of PNGs."""
    from PIL import Image
    rng = np.random.default_rng(0)
    n = 150
    xyz = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                          rng.uniform(1.8, 2.6, (n, 1))], 1).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    gt = JG.from_points(jnp.asarray(xyz), jnp.asarray(rgb), capacity=256)
    gt = gt.replace(log_scales=gt.log_scales + 0.7,
                    opacity_logits=jnp.where(gt.active[:, None], 2.0, -100.0))
    os.makedirs(os.path.join(root, "sparse", "0"))
    os.makedirs(os.path.join(root, "images"))
    f = 40.0
    cams = {1: JCM.ColmapCamera(1, "PINHOLE", W, H,
                                np.array([f, f, W / 2, H / 2]))}
    images = {}
    for i in range(10):
        w2c = np.asarray(look_at_w2c(jnp.asarray([0.1 * (i - 4.5), 0.01 * i,
                                                  0.0]),
                                     jnp.asarray([0.0, 0.0, 2.2])))
        cam = camera_from_fov(2 * np.arctan(W / (2 * f)),
                              2 * np.arctan(H / (2 * f)), W, H, w2c)
        img = np.asarray(j_render(gt, cam, chunk=64, group=1).rgb)
        name = f"{i:03d}.png"
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", name))
        images[i + 1] = JCM.ColmapImage(
            i + 1, JCM.rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], 1, name,
            np.zeros((0, 2)), np.zeros(0, np.int64))
    sparse = os.path.join(root, "sparse", "0")
    JCM.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    JCM.write_images_binary(images, os.path.join(sparse, "images.bin"))
    JCM.write_points3d_binary(JCM.ColmapPoints3D(
        xyz.astype(np.float64), (rgb * 255).astype(np.uint8), np.zeros(n)),
        os.path.join(sparse, "points3D.bin"))
    return xyz, rgb


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The scene, a checkpoint (a perturbed copy of the scene's Gaussians,
    written by JAX's trainer as refine_1_chkpnt30.npz), DTU-style masks of
    the two test views and an LPIPS weights file."""
    root = tmp_path_factory.mktemp("eval")
    scene = str(root / "scene")
    xyz, rgb = _write_scene(scene)
    rng = np.random.default_rng(1)
    g = JG.from_points(jnp.asarray(xyz + rng.normal(0, 0.02, xyz.shape)
                                   .astype(np.float32)),
                       jnp.asarray(rgb[::-1].copy()), capacity=256)
    g = g.replace(log_scales=g.log_scales + 0.6,
                  opacity_logits=jnp.where(g.active[:, None], 1.5, -100.0))
    cam = camera_from_fov(1.0, 0.8, W, H, np.eye(4, dtype=np.float32))
    jtr = JT.GSTrainer(JT.make_viewset([cam], np.zeros((1, H, W, 3),
                                                       np.float32)),
                       JT.TrainConfig(), g, model_path=str(root / "ckpt"))
    ckpt = jtr.save_checkpoint(30, epoch=1)
    masks = root / "masks"
    masks.mkdir()
    from PIL import Image
    for i in range(2):
        m = np.zeros((H, W), np.uint8)
        m[8 + 4 * i:40, 10:50 - 6 * i] = 255
        Image.fromarray(m).save(masks / f"{i:05d}.png")
    weights = str(root / "lpips.npz")
    save_params(random_lpips_params(0), weights)
    return root, scene, ckpt, str(masks), weights


def _model_dir(root, ckpt, name):
    d = root / "scenes" / name
    os.makedirs(d)
    shutil.copy(ckpt, d)
    return str(d)


def _pngs(folder):
    from PIL import Image
    return {n: np.asarray(Image.open(os.path.join(folder, n)), np.int16)
            for n in sorted(os.listdir(folder))}


def test_render_matches_jax(setup):
    """cli/render of the newest checkpoint: the two test views' renders and
    ground truths, and the --video path through the three train views."""
    root, scene, ckpt, _, _ = setup
    jdir = _model_dir(root, ckpt, "render_jax")
    tdir = _model_dir(root, ckpt, "render_port")
    argv = ["-s", scene, "--video", "--video_frames", "6"]
    JR.main(argv + ["-m", jdir])
    out = TR.main(argv + ["-m", tdir, "--device", "cpu"])
    assert out == os.path.join(tdir, "test", "ours_refine_1_chkpnt30")
    for sub in ("renders", "gt", "video"):
        want = _pngs(os.path.join(jdir, "test", "ours_refine_1_chkpnt30",
                                  sub))
        got = _pngs(os.path.join(out, sub))
        assert sorted(got) == sorted(want) and len(got) >= 2, sub
        for n in want:
            assert np.abs(got[n] - want[n]).max() <= 1, (sub, n)
        # 6 frames over 2 segments: 3 poses each, the last left out
        assert len(got) == {"video": 4}.get(sub, 2)
    r = _pngs(os.path.join(out, "renders"))["00000.png"]
    assert r.std() > 5                    # not an empty frame


def _blocks(path):
    return TSUM.parse_eval_res(path)


@pytest.mark.parametrize("masked", [False, True])
def test_metrics_and_summary_match_jax(setup, masked):
    """cli/metrics on the port's renders (with --lpips_weights, and with
    --masks or without): each package's numbers on the same PNGs, and the
    port's on its own renders against JAX's on JAX's; summarize's table
    from either package, string for string."""
    root, scene, ckpt, masks, weights = setup
    tag = "masked" if masked else "full"
    port = _model_dir(root, ckpt, f"port_{tag}")
    TR.main(["-s", scene, "-m", port, "--device", "cpu"])
    jax_own = _model_dir(root, ckpt, f"jax_{tag}")
    JR.main(["-s", scene, "-m", jax_own])
    same = str(root / "scenes" / f"same_{tag}")
    shutil.copytree(port, same)
    extra = ["--lpips_weights", weights] + (["--masks", masks] if masked
                                            else [])
    TM.main(["-m", port, "--device", "cpu"] + extra)
    JM.main(["-m", same] + extra)
    JM.main(["-m", jax_own] + extra)
    got = _blocks(os.path.join(port, "eval_res.txt"))
    want = _blocks(os.path.join(same, "eval_res.txt"))
    own = _blocks(os.path.join(jax_own, "eval_res.txt"))
    assert list(got) == list(want) == list(own) == [
        "ours_refine_1_chkpnt30.pth"]
    g, w, o = (b["ours_refine_1_chkpnt30.pth"] for b in (got, want, own))
    for k in ("PSNR", "SSIM", "LPIPS"):
        assert np.isfinite(g[k]) and g[k] > 0, k
        np.testing.assert_allclose(g[k], w[k], rtol=SAME[k], err_msg=k)
    for k in ("PSNR", "SSIM"):
        np.testing.assert_allclose(g[k], o[k], rtol=1e-3, err_msg=k)

    unmasked = TM.evaluate_dirs(
        os.path.join(port, "test", "ours_refine_1_chkpnt30", "renders"),
        os.path.join(port, "test", "ours_refine_1_chkpnt30", "gt"),
        device="cpu")
    # eval_res.txt holds 7 decimals
    assert (abs(g["PSNR"] - unmasked["PSNR"]) > 1e-6) == masked
    assert np.isnan(unmasked["LPIPS"])

    ck = ["ours_refine_1_chkpnt30.pth"]
    table = TSUM.summarize(str(root / "scenes"), checkpoints=ck)
    assert table == JSUM.summarize(str(root / "scenes"), checkpoints=ck)
    assert f"port_{tag}" in table and "AVG(" in table
    assert TSUM.summarize(str(root / "scenes")) == JSUM.summarize(
        str(root / "scenes"))


def test_summarize_main_prints_the_jax_table(setup, capsys):
    root = setup[0]
    os.makedirs(root / "sum" / "a")
    os.makedirs(root / "sum" / "b")
    for d, vals in (("a", (0.81234567, 24.5, 0.17)),
                    ("b", (0.7, 21.123456, float("nan")))):
        with open(root / "sum" / d / "eval_res.txt", "w") as f:
            for name in ("ours_chkpnt10000.pth",
                         "ours_refine_1_chkpnt10000.pth"):
                f.write(f"{name}\n  SSIM : {vals[0]:.7f}\n"
                        f"  PSNR : {vals[1]:.7f}\n"
                        f"  LPIPS: {vals[2]:.7f}\n")
    TSUM.main([str(root / "sum")])
    got = capsys.readouterr().out
    JSUM.main([str(root / "sum")])
    assert got == capsys.readouterr().out
    assert "AVG(2 scenes)" in got
