"""``--save_debug`` and ``--interp_type forward_warp`` in the port against
the JAX package on the CPU: ``utils/debug_dump.py`` (JAX's
tests/test_debug_dump.py, and the same PNG bytes as JAX's writer on the
same arrays), ``DiffusionGS.densify_views`` with the forward-warp
conditioning and the debug dump, against JAX's on the setup of
tests/test_torch_scene.py, and both flags through ``cli.train.main
--device cpu``.

Tolerances: the PNGs and GIFs of the same arrays are written by the same
PIL calls, so their pixels are equal; the densified frames as
tests/test_torch_scene.py holds the backward warp's, 1e-5 absolute (the
GS depths behind the splat come from JAX's tiled composite and the port's
plain one, the same formulas in another order), and the binary latent
masks of the debug set exactly.
"""
import os

import numpy as np
import pytest
import torch

from syn3r_tpu.pipeline import orchestrator as JO
from syn3r_tpu.pipeline.completion import PairConditioning as JCond
from syn3r_tpu.utils import debug_dump as JD
from syn3r_tpu_torch.cli import train as CLI
from syn3r_tpu_torch.pipeline import orchestrator as TO
from syn3r_tpu_torch.pipeline.completion import PairConditioning
from syn3r_tpu_torch.utils import debug_dump as TD
from test_torch_scene import H, W, _trainers, cloud, scene_dir  # noqa: F401


def _cond(f=4, h=12, w=16, lh=3, lw=4, steps=5):
    r = np.random.default_rng(0)
    return dict(
        image_start=r.uniform(size=(h, w, 3)).astype(np.float32),
        image_end=r.uniform(size=(h, w, 3)).astype(np.float32),
        cond_images=r.uniform(size=(f - 2, h, w, 3)).astype(np.float32),
        masks=r.uniform(size=(f - 2, lh, lw)).astype(np.float32),
        lambda_ts=(r.uniform(size=(steps, f)) > 0.5).astype(np.float32))


def _pixels(path):
    from PIL import Image
    im = Image.open(path)
    frames = []
    for i in range(getattr(im, "n_frames", 1)):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
    return np.stack(frames)


def test_dump_pair_debug_matches_jax(tmp_path):
    """The artifact set of JAX's test (endpoints, F - 2 cond and
    uncertainty PNGs, the lambda heatmap, F generated PNGs and the GIF of
    all F frames), from tensors in the port and numpy in JAX: the same
    names and the same pixels."""
    f = 4
    arrays = _cond(f=f)
    frames = np.random.default_rng(1).uniform(size=(f, 12, 16, 3)) \
        .astype(np.float32)
    want = JD.dump_pair_debug(str(tmp_path / "jax"), JCond(**arrays), frames)
    got = TD.dump_pair_debug(
        str(tmp_path / "port"),
        PairConditioning(**{k: torch.from_numpy(v)
                            for k, v in arrays.items()}),
        torch.from_numpy(frames))
    names = sorted(os.path.basename(p) for p in got)
    assert names == sorted(os.path.basename(p) for p in want)
    expect = {"endpoint_start.png", "endpoint_end.png", "lambda_ts.png",
              "completion.gif"}
    expect |= {f"cond_{i:02d}.png" for i in range(f - 2)}
    expect |= {f"uncertainty_{i:02d}.png" for i in range(f - 2)}
    expect |= {f"generated_{i:02d}.png" for i in range(f)}
    assert set(names) == expect
    for n in names:
        np.testing.assert_array_equal(_pixels(tmp_path / "port" / n),
                                      _pixels(tmp_path / "jax" / n))
    assert _pixels(tmp_path / "port" / "completion.gif").shape[0] == f


@pytest.mark.parametrize("writer,arr,size", [
    ("save_heatmap_png", np.ones((4, 6), np.float32), (24, 16)),
    ("save_png", np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4),
     (4, 3))])
def test_degenerate_inputs_match_jax(tmp_path, writer, arr, size):
    """A constant heatmap (no division by zero) and a 2-D gray PNG."""
    from PIL import Image
    getattr(TD, writer)(str(tmp_path / "t.png"), torch.from_numpy(arr))
    getattr(JD, writer)(str(tmp_path / "j.png"), arr)
    assert Image.open(tmp_path / "t.png").size == size
    np.testing.assert_array_equal(_pixels(tmp_path / "t.png"),
                                  _pixels(tmp_path / "j.png"))


def test_gif_clips_out_of_range(tmp_path):
    p = str(tmp_path / "c.gif")
    TD.save_gif(p, torch.stack([torch.full((2, 2, 3), -1.0),
                                torch.full((2, 2, 3), 2.0)]))
    px = _pixels(p)
    assert px.shape[0] == 2 and px[0].max() == 0 and px[1].min() == 255


def test_densify_views_forward_warp_save_debug_matches_jax(cloud, tmp_path):
    """interp_type='forward_warp' with save_debug, the warp-only
    completion: the frames of every pair and the debug set (binary latent
    masks) against JAX's."""
    jtr, ttr, _ = _trainers(cloud, tmp_path)
    kw = dict(diffusion_width=W, diffusion_height=H, num_frames=5,
              num_inference_steps=5, interp_type="forward_warp",
              save_debug=True)
    want_f, want_p = JO.DiffusionGS(
        jtr, JO.DiffusionGSConfig(**kw),
        save_dir=str(tmp_path / "jd")).densify_views(0)
    masks = []

    def completion(image_start, cond_images, image_end, mask, lam, gen):
        masks.append(mask)
        return torch.cat([image_start[None], cond_images, image_end[None]])
    runner = TO.DiffusionGS(ttr, TO.DiffusionGSConfig(**kw),
                            save_dir=str(tmp_path / "td"),
                            completion_fn=completion)
    got_f, got_p = runner.densify_views(0)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=1e-5)
    assert all(set(np.unique(m.numpy())) <= {0.0, 1.0} for m in masks)
    jdbg, tdbg = tmp_path / "jd" / "debug", tmp_path / "td" / "debug"
    assert sorted(os.listdir(tdbg)) == sorted(os.listdir(jdbg)) == [
        f"cyc0_pair{p}" for p in range(3)]
    for pair in os.listdir(tdbg):
        names = sorted(os.listdir(tdbg / pair))
        assert names == sorted(os.listdir(jdbg / pair))
        assert len(names) == 2 + 3 + 3 + 1 + 5 + 1
        for n in names:
            if n.startswith("uncertainty"):
                np.testing.assert_array_equal(_pixels(tdbg / pair / n),
                                              _pixels(jdbg / pair / n))


def test_cli_train_forward_warp_save_debug_on_cpu(scene_dir, tmp_path):
    """cli.train.main with --interp_type forward_warp --save_debug: one
    cycle of 3 pairs, each pair's debug set on disk."""
    out = tmp_path / "model"
    runner = CLI.main([
        "-s", scene_dir, "-m", str(out), "--n_views", "3",
        "--iterations", "6", "--refine_cycle_num", "1",
        "--diffusion_width", str(W), "--diffusion_height", str(H),
        "--num_frames", "5", "--num_inference_steps", "4",
        "--interp_type", "forward_warp", "--save_debug",
        "--tile_cap", "256", "--device", "cpu", "--log_every", "0"])
    assert runner.cfg.interp_type == "forward_warp" and runner.cfg.save_debug
    dbg = out / "dense_views" / "debug"
    assert sorted(os.listdir(dbg)) == [f"cyc0_pair{p}" for p in range(3)]
    for pair in os.listdir(dbg):
        files = os.listdir(dbg / pair)
        assert len(files) == 15 and "completion.gif" in files
    assert os.path.exists(out / "refine_0_chkpnt6.npz")
