"""The port's batch runner (``cli/batch.py``) on the CPU: its presets
against the JAX package's, the sequential path on one scene, ``--eval``
over every checkpoint (JAX's tests/test_cli.py::test_batch_eval_renders_
every_checkpoint), the fleet's per-slot ``CUDA_VISIBLE_DEVICES`` through a
stubbed ``Popen``, and one real ``--parallel 1`` worker subprocess.

The scene is tests/test_cli.py's (written by tests/test_torch_eval_cli.py's
``_write_scene``), cut to a few iterations, 3 frames a pair and a 64x48
diffusion size.
"""
import os
import subprocess

import pytest

from syn3r_tpu.cli import batch as JB
from syn3r_tpu_torch.cli import batch as TB
from test_torch_eval_cli import _write_scene

CUTS = ["--iterations", "6", "--refine_cycle_num", "1", "--num_frames",
        "3", "--num_inference_steps", "5", "--diffusion_width", "64",
        "--diffusion_height", "48", "--start_sample_svd_frame", "3",
        "--log_every", "0", "--disable_densification",
        "--svd_depth_warmup", "0", "--tile_cap", "256"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    _write_scene(str(root / "toy"))
    return root


def test_presets_and_scene_lists_match_jax():
    assert TB.PRESETS == JB.PRESETS
    assert TB.LLFF_SCENES == JB.LLFF_SCENES
    assert TB.DL3DV_SCENES == JB.DL3DV_SCENES


def test_batch_sequential_then_eval(data_root, tmp_path, capsys):
    """One scene in-process with the LLFF preset on the CPU, then --eval:
    both checkpoints rendered and evaluated, the summary printed."""
    out_root = tmp_path / "out"
    TB.main(["--dataset", "llff", "--data_root", str(data_root),
             "--out_root", str(out_root), "--scenes", "toy", "--eval",
             "--device", "cpu", "--extra", *CUTS])
    out = out_root / "toy"
    assert os.path.exists(out / "chkpnt6.npz")
    assert os.path.exists(out / "refine_0_chkpnt6.npz")
    tests = sorted(os.listdir(out / "test"))
    assert tests == ["ours_chkpnt6", "ours_refine_0_chkpnt6"]
    with open(out / "eval_res.txt") as f:
        blocks = [ln.strip() for ln in f if ln.startswith("ours_")]
    assert blocks == ["ours_chkpnt6.pth", "ours_refine_0_chkpnt6.pth"]
    assert "toy" in capsys.readouterr().out


def test_batch_eval_renders_every_checkpoint(tmp_path, monkeypatch):
    """--eval renders every checkpoint (the initial fit and each refine
    cycle, not chkpnt_latest), each call with --device, and evaluates the
    scene once."""
    data_root, out = tmp_path / "data", tmp_path / "out" / "toy"
    os.makedirs(data_root / "toy")
    os.makedirs(out)
    for n in ("chkpnt10000.npz", "refine_0_chkpnt10000.npz",
              "refine_1_chkpnt10000.npz", "chkpnt_latest.npz"):
        (out / n).touch()
    render_calls, metrics_calls = [], []
    monkeypatch.setattr("syn3r_tpu_torch.cli.render.main",
                        lambda argv: render_calls.append(argv))
    monkeypatch.setattr("syn3r_tpu_torch.cli.metrics.main",
                        lambda argv: metrics_calls.append(argv))
    monkeypatch.setattr("syn3r_tpu_torch.cli.summarize.summarize",
                        lambda root: "stub")
    TB.main(["--dataset", "llff", "--data_root", str(data_root),
             "--out_root", str(tmp_path / "out"), "--scenes", "toy",
             "--eval", "--device", "cpu"])
    names = sorted(os.path.basename(a[a.index("--checkpoint") + 1])
                   for a in render_calls)
    assert names == ["chkpnt10000.npz", "refine_0_chkpnt10000.npz",
                     "refine_1_chkpnt10000.npz"]
    assert all(a[a.index("--device") + 1] == "cpu"
               for a in render_calls + metrics_calls)
    assert len(metrics_calls) == 1


class _FakeProc:
    def __init__(self, argv, env):
        self.argv, self.env, self.pid = argv, env, 4242

    def poll(self):
        return 0


@pytest.mark.parametrize("visible,want", [
    (None, ["0", "1", "0"]), ("2,3", ["2", "3", "2"]),
    ("GPU-a", ["GPU-a", "GPU-a", "GPU-a"])])
def test_fleet_pins_each_slot(tmp_path, monkeypatch, visible, want):
    """Three scenes on two worker slots: each worker's CUDA_VISIBLE_DEVICES
    is its slot's card (of the cards this process sees), it runs the
    port's cli.train with the preset and --device, and logs to its scene's
    log.txt."""
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    procs = []

    def popen(argv, stdout=None, stderr=None, env=None):
        procs.append(_FakeProc(argv, env))
        return procs[-1]
    monkeypatch.setattr(TB.subprocess, "Popen", popen)
    data_root = tmp_path / "data"
    for s in ("a", "b", "c"):
        os.makedirs(data_root / s)
    TB.main(["--dataset", "dtu", "--data_root", str(data_root),
             "--out_root", str(tmp_path / "out"), "--parallel", "2",
             "--device", "cpu", "--extra", "--iterations", "5"])
    assert [p.env["CUDA_VISIBLE_DEVICES"] for p in procs] == want
    for p, s in zip(procs, "abc"):
        assert p.argv[1:3] == ["-m", "syn3r_tpu_torch.cli.train"]
        assert p.argv[3:7] == ["-s", str(data_root / s), "-m",
                               str(tmp_path / "out" / s)]
        assert p.argv[7:] == TB.PRESETS["dtu"] + ["--device", "cpu",
                                                  "--iterations", "5"]
        assert os.path.exists(tmp_path / "out" / s / "log.txt")


def test_fleet_reports_failed_scenes(tmp_path, monkeypatch):
    class Failing(_FakeProc):
        def poll(self):
            return 3
    monkeypatch.setattr(TB.subprocess, "Popen",
                        lambda argv, stdout=None, stderr=None, env=None:
                        Failing(argv, env))
    os.makedirs(tmp_path / "data" / "x")
    with pytest.raises(SystemExit, match="failed scenes"):
        TB.main(["--dataset", "llff", "--data_root", str(tmp_path / "data"),
                 "--out_root", str(tmp_path / "out"), "--scenes", "x",
                 "--parallel", "1", "--device", "cpu"])


def test_fleet_real_worker_on_cpu(data_root, tmp_path, monkeypatch):
    """One real worker subprocess (python -m syn3r_tpu_torch.cli.train) on
    the CPU from another working directory: it exits 0 and writes its
    checkpoints and log."""
    monkeypatch.chdir(tmp_path)
    envs = []
    popen = subprocess.Popen

    def spy(argv, **kw):
        envs.append(kw["env"])
        return popen(argv, **kw)
    monkeypatch.setattr(TB.subprocess, "Popen", spy)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    out = tmp_path / "out"
    TB.main(["--dataset", "llff", "--data_root", str(data_root),
             "--out_root", str(out), "--scenes", "toy", "--parallel", "1",
             "--device", "cpu", "--extra", *CUTS])
    assert envs[0]["CUDA_VISIBLE_DEVICES"] == "0"
    assert os.path.exists(out / "toy" / "refine_0_chkpnt6.npz")
    with open(out / "toy" / "log.txt") as f:
        assert "[done]" in f.read()
