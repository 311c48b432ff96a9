"""The port's weight conversion, runbook and profiling helpers on the CPU.

- ``cli/convert_weights``: the ``.npz`` trees it writes from a tiny
  HF-layout snapshot are key for key and array for array equal to the JAX
  package's converters (``torch_to_flax``, ``convert_clip_torch``,
  ``convert_lpips_torch``) on the same state dicts, from torch ``.bin``
  files (also against JAX's own CLI) and from ``.safetensors`` files
  written here byte by byte (F32, and F16/BF16, which it widens to
  float32 exactly); the trees load back into the port's modules unchanged.
  The snapshot's state dicts come from the port's own modules, which carry
  diffusers', HF's and the ``lpips`` package's state-dict names; no test
  imports ``diffusers`` or ``safetensors``.
- ``cli/runbook``: the convert, baseline and report stages on the scene of
  tests/test_cli.py with ``--device cpu``.
- ``utils/profiling``: ``device_memory_stats`` is None on the CPU and
  ``trace`` writes a Chrome trace.

Conversions are transposes and copies: equality is exact.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import json
import os

import numpy as np
import pytest
import torch

from syn3r_tpu.models.clip import convert_clip_torch as j_clip
from syn3r_tpu.models.convert import torch_to_flax as j_torch_to_flax
from syn3r_tpu.models.lpips import convert_lpips_torch as j_lpips
from syn3r_tpu_torch.cli import convert_weights as CW
from syn3r_tpu_torch.cli import runbook as RB
from syn3r_tpu_torch.diffusion.pipeline import init_random_weights_
from syn3r_tpu_torch.models.clip import CLIPVisionModelWithProjection
from syn3r_tpu_torch.models.convert import load_flax_params
from syn3r_tpu_torch.models.lpips import LPIPS
from syn3r_tpu_torch.models.svd_unet import UNetSpatioTemporalConditionModel
from syn3r_tpu_torch.models.vae import AutoencoderKLTemporalDecoder
from syn3r_tpu_torch.utils import profiling
from syn3r_tpu_torch.utils.params import load_params

NETS = {"unet": (UNetSpatioTemporalConditionModel, dict(
            block_out_channels=(32, 64), num_attention_heads=(2, 4),
            layers_per_block=1, addition_time_embed_dim=32), "diffusers"),
        "vae": (AutoencoderKLTemporalDecoder, dict(
            block_out_channels=(32, 32, 32), layers_per_block=1),
            "diffusers"),
        "image_encoder": (CLIPVisionModelWithProjection, dict(
            hidden=64, layers=2, heads=4, mlp_dim=128, patch=32,
            image_size=224, projection_dim=1024), "clip")}
OUT = {"unet": "unet.npz", "vae": "vae.npz", "image_encoder": "clip.npz"}


def _module(sub, seed):
    cls, kw, _ = NETS[sub]
    return init_random_weights_(cls(**kw),
                                torch.Generator().manual_seed(seed)).eval()


def _state(sub, seed):
    return {k: v.numpy().copy()
            for k, v in _module(sub, seed).state_dict().items()}


def _write_safetensors(path, tensors, dtype="F32"):
    """A .safetensors file by its format: the little-endian u64 header
    length, the JSON header, the raw buffer."""
    header, chunks, off = {}, [], 0
    for k, a in tensors.items():
        if dtype == "F16":
            raw = a.astype("<f2").tobytes()
        elif dtype == "BF16":
            raw = (a.astype("<f4").view("<u4") >> 16).astype("<u2").tobytes()
        else:
            raw = a.astype("<f4").tobytes()
        header[k] = {"dtype": dtype, "shape": list(a.shape),
                     "data_offsets": [off, off + len(raw)]}
        chunks.append(raw)
        off += len(raw)
    header["__metadata__"] = {"format": "pt"}
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(np.array([len(h)], "<u8").tobytes() + h + b"".join(chunks))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def _assert_npz_equals(path, tree):
    want = _flat(tree)
    with np.load(path) as got:
        assert sorted(got.files) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def states():
    return {sub: _state(sub, i) for i, sub in enumerate(NETS)}


def _snapshot(root, states, fmt):
    for sub, sd in states.items():
        os.makedirs(root / sub)
        if fmt == "bin":
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                       str(root / sub / "diffusion_pytorch_model.bin"))
        else:
            # two shards, as HF splits large checkpoints
            keys = sorted(sd)
            for i, part in enumerate((keys[::2], keys[1::2])):
                _write_safetensors(
                    root / sub / f"model-{i:05d}.safetensors",
                    {k: sd[k] for k in part})


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_convert_weights_matches_jax_converters(tmp_path, states, fmt):
    snap, out = tmp_path / "snap", tmp_path / "out"
    _snapshot(snap, states, fmt)
    CW.main(["--svd_dir", str(snap), "--out_dir", str(out)])
    for sub, sd in states.items():
        conv = j_clip if NETS[sub][2] == "clip" else j_torch_to_flax
        _assert_npz_equals(out / OUT[sub], conv(sd))
        # the tree loads back into the module unchanged
        net = _module(sub, 99)
        load_flax_params(net, load_params(out / OUT[sub]), NETS[sub][2])
        for k, v in net.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_convert_weights_bin_matches_jax_cli(tmp_path, states):
    """From the same .bin snapshot and lpips state dict, the port's CLI and
    the JAX package's write npz files with the same keys and arrays."""
    from syn3r_tpu.cli import convert_weights as JCW
    snap = tmp_path / "snap"
    _snapshot(snap, states, "bin")
    lp = {k: v.clone() for k, v in init_random_weights_(
        LPIPS(), torch.Generator().manual_seed(5)).state_dict().items()}
    torch.save(lp, str(tmp_path / "lpips.pth"))
    for cli, out in ((CW, "port"), (JCW, "jax")):
        cli.main(["--svd_dir", str(snap), "--out_dir", str(tmp_path / out),
                  "--lpips", str(tmp_path / "lpips.pth")])
    for name in ("unet.npz", "vae.npz", "clip.npz", "lpips.npz"):
        with np.load(tmp_path / "port" / name) as got, \
                np.load(tmp_path / "jax" / name) as want:
            assert sorted(got.files) == sorted(want.files), name
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{name} {k}")
    _assert_npz_equals(tmp_path / "port" / "lpips.npz",
                       j_lpips({k: v.numpy() for k, v in lp.items()}))


@pytest.mark.parametrize("dtype", ["F16", "BF16"])
def test_read_safetensors_widens_half_types(tmp_path, dtype):
    """F16 and BF16 tensors come back as float32, exactly the values the
    file holds (BF16 as its 16 bits above 16 zero bits)."""
    rng = np.random.default_rng(3)
    a = {"w": rng.normal(size=(3, 5)).astype(np.float32),
         "b": rng.normal(size=(7,)).astype(np.float32)}
    _write_safetensors(tmp_path / "x.safetensors", a, dtype)
    got = CW.read_safetensors(str(tmp_path / "x.safetensors"))
    for k, v in a.items():
        want = (v.astype(np.float16).astype(np.float32) if dtype == "F16"
                else (v.view(np.uint32) & 0xFFFF0000).view(np.float32))
        assert got[k].dtype == np.float32 and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], want)
        np.testing.assert_allclose(got[k], v, rtol=1e-2)


def test_convert_weights_needs_weights(tmp_path):
    os.makedirs(tmp_path / "snap" / "unet")
    with pytest.raises(FileNotFoundError):
        CW.main(["--svd_dir", str(tmp_path / "snap"),
                 "--out_dir", str(tmp_path / "out")])


def test_runbook_convert_baseline_report(tmp_path, states):
    """The runbook's convert, baseline (GS-only) and report stages on the
    scene of tests/test_cli.py, on the CPU."""
    from test_torch_eval_cli import _write_scene
    scene = str(tmp_path / "scene")
    _write_scene(scene)
    snap = tmp_path / "snap"
    _snapshot(snap, states, "bin")
    out = str(tmp_path / "run")
    argv = ["--hf_snapshot", str(snap), "--scene", scene, "--out", out,
            "--n_views", "3", "--iterations", "25", "--device", "cpu",
            "--stages", "convert,baseline,report",
            "--extra", "--log_every", "0", "--disable_densification",
            "--tile_cap", "256"]
    RB.main(argv)
    for f in ("unet.npz", "vae.npz", "clip.npz"):
        assert os.path.exists(os.path.join(out, "weights", f))
    assert os.path.exists(os.path.join(out, "gs_only", "chkpnt25.npz"))
    with open(os.path.join(out, "runbook_report.json")) as f:
        report = json.load(f)
    assert sorted(report) == ["gs_only"]
    assert sorted(report["gs_only"]) == ["LPIPS", "PSNR", "SSIM"]
    assert np.isfinite(report["gs_only"]["PSNR"])
    # a second run resumes: nothing is converted or trained again
    stamp = os.path.getmtime(os.path.join(out, "gs_only", "eval_res.txt"))
    RB.main(argv)
    assert os.path.getmtime(os.path.join(out, "gs_only",
                                         "eval_res.txt")) == stamp


def test_profiling_helpers_on_cpu(tmp_path):
    assert profiling.device_memory_stats() is None
    assert profiling.device_memory_stats("cpu") is None
    with profiling.trace(str(tmp_path / "tr")) as path:
        torch.ones(64).cumsum(0)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert os.path.dirname(path) == str(tmp_path / "tr") and events
