"""Parity of the port's kernel modules (GEGLU FF, attention) against the JAX
package on the CPU, and the port's isolation from JAX.

On the CPU the wrappers take their plain torch versions; the CUDA kernels
themselves are held against those plain versions on the card by
chip_smoke.py. Inputs are made with numpy from a seed and fed to both
packages. Tolerance: f32 on both sides; the two only sum in another order
(and the Pallas kernel's erf is the A&S 7.1.26 approximation, 1.5e-7), so
1e-4 absolute and relative bounds the difference with margin.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.models.layers import (_attention, _attention_chunked,
                                     _attention_dense,
                                     _attention_packed_heads)
from syn3r_tpu.ops.pallas_ffn import geglu_ffn_pallas, geglu_ffn_reference
from syn3r_tpu_torch.device import resolve_device
from syn3r_tpu_torch.ops import attention as A
from syn3r_tpu_torch.ops.geglu_ffn import geglu_ffn, geglu_ffn_reference \
    as torch_geglu_reference
from syn3r_tpu_torch.utils.profiling import counters

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ffn_inputs(r, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (r, c)).astype(np.float32)
    w1 = (rng.normal(size=(c, 8 * c)) * 0.05).astype(np.float32)
    b1 = (rng.normal(size=(8 * c,)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(4 * c, c)) * 0.05).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.05).astype(np.float32)
    return x, w1, b1, w2, b2


def _torch_ffn(fn, x, w1, b1, w2, b2):
    # flax kernels are (in, out); torch Linear weights are (out, in)
    return fn(torch.from_numpy(x), torch.from_numpy(w1.T.copy()),
              torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
              torch.from_numpy(b2)).numpy()


@pytest.mark.parametrize("r,c", [(256, 64), (512, 32)])
def test_geglu_plain_matches_jax_reference_and_pallas(r, c):
    args = _ffn_inputs(r, c, seed=r + c)
    jargs = [jnp.asarray(a) for a in args]
    want_ref = np.asarray(geglu_ffn_reference(*jargs, jnp.float32))
    want_pallas = np.asarray(geglu_ffn_pallas(*jargs, jnp.float32,
                                              interpret=True))
    got = _torch_ffn(torch_geglu_reference, *args)
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(3)]


def _as_torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("shape,port_fn,jax_fn", [
    ((3, 2, 5, 16), A.attention_packed_heads, _attention_packed_heads),
    ((2, 2, 64, 16), A.attention_dense, _attention_dense),
    ((1, 2, 576, 16), A.attention_chunked, _attention_chunked),
])
def test_attention_functions_match_jax(shape, port_fn, jax_fn):
    q, k, v = _qkv(shape, seed=shape[2])
    scale = shape[3] ** -0.5
    want = np.asarray(jax_fn(*(jnp.asarray(a) for a in (q, k, v)), scale))
    got = port_fn(*_as_torch((q, k, v)), scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [
    (3, 2, 5, 16),       # packed heads (temporal attention)
    (2, 2, 100, 16),     # dense (< 512 tokens)
    (1, 2, 576, 16),     # flash on the card: the ragged 576-token level
    (1, 1, 1024, 64),    # flash on the card: a 1024-divisible length
    (1, 1, 512, 160),    # chunked: d > 128 (the VAE's wide head)
])
def test_attention_dispatch_matches_jax(shape):
    q, k, v = _qkv(shape, seed=7)
    scale = shape[3] ** -0.5
    want = np.asarray(_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 scale))
    got = A.attention(*_as_torch((q, k, v)), scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(4, 5, 25, 64), (3, 3, 7, 64),
                                   (2, 2, 32, 64)])
def test_short_path_on_cpu_is_packed_heads(shape):
    """On the CPU the temporal attention's short path stays the packed
    version, as JAX's ``_attention_packed_heads``, and launches no
    frame-attention kernel."""
    counters.clear()
    q, k, v = _qkv(shape, seed=shape[2])
    scale = shape[3] ** -0.5
    want = np.asarray(_attention_packed_heads(
        *(jnp.asarray(a) for a in (q, k, v)), scale))
    got = A.attention(*_as_torch((q, k, v)), scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert counters["launches.frame_attn"] == 0


def test_flash_dispatch_rule():
    """The port takes its flash kernel exactly where the JAX package takes
    the Pallas flash kernel on a TPU."""
    assert A.takes_flash(9216, 9216, 64)
    assert A.takes_flash(2304, 2304, 64)      # 768-divisible
    assert A.takes_flash(576, 576, 64)        # padded to 640 on the TPU
    assert not A.takes_flash(9216, 9216, 512)  # VAE mid attention
    assert not A.takes_flash(1100, 1100, 64)
    assert not A.takes_flash(576, 1, 64)


def test_cpu_tensors_take_plain_versions():
    counters.clear()
    args = _ffn_inputs(64, 32, seed=3)
    got = _torch_ffn(geglu_ffn, *args)
    want = _torch_ffn(torch_geglu_reference, *args)
    np.testing.assert_array_equal(got, want)
    q, k, v = _as_torch(_qkv((1, 2, 576, 16), seed=4))
    np.testing.assert_array_equal(A.flash_attention(q, k, v, 0.25).numpy(),
                                  A.attention_chunked(q, k, v, 0.25).numpy())
    assert counters["launches.geglu_ffn"] == 0
    assert counters["launches.flash"] == 0


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    from syn3r_tpu_torch.diffusion.pipeline import load_svd_completion
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_svd_completion(None)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax():
    """Every module of the port and chip_smoke.py import with jax, flax and
    syn3r_tpu made unimportable, and none of them is loaded afterwards."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "flax", "syn3r_tpu"):
            sys.modules[name] = None
        import syn3r_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(
            syn3r_tpu_torch.__path__, "syn3r_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        import chip_smoke
        bad = sorted(k for k, v in sys.modules.items() if v is not None and
                     k.split(".")[0] in ("jax", "jaxlib", "flax",
                                         "syn3r_tpu"))
        assert not bad, bad
        assert len(mods) >= 15, mods
        print("isolated", len(mods))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "isolated" in res.stdout
