"""Parity of the port's GroupNorm and LayerNorm (ops/norm.py) against the
JAX package's references and its Pallas kernels in interpret mode, on the
CPU.

On the CPU the wrappers take their plain versions; the CUDA kernels are
held against those plain versions on the card by chip_smoke.py. The
port's stats/apply pair (the kernels' algorithm: the per-(B, C) affine,
then y = x a + b) also runs here on CPU tensors and is held to the JAX
kernels. Inputs are numpy from a seed, fed to both packages.

Tolerances: float32 on both sides, sums in another order: 2e-5 absolute
and relative (as tests/test_svd_models.py holds the Pallas kernels to their
references). bf16 outputs: both compute in float32 and round to bf16, so a
value may land on the neighbouring bf16: relative 2^-7 (one bf16 ulp at a
binade's lower edge), 1e-5 absolute. Gradients: float32, 1e-4.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.models import layers as JL
from syn3r_tpu.ops import pallas_norm as JN
from syn3r_tpu_torch.models import layers as TL
from syn3r_tpu_torch.models.convert import load_flax_params
from syn3r_tpu_torch.ops import norm as N
from syn3r_tpu_torch.utils.profiling import counters

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2.0 ** -7, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 1.7 + 0.3).astype(np.float32)
    w = (rng.normal(size=(c,)) * 0.3 + 1.0).astype(np.float32)
    b = (rng.normal(size=(c,)) * 0.2).astype(np.float32)
    return x, w, b


def _torch_x(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _jax_x(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                 else jnp.float32)


def _np(a):
    return np.asarray(torch.as_tensor(a).float() if isinstance(
        a, torch.Tensor) else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("shape,groups,dtype,silu", [
    ((3, 512, 320), 32, torch.float32, False),     # cg 10
    ((2, 1024, 320), 32, torch.float32, True),
    ((2, 256, 64), 16, torch.float32, True),       # cg 4
    ((2, 256, 1280), 32, torch.bfloat16, True),    # cg 40
    ((3, 4096, 320), 32, torch.bfloat16, False),   # temporal layout, 2 blocks
])
def test_group_norm_matches_jax(shape, groups, dtype, silu):
    x, w, b = _inputs(shape, seed=shape[1] + groups)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = (jnp.asarray(w), jnp.asarray(b), groups, 1e-6, jdt)
    want_ref = JN.group_norm_reference(_jax_x(x, dtype), *args, silu=silu)
    want_pallas = JN.group_norm_pallas(_jax_x(x, dtype), *args, silu=silu,
                                       interpret=True)
    assert want_pallas is not None
    tx, tw, tb = _torch_x(x, dtype), torch.from_numpy(w), torch.from_numpy(b)
    got = N.group_norm(tx, tw, tb, groups, 1e-6, silu)
    # the kernels' algorithm on the CPU: the affine, then x a + b
    a, bb = N.group_norm_stats(tx, tw, tb, groups, 1e-6)
    split = N.group_norm_apply(tx, a, bb, silu)
    tol = BF16 if dtype == torch.bfloat16 else F32
    assert got.dtype == split.dtype == dtype
    np.testing.assert_allclose(_np(got), _np(want_ref), **tol)
    np.testing.assert_allclose(_np(got), _np(want_pallas), **tol)
    np.testing.assert_allclose(_np(split), _np(want_pallas), **tol)


@pytest.mark.parametrize("shape,dtype,pallas", [
    ((512, 320), torch.float32, True),
    ((1024, 1280), torch.float32, True),
    ((256, 64), torch.float32, True),
    ((300, 640), torch.bfloat16, False),    # R blocks no Pallas grid
])
def test_layer_norm_matches_jax(shape, dtype, pallas):
    x, w, b = _inputs(shape, seed=shape[0])
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = JN.layer_norm_reference(_jax_x(x, dtype), jnp.asarray(w),
                                   jnp.asarray(b), 1e-5, jdt)
    got = N.layer_norm(_torch_x(x, dtype), torch.from_numpy(w),
                       torch.from_numpy(b), 1e-5)
    tol = BF16 if dtype == torch.bfloat16 else F32
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    if pallas:
        want_p = JN.layer_norm_pallas(_jax_x(x, dtype), jnp.asarray(w),
                                      jnp.asarray(b), 1e-5, jdt,
                                      interpret=True)
        np.testing.assert_allclose(_np(got), _np(want_p), **tol)


@pytest.mark.parametrize("kind", ["group_norm", "layer_norm"])
def test_norm_gradients_match_jax_vjp(kind):
    """The backward recomputes through the plain version, as _gn_bwd and
    _ln_bwd do: gradients of x, weight and bias against jax.vjp."""
    shape = (2, 64, 64) if kind == "group_norm" else (96, 64)
    x, w, b = _inputs(shape, seed=11)
    g = np.random.default_rng(12).normal(size=shape).astype(np.float32)
    if kind == "group_norm":
        def jfn(x_, w_, b_):
            return JN.group_norm_reference(x_, w_, b_, 8, 1e-6, jnp.float32,
                                           silu=True)

        def tfn(x_, w_, b_):
            return N.group_norm(x_, w_, b_, 8, 1e-6, True)
    else:
        def jfn(x_, w_, b_):
            return JN.layer_norm_reference(x_, w_, b_, 1e-5, jnp.float32)

        def tfn(x_, w_, b_):
            return N.layer_norm(x_, w_, b_, 1e-5)
    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    got = torch.autograd.grad(tfn(*ts), ts, torch.from_numpy(g))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **GRAD)


def test_norm_modules_bridge_from_flax():
    """The port's GroupNorm (4-d and 5-d channel-last input, SiLU) and
    LayerNorm take the flax trees of the JAX modules and agree with them."""
    rng = np.random.default_rng(13)
    cases = [
        (JL.GroupNorm(num_groups=8, epsilon=1e-6, silu=True),
         TL.GroupNorm(64, 8, 1e-6, silu=True),
         rng.normal(size=(2, 6, 10, 64)).astype(np.float32)),
        (JL.GroupNorm(num_groups=32, epsilon=1e-5),
         TL.GroupNorm(64, 32, 1e-5),
         rng.normal(size=(1, 3, 4, 5, 64)).astype(np.float32)),
        (JL.LayerNorm(), TL.LayerNorm(96),
         rng.normal(size=(2, 7, 96)).astype(np.float32)),
    ]
    for fm, tm, x in cases:
        params = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        params = jax.tree.map(
            lambda v: v + 0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                                  v.shape), params)
        load_flax_params(tm, params)
        want = np.asarray(fm.apply(params, jnp.asarray(x)))
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **F32)


def test_cpu_tensors_take_plain_versions_and_copies_are_counted():
    x, w, b = _inputs((2, 128, 64), seed=14)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    counters.clear()
    assert torch.equal(N.group_norm(tx, tw, tb, 8, 1e-6, True),
                       N.group_norm_reference(tx, tw, tb, 8, 1e-6, True))
    x2 = tx.reshape(-1, 64)
    assert torch.equal(N.layer_norm(x2, tw, tb, 1e-5),
                       N.layer_norm_reference(x2, tw, tb, 1e-5))
    assert (counters["launches.gn_stats"],
            counters["launches.gn_apply"]) == (0, 0)
    assert counters["launches.layer_norm"] == 0
    # a non-contiguous activation is copied once and counted
    counters.clear()
    ln = TL.LayerNorm(128)
    with torch.no_grad():
        got = ln(tx.transpose(1, 2))
        want = ln(tx.transpose(1, 2).contiguous())
    assert counters["norm.copies"] == 1
    assert torch.equal(got, want)


def test_cuda_wrappers_never_take_the_plain_version():
    """A tensor that is not on the CPU reaches the kernel wrappers, which
    launch or raise: here a meta tensor raises, no plain fallback."""
    x = torch.empty((2, 16, 64), device="meta")
    w = torch.ones(64)
    for call in (lambda: N.group_norm(x, w, w, 8, 1e-6),
                 lambda: N.group_norm_stats(x, w, w, 8, 1e-6),
                 lambda: N.layer_norm(x.reshape(32, 64), w, w, 1e-5)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


@pytest.mark.parametrize("b,s,c,vec", [
    (75, 9216, 320, 8), (75, 2304, 640, 8), (75, 576, 1280, 8),
    (75, 144, 2560, 8), (75, 2304, 1920, 8), (3, 230400, 320, 8),
    (8, 589824, 128, 4), (1, 4718592, 128, 8), (25, 576, 512, 4)])
def test_group_norm_launch_geometry(b, s, c, vec):
    """The GroupNorm plan at main-path shapes: whole rows of C/vec vectors
    a thread row with no idle lane, the rows cut into items of one pass,
    at least four items a block on a grid of at most the resident blocks
    (the temporal norm's B = 3 fills the card as B = 75 does)."""
    dtype = torch.bfloat16 if vec == 8 else torch.float32
    ncv = c // vec
    for kernel in N.GN_KERNELS:
        threads = N.group_norm_threads(c, dtype, kernel)
        resident = 2048 // threads
        plan = N.group_norm_plan(b, s, c, dtype, 132, resident, kernel)
        assert plan["vec"] == vec and plan["threads"] == threads
        assert threads % 32 == 0 and threads % ncv == 0 and threads <= 512
        assert plan["rows"] == threads // ncv
        assert plan["items"] == b * -(-s // plan["rows"])
        assert plan["items"] >= 4 * plan["grid"]
        assert plan["grid"] == min(132 * resident, plan["items"] // 4)
    with pytest.raises(ValueError, match="C/"):
        N.group_norm_plan(1, 16, 8192, torch.bfloat16, 132, 4)


def test_group_norm_wrapper_passes_bf16_weights_uncast(monkeypatch):
    """The stats launch takes a bf16 weight and bias as they are (widened
    in the kernel's fold, no cast launch) with its bf16 flag set, and a
    float32 pair as float32; mixed dtypes go as float32. Runs the wrapper
    on meta tensors with the launch recorded, not made."""
    got = []
    monkeypatch.setattr(N, "_check_input", lambda name, x, ndim: 8)
    monkeypatch.setattr(N, "_gn_resident", lambda *a: (132, 6))
    monkeypatch.setattr(N, "_launch", lambda *a: got.append(a) or 0)
    x = torch.empty((75, 144, 1280), dtype=torch.bfloat16, device="meta")
    for wdt, bdt, want in ((torch.bfloat16, torch.bfloat16, torch.bfloat16),
                           (torch.float32, torch.float32, torch.float32),
                           (torch.bfloat16, torch.float32, torch.float32)):
        got.clear()
        w = torch.empty(1280, dtype=wdt, device="meta")
        bias = torch.empty(1280, dtype=bdt, device="meta")
        N.group_norm_stats(x, w, bias, 32, 1e-6)
        (name, fn, _, xa, wa, ba, *rest), = got
        assert (name, fn) == ("group_norm", "syn3r_gn_stats") and xa is x
        assert wa.dtype == ba.dtype == want
        plan = N.group_norm_plan(75, 144, 1280, torch.bfloat16, 132, 6,
                                 "stats")
        part, counters = rest[0], rest[1]
        assert part.dtype == torch.float32
        assert part.numel() >= plan["slots"] * 2 * 1280
        assert counters.dtype == torch.int32 and counters.numel() >= 75
        assert rest[-4:] == [1, int(want == torch.bfloat16),
                             plan["threads"], plan["grid"]]
