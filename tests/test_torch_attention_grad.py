"""The backward of the port's attention and GEGLU feed-forward against the
JAX package on the CPU.

``flash_attention_bwd_reference`` (fed ``attention_lse_reference``) is the
plain version the backward kernels of ``csrc/flash_attention_bwd.cu`` are
held to on the card; here it must equal ``jax.vjp`` of JAX's
``_attention_chunked`` and autograd through the port's
``attention_chunked``. The ``_GegluFFN`` Function's backward (the one the
card runs: autograd through ``geglu_ffn_reference``) must equal
``jax.vjp`` of JAX's ``geglu_ffn``, whose ``_ffn_bwd`` is the vjp of its
reference. Inputs are seeded numpy arrays; everything is float32 on both
sides and differs only in summation order (explicit formulas against
autodiff, query chunks of 512 against JAX's scan), so 1e-5 absolute and
relative on O(1) gradients.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.models.layers import _attention_chunked
from syn3r_tpu.ops.pallas_ffn import geglu_ffn as jax_geglu_ffn
from syn3r_tpu_torch.device import resolve_device
from syn3r_tpu_torch.ops import attention as A
from syn3r_tpu_torch.ops import geglu_ffn as G
from syn3r_tpu_torch.utils.profiling import counters

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, h, s, d, seed):
    """q, k, v, dout as (B, S, H, D) arrays (the UNet's projection layout)
    and the scale."""
    rng = np.random.default_rng(seed)
    qkv = [rng.normal(size=(b, s, h, d)).astype(np.float32)
           for _ in range(3)]
    dout = rng.normal(size=(b, s, h, d)).astype(np.float32)
    return qkv, dout, d ** -0.5


def _views(arrs):
    """(B, H, S, D) strided views of (B, S, H, D) tensors, as the UNet
    hands them to attention."""
    return [torch.from_numpy(a).transpose(1, 2) for a in arrs]


@pytest.mark.parametrize("b,h,s", [(1, 2, 576), (2, 1, 640), (2, 2, 200)])
def test_bwd_reference_matches_jax_vjp_and_autograd(b, h, s):
    """576 and 640 take two query chunks (512 + the rest), 200 one ragged
    chunk; the lse against JAX's logsumexp of the scaled logits."""
    (q, k, v), dout, scale = _inputs(b, h, s, 64, seed=s + b)
    jq, jk, jv, jdo = (jnp.asarray(a).transpose(0, 2, 1, 3)
                       for a in (q, k, v, dout))
    want_out, vjp = jax.vjp(
        lambda *a: _attention_chunked(*a, scale), jq, jk, jv)
    want = [np.asarray(g) for g in vjp(jdo)]
    want_lse = np.asarray(jax.nn.logsumexp(
        jnp.einsum("bhqd,bhkd->bhqk", jq, jk) * scale, axis=-1))

    tq, tk, tv, tdo = _views((q, k, v, dout))
    out = A.attention_chunked(tq, tk, tv, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    lse = A.attention_lse_reference(tq, tk, scale)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    got = A.flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo, scale)
    for g, w in zip(got, want):
        assert g.shape == (b, h, s, 64) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **TOL)

    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    auto = torch.autograd.grad(A.attention_chunked(*leaves, scale), leaves,
                               tdo)
    for g, w in zip(got, auto):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert max(float(np.abs(w).max()) for w in want) > 1e-2


@pytest.mark.parametrize("r,c", [(200, 32), (96, 64)])
def test_geglu_function_backward_matches_jax_ffn_bwd(r, c, monkeypatch):
    """The Function's backward as the card runs it: its forward kernel is
    stood in for by the plain version (there is no card here), the
    backward is the code the card runs."""
    rng = np.random.default_rng(r + c)
    x = rng.normal(size=(r, c)).astype(np.float32)
    w1 = (rng.normal(size=(c, 8 * c)) * c ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=(8 * c,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(4 * c, c)) * (4 * c) ** -0.5).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    gy = rng.normal(size=(r, c)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    want_y, vjp = jax.vjp(lambda *a: jax_geglu_ffn(*a, jnp.float32), *jargs)
    want = [np.asarray(g) for g in vjp(jnp.asarray(gy))]

    launched = []

    def stand_in(*a):
        launched.append(1)
        return G.geglu_ffn_reference(*a)

    monkeypatch.setattr(G, "_geglu_launch", stand_in)
    # flax kernels are (in, out); torch Linear weights are (out, in)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
    y = G._GegluFFN.apply(*leaves)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(gy))
    assert launched == [1]
    for g, w, transpose in zip(got, want, (False, True, False, True, False)):
        g = g.numpy().T if transpose else g.numpy()
        np.testing.assert_allclose(g, w, **TOL)

    # only the inputs that require grad get one
    leaves[1].requires_grad_(False)
    y = G._GegluFFN.apply(*leaves)
    y.backward(torch.from_numpy(gy))
    assert leaves[1].grad is None and leaves[0].grad is not None


def test_kernel_route_takes_only_cuda_tensors():
    """The kernel wrappers raise on a CPU tensor (no plain fallback on the
    kernel route); on a host without a card the guided unit cannot be
    built for the default device."""
    q = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.flash_attention_bwd(q, q, q, q, lse, q, 0.125)
    # what the kernels cannot read is refused before any pointer is taken
    with pytest.raises(ValueError, match="must be like q"):
        A.flash_attention_bwd(q, q, q, q, lse, q.float(), 0.125)
    with pytest.raises(ValueError, match="must be like q"):
        A.flash_attention_bwd(q, q, q, q, lse[:, :1], q, 0.125)
    # the dq kernel reads out (for D) by TMA as bf16, like q
    with pytest.raises(ValueError, match="must be like q"):
        A.flash_attention_bwd(q, q, q, q.float(), lse, q, 0.125)
    with pytest.raises(ValueError, match="must be like q"):
        A.flash_attention_bwd(q, q, q, q[:, :, :32], lse, q, 0.125)
    # the launch plan refuses a head dim the kernels do not take, before
    # any device is asked
    with pytest.raises(ValueError, match="d = 64"):
        A.flash_bwd_plan(1, 2, 64, 132, d=32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        A._FlashAttention.apply(q.clone().requires_grad_(True), q, q, 0.125)
    # the CPU route of the public wrapper stays the plain version, with
    # autograd's gradient and no kernel launch
    counters.clear()
    qf = torch.randn((1, 2, 64, 64), requires_grad=True)
    A.flash_attention(qf, qf, qf, 0.125).sum().backward()
    assert qf.grad is not None and counters["launches.flash"] == 0
    assert (counters["launches.flash_bwd.dkv"],
            counters["launches.flash_bwd.dq"]) == (0, 0)
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    from syn3r_tpu_torch.diffusion.pipeline import load_svd_completion
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_svd_completion(None, guidance_through_unet=True)
