"""The port's tensor-parallel UNet forward against the JAX package's on
the CPU (JAX on the conftest's 8 virtual devices, the port on repeated
``cpu`` entries), the same tiny UNet weights bridged from the flax tree;
the sequence-parallel forward and the dir x TP denoise are in
tests/test_torch_parallel_sp.py.

Tolerance is JAX's own test's (tests/test_parallel.py): atol 2e-5
(float32, the row-parallel partial sums added in another order).
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.models.svd_unet import (UNetSpatioTemporalConditionModel as
                                       JUNet)
from syn3r_tpu_torch.models.convert import load_flax_params
from syn3r_tpu_torch.models.svd_unet import UNetSpatioTemporalConditionModel
from syn3r_tpu_torch.parallel import mesh as TM

UNET_KW = dict(block_out_channels=(32, 64), num_attention_heads=(2, 4),
               layers_per_block=1)
TIDS = [[6.0, 127.0, 0.02]]


def _case(b, f, seed=0, **unet_kw):
    """A tiny UNet of both packages with the same weights, and numpy
    inputs (b, f, 8, 8, 8)."""
    kw = dict(UNET_KW, **unet_kw)
    ju = JUNet(**kw)
    rng = np.random.default_rng(seed)
    sample = rng.normal(size=(b, f, 8, 8, 8)).astype(np.float32)
    ehs = rng.normal(size=(b, 1, 1024)).astype(np.float32)
    tids = np.tile(np.asarray(TIDS, np.float32), (b, 1))
    params = jax.jit(lambda k: ju.init(
        k, jnp.asarray(sample[:1]), 1.0, jnp.asarray(ehs[:1]),
        jnp.asarray(tids[:1])))(jax.random.PRNGKey(seed))
    tu = UNetSpatioTemporalConditionModel(**kw).eval()
    load_flax_params(tu, params)
    return ju, params, tu, (sample, ehs, tids)


def _port(run, args, **kw):
    with torch.no_grad():
        return run(*(torch.tensor(a) if i != 1 else a
                     for i, a in enumerate(args)), **kw).numpy()


def test_tp_shardings_follow_megatron_rule():
    """The rule hits to_q, to_v, the FF in- and out-projections and
    to_out, and no conv or norm, as JAX's does; each split weight holds
    1/N of its split axis a device (heads and units divide here)."""
    from syn3r_tpu_torch.parallel.tensor_parallel import (
        make_tp_unet_forward, unet_tp_shardings)
    tu = UNetSpatioTemporalConditionModel(**UNET_KW)
    mesh = TM.make_mesh(2, "model", devices=["cpu"] * 2)
    specs = unet_tp_shardings(tu, mesh)
    col = [k for k, p in specs.items() if p.spec == ("model", None)]
    row = [k for k, p in specs.items() if p.spec == (None, "model")]
    assert any(k.endswith("to_q.weight") for k in col)
    assert any(k.endswith("to_v.weight") for k in col)
    assert any("ff.net.0.proj" in k for k in col)
    assert any("ff_in.net.0.proj" in k for k in col)
    assert any(k.endswith("to_out.0.weight") for k in row)
    assert any("ff.net.2" in k for k in row)
    assert all("conv" not in k and "norm" not in k for k in col + row)
    assert specs["conv_in.weight"].spec == ()
    assert [k for k, p in specs.items() if p.spec == ("model",)] and all(
        k.endswith("proj.bias") for k, p in specs.items()
        if p.spec == ("model",))
    _, params_tp = make_tp_unet_forward(mesh, tu)
    for name in col + row:
        shards, whole = params_tp[name], tu.state_dict()[name]
        dim = 0 if name in col else 1
        assert len(shards) == 2
        assert all(s.shape[dim] * 2 == whole.shape[dim] for s in shards)
    q = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    assert torch.equal(torch.cat(params_tp[q]), tu.state_dict()[q])


ODD = dict(block_out_channels=(32, 96), num_attention_heads=(2, 3))


@pytest.mark.parametrize("parts, kw", [(2, {}), (4, {}), (2, ODD)])
def test_tp_unet_forward_matches_jax(parts, kw):
    """2- and 4-way tensor-parallel forwards against JAX's, and an odd
    head count (level 2's 3 heads over 2: 2 + 1) against JAX's padded
    split."""
    from jax.sharding import Mesh
    from syn3r_tpu.parallel.tensor_parallel import make_tp_unet_forward as jtp
    from syn3r_tpu_torch.parallel.tensor_parallel import make_tp_unet_forward

    ju, params, tu, args = _case(2, 2, **kw)
    jmesh = Mesh(np.array(jax.devices()[:parts]), ("model",))
    jrun, _ = jtp(jmesh, ju, params)
    want = np.asarray(jrun(jnp.asarray(args[0]), 1.0,
                           *(jnp.asarray(a) for a in args[1:])))
    run, params_tp = make_tp_unet_forward(
        TM.make_mesh(parts, "model", devices=["cpu"] * parts), tu)
    got = _port(run, (args[0], 1.0) + args[1:])
    assert got.shape == (2, 2, 8, 8, 4)
    np.testing.assert_allclose(got, want, atol=2e-5)
    if kw:
        k = "mid_block.attentions.0.transformer_blocks.0.attn1.to_k.weight"
        assert [t.shape[0] for t in params_tp[k]] == [2 * 32, 32]
