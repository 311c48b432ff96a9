"""The port's sequence-parallel (frame-axis) UNet forward and the guided
denoise with its directions on a (dir, model) mesh against the JAX
package's on the CPU (JAX on the conftest's 8 virtual devices, the port on
repeated ``cpu`` entries), the same tiny UNet weights bridged from the
flax tree.

Tolerances are JAX's own tests' (tests/test_parallel.py): the SP forward
atol 2e-5 (float32, the frame shards' GroupNorm sums added in another
order), the dir x TP denoise atol 2e-4.
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


@pytest.mark.parametrize("frames, parts", [(8, 8), (5, 2)])
def test_sp_unet_forward_matches_jax(frames, parts):
    """The frame axis sharded: F 8 over 8 (one frame a device) against
    JAX's sharded forward, and F 5 over 2 (3 + 2) against JAX's unsharded
    one (JAX's device_put refuses a frame axis the extent does not
    divide); with batch groups too, against the port's own unsharded
    forward."""
    from jax.sharding import Mesh
    from syn3r_tpu.parallel.sequence_parallel import make_sp_unet_forward as jsp
    from syn3r_tpu_torch.parallel.sequence_parallel import make_sp_unet_forward

    ju, params, tu, args = _case(3, frames, seed=1)
    jargs = (jnp.asarray(args[0]), 1.0) + tuple(jnp.asarray(a)
                                                for a in args[1:])
    if frames % parts == 0:
        jmesh = Mesh(np.array(jax.devices()[:parts]), ("seq",))
        want = np.asarray(jsp(jmesh, ju, params)(*jargs))
    else:
        want = np.asarray(jax.jit(ju.apply)(params, *jargs))
    run = make_sp_unet_forward(
        TM.make_mesh(parts, "seq", devices=["cpu"] * parts), tu)
    got = _port(run, (args[0], 1.0) + args[1:])
    np.testing.assert_allclose(got, want, atol=2e-5)
    grouped = _port(run, (args[0], 1.0) + args[1:], batch_groups=(1, 2))
    whole = _port(tu, (args[0], 1.0) + args[1:], batch_groups=(1, 2))
    np.testing.assert_allclose(grouped, whole, atol=2e-5)
    with pytest.raises(ValueError, match="frames over"):
        make_sp_unet_forward(TM.make_mesh(
            8, "seq", devices=["cpu"] * 8), tu)(
            torch.zeros((1, 5, 8, 8, 8)), 1.0, torch.zeros((1, 1, 1024)),
            torch.zeros((1, 3)))


def test_dir_tp_composed_guided_denoise():
    """JAX's test_dir_tp_composed_guided_denoise setting: the post
    denoise's directions over "dir" of a (2, 4) mesh, each direction's
    UNet tensor-parallel over its row of "model", against JAX's (dir x
    model) placement and JAX's unsharded pipeline."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from syn3r_tpu.diffusion.pipeline import (GuidedSVDConfig as JConfig,
                                              GuidedSVDPipeline as JPipe,
                                              SVDModels as JModels)
    from syn3r_tpu.parallel.mesh import make_mesh_2d as jmesh2d
    from syn3r_tpu.parallel.tensor_parallel import unet_tp_shardings as jtp
    from syn3r_tpu_torch.diffusion.pipeline import (GuidedSVDConfig,
                                                    GuidedSVDPipeline,
                                                    SVDModels)
    from syn3r_tpu_torch.parallel.tensor_parallel import TensorParallelUNet

    frames, h, w = 2, 8, 8
    ju, params, tu, _ = _case(1, frames, seed=3)
    rng = np.random.default_rng(3)
    lat = rng.normal(size=(1, frames, h, w, 4)).astype(np.float32)
    clip_s = rng.normal(size=(2, 1, 1024)).astype(np.float32)
    cond = (rng.normal(size=(frames, h, w, 4)) * 0.1).astype(np.float32)
    msk = np.full((frames - 2, h, w), 0.4, np.float32)
    lam = np.ones((2, frames), np.float32)
    args = (lat, clip_s, clip_s, cond, msk, lam)

    def jbuild(p, sharding=None):
        return JPipe(JModels(unet=ju, unet_params=p, vae=None,
                             vae_params=None, clip=None, clip_params=None),
                     JConfig(num_inference_steps=2, num_frames=frames,
                             variant="post", compute_dtype=jnp.float32,
                             direction_parallel=True,
                             direction_sharding=sharding))
    ref = np.asarray(jbuild(params).denoise(*(jnp.asarray(a) for a in args)))
    m = jmesh2d(2, 4)
    want = np.asarray(jbuild(jax.device_put(params, jtp(params, m)),
                             NamedSharding(m, P("dir"))).denoise(
        *(jnp.asarray(a) for a in args)))

    mesh = TM.make_mesh_2d(2, 4, devices=["cpu"] * 8)
    pipe = GuidedSVDPipeline(
        SVDModels(unet=tu, vae=None, clip=None),
        GuidedSVDConfig(num_inference_steps=2, num_frames=frames,
                        compute_dtype=torch.float32,
                        direction_sharding=TM.sharded(mesh, "dir")))
    units = pipe._units_of(0)
    assert all(isinstance(u.m.unet, TensorParallelUNet)
               and len(u.m.unet.devices) == 4 for u in units)
    got = pipe.denoise(*args).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, ref, atol=2e-4)
