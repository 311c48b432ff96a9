"""The port's parallel/ package against the JAX package's on the CPU: the
mesh and placements, the data-parallel GS step and UNet forward, and
GPipe. JAX runs on the conftest's 8 virtual CPU devices, the port on a
mesh of repeated ``cpu`` entries (the same code that spreads over cards).
Both get the same numpy inputs and weights.

Tolerances are JAX's own tests' (tests/test_parallel.py): the DP step's
loss rtol 1e-5 and means atol 1e-5 (float32, the views' losses summed in
another order), the DP UNet atol 2e-5, GPipe atol 1e-5.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.parallel import mesh as JM
from syn3r_tpu_torch.parallel import mesh as TM

CPU8 = ["cpu"] * 8
UNET_KW = dict(block_out_channels=(32, 64), num_attention_heads=(2, 4),
               layers_per_block=1)


def test_mesh_and_placements():
    """make_scene_topology over 8, 2 and 1 devices as JAX's: (4, 2),
    (1, 2), (None, None); axis names; make_mesh / make_mesh_2d /
    replicated / sharded and the slots a placement names."""
    devs = jax.devices()
    for n, shape in ((8, (4, 2)), (2, (1, 2))):
        jp, jd = JM.make_scene_topology(devs[:n])
        tp, td = TM.make_scene_topology(["cpu"] * n)
        assert tp.mesh.devices.shape == jp.mesh.devices.shape == shape
        assert tp.mesh.axis_names == jp.mesh.axis_names == ("pair", "dir")
        assert (tp.spec, td.spec) == (("pair",), ("dir",))
        assert (tp.shards, td.shards) == (shape[0], 2)
    assert JM.make_scene_topology(devs[:1]) == (None, None)
    assert TM.make_scene_topology(["cpu"]) == (None, None)
    assert TM.make_scene_topology([]) == (None, None)
    # a (4, 2) mesh over distinct names: slot k of the pair axis is row k
    names = [f"cuda:{i}" for i in range(8)]
    tp, td = TM.make_scene_topology(names)
    assert [str(d) for d in tp.slot_devices(2)] == ["cuda:4", "cuda:5"]
    assert [str(d) for d in td.slot_devices(1)] == [
        "cuda:1", "cuda:3", "cuda:5", "cuda:7"]
    assert tp.mesh.shape == {"pair": 4, "dir": 2}
    assert tp.mesh.along("dir", {"pair": 3}) == [torch.device("cuda:6"),
                                                 torch.device("cuda:7")]
    mesh = TM.make_mesh(8, devices=CPU8)
    assert mesh.size == 8 and mesh.axis_names == ("data",)
    assert TM.sharded(mesh).shards == 8 and TM.replicated(mesh).shards == 1
    m2 = TM.make_mesh_2d(2, 4, devices=names)
    assert m2.shape == {"dir": 2, "model": 4}
    assert [str(d) for d in m2.along("model", {"dir": 1})] == names[4:]
    assert TM.split_sizes(25, 2) == [13, 12]
    assert TM.split_sizes(5, 4) == [2, 1, 1, 1]
    with pytest.raises(ValueError, match="needs 8 devices"):
        TM.make_mesh_2d(2, 4, devices=names[:4])
    with pytest.raises(ValueError, match="no 'seq'"):
        TM.sharded(mesh, "seq")


def test_to_device_blocks_the_host_only_for_a_copy_to_the_host():
    """A copy to a card is stream-ordered (non_blocking); a copy to the
    host is not, so a gather onto the CPU (GPipe's output on x's device)
    can be read at once; a tensor already there is itself."""
    seen = []

    class Probe:
        def to(self, device, non_blocking=False):
            seen.append((str(device), non_blocking))
            return self

    for dev in ("cpu", "cuda:1", torch.device("cuda", 0)):
        TM.to_device(Probe(), dev)
    assert seen == [("cpu", False), ("cuda:1", True), ("cuda:0", True)]
    x = torch.ones(3)
    assert TM.to_device(x, "cpu") is x


def _gs_case():
    """JAX's test_dp_gs_train_step_matches_single_device scene: 64
    Gaussians, 8 views of 32x24 with noisy targets."""
    from syn3r_tpu.models import gaussians as JG
    from syn3r_tpu.ops.rasterize import render
    from syn3r_tpu.utils.camera import camera_from_fov, look_at_w2c

    rng = np.random.default_rng(0)
    n = 64
    xyz = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)),
                          rng.uniform(1.5, 2.5, (n, 1))], 1).astype(np.float32)
    state = JG.from_points(jnp.asarray(xyz), jnp.asarray(
        rng.uniform(size=(n, 3)).astype(np.float32)), capacity=64)
    cams, imgs = [], []
    for i in range(8):
        cam = camera_from_fov(0.9, 0.7, 32, 24, look_at_w2c(
            jnp.asarray([0.15 * (i - 4), 0., 0.]), jnp.asarray([0., 0., 2.0])))
        img = np.asarray(render(state, cam, chunk=64, group=1).rgb)
        cams.append(cam)
        imgs.append(np.clip(img + rng.normal(0, 0.05, img.shape), 0,
                            1).astype(np.float32))
    return state, cams, np.stack(imgs)


def test_dp_gs_train_step_matches_jax():
    """8 views over 8 replicas: loss and updated means against JAX's
    sharded step, and the port's one-replica step against the same."""
    from syn3r_tpu.gs.densify import DensifyStats
    from syn3r_tpu.gs.trainer import (AdamState, TrainConfig, TrainState,
                                      make_viewset)
    from syn3r_tpu.models import gaussians as JG
    from syn3r_tpu.parallel.data_parallel import make_dp_gs_train_step as jdp
    from syn3r_tpu_torch.gs import densify as TD
    from syn3r_tpu_torch.gs import trainer as TT
    from syn3r_tpu_torch.models import gaussians as TG
    from syn3r_tpu_torch.parallel.data_parallel import make_dp_gs_train_step
    from syn3r_tpu_torch.utils.camera import camera_from_numpy, stack_cameras

    state, cams, imgs = _gs_case()
    views = make_viewset(cams, imgs)
    cfg = TrainConfig(chunk=64, group=1, rasterizer="dense")
    ts = TrainState(gaussians=state, adam=AdamState.init(
        JG.get_params(state)), stats=DensifyStats.zeros(64),
        step=jnp.zeros((), jnp.int32), key=jax.random.PRNGKey(0))
    mesh = JM.make_mesh(8)
    with mesh:
        step, prepare = jdp(mesh, cfg, extent=1.0)
        new_j, loss_j = step(*prepare(ts, views.cameras, views.images))

    tstate = TG.gaussians_from_numpy(state)
    tts = TT.TrainState(gaussians=tstate,
                        adam=TT.AdamState.init(TG.get_params(tstate)),
                        stats=TD.DensifyStats.zeros(64), step=0)
    tcams = stack_cameras([camera_from_numpy(c) for c in cams])
    tcfg = TT.TrainConfig(chunk=64, rasterizer="dense")
    tmesh = TM.make_mesh(8, devices=CPU8)
    tstep, tprepare = make_dp_gs_train_step(tmesh, tcfg, extent=1.0)
    placed = tprepare(tts, tcams, torch.tensor(imgs))
    assert [len(c) for c in placed[1]] == [1] * 8
    new_t, loss_t = tstep(*placed)
    one_t, loss_one = tstep(tts, tcams, torch.tensor(imgs))

    assert float(loss_t) > 0
    for loss in (loss_t, loss_one):
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for got in (new_t[0].gaussians.means, new_t[7].gaussians.means,
                one_t.gaussians.means):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(new_j.gaussians.means),
                                   atol=1e-5)
    assert new_t[3].step == 1 and new_t[3].adam.count == 1
    with pytest.raises(ValueError, match="7 views over 8"):
        tprepare(tts, tcams, torch.tensor(imgs[:7]))


def _unet_pair():
    from syn3r_tpu.models.svd_unet import UNetSpatioTemporalConditionModel
    from syn3r_tpu_torch.models.convert import load_flax_params
    from syn3r_tpu_torch.models.svd_unet import (
        UNetSpatioTemporalConditionModel as TUNet)
    ju = UNetSpatioTemporalConditionModel(**UNET_KW)
    rng = np.random.default_rng(1)
    sample = rng.normal(size=(8, 2, 8, 8, 8)).astype(np.float32)
    ehs = rng.normal(size=(8, 1, 1024)).astype(np.float32)
    tids = np.tile(np.asarray([[6.0, 127.0, 0.02]], np.float32), (8, 1))
    params = jax.jit(lambda k: ju.init(
        k, jnp.asarray(sample[:1]), 1.0, jnp.asarray(ehs[:1]),
        jnp.asarray(tids[:1])))(jax.random.PRNGKey(0))
    tu = TUNet(**UNET_KW).eval()
    load_flax_params(tu, params)
    return ju, params, tu, (sample, ehs, tids)


def test_dp_unet_forward_matches_jax():
    """Batch 8 over 8 UNet replicas against JAX's sharded forward."""
    from syn3r_tpu.parallel.data_parallel import make_dp_unet_forward as jdp
    from syn3r_tpu_torch.parallel.data_parallel import make_dp_unet_forward

    ju, params, tu, (sample, ehs, tids) = _unet_pair()
    mesh = JM.make_mesh(8)
    with mesh:
        want = np.asarray(jdp(mesh, ju, params)(
            jnp.asarray(sample), 1.0, jnp.asarray(ehs), jnp.asarray(tids)))
    run = make_dp_unet_forward(TM.make_mesh(8, devices=CPU8), tu)
    with torch.no_grad():
        got = run(torch.tensor(sample), 1.0, torch.tensor(ehs),
                  torch.tensor(tids))
    assert got.shape == (8, 2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_gpipe_matches_jax_and_sequential():
    """4 stages x 4 microbatches of a BasicTransformerBlock tower on a
    4-device stage axis: against JAX's GPipe and the plain sequential
    application; JAX's ValueErrors."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from syn3r_tpu.models.svd_unet import BasicTransformerBlock as JBlock
    from syn3r_tpu.parallel.pipeline_parallel import make_gpipe as jgpipe
    from syn3r_tpu_torch.models.convert import load_flax_params
    from syn3r_tpu_torch.models.svd_unet import BasicTransformerBlock
    from syn3r_tpu_torch.parallel.pipeline_parallel import make_gpipe

    n_stages, d = 4, 16
    blk = JBlock(heads=2, dim_head=d // 2)
    x = np.random.default_rng(2).normal(size=(8, 6, d)).astype(np.float32)
    ctx = jnp.zeros((8, 1, d))
    ps = [blk.init(jax.random.PRNGKey(i), jnp.asarray(x), ctx)
          for i in range(n_stages)]
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *ps)
    jmesh = Mesh(np.array(jax.devices()[:n_stages]), ("stage",))
    stacked = jax.device_put(stacked, NamedSharding(jmesh, P("stage")))
    jrun = jgpipe(jmesh, lambda p, xin: blk.apply(
        p, xin, jnp.zeros((xin.shape[0], 1, d))), n_stages)
    want = np.asarray(jrun(stacked, jnp.asarray(x), 4))

    blocks = []
    for p in ps:
        tb = BasicTransformerBlock(d, 2, d // 2, d).eval()
        load_flax_params(tb, p)
        blocks.append(tb)
    mesh = TM.make_mesh(n_stages, "stage", devices=["cpu"] * n_stages)
    run = make_gpipe(mesh, lambda b, xin: b(
        xin, torch.zeros((xin.shape[0], 1, d))), n_stages)
    with torch.no_grad():
        got = run(blocks, torch.tensor(x), 4).numpy()
        seq = torch.tensor(x)
        for b in blocks:
            seq = b(seq, torch.zeros((8, 1, d)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, seq.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        run(blocks, torch.tensor(x), 3)
    with pytest.raises(ValueError, match="want 3"):
        make_gpipe(mesh, None, 3)
