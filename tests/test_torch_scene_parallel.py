"""The within-scene placement (``--scene_parallel``) of the port against
the JAX package's on the CPU: ``densify_views`` with ``pair_parallel``
on a 2-slot pair mesh and with no placement (JAX's
test_pair_parallel_densify_matches_sequential), the pair waves' padding,
seeds and caches, the (4, 2) (pair, dir) scene over 2 cycles with tiny
networks (JAX's test_scene_pair_x_direction_mesh_end_to_end), and
``cli.train.main`` on one device. The port's meshes repeat ``cpu``.

Tolerances: the warp-only densify against the port's sequential loop atol
1e-6 (JAX's own bound; here every path computes the same), poses exact,
against JAX's at the densify tolerance of tests/test_torch_scene.py (1e-5
absolute: float32 renders on both sides). The (4, 2) scene's cycle-0
caches against the port's sequential pipeline exactly (atol 0: each
(pair, direction) on a repeated device makes the sequential unit's own
calls in the same order, so a wrong pair, seed or slot shows; JAX's own
test holds its mesh run to its sequential one at 5e-3). That scene is not
held to JAX's frames: its completion draws the latent noise and the
noise augmentation inside the pipeline, JAX's from its PRNG keys and the
port's from torch generators, so the two runs denoise different noise.
The completion unit itself is held to JAX's on the same noise in
tests/test_torch_pipeline.py, and the warp-only densify above to JAX's
pair-parallel run.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import os

import jax
import numpy as np
import pytest
import torch

from syn3r_tpu.pipeline import orchestrator as JO
from syn3r_tpu_torch.cli import train as CLI
from syn3r_tpu_torch.parallel import mesh as TM
from syn3r_tpu_torch.pipeline import orchestrator as TO
from test_torch_scene import H, W, _trainers, cloud, scene_dir  # noqa: F401

KW = dict(diffusion_width=W, diffusion_height=H, num_frames=5,
          num_inference_steps=5, refine_cycle_num=1,
          perturb_interp_poses=False)


def _cache(d, cycle, pi):
    return os.path.join(d, f"interpolated_dense_views_cyc{cycle}_view{pi}.npz")


def test_pair_parallel_densify_matches_sequential(cloud, tmp_path):
    """pair_parallel on a 2-slot pair mesh and with no placement: the
    sequential loop's frames and poses, JAX's pair-parallel ones, and the
    caches it writes reload."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    jtr, ttr, _ = _trainers(cloud, tmp_path)

    def run(save_dir, **kw):
        return TO.DiffusionGS(ttr, TO.DiffusionGSConfig(**KW, **kw),
                              save_dir=str(tmp_path / save_dir)
                              ).densify_views(0)

    f_seq, p_seq = run("seq")
    pair = TM.sharded(TM.make_mesh(2, "pair", devices=["cpu"] * 2), "pair")
    f_par, p_par = run("par", pair_parallel=True, pair_sharding=pair)
    f_one, p_one = run("one", pair_parallel=True)
    assert f_par.shape == f_seq.shape == (3, 5, H, W, 3)
    for f, p in ((f_par, p_par), (f_one, p_one)):
        np.testing.assert_allclose(f.numpy(), f_seq.numpy(), atol=1e-6)
        np.testing.assert_allclose(p.numpy(), p_seq.numpy(), atol=0)
    jmesh = Mesh(np.array(jax.devices()[:2]), ("pair",))
    jf, jp = JO.DiffusionGS(jtr, JO.DiffusionGSConfig(
        **KW, pair_parallel=True, pair_sharding=NamedSharding(
            jmesh, P("pair"))), save_dir=str(tmp_path / "jax")
    ).densify_views(0)
    np.testing.assert_allclose(f_par.numpy(), np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(p_par.numpy(), np.asarray(jp), atol=1e-5)
    # the caches of the parallel path; the reload hits them
    f2, _ = run("par", pair_parallel=True, pair_sharding=pair)
    np.testing.assert_allclose(f2.numpy(), f_par.numpy(), atol=0)


def test_pair_waves_pad_seed_and_cache(cloud, tmp_path):
    """3 pairs on a 2-slot pair axis are 2 waves, the second padded by
    repeating its pair: each slot's call on its slot's device with the
    sequential loop's seed, the padded slot's frames dropped (3 caches);
    with no placement one wave of all 3."""
    _, ttr, _ = _trainers(cloud, tmp_path)
    calls = []

    def completion(start, cond, end, mask, lam, gen):
        calls.append((str(start.device), gen.initial_seed()))
        return torch.cat([start[None], cond, end[None]])

    names = ["cpu:0", "cpu:1"]
    pair = TM.sharded(TM.Mesh([torch.device("cpu")] * 2, ("pair",)), "pair")
    runner = TO.DiffusionGS(
        ttr, TO.DiffusionGSConfig(**KW, pair_parallel=True,
                                  pair_sharding=pair, seed=7),
        completion_fn=completion, save_dir=str(tmp_path / "d"))
    runner.densify_views(2)
    seeds = [7 + 2000 + pi for pi in (0, 1, 2, 2)]
    assert calls == [("cpu", s) for s in seeds]
    assert sorted(os.listdir(tmp_path / "d")) == sorted(
        os.path.basename(_cache(tmp_path / "d", 2, pi)) for pi in range(3))
    assert [str(d) for d in TM.make_scene_topology(
        names * 2)[0].slot_devices(1)] == names
    calls.clear()
    TO.DiffusionGS(ttr, TO.DiffusionGSConfig(**KW, pair_parallel=True),
                   completion_fn=completion,
                   save_dir=str(tmp_path / "e")).densify_views(0)
    assert calls == [("cpu", pi) for pi in range(3)]


def _tiny_models():
    from syn3r_tpu_torch.diffusion.pipeline import (SVDModels,
                                                    init_random_weights_)
    from syn3r_tpu_torch.models.clip import CLIPVisionModelWithProjection
    from syn3r_tpu_torch.models.svd_unet import (
        UNetSpatioTemporalConditionModel)
    from syn3r_tpu_torch.models.vae import AutoencoderKLTemporalDecoder
    gen = torch.Generator().manual_seed(0)
    nets = [UNetSpatioTemporalConditionModel(
        block_out_channels=(32, 64), num_attention_heads=(2, 4),
        layers_per_block=1, addition_time_embed_dim=32),
        AutoencoderKLTemporalDecoder(block_out_channels=(32, 32, 32, 32),
                                     layers_per_block=1),
        CLIPVisionModelWithProjection(hidden=64, layers=2, heads=4,
                                      mlp_dim=128, patch=32, image_size=224,
                                      projection_dim=1024)]
    for n in nets:
        init_random_weights_(n, gen).eval()
    return SVDModels(unet=nets[0], vae=nets[1], clip=nets[2])


def test_scene_pair_x_direction_mesh_end_to_end(cloud, tmp_path):
    """The (pair=4, dir=2) topology with a real tiny GuidedSVDPipeline:
    a full 2-cycle run (init, densify in one padded wave, refine) whose
    cycle-0 caches reproduce the sequential pipeline's densify; cycle-1
    caches and a finite held-out render."""
    from syn3r_tpu_torch.diffusion.pipeline import (GuidedSVDConfig,
                                                    GuidedSVDPipeline)
    models = _tiny_models()
    f = 3

    def pipe(**kw):
        return GuidedSVDPipeline(models, GuidedSVDConfig(
            num_inference_steps=2, num_frames=f, decode_chunk_size=4,
            compute_dtype=torch.float32, **kw))
    kw = dict(KW, num_frames=f, num_inference_steps=2, refine_cycle_num=2)
    _, tr_seq, _ = _trainers(cloud, tmp_path / "s", iterations=8)
    tr_seq.training(0)
    f_seq, p_seq = TO.DiffusionGS(
        tr_seq, TO.DiffusionGSConfig(**kw), completion_fn=pipe(),
        save_dir=str(tmp_path / "seq_dense")).densify_views(0)

    pair_sh, dir_sh = TM.make_scene_topology(["cpu"] * 8)
    par = pipe(direction_sharding=dir_sh)
    assert len({id(u) for u in (par._units_of(0) + par._units_of(3))}) == 1
    _, tr_par, _ = _trainers(cloud, tmp_path / "p", iterations=8)
    runner = TO.DiffusionGS(
        tr_par, TO.DiffusionGSConfig(**kw, pair_parallel=True,
                                     pair_sharding=pair_sh),
        completion_fn=par, save_dir=str(tmp_path / "par_dense"))
    runner.run(refine_cycles=2)

    assert f_seq.shape == (3, f, H, W, 3)
    cached = [np.load(_cache(tmp_path / "par_dense", 0, pi))
              for pi in range(3)]
    np.testing.assert_allclose(np.stack([c["frames"] for c in cached]),
                               f_seq.numpy(), atol=0)
    np.testing.assert_allclose(np.stack([c["poses"] for c in cached]),
                               p_seq.numpy(), atol=0)
    for pi in range(3):
        assert os.path.exists(_cache(tmp_path / "par_dense", 1, pi))
    assert len(os.listdir(tmp_path / "par_dense")) == 6
    out = tr_par.render_view(tr_par.train_views.cameras.at(1))
    assert torch.isfinite(out["render"]).all()


def test_cli_scene_parallel_on_one_device(scene_dir, tmp_path, capsys):
    """--scene_parallel auto on one device runs the pairs one after
    another (no mesh printed); on exits with JAX's message."""
    args = ["-s", scene_dir, "-m", str(tmp_path / "m"), "--n_views", "3",
            "--iterations", "4", "--refine_cycle_num", "1",
            "--diffusion_width", str(W), "--diffusion_height", str(H),
            "--num_frames", "3", "--num_inference_steps", "2",
            "--tile_cap", "256", "--device", "cpu", "--log_every", "0"]
    runner = CLI.main(args)
    assert not runner.cfg.pair_parallel and runner.cfg.pair_sharding is None
    assert "[scene_parallel]" not in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "m" / "dense_views")) == 3
    with pytest.raises(SystemExit, match="requires >= 2 devices"):
        CLI.main(args + ["--scene_parallel", "on"])
    parsed = CLI.build_parser().parse_args(args + ["--scene_parallel", "off"])
    assert CLI.scene_topology(parsed, torch.device("cpu")) == (None, None)
