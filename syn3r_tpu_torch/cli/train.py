"""Training entry point: one scene's test-time optimization on the card.

Counterpart of ``syn3r_tpu/cli/train.py`` with the same flags, plus
``--device`` (``cuda`` by default; ``cpu`` runs the plain torch path) and
``--rasterizer kernel|tiled|dense`` (the port's ``TrainConfig`` names).
Loads a COLMAP scene, fits 3DGS and runs the refine-cycle loop with guided
SVD completion (``--svd_weights``: the converted ``unet.npz``, ``vae.npz``,
``clip.npz`` of the JAX package; ``--diffusion_type`` picks the post or
the prob variant) or the warp-only completion without it, the LPIPS
refine loss with ``--lpips_weights`` (the JAX package's converted VGG
``.npz``), and the DL3DV point-cloud densification with
``--dust3r_weights`` (the JAX package's ``Dust3R`` flax tree as a flat
``.npz``, the network's widths and depths read from its shapes) and its
frame-quality gate with ``--gmflow_weights`` (a ``GMFlowPublic`` tree)::

    python -m syn3r_tpu_torch.cli.train -s <scene> -m <out> --n_views 3

``main`` is parse -> ``load_colmap_scene`` -> ``build_runner`` -> ``run``;
``build_runner`` also takes an in-memory ``SceneData`` and a completion
callable. ``--num_frames`` sets the frames of a pair (poses, warps, the
warp-only completion), but the ``--svd_weights`` completion is built for
25 frames whatever it says, as in the JAX package: with another count its
first denoise raises ``ValueError`` (JAX's raises one too, from a shape
mismatch inside its jitted loop). ``--interp_type forward_warp`` builds
the splat conditioning, ``--save_debug`` writes each pair's debug images
under ``<model_path>/dense_views/debug/``, ``--guidance_reuse_cfg_uncond 1``
configures the ``--svd_weights`` completion. Not ported, raising
``NotImplementedError``: ``--scene_parallel on`` (multi-GPU).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("syn3r-tpu-torch train")
    # scene / IO
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--images", default="images")
    p.add_argument("--resolution", "-r", type=int, default=1)
    p.add_argument("--n_views", type=int, default=3)
    p.add_argument("--llffhold", type=int, default=8)
    p.add_argument("--rand_pcd", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain torch path)")
    # diffusion / refine loop
    p.add_argument("--diffusion_type", default="2PassProbUncertainPost",
                   choices=["2PassProbUncertain", "2PassProbUncertainPost"])
    p.add_argument("--densify_type", default="interpolate_gs_v2",
                   choices=["interpolate_gs_v2", "interpolate_loop0_gs"])
    p.add_argument("--interp_type", default="backward_warp",
                   choices=["backward_warp", "forward_warp"])
    p.add_argument("--refine_cycle_num", type=int, default=2)
    p.add_argument("--cam_confidence", type=float, default=0.05)
    p.add_argument("--weight_clamp", type=float, default=0.2,
                   help="no-op, kept for reference-CLI parity (the live "
                        "clamp is 0.4 inside the scheduler)")
    p.add_argument("--pseudo_cam_sampling_rate", type=float, default=0.02)
    p.add_argument("--num_views_for_pcd_densification", type=int, default=4)
    p.add_argument("--fps_keyframe_sampling", type=int, default=0)
    p.add_argument("--reorg_train_views", type=int, default=1)
    p.add_argument("--num_inference_steps", type=int, default=100)
    p.add_argument("--guidance_reuse_cfg_uncond", type=int, default=0)
    p.add_argument("--diffusion_width", type=int, default=1024)
    p.add_argument("--diffusion_height", type=int, default=576)
    p.add_argument("--num_frames", type=int, default=25)
    p.add_argument("--svd_weights", default=None,
                   help="dir with converted SVD/CLIP/VAE params (.npz); "
                        "without it the warp-only completion runs")
    p.add_argument("--dust3r_weights", default=None,
                   help="a Dust3R flax tree (.npz): the DUSt3R point-cloud "
                        "densification")
    p.add_argument("--gmflow_weights", default=None,
                   help="a GMFlowPublic flax tree (.npz): the flow gate of "
                        "that densification")
    # GS optimization
    p.add_argument("--iterations", type=int, default=10_000)
    p.add_argument("--lambda_dssim", type=float, default=0.2)
    p.add_argument("--densify_grad_threshold", type=float, default=2e-4)
    p.add_argument("--percent_dense", type=float, default=0.01)
    p.add_argument("--sample_svd_pseudo_interval", type=int, default=2)
    p.add_argument("--start_sample_svd_frame", type=int, default=2000)
    p.add_argument("--use_proximity_densify", type=int, default=1)
    p.add_argument("--proximity_threshold", type=float, default=0.01)
    p.add_argument("--num_train_samples", type=int, default=None,
                   help="fork flag; --n_views is authoritative")
    p.add_argument("--use_dust3r", type=int, default=0,
                   help="fork flag; 0 in every shipped config")
    p.add_argument("--dataset", default="llff",
                   choices=["llff", "dtu", "dl3dv"],
                   help="accepted for script parity; behaviour comes from "
                        "the explicit flags")
    p.add_argument("--sample_pseudo_interval", type=int, default=10 ** 20)
    p.add_argument("--start_sample_pseudo", type=int, default=2000)
    p.add_argument("--svd_depth_warmup", type=int, default=0)
    p.add_argument("--lpips_weight", type=float, default=1.0)
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--rasterizer", default="kernel",
                   choices=["kernel", "tiled", "dense"],
                   help="kernel = the tile composite kernels; tiled = the "
                        "same tiles, plain torch composite; dense = the "
                        "exact dense path")
    p.add_argument("--tile_cap", type=int, default=1024)
    p.add_argument("--disable_densification", action="store_true")
    p.add_argument("--save_debug", action="store_true")
    p.add_argument("--scene_parallel", default="auto",
                   choices=["auto", "off", "on"],
                   help="auto and off run the pairs one after another on "
                        "one card; on (multi-GPU) is not ported")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=1000)
    return p


def _check_ported(args):
    """Raise NotImplementedError for a flag whose path is not ported."""
    if args.scene_parallel == "on":
        raise NotImplementedError("--scene_parallel on (multi-GPU) is not "
                                  "ported to syn3r_tpu_torch")


def svd_config(args) -> dict:
    """The ``GuidedSVDConfig`` fields the flags set, as JAX's
    ``_load_svd_completion`` sets them: ``--num_frames`` is not one of
    them, so the completion is the 25-frame pipeline."""
    return dict(
        num_inference_steps=args.num_inference_steps,
        variant=("post" if args.diffusion_type == "2PassProbUncertainPost"
                 else "prob"),
        guidance_reuse_cfg_uncond=bool(args.guidance_reuse_cfg_uncond))


def build_runner(args, scene, completion_fn=None):
    """The ``DiffusionGS`` of ``args`` on ``scene`` (a ``SceneData``): the
    trainer on ``args.device``, the completion from ``args.svd_weights``
    unless ``completion_fn`` is given, the warp-only one otherwise."""
    import torch

    from ..device import resolve_device
    from ..gs.trainer import GSTrainer, TrainConfig, make_viewset
    from ..models import gaussians as G
    from ..pipeline.orchestrator import DiffusionGS, DiffusionGSConfig
    from ..utils.params import load_params

    _check_ported(args)
    dev = resolve_device(args.device)
    views = make_viewset(scene.train_cameras, scene.train_images)
    test_views = (make_viewset(scene.test_cameras, scene.test_images)
                  if len(scene.test_cameras) else None)
    init = G.from_points(torch.as_tensor(scene.points_xyz, device=dev),
                         torch.as_tensor(scene.points_rgb, device=dev))
    cfg = TrainConfig(
        iterations=args.iterations, lambda_dssim=args.lambda_dssim,
        densify_grad_threshold=args.densify_grad_threshold,
        percent_dense=args.percent_dense,
        sample_svd_pseudo_interval=args.sample_svd_pseudo_interval,
        start_sample_svd_iter=args.start_sample_svd_frame,
        sample_pseudo_interval=args.sample_pseudo_interval,
        start_sample_pseudo=args.start_sample_pseudo,
        pseudo_cam_sampling_rate=args.pseudo_cam_sampling_rate,
        svd_depth_warmup=args.svd_depth_warmup,
        lpips_weight=args.lpips_weight,
        use_proximity_densify=bool(args.use_proximity_densify),
        proximity_threshold=args.proximity_threshold,
        rasterizer=args.rasterizer, tile_cap=args.tile_cap, seed=args.seed)
    trainer = GSTrainer(views, cfg, init, model_path=args.model_path,
                        test_views=test_views, device=dev)
    if args.lpips_weights:
        trainer.set_lpips(load_params(args.lpips_weights))
    if completion_fn is None and args.svd_weights:
        from ..diffusion.pipeline import load_svd_completion
        completion_fn = load_svd_completion(args.svd_weights, dev,
                                            seed=args.seed,
                                            **svd_config(args))
    dcfg = DiffusionGSConfig(
        diffusion_width=args.diffusion_width,
        diffusion_height=args.diffusion_height,
        num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps,
        refine_cycle_num=args.refine_cycle_num,
        cam_confidence=args.cam_confidence,
        densify_type=args.densify_type,
        interp_type=args.interp_type,
        disable_densification=args.disable_densification,
        pseudo_cam_sampling_rate=args.pseudo_cam_sampling_rate,
        use_lpips_loss=bool(args.lpips_weights),
        num_views_for_pcd_densification=args.num_views_for_pcd_densification,
        fps_keyframe_sampling=bool(args.fps_keyframe_sampling),
        reorg_train_views=bool(args.reorg_train_views),
        save_debug=args.save_debug,
        seed=args.seed)
    dust3r_fn = flow_fn = None
    if args.dust3r_weights:
        from ..vision.dust3r import load_dust3r, make_dust3r_fn
        dust3r_fn = make_dust3r_fn(load_dust3r(
            load_params(args.dust3r_weights), dev))
    if args.gmflow_weights:
        from ..vision.gmflow_public import load_gmflow, make_flow_fn
        flow_fn = make_flow_fn(load_gmflow(load_params(args.gmflow_weights),
                                           dev))
    return DiffusionGS(trainer, dcfg, completion_fn=completion_fn,
                       dust3r_fn=dust3r_fn, flow_fn=flow_fn)


def main(argv=None):
    from ..gs.scene import load_colmap_scene

    args = build_parser().parse_args(argv)
    _check_ported(args)
    scene = load_colmap_scene(args.source_path, images_dir=args.images,
                              resolution=args.resolution,
                              n_views=args.n_views, llffhold=args.llffhold,
                              rand_pcd=args.rand_pcd, seed=args.seed)
    print(f"[scene] {len(scene.train_cameras)} train / "
          f"{len(scene.test_cameras)} test views, "
          f"{len(scene.points_xyz)} points")
    runner = build_runner(args, scene)
    runner.run(log_every=args.log_every)
    print(f"[done] checkpoints in {args.model_path}")
    return runner


if __name__ == "__main__":
    main()
