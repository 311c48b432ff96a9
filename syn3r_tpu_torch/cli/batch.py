"""Batch runner: the reference's bash-script layer over a dataset.

Counterpart of ``syn3r_tpu/cli/batch.py``: loops the scenes of a dataset
with the per-dataset flags the reference hard-codes in its shell scripts
(``PRESETS``), skips a scene whose final checkpoint exists, then with
``--eval`` renders every checkpoint of every scene, evaluates it and
prints the summary::

    python -m syn3r_tpu_torch.cli.batch --dataset llff \\
        --data_root <scenes> --out_root <models> [--parallel N] [--eval]

Presets:
  llff : 3 views, 2PassProbUncertainPost, cam_confidence 0.05, no DUSt3R
  dtu  : 3 views, 2PassProbUncertain, loop0 densify (N-1 pairs),
         lambda_dssim 0.5, resolution 4
  dl3dv: 9 views, 2PassProbUncertainPost, cam_confidence 0.2, rand_pcd,
         images_4, DUSt3R pcd densification

``--parallel N`` runs N ``syn3r_tpu_torch.cli.train`` subprocesses at a
time, worker slot i pinned to one card with ``CUDA_VISIBLE_DEVICES`` (the
i-th of the cards this process sees, or card i). Scenes share nothing but
the kernel build directory, which ``kernels/build.py`` writes by atomic
renames. ``--device`` goes to every train, render and metrics call.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time

PRESETS = {
    "llff": ["--n_views", "3", "--diffusion_type", "2PassProbUncertainPost",
             "--cam_confidence", "0.05", "--pseudo_cam_sampling_rate",
             "0.02", "--refine_cycle_num", "2",
             "--num_views_for_pcd_densification", "1",
             "--sample_svd_pseudo_interval", "1",
             "--start_sample_svd_frame", "2000",
             "--svd_depth_warmup", "1",
             "--use_proximity_densify", "0",
             "--densify_grad_threshold", "0.0002",
             "--percent_dense", "0.001"],
    "dtu": ["--n_views", "3", "--diffusion_type", "2PassProbUncertain",
            "--densify_type", "interpolate_loop0_gs",
            "--cam_confidence", "0.05", "--lambda_dssim", "0.5",
            "--sample_svd_pseudo_interval", "1",
            "--resolution", "4", "--refine_cycle_num", "2"],
    "dl3dv": ["--n_views", "9", "--diffusion_type",
              "2PassProbUncertainPost", "--cam_confidence", "0.2",
              "--rand_pcd", "--images", "images_4",
              "--num_views_for_pcd_densification", "4",
              "--fps_keyframe_sampling", "1",
              "--sample_svd_pseudo_interval", "1",
              "--svd_depth_warmup", "1",
              "--use_proximity_densify", "0",
              "--densify_grad_threshold", "0.0002",
              "--percent_dense", "0.001",
              "--refine_cycle_num", "2"],
}

LLFF_SCENES = ["fern", "flower", "fortress", "horns", "leaves", "orchids",
               "room", "trex"]

# the 10 DL3DV-10K scene hashes the reference evaluates on
# (bash_scripts/batch_dl3dv_train.sh:30-41)
DL3DV_SCENES = [
    "03f5c560f5725ad6ca55fd7e6c0af4c4c7a7ca94c444a584f2a9f316d3b35ea2",
    "25f7dbc10c0e2a9a8ffa33c35660d9090b6f7df6478653e351b3cb1195f7347b",
    "6ed1058f96df97f1c8175739843cf0f272ce0c60c5727dbb010a3a0fac3ef10d",
    "0850228cdbf7df721a10d73003db4b8d9d83e17c480b79a6d5d643eff6c8c163",
    "0a78c25f77c1ba1d1a3f07c18c9735ae1254a9a71290734b8836eefbefaadbc7",
    "51a802f3dc0268da35ad944e92cc7266fef00680816eb30d5847d5845b3e867a",
    "87c8b2841c276f00d10c53c32ffe628fb26fa3d2cd3ab7bb577ff25d31ee5dbd",
    "97f72cff0be96647eeb2fe17ac49752c739af5d1cda656b52e83917a4b2bc17d",
    "9daa05c4182bb2ea065d280d4f510929d8e9c6d6e18a0782031c7c805cb822ec",
    "9e4da70fe0be5d28ea7b375291bbf5523246345d807aa47d5208c6e6c2f5694c",
]


def main(argv=None):
    p = argparse.ArgumentParser("syn3r-tpu-torch batch")
    p.add_argument("--dataset", choices=list(PRESETS), required=True)
    p.add_argument("--data_root", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--scenes", nargs="*", default=None,
                   help="default: all subdirs (llff: the standard 8)")
    p.add_argument("--eval", action="store_true",
                   help="render + metrics after each scene")
    p.add_argument("--parallel", type=int, default=0,
                   help="run N training subprocesses at a time, one card "
                        "each (0 = in-process, one scene after another)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain torch path)")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="extra flags forwarded to cli.train")
    args = p.parse_args(argv)

    scenes = args.scenes
    if not scenes:
        if args.dataset == "llff":
            scenes = [s for s in LLFF_SCENES
                      if os.path.isdir(os.path.join(args.data_root, s))]
        elif args.dataset == "dl3dv" and any(
                os.path.isdir(os.path.join(args.data_root, s))
                for s in DL3DV_SCENES):
            scenes = [s for s in DL3DV_SCENES
                      if os.path.isdir(os.path.join(args.data_root, s))]
        else:
            scenes = sorted(d for d in os.listdir(args.data_root)
                            if os.path.isdir(os.path.join(args.data_root, d)))

    def scene_paths(scene):
        return (os.path.join(args.data_root, scene),
                os.path.join(args.out_root, scene))

    todo = []
    for scene in scenes:
        _, out = scene_paths(scene)
        if os.path.exists(os.path.join(out, "refine_1_chkpnt10000.npz")):
            print(f"[batch] skip {scene}: final checkpoint exists")
        else:
            todo.append(scene)

    device = ["--device", args.device]
    train_flags = PRESETS[args.dataset] + device + list(args.extra)
    if args.parallel > 0:
        _run_fleet(todo, scene_paths, train_flags, args.parallel)
    else:
        from . import train as train_cli
        for scene in todo:
            src, out = scene_paths(scene)
            print(f"[batch] === {scene} ===")
            train_cli.main(["-s", src, "-m", out] + train_flags)

    if args.eval:
        from . import metrics as metrics_cli
        from . import render as render_cli
        from .summarize import summarize
        for scene in scenes:
            src, out = scene_paths(scene)
            if os.path.exists(os.path.join(out, "eval_res.txt")):
                continue
            # every checkpoint (the initial fit and each refine cycle), as
            # the reference's eval loop renders each ``chkpnt`` file
            ckpts = sorted(
                glob.glob(os.path.join(out, "chkpnt*.npz"))
                + glob.glob(os.path.join(out, "refine_*_chkpnt*.npz")))
            ckpts = [c for c in ckpts if not c.endswith("chkpnt_latest.npz")]
            for c in ckpts or [None]:
                cargs = ["-s", src, "-m", out] + device
                if c:
                    cargs += ["--checkpoint", c]
                render_cli.main(cargs)
            metrics_cli.main(["-m", out] + device)
        print(summarize(args.out_root))


def _worker_devices(n_workers: int) -> list[str]:
    """The ``CUDA_VISIBLE_DEVICES`` of each worker slot: the cards this
    process sees, in order and round robin, or card i for slot i."""
    seen = [d.strip() for d in
            os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
            if d.strip()]
    return [seen[i % len(seen)] if seen else str(i)
            for i in range(n_workers)]


def _run_fleet(scenes, scene_paths, train_flags, n_workers: int):
    """A bounded pool of ``cli.train`` subprocesses, worker slot i pinned to
    its card by ``CUDA_VISIBLE_DEVICES``; each logs to ``<out>/log.txt``.
    Raises SystemExit naming the scenes whose worker failed."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    devices = _worker_devices(n_workers)
    pending = list(scenes)
    running: dict = {}                     # slot -> (proc, scene, log)
    failed = []
    while pending or running:
        while pending and len(running) < n_workers:
            slot = next(i for i in range(n_workers) if i not in running)
            scene = pending.pop(0)
            src, out = scene_paths(scene)
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=devices[slot])
            env["PYTHONPATH"] = os.pathsep.join(
                [root] + [v for v in [env.get("PYTHONPATH")] if v])
            os.makedirs(out, exist_ok=True)
            log = open(os.path.join(out, "log.txt"), "a")
            proc = subprocess.Popen(
                [sys.executable, "-m", "syn3r_tpu_torch.cli.train",
                 "-s", src, "-m", out] + train_flags,
                stdout=log, stderr=subprocess.STDOUT, env=env)
            running[slot] = (proc, scene, log)
            print(f"[batch] slot {slot} (card {devices[slot]}): {scene} "
                  f"(pid {proc.pid})")
        done_slot = None
        for slot, (proc, scene, log) in running.items():
            rc = proc.poll()
            if rc is not None:
                log.close()
                print(f"[batch] slot {slot}: {scene} exited rc={rc}")
                if rc != 0:
                    failed.append(scene)
                done_slot = slot
                break
        if done_slot is not None:
            del running[done_slot]
        else:
            time.sleep(1.0)
    if failed:
        raise SystemExit(f"[batch] failed scenes: {failed}")


if __name__ == "__main__":
    main()
