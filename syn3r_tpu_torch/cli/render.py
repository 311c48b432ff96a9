"""Render entry point: a checkpoint's test views (and optionally an
interpolated camera path) as PNGs, the ``renders/`` and ``gt/`` folders
``cli/metrics.py`` reads.

Counterpart of ``syn3r_tpu/cli/render.py`` with the same flags, plus
``--device`` (``cuda`` by default, the composite kernels; ``cpu`` the plain
torch path)::

    python -m syn3r_tpu_torch.cli.render -s <scene> -m <model dir>

It reads the checkpoints of either package (``GSTrainer.load_checkpoint``)
and writes ``test/ours_<checkpoint name>/{renders,gt}/%05d.png``;
``--video`` also renders the slerp path through the train views into
``video/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def build_parser():
    p = argparse.ArgumentParser("syn3r-tpu-torch render")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file; default = newest in model_path")
    p.add_argument("--images", default="images")
    p.add_argument("--resolution", "-r", type=int, default=1)
    p.add_argument("--n_views", type=int, default=3)
    p.add_argument("--llffhold", type=int, default=8)
    p.add_argument("--video", action="store_true",
                   help="also render an interpolated camera path")
    p.add_argument("--video_frames", type=int, default=90)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain torch path)")
    return p


def save_png(img, path: str):
    """An (H, W, 3) image in [0, 1] as an 8-bit PNG, truncated as the JAX
    package writes it."""
    import numpy as np
    import torch
    from PIL import Image
    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) \
        else np.asarray(img)
    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from ..device import resolve_device
    from ..gs.scene import load_colmap_scene
    from ..gs.trainer import GSTrainer, TrainConfig, make_viewset
    from ..models import gaussians as G
    from ..utils import se3

    dev = resolve_device(args.device)
    scene = load_colmap_scene(args.source_path, images_dir=args.images,
                              resolution=args.resolution,
                              n_views=args.n_views, llffhold=args.llffhold)
    views = make_viewset(scene.train_cameras, scene.train_images)
    init = G.from_points(torch.as_tensor(scene.points_xyz, device=dev),
                         torch.as_tensor(scene.points_rgb, device=dev))
    tr = GSTrainer(views, TrainConfig(), init, model_path=args.model_path,
                   device=dev)
    ckpt = args.checkpoint or tr.latest_checkpoint()
    if ckpt is None:
        raise SystemExit(f"no checkpoint found in {args.model_path}")
    tr.load_checkpoint(ckpt)
    name = os.path.splitext(os.path.basename(ckpt))[0]

    out_dir = os.path.join(args.model_path, "test", f"ours_{name}")
    os.makedirs(os.path.join(out_dir, "renders"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "gt"), exist_ok=True)
    for i, cam in enumerate(scene.test_cameras):
        save_png(tr.render_view(cam)["render"],
                 os.path.join(out_dir, "renders", f"{i:05d}.png"))
        save_png(scene.test_images[i],
                 os.path.join(out_dir, "gt", f"{i:05d}.png"))
    print(f"[render] {len(scene.test_cameras)} test views -> {out_dir}")

    if args.video:
        vid_dir = os.path.join(out_dir, "video")
        os.makedirs(vid_dir, exist_ok=True)
        cams = scene.train_cameras
        k = 0
        per_seg = max(args.video_frames // max(len(cams) - 1, 1), 2)
        for a in range(len(cams) - 1):
            poses = se3.interpolate_poses(cams[a].w2c, cams[a + 1].w2c,
                                          per_seg)
            for p in poses[:-1]:
                cam = dataclasses.replace(cams[0], w2c=p)
                save_png(tr.render_view(cam)["render"],
                         os.path.join(vid_dir, f"{k:05d}.png"))
                k += 1
        print(f"[render] video path: {k} frames -> {vid_dir}")
    return out_dir


if __name__ == "__main__":
    main()
