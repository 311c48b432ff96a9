"""Point-cloud bootstrap: posed RGB-D views -> a COLMAP ``points3D.bin``.

Counterpart of ``syn3r_tpu/cli/generate_pcd.py`` (the reference's
``scripts/generate_pcd_for_gs.py`` surface): each image and its ``.npy``
depth are unprojected every ``--stride`` pixels with the camera of the
COLMAP model, merged (optionally one point a voxel), cleaned by the
statistical outlier removal and written as COLMAP points::

    python -m syn3r_tpu_torch.cli.generate_pcd --images a.png b.png \\
        --depths a.npy b.npy --sparse_dir <scene>/sparse/0 \\
        --out points3D.bin [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..utils import colmap
from ..utils.camera import unproject
from ..utils.pcd import remove_statistical_outliers
from ..utils.se3 import se3_inverse


def depth_to_pointcloud(image01: np.ndarray, depth: np.ndarray,
                        K: np.ndarray, w2c: np.ndarray, stride: int = 2,
                        max_depth: float = 100.0):
    """(H, W, 3) colours in [0, 1] and an (H, W) depth -> world points and
    their colours, every stride-th pixel with 1e-4 < z < max_depth."""
    d = torch.as_tensor(np.asarray(depth[::stride, ::stride], np.float32))
    rgb = image01[::stride, ::stride].reshape(-1, 3)
    Ks = np.asarray(K, np.float32).copy()
    Ks[:2] /= stride
    pts_cam = unproject(d, torch.as_tensor(Ks)).reshape(-1, 3).numpy()
    valid = (pts_cam[:, 2] > 1e-4) & (pts_cam[:, 2] < max_depth)
    c2w = se3_inverse(torch.as_tensor(np.asarray(w2c, np.float32))).numpy()
    pts_w = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    return pts_w[valid], rgb[valid]


def merge_views(views, voxel: float = 0.0):
    """views: a list of (xyz, rgb). With ``voxel`` > 0, the first point of
    each occupied voxel (np.unique order)."""
    xyz = np.concatenate([v[0] for v in views])
    rgb = np.concatenate([v[1] for v in views])
    if voxel > 0 and len(xyz):
        keys = np.floor(xyz / voxel).astype(np.int64)
        _, idx = np.unique(keys, axis=0, return_index=True)
        xyz, rgb = xyz[idx], rgb[idx]
    return xyz, rgb


def write_colmap_points(xyz: np.ndarray, rgb01: np.ndarray, path: str):
    colmap.write_points3d_binary(colmap.ColmapPoints3D(
        xyz.astype(np.float64),
        np.clip(rgb01 * 255.0, 0, 255).astype(np.uint8),
        np.zeros(len(xyz))), path)


def main(argv=None):
    p = argparse.ArgumentParser("syn3r-tpu-torch generate-pcd")
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--depths", nargs="+", required=True,
                   help=".npy depth maps matching --images")
    p.add_argument("--sparse_dir", required=True,
                   help="COLMAP sparse dir providing cameras + poses")
    p.add_argument("--out", required=True, help="output points3D.bin")
    p.add_argument("--stride", type=int, default=2)
    p.add_argument("--voxel", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="where the outlier removal's neighbour search runs")
    args = p.parse_args(argv)

    from PIL import Image

    from ..device import resolve_device
    dev = resolve_device(args.device)
    cams, imgs, _ = colmap.read_model(args.sparse_dir)
    by_name = {im.name: im for im in imgs.values()}
    views = []
    for img_path, depth_path in zip(args.images, args.depths):
        im = by_name[os.path.basename(img_path)]
        rgb = np.asarray(Image.open(img_path).convert("RGB"),
                         np.float32) / 255.0
        views.append(depth_to_pointcloud(rgb, np.load(depth_path),
                                         cams[im.camera_id].K(), im.w2c(),
                                         stride=args.stride))
    xyz, rgb = merge_views(views, voxel=args.voxel)
    xyz, rgb = remove_statistical_outliers(xyz, rgb, device=dev)
    write_colmap_points(xyz, rgb, args.out)
    print(f"[pcd] wrote {len(xyz)} points -> {args.out}")


if __name__ == "__main__":
    main()
