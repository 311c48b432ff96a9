"""Scene loading: COLMAP sparse reconstructions with LLFF/DTU conventions.

Counterpart of ``syn3r_tpu/gs/scene.py``: ``--source_path`` with
``sparse/0`` (or ``sparse``) and an images directory, ``--resolution``
downscale, the llffhold test split (every k-th image by name), ``--n_views``
training views spaced evenly over the train split, the initial point cloud
from points3D or uniform random points (``--rand_pcd``). Cameras are the
port's ``Camera`` on the CPU; images float32 numpy in [0, 1].
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..utils import colmap
from ..utils.camera import Camera, make_camera


@dataclasses.dataclass
class SceneData:
    train_cameras: list[Camera]
    train_images: np.ndarray          # (V, H, W, 3) float32 [0,1]
    test_cameras: list[Camera]
    test_images: np.ndarray
    points_xyz: Optional[np.ndarray]  # (N, 3)
    points_rgb: Optional[np.ndarray]  # (N, 3) [0,1]


def _load_image(path: str, resolution: int) -> np.ndarray:
    from PIL import Image
    img = Image.open(path)
    if resolution > 1:
        img = img.resize((img.width // resolution, img.height // resolution),
                         Image.LANCZOS)
    return np.asarray(img.convert("RGB"), np.float32) / 255.0


def load_colmap_scene(source_path: str, images_dir: str = "images",
                      resolution: int = 1, n_views: int = 0,
                      llffhold: int = 8, rand_pcd: bool = False,
                      rand_points: int = 100_000,
                      seed: int = 0) -> SceneData:
    """Load a COLMAP scene. n_views > 0 keeps that many training views,
    evenly spaced over the train split; every llffhold-th image (sorted by
    name) is a test view."""
    sparse = os.path.join(source_path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_path, "sparse")
    cams, imgs, pts = colmap.read_model(sparse)

    order = sorted(imgs.keys(), key=lambda k: imgs[k].name)
    test_idx = set(order[i] for i in range(0, len(order), llffhold)) \
        if llffhold > 0 and len(order) > llffhold else set()
    train_ids = [k for k in order if k not in test_idx]
    test_ids = [k for k in order if k in test_idx]
    if 0 < n_views < len(train_ids):
        sel = np.linspace(0, len(train_ids) - 1, n_views).round().astype(int)
        train_ids = [train_ids[i] for i in sel]

    img_root = os.path.join(source_path, images_dir)

    def build(ids):
        cameras, images = [], []
        for k in ids:
            im = imgs[k]
            cam_model = cams[im.camera_id]
            path = os.path.join(img_root, im.name)
            if not os.path.exists(path):
                base = os.path.splitext(im.name)[0]
                for ext in (".png", ".jpg", ".JPG", ".jpeg"):
                    if os.path.exists(os.path.join(img_root, base + ext)):
                        path = os.path.join(img_root, base + ext)
                        break
            arr = _load_image(path, resolution)
            h, w = arr.shape[:2]
            # intrinsics from the calibration resolution to the loaded one
            K0 = cam_model.K()
            sx, sy = w / cam_model.width, h / cam_model.height
            K = np.array([[K0[0, 0] * sx, 0, K0[0, 2] * sx],
                          [0, K0[1, 1] * sy, K0[1, 2] * sy],
                          [0, 0, 1]], np.float32)
            cameras.append(make_camera(K, im.w2c().astype(np.float32), w, h))
            images.append(arr)
        return cameras, (np.stack(images) if images else
                         np.zeros((0, 1, 1, 3), np.float32))

    train_cams, train_imgs = build(train_ids)
    test_cams, test_imgs = build(test_ids)

    if rand_pcd or pts is None or len(pts.xyz) == 0:
        rng = np.random.default_rng(seed)
        # uniform points in the bounding volume of the camera centres
        centers = np.stack([c.position.numpy() for c in train_cams])
        lo = centers.min(0) - 1.0
        hi = centers.max(0) + 3.0
        xyz = rng.uniform(lo, hi, (rand_points, 3)).astype(np.float32)
        rgb = rng.uniform(0, 1, (rand_points, 3)).astype(np.float32)
    else:
        xyz = pts.xyz.astype(np.float32)
        rgb = pts.rgb.astype(np.float32) / 255.0

    return SceneData(train_cameras=train_cams, train_images=train_imgs,
                     test_cameras=test_cams, test_images=test_imgs,
                     points_xyz=xyz, points_rgb=rgb)
