"""COLMAP sparse-reconstruction I/O (text + binary), pure Python.

The port's own copy of ``syn3r_tpu/utils/colmap.py`` (numpy only, so the
port imports nothing of the JAX package): the readers of the reference's
``solver_utils/colmap_loader.py`` (:83-340) and its binary writers
(:167-191, 253-267, 299-311), written from the public COLMAP file-format
specification (https://colmap.github.io/format.html).

Used by scene loading (cameras.bin / images.bin / points3D.bin);
``write_points3d_binary`` writes a point cloud for it.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Sequence

import numpy as np

# camera model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific

    def K(self) -> np.ndarray:
        """3x3 intrinsic matrix (pinhole family; radial distortion ignored)."""
        p = self.params
        if self.model == "SIMPLE_PINHOLE" or self.model == "SIMPLE_RADIAL":
            f, cx, cy = p[0], p[1], p[2]
            fx = fy = f
        elif self.model in ("PINHOLE", "OPENCV"):
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        elif self.model == "RADIAL":
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:
            raise ValueError(f"unsupported camera model {self.model}")
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray   # (4,) wxyz, world->cam rotation
    tvec: np.ndarray   # (3,) world->cam translation
    camera_id: int
    name: str
    xys: np.ndarray    # (N, 2)
    point3d_ids: np.ndarray  # (N,)

    def w2c(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = qvec_to_rotmat(self.qvec)
        m[:3, 3] = self.tvec
        return m


@dataclasses.dataclass
class ColmapPoints3D:
    xyz: np.ndarray     # (N, 3) float64
    rgb: np.ndarray     # (N, 3) uint8
    error: np.ndarray   # (N,)


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(m: np.ndarray) -> np.ndarray:
    # Shepperd's method, numpy double precision
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                      (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                      0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                      (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    if q[0] < 0:
        q = -q
    return q


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * num_params))
            cams[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cams


def write_cameras_binary(cams: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            cams[cam_id] = ColmapCamera(cam_id, model, int(parts[2]),
                                        int(parts[3]),
                                        np.array([float(p) for p in parts[4:]]))
    return cams


def write_cameras_text(cams: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cams.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------

def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (img_id,) = _read(f, "<i")
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            (cam_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.array(_read(f, "<" + "ddq" * npts)).reshape(npts, 3) \
                if npts else np.zeros((0, 3))
            imgs[img_id] = ColmapImage(img_id, qvec, tvec, cam_id,
                                       name.decode("utf-8"),
                                       data[:, :2].astype(np.float64),
                                       data[:, 2].astype(np.int64))
    return imgs


def write_images_binary(imgs: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.xys)
            f.write(struct.pack("<Q", n))
            for (x, y), pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(p) for p in pts]).reshape(-1, 3) \
            if pts else np.zeros((0, 3))
        imgs[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name,
                                   xys[:, :2], xys[:, 2].astype(np.int64))
    return imgs


# ---------------------------------------------------------------------------
# points3D
# ---------------------------------------------------------------------------

def read_points3d_binary(path: str) -> ColmapPoints3D:
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.zeros((n, 3))
        rgb = np.zeros((n, 3), np.uint8)
        err = np.zeros(n)
        for i in range(n):
            (_pid,) = _read(f, "<Q")
            xyz[i] = _read(f, "<ddd")
            rgb[i] = _read(f, "<BBB")
            (err[i],) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)  # skip track (image_id, point2D_idx) pairs
    return ColmapPoints3D(xyz, rgb, err)


def write_points3d_binary(pts: ColmapPoints3D, path: str) -> None:
    n = len(pts.xyz)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<Q", i + 1))
            f.write(struct.pack("<ddd", *pts.xyz[i]))
            f.write(struct.pack("<BBB", *pts.rgb[i].astype(np.uint8)))
            f.write(struct.pack("<d", float(pts.error[i])))
            f.write(struct.pack("<Q", 0))  # empty track


def read_points3d_text(path: str) -> ColmapPoints3D:
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(v) for v in p[1:4]])
            rgb.append([int(v) for v in p[4:7]])
            err.append(float(p[7]))
    return ColmapPoints3D(np.array(xyz), np.array(rgb, np.uint8),
                          np.array(err))


def read_model(sparse_dir: str):
    """Read (cameras, images, points3D) from a COLMAP sparse dir, preferring
    binary files."""
    def pick(base):
        b = os.path.join(sparse_dir, base + ".bin")
        t = os.path.join(sparse_dir, base + ".txt")
        return (b, True) if os.path.exists(b) else (t, False)

    cpath, cbin = pick("cameras")
    ipath, ibin = pick("images")
    ppath, pbin = pick("points3D")
    cams = read_cameras_binary(cpath) if cbin else read_cameras_text(cpath)
    imgs = read_images_binary(ipath) if ibin else read_images_text(ipath)
    pts = None
    if os.path.exists(ppath):
        pts = read_points3d_binary(ppath) if pbin else read_points3d_text(ppath)
    return cams, imgs, pts
