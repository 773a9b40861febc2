"""COLMAP binary/text model parsing (counterpart of gof_tpu/data/colmap.py).

Replaces scene/colmap_loader.py (294 LoC): cameras.bin/txt, images.bin/txt,
points3D.bin/txt readers. Same data model; implemented with struct/numpy
bulk reads rather than per-record torch ops. Binary models are read by the
native C++ reader (gof_tpu_torch/native, built with g++ at first use) when
it loads, by the Python parsers otherwise; the first read says which.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

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


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(fmt, f):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            cam_id, model_id, w, h = _read("<iiQQ", f)
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{np_}d", f))
            cams[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            vals = _read("<idddddddi", f)
            img_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            cam_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read("<Q", f)
            f.seek(24 * n2d, os.SEEK_CUR)  # skip 2D points (x, y, p3d_id)
            imgs[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name.decode())
    return imgs


def read_points3d_binary(path: str):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, errors (N,))."""
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty((n,))
        for i in range(n):
            v = _read("<QdddBBBd", f)
            xyz[i] = v[1:4]
            rgb[i] = v[4:7]
            err[i] = v[7]
            (tl,) = _read("<Q", f)
            f.seek(8 * tl, os.SEEK_CUR)
    return xyz, rgb, err


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            cams[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]), np.array([float(x) for x in el[4:]])
            )
    return cams


def read_images_text(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        lines = [l for l in f if not l.startswith("#") and l.strip()]
    for i in range(0, len(lines), 2):  # every image has a second 2D-points line
        el = lines[i].split()
        imgs[int(el[0])] = ColmapImage(
            int(el[0]),
            np.array([float(x) for x in el[1:5]]),
            np.array([float(x) for x in el[5:8]]),
            int(el[8]),
            el[9],
        )
    return imgs


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([int(x) for x in el[4:7]])
            err.append(float(el[7]))
    return np.array(xyz), np.array(rgb, np.uint8), np.array(err)


_READER_SAID = False


def _say_reader(native: bool) -> None:
    global _READER_SAID
    if not _READER_SAID:
        _READER_SAID = True
        print("COLMAP reader: " + ("native (gof_tpu_torch/native)" if native
                                   else "Python parsers (the native reader did not load)"))


def load_model(sparse_dir: str):
    """Load (cameras, images, points) from a COLMAP sparse dir, preferring
    binary (scene/dataset_readers.py:140-150). Uses the native C++ reader
    when it loads; falls back to the Python parsers."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        native = _load_model_native(sparse_dir)
        _say_reader(native is not None)
        if native is not None:
            return native
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        pts = read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
        pts = read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, pts


def _load_model_native(sparse_dir: str):
    from .. import native

    rc = native.read_cameras_native(os.path.join(sparse_dir, "cameras.bin"))
    ri = native.read_images_native(os.path.join(sparse_dir, "images.bin"))
    rp = native.read_points3d_native(os.path.join(sparse_dir, "points3D.bin"))
    if rc is None or ri is None or rp is None:
        return None
    cam_ids, models, wh, params = rc
    model_names = {k: v[0] for k, v in CAMERA_MODELS.items()}
    cams = {
        int(cid): ColmapCamera(
            int(cid), model_names.get(int(m), "UNKNOWN"), int(w), int(h),
            np.asarray(p[: CAMERA_MODELS.get(int(m), ("", 12))[1]]),
        )
        for cid, m, (w, h), p in zip(cam_ids, models, wh, params)
    }
    ids, qvec, tvec, img_cam_ids, names = ri
    imgs = {
        int(i): ColmapImage(int(i), qvec[k], tvec[k], int(img_cam_ids[k]), names[k])
        for k, i in enumerate(ids)
    }
    return cams, imgs, rp
