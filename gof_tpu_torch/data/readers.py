"""Scene/dataset readers: COLMAP and Blender (NeRF-synthetic); a copy of
gof_tpu/data/readers.py on the port's own modules.

Replaces scene/dataset_readers.py + utils/camera_utils.py. Semantics kept:
- every-8th-image eval split for COLMAP scenes (dataset_readers.py:153-155)
- cameras_extent = 1.1 * max distance from the average camera center
  (getNerfppNorm, dataset_readers.py:45-66)
- resolution rules: -r in {1,2,4,8} divides; -1 auto-caps width at 1600px
  (utils/camera_utils.py:20-55)
- Blender: transforms_{split}.json, OpenGL->COLMAP axis flip, alpha composite
  onto the background (dataset_readers.py:184-260)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
from PIL import Image

from .. import transforms
from . import colmap


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray  # camera-to-world rotation (COLMAP convention: w2v uses R^T)
    T: np.ndarray  # world-to-view translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int
    # for synthetic data the image may be preloaded
    image: Optional[np.ndarray] = None  # [H, W, 3] float32 in [0,1]
    alpha: Optional[np.ndarray] = None  # [H, W] float32 mask if present


@dataclass
class SceneInfo:
    point_cloud_xyz: np.ndarray
    point_cloud_rgb: np.ndarray  # float [0,1]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def _nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    centers = []
    for c in cam_infos:
        w2v = transforms.world_to_view(c.R, c.T)
        centers.append(np.linalg.inv(w2v)[:3, 3])
    centers = np.stack(centers)
    avg = centers.mean(axis=0)
    dist = np.linalg.norm(centers - avg, axis=1)
    radius = float(dist.max()) * 1.1
    return {"translate": -avg, "radius": radius}


def read_colmap_scene(path: str, images_dir: str = "images", eval_split: bool = False, llffhold: int = 8) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    cams, imgs, (xyz, rgb, _err) = colmap.load_model(sparse)

    cam_infos = []
    for idx, (img_id, im) in enumerate(sorted(imgs.items(), key=lambda kv: kv[1].name)):
        cam = cams[im.camera_id]
        R = colmap.qvec_to_rotmat(im.qvec).T  # stored transposed, as in the reference
        T = im.tvec
        if cam.model == "SIMPLE_PINHOLE":
            focal_x = focal_y = cam.params[0]
        elif cam.model == "PINHOLE":
            focal_x, focal_y = cam.params[0], cam.params[1]
        else:
            raise ValueError(
                f"Camera model {cam.model} not supported (undistort with convert.py first)"
            )
        fovx = transforms.focal_to_fov(focal_x, cam.width)
        fovy = transforms.focal_to_fov(focal_y, cam.height)
        cam_infos.append(
            CameraInfo(
                uid=idx, R=R, T=T, fovx=float(fovx), fovy=float(fovy),
                image_path=os.path.join(path, images_dir, im.name),
                image_name=os.path.splitext(im.name)[0],
                width=cam.width, height=cam.height,
            )
        )

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    return SceneInfo(
        point_cloud_xyz=xyz.astype(np.float32),
        point_cloud_rgb=(rgb.astype(np.float32) / 255.0),
        train_cameras=train,
        test_cameras=test,
        nerf_normalization=_nerfpp_norm(train),
        ply_path=os.path.join(path, "sparse/0/points3D.ply"),
    )


def read_blender_scene(path: str, white_background: bool, eval_split: bool = True, extension: str = ".png") -> SceneInfo:
    def read_split(transforms_file):
        with open(os.path.join(path, transforms_file)) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        infos = []
        for idx, frame in enumerate(meta["frames"]):
            c2w = np.array(frame["transform_matrix"])
            # OpenGL/Blender camera (Y up, Z back) -> COLMAP (Y down, Z fwd)
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]
            img_path = os.path.join(path, frame["file_path"] + extension)
            im = np.asarray(Image.open(img_path).convert("RGBA"), np.float32) / 255.0
            bg = 1.0 if white_background else 0.0
            rgb = im[..., :3] * im[..., 3:4] + bg * (1 - im[..., 3:4])
            H, W = im.shape[:2]
            fovy = transforms.focal_to_fov(transforms.fov_to_focal(fovx, W), H)
            infos.append(
                CameraInfo(
                    uid=idx, R=R, T=T, fovx=float(fovx), fovy=float(fovy),
                    image_path=img_path, image_name=os.path.basename(frame["file_path"]),
                    width=W, height=H, image=rgb.astype(np.float32), alpha=im[..., 3],
                )
            )
        return infos

    train = read_split("transforms_train.json")
    test = read_split("transforms_test.json") if (
        eval_split and os.path.exists(os.path.join(path, "transforms_test.json"))
    ) else []

    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        from ..utils import ply as ply_lib

        verts, _ = ply_lib.read_ply(ply_path)
        xyz = np.stack([verts["x"], verts["y"], verts["z"]], -1).astype(np.float32)
        if "red" in verts:
            rgb = np.stack([verts["red"], verts["green"], verts["blue"]], -1).astype(np.float32)
            if rgb.max() > 1.5:
                rgb = rgb / 255.0
        else:
            rgb = np.full_like(xyz, 0.5)
    else:
        # random init inside [-1.3, 1.3]^3 with random SH colors
        # (dataset_readers.py:221-233: 100k points)
        rng = np.random.default_rng(0)
        n = 100_000
        xyz = (rng.random((n, 3), dtype=np.float32) * 2.6 - 1.3).astype(np.float32)
        rgb = rng.random((n, 3)).astype(np.float32)
    return SceneInfo(
        point_cloud_xyz=xyz,
        point_cloud_rgb=rgb,
        train_cameras=train,
        test_cameras=test,
        nerf_normalization=_nerfpp_norm(train),
        ply_path=ply_path,
    )


def read_multiscale_scene(path: str, white_background: bool,
                          load_allres: bool = False) -> SceneInfo:
    """Multi-scale Blender scenes (metadata.json, dataset_readers.py:262-344):
    each split lists per-image file paths, c2w matrices, focals and sizes;
    train uses scale 0 only unless load_allres."""
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)

    def read_split(split, all_res):
        d = meta[split]
        infos = []
        n = len(d["file_path"])
        for idx in range(n):
            # multi-scale data stores 4 scales consecutively
            if not all_res and idx % 4 != 0 and split == "train":
                continue
            c2w = np.array(d["cam2world"][idx])
            c2w = c2w.copy()
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]
            W = int(d["width"][idx])
            H = int(d["height"][idx])
            focal = float(d["focal"][idx])
            fovx = transforms.focal_to_fov(focal, W)
            fovy = transforms.focal_to_fov(focal, H)
            img_path = os.path.join(path, d["file_path"][idx])
            im = np.asarray(Image.open(img_path).convert("RGBA"), np.float32) / 255.0
            bg = 1.0 if white_background else 0.0
            rgb = im[..., :3] * im[..., 3:4] + bg * (1 - im[..., 3:4])
            infos.append(
                CameraInfo(
                    uid=idx, R=R, T=T, fovx=float(fovx), fovy=float(fovy),
                    image_path=img_path,
                    image_name=os.path.basename(d["file_path"][idx]),
                    width=W, height=H, image=rgb.astype(np.float32), alpha=im[..., 3],
                )
            )
        return infos

    train = read_split("train", load_allres)
    test = read_split("test", True) if "test" in meta else []
    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        # optional explicit init cloud (same extension as the Blender
        # reader above; the real multi-scale datasets ship none)
        from ..utils import ply as ply_lib

        verts, _ = ply_lib.read_ply(ply_path)
        xyz = np.stack([verts["x"], verts["y"], verts["z"]], -1).astype(np.float32)
        if "red" in verts:
            rgb = np.stack([verts["red"], verts["green"], verts["blue"]], -1).astype(np.float32)
            if rgb.max() > 1.5:
                rgb = rgb / 255.0
        else:
            rgb = np.full_like(xyz, 0.5)
    else:
        rng = np.random.default_rng(0)
        n = 100_000
        xyz = (rng.random((n, 3), dtype=np.float32) * 2.6 - 1.3).astype(np.float32)
        rgb = rng.random((n, 3)).astype(np.float32)
    return SceneInfo(
        point_cloud_xyz=xyz, point_cloud_rgb=rgb,
        train_cameras=train, test_cameras=test,
        nerf_normalization=_nerfpp_norm(train),
        ply_path=ply_path,
    )


def detect_scene_type(path: str) -> str:
    if os.path.exists(os.path.join(path, "sparse")):
        return "colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "blender"
    if os.path.exists(os.path.join(path, "metadata.json")):
        return "multiscale"
    raise ValueError(f"Could not recognize scene type in {path}")


def _target_resolution(orig_w: int, orig_h: int, resolution: int):
    """The reference resolution rules (utils/camera_utils.py:20-55)."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / resolution), round(orig_h / resolution))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    return (int(orig_w / global_down), int(orig_h / global_down))


def load_image(info: CameraInfo, resolution: int = -1) -> np.ndarray:
    """Load and resize gt image per the reference resolution rules
    (utils/camera_utils.py:20-55). Returns [H, W, 3] float32."""
    if info.image is not None:
        img = Image.fromarray((info.image * 255).astype(np.uint8))
    else:
        img = Image.open(info.image_path).convert("RGB")
    orig_w, orig_h = img.size
    res = _target_resolution(orig_w, orig_h, resolution)
    if res != (orig_w, orig_h):
        img = img.resize(res, Image.LANCZOS)
    return np.asarray(img, np.float32) / 255.0


def load_alpha(info: CameraInfo, resolution: int = -1):
    """The view's alpha mask, resized like the image, or None. COLMAP-format
    datasets with RGBA images (e.g. preprocessed DTU) carry the mask in the
    4th channel (the reference's gt_alpha_mask, utils/camera_utils.py:29-43)."""
    if info.alpha is not None:
        a = Image.fromarray((np.asarray(info.alpha) * 255).astype(np.uint8))
    else:
        img = Image.open(info.image_path)
        if img.mode not in ("RGBA", "LA", "PA"):
            return None
        a = img.getchannel("A")
    orig_w, orig_h = a.size
    res = _target_resolution(orig_w, orig_h, resolution)
    if res != (orig_w, orig_h):
        a = a.resize(res, Image.LANCZOS)
    return np.asarray(a, np.float32) / 255.0
