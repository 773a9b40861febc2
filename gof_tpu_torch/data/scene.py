"""Scene container and Gaussian PLY snapshots (counterpart of
gof_tpu/data/scene.py).

The PLY fields are gof_tpu's (scene.py:111-177): x y z, nx ny nz, f_dc_*,
f_rest_* (channel-major), opacity, scale_*, rot_*, filter_3D — so a model
saved by either package loads in the other.
"""

from __future__ import annotations

import json
import os
import random
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import cameras as cameras_lib
from ..model import gaussians as gm
from ..utils import ply
from . import readers


class Scene:
    def __init__(
        self,
        source_path: str,
        model_path: str,
        images: str = "images",
        resolution: int = -1,
        white_background: bool = False,
        eval_split: bool = False,
        shuffle: bool = True,
        load_allres: bool = False,
    ):
        self.source_path = source_path
        self.model_path = model_path
        kind = readers.detect_scene_type(source_path)
        if kind == "colmap":
            info = readers.read_colmap_scene(source_path, images, eval_split)
        elif kind == "multiscale":
            info = readers.read_multiscale_scene(source_path, white_background,
                                                 load_allres=load_allres)
        else:
            info = readers.read_blender_scene(source_path, white_background, eval_split=True)
        self.info = info
        self.resolution = resolution
        self.cameras_extent = info.nerf_normalization["radius"]

        self.train_cameras: List[readers.CameraInfo] = list(info.train_cameras)
        self.test_cameras: List[readers.CameraInfo] = list(info.test_cameras)
        if shuffle:
            random.shuffle(self.train_cameras)

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            cams_json = [
                {
                    "id": c.uid, "img_name": c.image_name, "width": c.width, "height": c.height,
                    "fovx": c.fovx, "fovy": c.fovy,
                    "rotation": np.asarray(c.R).tolist(), "position": (-c.R @ c.T).tolist(),
                }
                for c in self.train_cameras + self.test_cameras
            ]
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump(cams_json, f)

    def camera(self, info: readers.CameraInfo,
               device: torch.device | str = "cpu") -> Tuple[cameras_lib.Camera, np.ndarray]:
        """(Camera on `device`, gt image [3, H, W] float32 numpy)."""
        img = readers.load_image(info, self.resolution)
        H, W = img.shape[:2]
        cam = cameras_lib.make_camera(info.R, info.T, info.fovx, info.fovy, W, H,
                                      uid=info.uid, device=device)
        return cam, np.transpose(img, (2, 0, 1))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_gaussians_ply(path: str, params: gm.GaussianParams, state: gm.GaussianState,
                       sh_degree: int) -> None:
    """Write the active Gaussians with gof_tpu's PLY fields."""
    idx = np.nonzero(_host(state.active))[0]
    xyz = _host(params.xyz)[idx]
    f_dc = _host(params.features_dc)[idx].reshape(len(idx), -1)  # [N, 3]
    f_rest = _host(params.features_rest)[idx]  # [N, K-1, 3]
    # the reference stores rest coefficients channel-major (K-1 per channel)
    f_rest_flat = f_rest.transpose(0, 2, 1).reshape(len(idx), -1)
    props = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    props.update({"nx": np.zeros(len(idx)), "ny": np.zeros(len(idx)), "nz": np.zeros(len(idx))})
    for i in range(f_dc.shape[1]):
        props[f"f_dc_{i}"] = f_dc[:, i]
    for i in range(f_rest_flat.shape[1]):
        props[f"f_rest_{i}"] = f_rest_flat[:, i]
    props["opacity"] = _host(params.opacity)[idx]
    sc = _host(params.scaling)[idx]
    for i in range(3):
        props[f"scale_{i}"] = sc[:, i]
    rot = _host(params.rotation)[idx]
    for i in range(4):
        props[f"rot_{i}"] = rot[:, i]
    props["filter_3D"] = _host(state.filter_3d)[idx]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ply.write_ply(path, props)


def load_gaussians_ply(path: str, sh_degree: int, capacity: Optional[int] = None,
                       device: torch.device | str = "cpu"):
    """Read a Gaussian PLY into padded (GaussianParams, GaussianState) on
    `device`; padding slots are inactive, as in gof_tpu."""
    verts, _ = ply.read_ply(path)
    n = len(verts["x"])
    K = (sh_degree + 1) ** 2
    cap = capacity or max(1, n)
    xyz = np.stack([verts["x"], verts["y"], verts["z"]], -1).astype(np.float32)
    f_dc = np.stack([verts[f"f_dc_{i}"] for i in range(3)], -1).astype(np.float32)[:, None, :]
    n_rest = 3 * (K - 1)
    if n_rest and "f_rest_0" in verts:
        fr = np.stack([verts[f"f_rest_{i}"] for i in range(n_rest)], -1).astype(np.float32)
        f_rest = fr.reshape(n, 3, K - 1).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, K - 1, 3), np.float32)
    scaling = np.stack([verts[f"scale_{i}"] for i in range(3)], -1).astype(np.float32)
    rotation = np.stack([verts[f"rot_{i}"] for i in range(4)], -1).astype(np.float32)
    opacity = np.asarray(verts["opacity"], np.float32)
    filt = np.asarray(verts.get("filter_3D", np.full(n, 1e-4)), np.float32)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    rot = pad(rotation)
    rot[n:, 0] = 1.0
    z = np.zeros((cap,), np.float32)
    params = gm.GaussianParams(
        xyz=pad(xyz), features_dc=pad(f_dc), features_rest=pad(f_rest),
        scaling=pad(scaling, -10.0), rotation=rot, opacity=pad(opacity),
    )
    state = gm.GaussianState(
        active=np.arange(cap) < n, filter_3d=pad(filt, 1e-4),
        max_radii2d=z, grad_accum=z, grad_abs_accum=z, denom=z,
    )
    return gm.from_numpy(params, state, device)
