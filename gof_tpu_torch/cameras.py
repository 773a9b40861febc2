"""Camera (counterpart of gof_tpu/cameras.py).

A `Camera` is a dataclass of tensors on one device; the image size is plain
ints. Matrices are assembled in numpy exactly as gof_tpu assembles them, so
both packages see bit-identical cameras.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from . import transforms
from .constants import CAMERA_ZFAR, CAMERA_ZNEAR
from .utils import trace


@dataclass
class Camera:
    width: int
    height: int
    world_view: torch.Tensor  # (4,4) world -> view
    full_proj: torch.Tensor  # (4,4) proj @ world_view
    cam_center: torch.Tensor  # (3,) camera position in world space
    tan_fovx: torch.Tensor  # 0-d f32
    tan_fovy: torch.Tensor  # 0-d f32
    uid: int = 0

    # `int / tensor` would run as reciprocal-then-multiply in torch and round
    # twice; divide two f32 tensors to round once, as gof_tpu does
    @property
    def focal_x(self) -> torch.Tensor:
        with trace.copy("focal"):
            w = self.tan_fovx.new_tensor(float(self.width))
        return w / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        with trace.copy("focal"):
            h = self.tan_fovy.new_tensor(float(self.height))
        return h / (2.0 * self.tan_fovy)

    def to(self, device: torch.device | str) -> Camera:
        """This camera with its matrices on `device` (numpy arrays taken as
        they are)."""
        return replace(self, **{f: torch.as_tensor(getattr(self, f), device=device)
                                for f in TENSOR_FIELDS})

    def numpy(self) -> Camera:
        """This camera with its matrices as host numpy arrays, for a process
        boundary; .to(device) turns it back."""
        return replace(self, **{f: getattr(self, f).detach().cpu().numpy() for f in TENSOR_FIELDS})


TENSOR_FIELDS = ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy")


def make_camera(
    R: np.ndarray,
    t: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    uid: int = 0,
    znear: float = CAMERA_ZNEAR,
    zfar: float = CAMERA_ZFAR,
    device: torch.device | str = "cpu",
) -> Camera:
    """Build a Camera from COLMAP-convention (R, t) and fields of view."""
    w2v = transforms.world_to_view(R, t)
    proj = transforms.projection_matrix(znear, zfar, fovx, fovy)
    full = (proj @ w2v).astype(np.float32)
    cam_center = np.linalg.inv(w2v)[:3, 3].astype(np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        width=int(width),
        height=int(height),
        world_view=f32(w2v),
        full_proj=f32(full),
        cam_center=f32(cam_center),
        tan_fovx=f32(np.tan(fovx / 2)),
        tan_fovy=f32(np.tan(fovy / 2)),
        uid=int(uid),
    )


def look_at_camera(
    eye,
    target,
    up=(0.0, 1.0, 0.0),
    fovx: float = 0.8,
    fovy: Optional[float] = None,
    width: int = 128,
    height: int = 128,
    uid: int = 0,
    device: torch.device | str = "cpu",
) -> Camera:
    """Camera at `eye` looking at `target` (COLMAP axes: x right, y down,
    z forward)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    t = -R.T @ eye
    if fovy is None:
        fovy = 2 * np.arctan(np.tan(fovx / 2) * height / width)
    return make_camera(R, t, fovx, fovy, width, height, uid=uid, device=device)
