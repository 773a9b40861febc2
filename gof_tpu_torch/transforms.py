"""Camera and rigid-body transforms (counterpart of gof_tpu/transforms.py).

Conventions as in gof_tpu: (w, x, y, z) quaternions, plain row-major math
(`p_view = w2v @ [p, 1]`). Matrix construction for cameras is numpy, exactly
as in gof_tpu, so camera matrices agree bit for bit; point math is torch.
"""

from __future__ import annotations

import numpy as np
import torch


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (..., 4) (w,x,y,z) -> rotation matrices (..., 3, 3),
    normalizing first."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """4x4 world->view matrix from COLMAP-convention (R, t):
    Rt[:3,:3] = R^T, Rt[:3,3] = t (getWorld2View2)."""
    w2v = np.eye(4, dtype=np.float32)
    w2v[:3, :3] = np.asarray(R, np.float32).T
    w2v[:3, 3] = np.asarray(t, np.float32)
    return w2v


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection, z_sign=+1 (getProjectionMatrix)."""
    tan_half_y = np.tan(fovy / 2)
    tan_half_x = np.tan(fovx / 2)
    top = tan_half_y * znear
    bottom = -top
    right = tan_half_x * znear
    left = -right
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def fov_to_focal(fov: float, pixels: float) -> float:
    """Focal length in pixels from a field of view."""
    return pixels / (2.0 * np.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def ndc_to_pixel(v: torch.Tensor, size) -> torch.Tensor:
    """NDC [-1,1] -> continuous pixel coordinate (ndc2Pix)."""
    return ((v + 1.0) * size - 1.0) * 0.5


def project_points(points: torch.Tensor, full_proj: torch.Tensor) -> torch.Tensor:
    """Project (N,3) world points with a 4x4 proj@view matrix -> NDC (N,3),
    with the reference's 1e-7 guard on the w-division."""
    ph = points @ full_proj[:3, :3].T + full_proj[:3, 3]
    pw = points @ full_proj[3, :3] + full_proj[3, 3]
    return ph / (pw[..., None] + 1e-7)


def transform_points(points: torch.Tensor, mat4: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid/affine transform to (N,3) points (no w-division)."""
    return points @ mat4[:3, :3].T + mat4[:3, 3]
