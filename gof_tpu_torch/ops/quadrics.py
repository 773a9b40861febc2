"""Per-Gaussian view-dependent quadric math (counterpart of
gof_tpu/ops/quadrics.py; plain differentiable torch).

Replaces the reference preprocess (computeCov3D, computeCov2D + dilation,
computeView2Gaussian, preprocessCUDA; forward.cu:74-404). As in gof_tpu the
ray-Gaussian quadratic is cached in factored form: M = S^-1 Q and
u0 = S^-1 t2, so along a view ray r (z = 1), with d = M r, the peak depth is
t* = -(u0.d)/(d.d) and the peak value |u0 + t* d|^2 — stable in f32. All math
is componentwise over [P] vectors, in gof_tpu's operation order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import sh as sh_lib
from ..constants import FRUSTUM_NEAR
from ..transforms import ndc_to_pixel
from ..utils import trace


def _rot_comps(rotation: torch.Tensor):
    """Normalized-quaternion rotation matrix as 9 elementwise components."""
    q = rotation / (torch.linalg.norm(rotation, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )


def cov3d_from_scaling_rotation(scaling: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """World covariance Sigma = R S^2 R^T, upper triangle (..., 6)."""
    R = _rot_comps(rotation)
    s2 = (scaling[..., 0] ** 2, scaling[..., 1] ** 2, scaling[..., 2] ** 2)

    def sig(i, k):
        return (R[i][0] * R[k][0] * s2[0] + R[i][1] * R[k][1] * s2[1]
                + R[i][2] * R[k][2] * s2[2])

    return torch.stack(
        [sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)], dim=-1)


@dataclass
class View2Gaussian:
    """Factored view->unit-Gaussian transform."""

    M: torch.Tensor  # (..., 3, 3) = S^-1 Q
    u0: torch.Tensor  # (..., 3) camera origin in unit-Gaussian coordinates


def view_to_gaussian(mean: torch.Tensor, scaling: torch.Tensor, rotation: torch.Tensor,
                     world_view: torch.Tensor) -> View2Gaussian:
    """Per-Gaussian factored quadric transform; s_eff = sqrt(s^2 + 1e-7)
    matches the reference's 1e-7 (forward.cu:255)."""
    Rg = _rot_comps(rotation)  # gaussian -> world
    W = world_view[..., :3, :3]
    tvec = world_view[..., :3, 3]
    Rv = tuple(
        tuple(
            W[..., i, 0] * Rg[0][j] + W[..., i, 1] * Rg[1][j] + W[..., i, 2] * Rg[2][j]
            for j in range(3)
        )
        for i in range(3)
    )
    mx, my, mz = mean[..., 0], mean[..., 1], mean[..., 2]
    tg = tuple(
        W[..., i, 0] * mx + W[..., i, 1] * my + W[..., i, 2] * mz + tvec[..., i]
        for i in range(3)
    )
    s_eff = torch.sqrt(scaling * scaling + 1e-7)
    se = (s_eff[..., 0], s_eff[..., 1], s_eff[..., 2])
    M = torch.stack(
        [torch.stack([Rv[j][i] / se[i] for j in range(3)], dim=-1) for i in range(3)],
        dim=-2,
    )
    u0 = torch.stack(
        [-(Rv[0][i] * tg[0] + Rv[1][i] * tg[1] + Rv[2][i] * tg[2]) / se[i] for i in range(3)],
        dim=-1,
    )
    return View2Gaussian(M=M, u0=u0)


def cov2d_ewa(mean, cov3d, world_view, focal_x, focal_y, tan_fovx, tan_fovy, kernel_size):
    """EWA-splatted 2D covariance with the Mip-Splatting dilation
    (computeCov2D, forward.cu:74-124). Returns (cov2d (...,3) [xx, xy, yy]
    dilated, coef (...,))."""
    W = world_view[..., :3, :3]
    tvec = world_view[..., :3, 3]
    mx, my, mz = mean[..., 0], mean[..., 1], mean[..., 2]
    pv = tuple(
        W[..., i, 0] * mx + W[..., i, 1] * my + W[..., i, 2] * mz + tvec[..., i]
        for i in range(3)
    )
    tz = pv[2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(pv[0] / tz, -limx, limx) * tz
    ty = torch.clamp(pv[1] / tz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz * inv_tz
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz * inv_tz

    a0 = tuple(j00 * W[..., 0, k] + j02 * W[..., 2, k] for k in range(3))
    a1 = tuple(j11 * W[..., 1, k] + j12 * W[..., 2, k] for k in range(3))

    c = cov3d
    s0, s1c, s2c = c[..., 0], c[..., 1], c[..., 2]
    s3, s4, s5 = c[..., 3], c[..., 4], c[..., 5]

    def quad(a, b):
        return (a[0] * b[0] * s0 + a[1] * b[1] * s3 + a[2] * b[2] * s5
                + (a[0] * b[1] + a[1] * b[0]) * s1c
                + (a[0] * b[2] + a[2] * b[0]) * s2c
                + (a[1] * b[2] + a[2] * b[1]) * s4)

    cxx = quad(a0, a0)
    cxy = quad(a0, a1)
    cyy = quad(a1, a1)

    det0 = torch.clamp_min(cxx * cyy - cxy * cxy, 1e-6)
    det1 = torch.clamp_min((cxx + kernel_size) * (cyy + kernel_size) - cxy * cxy, 1e-6)
    coef = torch.sqrt(det0 / (det1 + 1e-6) + 1e-6)
    raw_det0 = cxx * cyy - cxy * cxy
    raw_det1 = (cxx + kernel_size) * (cyy + kernel_size) - cxy * cxy
    coef = torch.where((raw_det0 <= 1e-6) | (raw_det1 <= 1e-6), torch.zeros_like(coef), coef)
    cov2d = torch.stack([cxx + kernel_size, cxy, cyy + kernel_size], dim=-1)
    return cov2d, coef


def screen_extent(cov2d: torch.Tensor, coef: torch.Tensor, opacities: torch.Tensor | None):
    """Un-ceiled screen radius (...,) and per-axis half-extents (..., 2).

    The radius is where alpha = op * coef * exp(-r^2/2) falls below the 1/255
    blend cutoff, capped at 3 sigma (the reference's fixed 3 sigma when no
    opacities are given). `preprocess` takes the ceil of both.
    """
    det = cov2d[..., 0] * cov2d[..., 2] - cov2d[..., 1] * cov2d[..., 1]
    mid = 0.5 * (cov2d[..., 0] + cov2d[..., 2])
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    if opacities is not None:
        nsig = torch.sqrt(2.0 * torch.log(torch.clamp_min(opacities * coef * 255.0, 1.001)))
        nsig = torch.clamp_max(nsig, 3.0)
    else:
        nsig = torch.full_like(lambda1, 3.0)
    radius = nsig * torch.sqrt(torch.clamp_min(lambda1, 1e-12))
    with trace.copy("index"):  # the list index goes to the device
        c02 = cov2d[..., [0, 2]]
    radius_xy = nsig[..., None] * torch.sqrt(torch.clamp_min(c02, 1e-12))
    return radius, radius_xy


@dataclass
class PreprocessOut:
    """Dense per-Gaussian preprocess results (all tensors shaped (P, ...))."""

    valid: torch.Tensor  # bool: in frustum, non-degenerate, radius > 0
    depth: torch.Tensor  # view-space z
    mean2d: torch.Tensor  # (P, 2) continuous pixel coordinates
    conic: torch.Tensor  # (P, 3) inverse dilated 2D covariance [a, b, c]
    coef: torch.Tensor  # mip-splatting opacity compensation
    radius: torch.Tensor  # screen radius in pixels (float, ceil'ed)
    radius_xy: torch.Tensor  # (P, 2) per-axis bbox half-extents (<= radius)
    rgb: torch.Tensor  # (P, 3) SH-evaluated colors
    v2g_M: torch.Tensor  # (P, 3, 3)
    v2g_u0: torch.Tensor  # (P, 3)


def preprocess(means3d, scales, rotations, shs, sh_degree: int, camera, kernel_size,
               active_mask=None, opacities=None) -> PreprocessOut:
    """Vectorized per-Gaussian preprocessing (preprocessCUDA, forward.cu:282-404).

    means3d (P, 3); scales (P, 3), already 3D-filtered; rotations (P, 4) wxyz;
    shs (P, K, 3); active_mask (P,) marks live slots of a padded pool.
    """
    W, H = camera.width, camera.height
    wv = camera.world_view
    mx, my, mz = means3d[..., 0], means3d[..., 1], means3d[..., 2]
    depth = wv[2, 0] * mx + wv[2, 1] * my + wv[2, 2] * mz + wv[2, 3]
    in_front = depth > FRUSTUM_NEAR

    fp = camera.full_proj
    pw = fp[3, 0] * mx + fp[3, 1] * my + fp[3, 2] * mz + fp[3, 3] + 1e-7
    ndc_x = (fp[0, 0] * mx + fp[0, 1] * my + fp[0, 2] * mz + fp[0, 3]) / pw
    ndc_y = (fp[1, 0] * mx + fp[1, 1] * my + fp[1, 2] * mz + fp[1, 3]) / pw
    mean2d = torch.stack([ndc_to_pixel(ndc_x, W), ndc_to_pixel(ndc_y, H)], dim=-1)

    cov3d = cov3d_from_scaling_rotation(scales, rotations)
    cov2d, coef = cov2d_ewa(means3d, cov3d, wv, camera.focal_x, camera.focal_y,
                            camera.tan_fovx, camera.tan_fovy, kernel_size)
    det = cov2d[..., 0] * cov2d[..., 2] - cov2d[..., 1] * cov2d[..., 1]
    nondegenerate = det != 0.0
    det_inv = 1.0 / torch.where(nondegenerate, det, torch.ones_like(det))
    conic = torch.stack(
        [cov2d[..., 2] * det_inv, -cov2d[..., 1] * det_inv, cov2d[..., 0] * det_inv], dim=-1)
    radius, radius_xy = screen_extent(cov2d, coef, opacities)
    radius = torch.ceil(radius)
    radius_xy = torch.ceil(radius_xy)

    rgb = sh_lib.sh_to_rgb(sh_degree, shs, means3d, camera.cam_center)
    v2g = view_to_gaussian(means3d, scales, rotations, wv)

    valid = in_front & nondegenerate & (radius > 0)
    if active_mask is not None:
        valid = valid & active_mask
    return PreprocessOut(
        valid=valid, depth=depth, mean2d=mean2d, conic=conic, coef=coef,
        radius=radius, radius_xy=radius_xy, rgb=rgb, v2g_M=v2g.M, v2g_u0=v2g.u0,
    )
