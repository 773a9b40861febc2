"""Gaussian model parameters and state (counterpart of gof_tpu/model/gaussians.py).

Parameters live in padded arrays with an `active` mask, as in gof_tpu, so a
model carried across with `from_numpy` keeps its slot layout, and
`init_from_points` pads the pool to gof_tpu's capacity with the same values.
Ported for training: init, the Mip 3D filter, the densification statistics
and the opacity reset. densify_and_prune waits (ROADMAP A.8).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import sh as sh_lib
from ..ops import knn

FRUSTUM_NEAR = 0.2
FILTER_SCALE = 0.2**0.5


@dataclass
class GaussianParams:
    """Trainable leaves, all [CAP, ...] f32."""

    xyz: torch.Tensor  # [C, 3]
    features_dc: torch.Tensor  # [C, 1, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    scaling: torch.Tensor  # [C, 3] log-scale
    rotation: torch.Tensor  # [C, 4] unnormalized quat (w,x,y,z)
    opacity: torch.Tensor  # [C] logit


@dataclass
class GaussianState:
    """Non-trainable per-Gaussian state, all [CAP, ...]."""

    active: torch.Tensor  # [C] bool
    filter_3d: torch.Tensor  # [C] mip 3D filter stddev
    max_radii2d: torch.Tensor  # [C]
    grad_accum: torch.Tensor  # [C]
    grad_abs_accum: torch.Tensor  # [C]
    denom: torch.Tensor  # [C]


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def num_active(state: GaussianState) -> torch.Tensor:
    return torch.sum(state.active)


def get_scaling(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.scaling)


def get_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity)


def get_features(params: GaussianParams) -> torch.Tensor:
    return torch.cat([params.features_dc, params.features_rest], dim=1)


def filtered_scaling(params: GaussianParams, filter_3d: torch.Tensor) -> torch.Tensor:
    """sqrt(s^2 + f^2) (gaussian_model.py:156-162)."""
    s2 = torch.exp(params.scaling) ** 2
    return torch.sqrt(s2 + filter_3d[:, None] ** 2)


def filtered_opacity(params: GaussianParams, filter_3d: torch.Tensor) -> torch.Tensor:
    """opacity * sqrt(det(s^2) / det(s^2 + f^2)) (gaussian_model.py:183-194)."""
    s2 = torch.exp(params.scaling) ** 2
    det1 = torch.prod(s2, dim=-1)
    det2 = torch.prod(s2 + filter_3d[:, None] ** 2, dim=-1)
    return torch.sigmoid(params.opacity) * torch.sqrt(det1 / det2)


def from_numpy(params, state, device: torch.device | str = "cpu"):
    """Carry a model across from gof_tpu: `params` and `state` are any objects
    with gof_tpu's GaussianParams / GaussianState field names holding numpy
    arrays (e.g. `jax.device_get` of the JAX NamedTuples). Returns the port's
    (GaussianParams, GaussianState) on `device`."""

    def conv(obj, cls):
        out = {}
        for f in fields(cls):
            a = np.asarray(getattr(obj, f.name))
            a = a.astype(bool) if f.name == "active" else a.astype(np.float32)
            out[f.name] = torch.as_tensor(np.ascontiguousarray(a), device=device)
        return cls(**out)

    return conv(params, GaussianParams), conv(state, GaussianState)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_from_points(points: np.ndarray, colors: np.ndarray, sh_degree: int, capacity: int,
                     device: torch.device | str = "cpu"):
    """create_from_pcd (gaussian_model.py:317-340) into a padded pool of
    `capacity` slots, as gof_tpu: SH-DC from RGB, log sqrt(3-NN mean squared
    distance) scales, opacity 0.1; padding slots are inactive, at the origin,
    with scaling -10, identity rotation and opacity logit 0."""
    P = points.shape[0]
    if capacity < P:
        raise ValueError(f"capacity {capacity} < {P} points")
    K = sh_lib.num_sh_coeffs(sh_degree)
    dist2 = torch.clamp_min(torch.from_numpy(knn.mean_sq_dist_3nn_exact(points)), 1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def pad(x, fill=0.0):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill, dtype=torch.float32)
        out[:P] = x
        return out.to(device)

    dc = sh_lib.rgb_to_sh_dc(torch.as_tensor(np.asarray(colors, np.float32)))[:, None, :]
    rot = torch.zeros((P, 4), dtype=torch.float32)
    rot[:, 0] = 1.0
    rot = pad(rot)
    rot[P:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(torch.as_tensor(np.asarray(points, np.float32))),
        features_dc=pad(dc),
        features_rest=pad(torch.zeros((P, K - 1, 3))),
        scaling=pad(scales, fill=-10.0),
        rotation=rot,
        opacity=pad(torch.full((P,), float(inverse_sigmoid(torch.tensor(0.1))))),
    )
    z = torch.zeros((capacity,), dtype=torch.float32, device=device)
    state = GaussianState(
        active=torch.arange(capacity, device=device) < P,
        filter_3d=z + 1e-4, max_radii2d=z.clone(), grad_accum=z.clone(),
        grad_abs_accum=z.clone(), denom=z.clone(),
    )
    return params, state


# ---------------------------------------------------------------------------
# Mip-Splatting 3D filter
# ---------------------------------------------------------------------------


def compute_3d_filter(xyz: torch.Tensor, active: torch.Tensor, world_views: torch.Tensor,
                      focals_x: torch.Tensor, focals_y: torch.Tensor, widths: torch.Tensor,
                      heights: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian 3D filter stddev over all training cameras
    (compute_3D_filter, gaussian_model.py:262-311); camera arrays [N, ...]."""
    pv = torch.einsum("nij,pj->npi", world_views[:, :3, :3], xyz) + world_views[:, None, :3, 3]
    z = pv[..., 2]
    in_front = z > FRUSTUM_NEAR
    zc = torch.clamp_min(z, 0.001)
    x_pix = pv[..., 0] / zc * focals_x[:, None] + widths[:, None] / 2.0
    y_pix = pv[..., 1] / zc * focals_y[:, None] + heights[:, None] / 2.0
    in_screen = ((x_pix >= -0.15 * widths[:, None]) & (x_pix <= 1.15 * widths[:, None])
                 & (y_pix >= -0.15 * heights[:, None]) & (y_pix <= 1.15 * heights[:, None]))
    visible = in_front & in_screen  # [N, P]
    inf = torch.full_like(zc, float("inf"))
    dist = torch.amin(torch.where(visible, zc, inf), dim=0)  # [P]
    any_vis = torch.any(visible, dim=0)
    max_seen = torch.amax(torch.where(any_vis & active, dist, -inf[0]))
    max_seen = torch.where(torch.isfinite(max_seen), max_seen, torch.ones_like(max_seen))
    dist = torch.where(any_vis, dist, max_seen)
    return dist / torch.amax(focals_x) * FILTER_SCALE


# ---------------------------------------------------------------------------
# Densification statistics, opacity reset
# ---------------------------------------------------------------------------


def add_densification_stats(state: GaussianState, carrier_grad: torch.Tensor,
                            radii: torch.Tensor, visible: torch.Tensor) -> GaussianState:
    """Accumulate per-step stats (add_densification_stats,
    gaussian_model.py:709-714, and the max_radii2D update, train.py:253-254)."""
    gxy = torch.linalg.norm(carrier_grad[:, :2], dim=-1)
    gabs = torch.abs(carrier_grad[:, 2])
    vis = visible & state.active
    zero = torch.zeros_like(gxy)
    return GaussianState(
        active=state.active, filter_3d=state.filter_3d,
        max_radii2d=torch.where(vis, torch.maximum(state.max_radii2d, radii), state.max_radii2d),
        grad_accum=state.grad_accum + torch.where(vis, gxy, zero),
        grad_abs_accum=state.grad_abs_accum + torch.where(vis, gabs, zero),
        denom=state.denom + vis.to(torch.float32),
    )


def reset_opacity(params: GaussianParams, filter_3d: torch.Tensor) -> GaussianParams:
    """reset_opacity (gaussian_model.py:465-483): clamp the filtered opacity
    to <= 0.01, undo the filter compensation, store the logit."""
    op_f = filtered_opacity(params, filter_3d)
    s2 = torch.exp(params.scaling) ** 2
    coef = torch.sqrt(torch.prod(s2, dim=-1) / torch.prod(s2 + filter_3d[:, None] ** 2, dim=-1))
    new = torch.clamp_max(op_f, 0.01) / torch.clamp_min(coef, 1e-12)
    new = torch.clamp(new, 1e-6, 1.0 - 1e-6)
    return GaussianParams(xyz=params.xyz, features_dc=params.features_dc,
                          features_rest=params.features_rest, scaling=params.scaling,
                          rotation=params.rotation, opacity=inverse_sigmoid(new))
