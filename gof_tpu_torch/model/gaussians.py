"""Gaussian model parameters and state (counterpart of gof_tpu/model/gaussians.py).

Parameters live in padded arrays with an `active` mask, as in gof_tpu, so a
model carried across with `from_numpy` keeps its slot layout. Densification
and the 3D filter come with the training port.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch


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
