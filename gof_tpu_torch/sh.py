"""Spherical harmonics evaluation, degrees 0..3 (counterpart of gof_tpu/sh.py).

Replaces computeColorFromSH (forward.cu:20-71); the backward comes from
torch autograd.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH colors (..., 3) from coefficients (..., K, 3), K >= (degree+1)^2,
    and unit view directions (..., 3); no +0.5 shift, no clamp."""
    result = C0 * sh[..., 0, :]
    if degree > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = result - C1 * y * sh[..., 1, :] + C1 * z * sh[..., 2, :] - C1 * x * sh[..., 3, :]
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * sh[..., 4, :]
                + C2[1] * yz * sh[..., 5, :]
                + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                + C2[3] * xz * sh[..., 7, :]
                + C2[4] * (xx - yy) * sh[..., 8, :]
            )
            if degree > 2:
                result = (
                    result
                    + C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                    + C3[1] * xy * z * sh[..., 10, :]
                    + C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                    + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                    + C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                    + C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :]
                )
    return result


def sh_to_rgb(degree: int, sh: torch.Tensor, means: torch.Tensor, campos: torch.Tensor) -> torch.Tensor:
    """SH -> clamped RGB as the rasterizer does it:
    dirs = normalize(mean - campos); color = max(eval + 0.5, 0). The max
    is torch.maximum, whose gradient at a tie (a channel at exactly 0, as
    init gives a point of colour 0) is halved, as jnp.maximum's is in
    gof_tpu; clamp_min would pass all of it (ROADMAP C25)."""
    dirs = means - campos
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    c = eval_sh(degree, sh, dirs) + 0.5
    return torch.maximum(c, torch.zeros_like(c))


def rgb_to_sh_dc(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> degree-0 SH coefficient (RGB2SH)."""
    return (rgb - 0.5) / C0


def sh_dc_to_rgb(dc: torch.Tensor) -> torch.Tensor:
    return dc * C0 + 0.5
