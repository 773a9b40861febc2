"""Dense oracle renderer, the mathematical spec of the rasterizer
(counterpart of gof_tpu/ops/oracle.py).

Evaluates every (gaussian, pixel) pair with no tile culling, O(P * pixels):
small test scenes only. Plain torch, so autograd gives reference gradients
for the hand-written backward kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import blend, quadrics


class OracleOut(NamedTuple):
    image: torch.Tensor  # [9, H, W]
    transmittance: torch.Tensor  # [H, W] final T
    depth_ndc_sum: torch.Tensor  # [H, W] final dist1 (sum w * m)


def render_oracle(means3d, scales, rotations, opacities, shs, sh_degree: int, camera,
                  kernel_size: float, bg: torch.Tensor, active_mask=None) -> OracleOut:
    """Render with every valid gaussian contributing to every pixel.
    `scales` / `opacities` are the 3D-filtered values."""
    H, W = camera.height, camera.width
    pre = quadrics.preprocess(means3d, scales, rotations, shs, sh_degree, camera, kernel_size,
                              active_mask)
    # depth-sort all gaussians (invalid ones last, with zero alpha)
    inf = torch.full_like(pre.depth, float("inf"))
    order = torch.argsort(torch.where(pre.valid, pre.depth, inf).detach(), stable=True)
    valid = pre.valid[order]
    # the 2D-dilation compensation is detached, as in the reference (its
    # cov2D backward is disabled, backward.cu:991-1007)
    coef = pre.coef[order].detach()
    op = opacities[order] * torch.where(valid, coef, torch.zeros_like(coef))
    M = pre.v2g_M[order]
    u0 = pre.v2g_u0[order]

    rx, ry = blend.pixel_rays(W, H, camera.focal_x, camera.focal_y)
    terms = blend.ray_terms(*(M[:, a, b, None] for a in range(3) for b in range(3)),
                            u0[:, 0, None], u0[:, 1, None], u0[:, 2, None], op[:, None],
                            rx.reshape(1, -1), ry.reshape(1, -1))
    carry = blend.init_carry(H * W, device=means3d.device)
    carry = blend.blend_chunk(carry, terms, pre.rgb[order])
    image = blend.finalize(carry, bg)
    return OracleOut(image=image.reshape(9, H, W),
                     transmittance=carry.transmittance.reshape(H, W),
                     depth_ndc_sum=carry.dist1.reshape(H, W))
