"""Shared ray-Gaussian blend math (counterpart of gof_tpu/ops/blend.py).

Plain torch, differentiated by autograd. Used by the dense oracle
(ops/oracle.py) and the tiled reference renderer (ops/tiled_ref.py, the
"xla" backend); `pixel_rays` and `ndc_depth` also by the train step's
depth-to-normal. Semantics follow renderCUDA (forward.cu:409-612) with
gof_tpu's one documented deviation: every contribution is zeroed once the
transmittance has fallen below TRANSMITTANCE_EPS, instead of freezing the
pixel the first time T * (1 - alpha) < 1e-4 (forward.cu:536-541).

The blend helpers take [..., G, PIX] blocks: gaussians on the second-last
axis, pixels on the last, any leading batch axes (the tiled renderer's
tiles) in front, where gof_tpu vmaps over them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import (
    ALPHA_MAX,
    ALPHA_MIN,
    FAR_PLANE,
    MEDIAN_THRESHOLD,
    NEAR_PLANE,
    TRANSMITTANCE_EPS,
)


def pixel_rays(width: int, height: int, focal_x, focal_y):
    """View-space ray xy slopes for every pixel (forward.cu:448):
    ray = ((px + 0.5 - W/2) / fx, (py + 0.5 - H/2) / fy, 1).
    Returns rx, ry each shaped (H, W), on the focal lengths' device."""
    focal_x = torch.as_tensor(focal_x, dtype=torch.float32)
    focal_y = torch.as_tensor(focal_y, dtype=torch.float32, device=focal_x.device)
    px = torch.arange(width, dtype=torch.float32, device=focal_x.device) + 0.5
    py = torch.arange(height, dtype=torch.float32, device=focal_x.device) + 0.5
    rx = (px[None, :] - width / 2.0) / focal_x
    ry = (py[:, None] - height / 2.0) / focal_y
    return rx.expand(height, width), ry.expand(height, width)


def ndc_depth(t):
    """2DGS NDC depth mapping (forward.cu:543-545), clamped below at
    NEAR_PLANE so masked entries stay finite."""
    t = torch.clamp_min(t, NEAR_PLANE)
    return (FAR_PLANE * t - FAR_PLANE * NEAR_PLANE) / ((FAR_PLANE - NEAR_PLANE) * t)


class RayTerms(NamedTuple):
    """Per-(gaussian, pixel) blend quantities, each [..., G, PIX]."""

    alpha: torch.Tensor  # masked, clamped alpha
    t: torch.Tensor  # depth of the gaussian's peak along the ray
    n0: torch.Tensor  # normalized, negated view-space normal components
    n1: torch.Tensor
    n2: torch.Tensor


def ray_terms(m00, m01, m02, m10, m11, m12, m20, m21, m22, u0x, u0y, u0z, op,
              rx, ry) -> RayTerms:
    """Alpha, depth and normal for a block of gaussians x pixels
    (forward.cu:502-541 through the factored (M, u0) quadric): d = M r,
    t = -(u0.d)/(d.d), min_value = |u0 + t d|^2, normal = M^T d.
    Gaussian params broadcast to [..., G, 1], rx / ry to [..., 1, PIX]."""
    d0 = m00 * rx + m01 * ry + m02
    d1 = m10 * rx + m11 * ry + m12
    d2 = m20 * rx + m21 * ry + m22
    dd = d0 * d0 + d1 * d1 + d2 * d2
    ud = u0x * d0 + u0y * d1 + u0z * d2
    t = -ud / (dd + 1e-12)
    v0 = u0x + t * d0
    v1 = u0y + t * d1
    v2 = u0z + t * d2
    min_value = v0 * v0 + v1 * v1 + v2 * v2
    # min_value >= 0 by construction: the reference's power <= 0 clamp
    # (forward.cu:524-527) is automatic
    alpha = torch.clamp_max(op * torch.exp(-0.5 * min_value), ALPHA_MAX)
    alpha = torch.where((t > NEAR_PLANE) & (alpha >= ALPHA_MIN), alpha, torch.zeros_like(alpha))
    # normal = M^T d, negated and normalized (forward.cu:504-508, 548-549)
    n0 = m00 * d0 + m10 * d1 + m20 * d2
    n1 = m01 * d0 + m11 * d1 + m21 * d2
    n2 = m02 * d0 + m12 * d1 + m22 * d2
    inv_len = 1.0 / torch.sqrt(n0 * n0 + n1 * n1 + n2 * n2 + 1e-7)
    return RayTerms(alpha=alpha, t=t, n0=-n0 * inv_len, n1=-n1 * inv_len, n2=-n2 * inv_len)


class BlendCarry(NamedTuple):
    """Per-pixel running state across gaussian chunks, each [..., PIX]
    ([..., 3, PIX] for rgb and normal).

    The pairwise depth distortion sum_{j<i} w_i w_j (m_i - m_j)^2 has the
    closed form (sum w)(sum w m^2) - (sum w m)^2, so only the three totals
    are carried (gof_tpu's formulation of forward.cu:551-557)."""

    transmittance: torch.Tensor  # prod(1 - alpha) so far
    acc_alpha: torch.Tensor  # sum of weights
    rgb: torch.Tensor
    normal: torch.Tensor
    depth: torch.Tensor  # median depth (last t while T > 0.5)
    dist1: torch.Tensor  # sum w * m
    dist2: torch.Tensor  # sum w * m^2


def init_carry(shape, dtype=torch.float32, device=None) -> BlendCarry:
    """An empty carry for pixels of `shape` (an int or a tuple whose last
    entry is PIX)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    z = torch.zeros(shape, dtype=dtype, device=device)
    z3 = torch.zeros(shape[:-1] + (3, shape[-1]), dtype=dtype, device=device)
    return BlendCarry(transmittance=torch.ones(shape, dtype=dtype, device=device),
                      acc_alpha=z, rgb=z3, normal=z3.clone(), depth=z.clone(),
                      dist1=z.clone(), dist2=z.clone())


def blend_chunk(carry: BlendCarry, terms: RayTerms, colors: torch.Tensor) -> BlendCarry:
    """Blend one depth-ordered chunk of gaussians into the carry.

    terms: RayTerms with [..., G, PIX] fields (alpha already masked);
    colors: [..., G, 3] per-gaussian RGB."""
    a = terms.alpha
    prod_incl = torch.cumprod(1.0 - a, dim=-2)
    # exclusive prefix transmittance per gaussian
    T = carry.transmittance.unsqueeze(-2) * torch.cat(
        [torch.ones_like(prod_incl[..., :1, :]), prod_incl[..., :-1, :]], dim=-2)
    w = a * T * (T > TRANSMITTANCE_EPS)

    m = ndc_depth(terms.t)
    wm = w * m
    wmm = wm * m

    rgb = carry.rgb + colors.transpose(-1, -2) @ w
    nrm = carry.normal + torch.stack([(terms.n0 * w).sum(-2), (terms.n1 * w).sum(-2),
                                      (terms.n2 * w).sum(-2)], dim=-2)

    # median depth: t of the LAST contributing gaussian with T > 0.5
    # (forward.cu:568-571)
    med_mask = (a > 0) & (T > MEDIAN_THRESHOLD)
    g_idx = torch.arange(a.shape[-2], device=a.device)[:, None]
    last_idx = torch.where(med_mask, g_idx, -1).amax(dim=-2)
    any_med = last_idx >= 0
    onehot = (g_idx == last_idx.unsqueeze(-2)) & med_mask
    chunk_depth = torch.where(onehot, terms.t, torch.zeros_like(terms.t)).sum(-2)
    depth = torch.where(any_med, chunk_depth, carry.depth)

    return BlendCarry(
        transmittance=carry.transmittance * prod_incl[..., -1, :],
        acc_alpha=carry.acc_alpha + w.sum(-2),
        rgb=rgb,
        normal=nrm,
        depth=depth,
        dist1=carry.dist1 + wm.sum(-2),
        dist2=carry.dist2 + wmm.sum(-2),
    )


def finalize(carry: BlendCarry, bg: torch.Tensor) -> torch.Tensor:
    """The 9-channel output [..., 9, PIX] (forward.cu:584-611): the
    distortion's closed form normalized by (1 - T)^2 + 1e-7
    (forward.cu:589)."""
    T = carry.transmittance
    rgb = carry.rgb + T.unsqueeze(-2) * bg[:, None]
    distortion_raw = carry.acc_alpha * carry.dist2 - carry.dist1 * carry.dist1
    distortion = distortion_raw / ((1.0 - T) ** 2 + 1e-7)
    return torch.cat([rgb, carry.normal, carry.depth.unsqueeze(-2),
                      carry.acc_alpha.unsqueeze(-2), distortion.unsqueeze(-2)], dim=-2)
