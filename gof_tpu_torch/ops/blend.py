"""Shared ray math (counterpart of gof_tpu/ops/blend.py; so far the two
helpers `train.depth_to_normal` and the blend need: `pixel_rays`,
`ndc_depth`)."""

from __future__ import annotations

import torch

from ..constants import FAR_PLANE, NEAR_PLANE


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
