"""Visualization helpers: debug image grids, depth colormaps (counterpart of
gof_tpu/utils/vis.py, numpy and PIL only).

Replaces utils/vis_utils.py + the (hardcoded-off) is_save_images grid in the
reference train loop (train.py:193-235): gt / render / normals / depth /
alpha / distortion in one 2x3 panel.
"""

from __future__ import annotations

import numpy as np


def colormap_turbo(x: np.ndarray) -> np.ndarray:
    """Cheap turbo-like colormap for [0,1] scalars -> [H, W, 3]."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.6 * x - 0.2, 0, 1)
    g = np.clip(1.5 - np.abs(2.4 * x - 1.2), 0, 1)
    b = np.clip(1.2 - 1.6 * x, 0, 1)
    return np.stack([r, g, b], axis=-1)


def normalize01(x: np.ndarray) -> np.ndarray:
    lo, hi = np.nanmin(x), np.nanmax(x)
    return (x - lo) / max(hi - lo, 1e-12)


def debug_grid(image9: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[9, H, W] render + [3, H, W] gt -> [2H, 3W, 3] uint8 panel."""
    img = np.asarray(image9)
    H, W = img.shape[1:]
    rgb = np.clip(img[:3], 0, 1).transpose(1, 2, 0)
    gtc = np.clip(np.asarray(gt), 0, 1).transpose(1, 2, 0)
    normal = (img[3:6].transpose(1, 2, 0) * 0.5 + 0.5).clip(0, 1)
    depth = colormap_turbo(normalize01(img[6]))
    alpha = np.repeat(np.clip(img[7], 0, 1)[..., None], 3, axis=-1)
    dist = colormap_turbo(normalize01(np.log1p(np.maximum(img[8], 0))))
    top = np.concatenate([gtc, rgb, normal], axis=1)
    bot = np.concatenate([depth, alpha, dist], axis=1)
    return (np.concatenate([top, bot], axis=0) * 255).astype(np.uint8)


def save_debug_grid(path: str, image9, gt) -> None:
    from PIL import Image

    import os

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(debug_grid(np.asarray(image9), np.asarray(gt))).save(path)
