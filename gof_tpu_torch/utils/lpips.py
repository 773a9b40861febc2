"""LPIPS perceptual metric on a VGG16 backbone (counterpart of
gof_tpu/utils/lpips.py).

The metric needs pretrained VGG16 + LPIPS linear-head weights; none ship
with the repository and none may be fetched, so `lpips_fn(...)` is only
available when a weights file is supplied (metrics report LPIPS = null
otherwise).

Weights format, gof_tpu's: an .npz with torchvision VGG16 conv weights under
`features.{idx}.weight/bias` (OIHW, as F.conv2d takes them) and LPIPS heads
under `lin{k}.model.1.weight`, as scripts/convert_lpips_weights.py writes
it from the official checkpoints.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv layout: (out_channels, layers-per-block); LPIPS taps the relu
# after each block (features 3, 8, 15, 22, 29 in torchvision indexing).
_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_CONV_IDS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def vgg16_features(convs, x: torch.Tensor) -> list:
    """The relu taps of VGG16.features; x: [N, 3, H, W] in LPIPS's scaled
    input range; convs: the 13 (weight, bias) pairs in order."""
    taps = []
    ci = 0
    for b, (_ch, n_layers) in enumerate(_BLOCKS):
        for _ in range(n_layers):
            w, bias = convs[ci]
            x = F.relu(F.conv2d(x, w, bias, padding=1))
            ci += 1
        taps.append(x)
        if b < len(_BLOCKS) - 1:
            x = F.max_pool2d(x, 2, 2)
    return taps


def _normalize(feat: torch.Tensor) -> torch.Tensor:
    return feat / torch.sqrt(torch.sum(feat**2, dim=1, keepdim=True) + 1e-10)


def lpips(convs, lin_weights, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """img*: [3, H, W] in [0, 1]. Returns the scalar LPIPS distance."""
    shift = torch.as_tensor(_SHIFT, device=img0.device).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=img0.device).view(1, 3, 1, 1)

    def prep(im):
        return (im[None] * 2.0 - 1.0 - shift) / scale

    total = torch.zeros((), device=img0.device)
    for a, b, w in zip(vgg16_features(convs, prep(img0)), vgg16_features(convs, prep(img1)),
                       lin_weights):
        d = (_normalize(a) - _normalize(b)) ** 2  # [1, C, H, W]
        total = total + torch.mean(torch.sum(d * w.view(1, -1, 1, 1), dim=1))
    return total


def load_weights(path: str, device: torch.device | str = "cpu"):
    """Load converted .npz weights -> (13 conv (weight, bias) pairs, list of
    the 5 head weights)."""
    data = np.load(path)

    def t(key):
        return torch.tensor(np.asarray(data[key], np.float32), device=device)

    convs = [(t(f"features.{i}.weight"), t(f"features.{i}.bias")) for i in _CONV_IDS]
    lins = [t(f"lin{k}.model.1.weight").reshape(-1) for k in range(5)]
    return convs, lins


def lpips_fn(weights_path: Optional[str], device: torch.device | str = "cpu"):
    """Returns lpips(img0, img1) on `device`, or None when weights are missing."""
    if not weights_path or not os.path.exists(weights_path):
        return None
    convs, lins = load_weights(weights_path, device)

    @torch.no_grad()
    def fn(a, b):
        return lpips(convs, lins, torch.as_tensor(a, device=device),
                     torch.as_tensor(b, device=device))

    return fn
