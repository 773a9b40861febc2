"""Image losses: L1, SSIM (11x11 Gaussian window) and PSNR (counterpart of
gof_tpu/utils/losses.py).

SSIM uses gof_tpu's 11-tap, sigma 1.5 separable window with zero 'SAME'
padding and the standard C1/C2 stabilizers, as two depthwise convolutions
(TF32 is off for them: gof_tpu_torch/__init__.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import trace


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


_WIN = _gaussian_window()


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable 11-tap Gaussian blur with zero SAME padding; x: [C, H, W]."""
    C = x.shape[0]
    with trace.copy("ssim_window"):
        w = torch.as_tensor(_WIN, device=x.device, dtype=x.dtype)
    k = len(_WIN)
    y = F.conv2d(x[None], w.view(1, 1, k, 1).expand(C, 1, k, 1), padding=(k // 2, 0), groups=C)
    y = F.conv2d(y, w.view(1, 1, 1, k).expand(C, 1, 1, k), padding=(0, k // 2), groups=C)
    return y[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over [C, H, W] images in [0, 1]."""
    C1 = 0.01**2
    C2 = 0.03**2
    mu1 = _blur(img1)
    mu2 = _blur(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1) - mu1_sq
    sigma2_sq = _blur(img2 * img2) - mu2_sq
    sigma12 = _blur(img1 * img2) - mu12
    m = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return torch.mean(m)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR in dB (utils/image_utils.py:14-18)."""
    mse = torch.mean((img1 - img2) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
