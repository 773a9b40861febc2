"""The windows the blend kernels walk (plain version of `windows::count`,
csrc/windows.cuh).

A tile of the forward blend (K1) or a block of query points of the field
(K5) walks the CHUNK_SIZE-row windows of its segment [seg_s, seg_e) from the
aligned base floor(seg_s / 128) * 128, so its work is known before the
kernel: the window count. K1 walks fewer where its early exit fires
(CH_LIVEC); K5 walks them all.
"""

from __future__ import annotations

import torch

from .binning import CHUNK_SIZE


def window_counts(seg_s: torch.Tensor, seg_e: torch.Tensor) -> torch.Tensor:
    """Windows each segment walks from its aligned base (0 if empty)."""
    s, e = seg_s.to(torch.int64), seg_e.to(torch.int64)
    base = torch.div(s, CHUNK_SIZE, rounding_mode="floor") * CHUNK_SIZE
    return torch.where(e > s, torch.div(e - base + CHUNK_SIZE - 1, CHUNK_SIZE,
                                        rounding_mode="floor"), torch.zeros_like(s))
