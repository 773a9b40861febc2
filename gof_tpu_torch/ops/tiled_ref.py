"""Tile <-> image layout (counterpart of gof_tpu/ops/tiled_ref.py; only
`assemble_image` is ported so far)."""

from __future__ import annotations

import torch

from ..constants import TILE_W


def assemble_image(tile_out: torch.Tensor, ntx: int, nty: int, width: int, height: int) -> torch.Tensor:
    """[NTILES, C, TILE_PIXELS] -> [C, H, W] crop. Lane l of tile (ty, tx) is
    pixel (ty*32 + l // 32, tx*32 + l % 32)."""
    C = tile_out.shape[1]
    img = tile_out.reshape(nty, ntx, C, TILE_W, TILE_W)
    img = img.permute(2, 0, 3, 1, 4).reshape(C, nty * TILE_W, ntx * TILE_W)
    return img[:, :height, :width]
