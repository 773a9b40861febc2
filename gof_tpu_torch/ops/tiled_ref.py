"""Tiled reference renderer and the tile <-> image layout (counterpart of
gof_tpu/ops/tiled_ref.py).

Renders through the same binning and payload as the kernels, but blends
each tile's whole (padded) gaussian list at once in plain torch
(ops/blend.py), differentiated by autograd. It is the port's "xla" backend
(ops/render.py), gof_tpu's reference path, and runs on whatever device the
tensors are on. Memory is O(ntiles * max_tile_len * TILE_PIXELS): small
scenes only.
"""

from __future__ import annotations

import torch

from ..constants import MEDIAN_THRESHOLD, TILE_PIXELS, TILE_W
from . import blend
from .binning import Binning
# the kernels' payload columns (0:3 rgb | 3 op_eff | 4:13 M row-major |
# 13:16 u0) and output channels
from .rasterize import OUT_CH
from .rasterize import P_COLS as PAYLOAD_COLS


def build_payload(rgb, op_eff, M, u0, binning: Binning) -> torch.Tensor:
    """Per-gaussian rows in slot order, [CAP, 16]; padding slots (id P)
    gather an appended zero row, so they blend to nothing."""
    P = rgb.shape[0]
    flat = torch.cat([rgb, op_eff[:, None], M.reshape(P, 9), u0], dim=1)
    flat = torch.cat([flat, flat.new_zeros((1, PAYLOAD_COLS))], dim=0)
    return flat[binning.slot_to_gaussian.long()]


def tile_rays(ntx: int, nty: int, width: int, height: int, focal_x, focal_y):
    """Per-tile pixel ray slopes, each [NTILES, TILE_PIXELS]. Lane l of tile
    (ty, tx) is pixel (ty*32 + l // 32, tx*32 + l % 32)."""
    focal_x = torch.as_tensor(focal_x, dtype=torch.float32)
    focal_y = torch.as_tensor(focal_y, dtype=torch.float32, device=focal_x.device)
    dev = focal_x.device
    lane = torch.arange(TILE_PIXELS, dtype=torch.float32, device=dev)
    lx = lane % TILE_W
    ly = torch.div(lane, TILE_W, rounding_mode="floor")
    tx = torch.arange(ntx, dtype=torch.float32, device=dev) * TILE_W
    ty = torch.arange(nty, dtype=torch.float32, device=dev) * float(TILE_W)
    px = (tx[None, :, None] + lx[None, None, :] + 0.5 - width / 2.0) / focal_x
    py = (ty[:, None, None] + ly[None, None, :] + 0.5 - height / 2.0) / focal_y
    rx = px.expand(nty, ntx, TILE_PIXELS).reshape(-1, TILE_PIXELS)
    ry = py.expand(nty, ntx, TILE_PIXELS).reshape(-1, TILE_PIXELS)
    return rx, ry


def blend_tile(payload_tile: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
               bg: torch.Tensor) -> torch.Tensor:
    """Blend tiles' whole (padded) lists: payload_tile [..., L, 16], rx / ry
    [..., PIX] -> [..., 16, PIX] (channels 0-8 the image, 9 final T, 10 the
    final sum w*m, 11 the median visit index or -1, 12-15 zero)."""
    p = payload_tile
    col = [p[..., k:k + 1] for k in range(PAYLOAD_COLS)]
    terms = blend.ray_terms(*col[4:13], *col[13:16], col[3],
                            rx.unsqueeze(-2), ry.unsqueeze(-2))
    carry = blend.init_carry(rx.shape, rx.dtype, rx.device)
    carry = blend.blend_chunk(carry, terms, p[..., 0:3])
    img = blend.finalize(carry, bg)

    # median visit index for the backward's depth-gradient routing
    a = terms.alpha
    prod_incl = torch.cumprod(1.0 - a, dim=-2)
    T = torch.cat([torch.ones_like(prod_incl[..., :1, :]), prod_incl[..., :-1, :]], dim=-2)
    med_mask = (a > 0) & (T > MEDIAN_THRESHOLD)
    g_idx = torch.arange(a.shape[-2], device=a.device)[:, None]
    med_idx = torch.where(med_mask, g_idx, -1).amax(dim=-2).to(img.dtype)

    extra = torch.stack([carry.transmittance, carry.dist1, med_idx, torch.zeros_like(med_idx)],
                        dim=-2)
    pad = img.new_zeros(img.shape[:-2] + (OUT_CH - 9 - 4, img.shape[-1]))
    return torch.cat([img, extra, pad], dim=-2)


def render_tiles_xla(payload: torch.Tensor, binning: Binning, ntx: int, nty: int, width: int,
                     height: int, focal_x, focal_y, bg: torch.Tensor,
                     max_tile_len: int) -> torch.Tensor:
    """Render all tiles densely -> [NTILES, 16, TILE_PIXELS].

    max_tile_len: padded per-tile list length (>= the longest segment)."""
    dev = payload.device
    seg_start = binning.bounds[:-1].long()
    seg_len = binning.bounds[1:].long() - seg_start
    k = torch.arange(max_tile_len, device=dev)
    idx = torch.clamp(seg_start[:, None] + k[None, :], 0, payload.shape[0] - 1)
    in_range = k[None, :] < seg_len[:, None]
    ptile = torch.where(in_range[..., None], payload[idx], payload.new_zeros(()))
    rx, ry = tile_rays(ntx, nty, width, height, focal_x, focal_y)
    return blend_tile(ptile, rx.to(dev), ry.to(dev), bg)


def assemble_image(tile_out: torch.Tensor, ntx: int, nty: int, width: int, height: int) -> torch.Tensor:
    """[NTILES, C, TILE_PIXELS] -> [C, H, W] crop. Lane l of tile (ty, tx) is
    pixel (ty*32 + l // 32, tx*32 + l % 32)."""
    C = tile_out.shape[1]
    img = tile_out.reshape(nty, ntx, C, TILE_W, TILE_W)
    img = img.permute(2, 0, 3, 1, 4).reshape(C, nty * TILE_W, ntx * TILE_W)
    return img[:, :height, :width]
