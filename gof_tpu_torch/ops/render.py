"""High-level render API (counterpart of gof_tpu/ops/render.py), forward only.

preprocess -> tile rects -> bin_gaussians (class-expansion kernel + sorts)
-> payload gather -> forward blend kernel -> assemble. Gradients come with
the backward kernel; until then `render` runs under `torch.no_grad()`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import cameras as cameras_lib
from . import binning, quadrics, tiled_ref
from . import rasterize as rz


@dataclass
class RenderOut:
    """Same fields as gof_tpu's RenderOut.

    image: [9, H, W] — rgb, normal, median depth, alpha, distortion.
    num_keys: the class-padded slot demand (Binning.num_slots), as in gof_tpu.
    overflow / compact_overflow: always False (buffers are sized per view).
    live_*: zeros (liveness culling is not ported).
    """

    image: torch.Tensor
    transmittance: torch.Tensor
    radii: torch.Tensor
    visibility: torch.Tensor
    num_keys: torch.Tensor
    overflow: torch.Tensor
    compact_demand: torch.Tensor
    compact_overflow: torch.Tensor
    live_counts: Optional[torch.Tensor] = None
    live_bad: Optional[torch.Tensor] = None
    live_overflow: Optional[torch.Tensor] = None
    live_demand: Optional[torch.Tensor] = None


@torch.no_grad()
def render(
    camera: cameras_lib.Camera,
    means3d: torch.Tensor,
    scales: torch.Tensor,  # 3D-filtered scales
    rotations: torch.Tensor,
    opacities: torch.Tensor,  # 3D-filtered opacities
    shs: torch.Tensor,
    sh_degree: int,
    kernel_size: float,
    bg: torch.Tensor,
    active_mask: Optional[torch.Tensor] = None,
    with_reg: bool = True,
) -> RenderOut:
    """Render one view. All tensors live on the camera's device; CUDA
    tensors run the CUDA kernels, CPU tensors their plain versions."""
    pre = quadrics.preprocess(means3d, scales, rotations, shs, sh_degree, camera, kernel_size,
                              active_mask, opacities=opacities)
    ntx, nty = binning.tile_grid(camera.width, camera.height)
    ntiles = ntx * nty
    rects = binning.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty,
                                   radius_xy=pre.radius_xy)
    op_eff = opacities * torch.where(pre.valid, pre.coef, torch.zeros_like(pre.coef))
    b = binning.bin_gaussians(pre.depth, rects, ntx, nty, mean2d=pre.mean2d, radius=pre.radius)
    payload = rz.build_payload16(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b)
    meta = rz._meta_vec(camera.focal_x, camera.focal_y, bg, camera.width, camera.height)
    tile_out = rz.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=with_reg)

    last = tile_out[ntiles - 1]
    compact_demand = (last[rz.CH_CSTART, 0] + last[rz.CH_LIVEC, 0] * rz.CHUNK_SIZE).to(torch.int32)
    full = tiled_ref.assemble_image(tile_out, ntx, nty, camera.width, camera.height)
    radii = torch.where(pre.valid, pre.radius, torch.zeros_like(pre.radius))
    dev = means3d.device
    false = torch.zeros((), dtype=torch.bool, device=dev)
    return RenderOut(
        image=full[:9],
        transmittance=full[rz.CH_TFINAL],
        radii=radii,
        visibility=radii > 0,
        num_keys=b.num_slots,
        overflow=b.overflow,
        compact_demand=compact_demand,
        compact_overflow=false,
        live_counts=torch.zeros((ntiles,), dtype=torch.int32, device=dev),
        live_bad=torch.zeros((ntiles,), dtype=torch.bool, device=dev),
        live_overflow=false,
        live_demand=torch.zeros((), dtype=torch.int32, device=dev),
    )
