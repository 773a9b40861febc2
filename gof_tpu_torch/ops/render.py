"""High-level render API (counterpart of gof_tpu/ops/render.py).

preprocess -> tile rects -> bin_gaussians (class-expansion kernel + sorts)
-> [compact_live, with a liveness limit] -> rasterize (payload gather,
forward blend kernel; backward blend kernel, per-gaussian reduce kernel and
quadric chain in its autograd backward) -> assemble. Differentiable in
means3d, scales, rotations, opacities, shs and the densification carrier;
serving calls it under `torch.no_grad()`.

backend "pallas" (the default) is that kernel path (plain versions on CPU
tensors); "xla" is gof_tpu's reference path, ops/tiled_ref.py's dense
per-tile blend in plain torch on whatever device the tensors are on,
differentiated by autograd. It is used only where a caller asks for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import cameras as cameras_lib
from ..constants import TILE_H, TILE_W, TRANSMITTANCE_EPS
from . import binning, quadrics, tiled_ref
from . import rasterize as rz


@dataclass
class RenderOut:
    """Same fields as gof_tpu's RenderOut.

    image: [9, H, W] — rgb, normal, median depth, alpha, distortion.
    num_keys: the class-padded slot demand (Binning.num_slots), as in gof_tpu.
    overflow / compact_overflow: always False (buffers are sized per view).
    live_counts: [NTILES] chunks the forward walked per tile (CH_LIVEC), the
      next visit's prefix bound; live_bad: tiles cut by a stale bound while
      unsaturated (the step must be skipped); live_overflow: always False;
      live_demand: keys of the compacted list (0 without a limit). The xla
      backend returns zeros for all four, as gof_tpu's does.
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
    carrier: Optional[torch.Tensor] = None,
    active_mask: Optional[torch.Tensor] = None,
    with_stats: bool = True,
    with_reg: bool = True,
    backend: str = "pallas",
    live_limit_chunks: Optional[torch.Tensor] = None,
) -> RenderOut:
    """Render one view. All tensors live on the camera's device; CUDA
    tensors run the CUDA kernels, CPU tensors their plain versions.

    carrier: [P, 3] zeros whose gradient receives the densification
      statistics (the reference's screenspace_points trick); created if None.
    with_stats: carry the statistics columns through the payload and the
      backward (the training step turns it off after densification).
    with_reg: compute the regularizer channels (normals, median depth,
      distortion) and their gradients; without it they render as zeros and
      must receive no cotangent.
    backend: "pallas" (the kernels) or "xla" (ops/tiled_ref.py).
    live_limit_chunks: [NTILES] int per-tile bounds of the live prefix in
      chunks (binning.compact_live; LIM_INF = none), pallas backend only.
    """
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "xla" and live_limit_chunks is not None:
        raise ValueError("live_limit_chunks needs the pallas backend")
    pre = quadrics.preprocess(means3d, scales, rotations, shs, sh_degree, camera, kernel_size,
                              active_mask, opacities=opacities)
    ntx, nty = binning.tile_grid(camera.width, camera.height)
    ntiles = ntx * nty
    rects = binning.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty,
                                   radius_xy=pre.radius_xy)
    # The 2D-dilation compensation is detached, as in gof_tpu (its cov2D
    # backward is disabled in the reference, backward.cu:991-1007).
    coef = pre.coef.detach()
    op_eff = opacities * torch.where(pre.valid, coef, torch.zeros_like(coef))
    with torch.no_grad():  # integer work; it views the depths' bits as int32
        b = binning.bin_gaussians(pre.depth, rects, ntx, nty, mean2d=pre.mean2d,
                                  radius=pre.radius)
    dev = means3d.device
    false = torch.zeros((), dtype=torch.bool, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    if backend == "xla":
        payload = tiled_ref.build_payload(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b)
        max_len = max(int((b.bounds[1:] - b.bounds[:-1]).max()), 1)  # host read
        tile_out = tiled_ref.render_tiles_xla(payload, b, ntx, nty, camera.width, camera.height,
                                              camera.focal_x, camera.focal_y, bg, max_len)
        compact_demand = zero_i
        live_counts = torch.zeros((ntiles,), dtype=torch.int32, device=dev)
        live_bad = torch.zeros((ntiles,), dtype=torch.bool, device=dev)
        live_demand = zero_i
    else:
        if carrier is None:
            carrier = means3d.new_zeros((means3d.shape[0], 3))
        b_blend = b
        if live_limit_chunks is not None:
            with torch.no_grad():
                b_blend, truncated, _, live_demand = binning.compact_live(
                    b, live_limit_chunks, means3d.shape[0])
        meta = rz.RasterMeta(ntx=ntx, nty=nty, width=camera.width, height=camera.height,
                             with_stats=with_stats, with_reg=with_reg)
        tile_out = rz.rasterize(meta, pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, pre.conic,
                                pre.mean2d, carrier, camera.focal_x, camera.focal_y, bg, b_blend)
        aux = tile_out.detach()
        last = aux[ntiles - 1]
        compact_demand = (last[rz.CH_CSTART, 0]
                          + last[rz.CH_LIVEC, 0] * rz.CHUNK_SIZE).to(torch.int32)
        live_counts = aux[:, rz.CH_LIVEC, 0].to(torch.int32)
        if live_limit_chunks is not None:
            # a tile cut by a stale bound while any of its in-image pixels
            # was unsaturated rendered (and differentiates) wrong; padding
            # pixels of edge tiles never saturate, so they are masked out
            t_idx = torch.arange(ntiles, device=dev)[:, None]
            p_idx = torch.arange(rz.NPIX, device=dev)[None, :]
            in_img = (((t_idx // ntx) * TILE_H + p_idx // TILE_W < camera.height)
                      & ((t_idx % ntx) * TILE_W + p_idx % TILE_W < camera.width))
            tfin = torch.where(in_img, aux[:, rz.CH_TFINAL], torch.zeros_like(aux[:, 0]))
            live_bad = truncated & (tfin.amax(dim=1) >= TRANSMITTANCE_EPS)
        else:
            live_bad = torch.zeros((ntiles,), dtype=torch.bool, device=dev)
            live_demand = zero_i

    full = tiled_ref.assemble_image(tile_out, ntx, nty, camera.width, camera.height)
    radii = torch.where(pre.valid, pre.radius, torch.zeros_like(pre.radius)).detach()
    return RenderOut(
        image=full[:9],
        transmittance=full[rz.CH_TFINAL],
        radii=radii,
        visibility=radii > 0,
        num_keys=b.num_slots,
        overflow=b.overflow,
        compact_demand=compact_demand,
        compact_overflow=false,
        live_counts=live_counts,
        live_bad=live_bad,
        live_overflow=false,
        live_demand=live_demand,
    )
