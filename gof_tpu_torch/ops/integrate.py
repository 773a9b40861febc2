"""Opacity-field evaluation at arbitrary 3D points (counterpart of
gof_tpu/ops/integrate.py).

Per query point p in one view: ray r = (x/z, y/z, 1) in view space; over
the gaussians binned to p's tile, in depth order:

  t*    = min(t_peak, depth(p))
  alpha = min(0.99, op * exp(-0.5 |u0 + t* d|^2)),
          counted only if t_peak > NEAR_PLANE and alpha >= 1/255
  T    *= 1 - alpha                    (no early exit)

Points that project into no pixel, or lie behind the camera, keep T = 1.

`integrate_transmittance` runs kernel csrc/integrate.cu on CUDA tensors and
its plain version `integrate_transmittance_reference` on CPU tensors. Both
multiply T serially in row order and skip inactive and out-of-segment rows
(the plain version multiplies them by exactly 1), so they agree to the bit
and a non-finite row of a neighbouring tile cannot leak in. gof_tpu's
kernel multiplies a log-doubling cumprod per 128-row chunk and forms d on
the MXU: the port agrees with it to a tolerance.

Sizes follow the demand, as in ops/binning.py: the point slots are counted
on the host once per call, so there are no padding blocks and block b holds
point slots [b * PBLOCK, (b + 1) * PBLOCK) (gof_tpu's block_ofs and
block_real are implied). The kernel writes each point's T straight to its
index in an [N] output that starts at 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..constants import ALPHA_MAX, ALPHA_MIN, NEAR_PLANE, TILE_H, TILE_W
from . import cuda_lib
from .binning import CHUNK_SIZE, AlignedBins, Binning, bin_items_aligned

PBLOCK = 1024  # query points per kernel block
# point blocks per step of the plain version: bounds its [blocks, 128, 1024]
# temporaries to 64 MB each
REF_BLOCK_GROUP = 128

INTEGRATE = cuda_lib.LaunchCounter("integrate")


@dataclass
class PointBins:
    bins: AlignedBins  # point binning (block = PBLOCK)
    n_blocks: int  # block b holds point slots [b * PBLOCK, (b + 1) * PBLOCK)
    block_tile: torch.Tensor  # [B] int32 tile id per block
    rx: torch.Tensor  # [B * PBLOCK] per-slot ray slopes and view depth
    ry: torch.Tensor
    depth: torch.Tensor
    point_of_slot: torch.Tensor  # [B * PBLOCK] int32 point index (N = padding)


def _ray_and_pixel(points: torch.Tensor, camera):
    """View-space ray slopes, depth, continuous pixel and validity: the point
    projects into the image from in front of the camera."""
    from ..transforms import ndc_to_pixel, project_points

    wv = camera.world_view
    pv = points @ wv[:3, :3].T + wv[:3, 3]
    z = pv[:, 2]
    ok = z > 1e-4
    zs = torch.where(ok, z, torch.ones_like(z))
    rx, ry = pv[:, 0] / zs, pv[:, 1] / zs
    ndc = project_points(points, camera.full_proj)
    px = ndc_to_pixel(ndc[:, 0], camera.width)
    py = ndc_to_pixel(ndc[:, 1], camera.height)
    ok = ok & (px >= 0) & (px < camera.width) & (py >= 0) & (py < camera.height)
    return rx, ry, z, px, py, ok


def bin_points(points: torch.Tensor, camera, ntx: int, nty: int) -> PointBins:
    """Bin query points to tiles (one tile per point), PBLOCK-aligned. The
    tile comes from the projected pixel truncated by the tile size, the ray
    from the view transform, as in gof_tpu."""
    N = points.shape[0]
    rx, ry, z, px, py, valid = _ray_and_pixel(points, camera)
    ntiles = ntx * nty
    # clamp before the cast: gof_tpu's XLA cast saturates, torch's does not
    tx = torch.clamp(px / TILE_W, 0, ntx - 1).to(torch.int32)
    ty = torch.clamp(py / TILE_H, 0, nty - 1).to(torch.int32)
    tile_of_point = torch.where(valid, ty * ntx + tx, ntiles)
    b = bin_items_aligned(tile_of_point, ntiles, PBLOCK)

    slot = b.slot_to_item.long()

    def gather(x):  # padding slots (item N) read an appended zero
        return torch.cat([x, x.new_zeros(1)])[slot]

    n_blocks = b.slot_to_item.shape[0] // PBLOCK
    dev = points.device
    block_tile = torch.repeat_interleave(
        torch.arange(ntiles, dtype=torch.int32, device=dev), b.tile_blocks.long(),
        output_size=n_blocks)
    return PointBins(
        bins=b,
        n_blocks=n_blocks,
        block_tile=block_tile,
        rx=gather(rx),
        ry=gather(ry),
        depth=gather(z),
        point_of_slot=b.slot_to_item,
    )


def integrate_transmittance_reference(payload: torch.Tensor, gauss_bins: Binning,
                                      pbins: PointBins, n_points: int) -> torch.Tensor:
    """Plain version of the integrate kernel: per-point T in one view, [N].

    Point block by point block, REF_BLOCK_GROUP blocks at a time: each
    128-row window of the blocks' gaussian segments is one
    [blocks, 128, PBLOCK] step, and T is carried by a cumprod over
    [T, 1 - a_0, 1 - a_1, ...] along the row axis, which scans serially as
    the kernel's loop multiplies.
    """
    dev = payload.device
    cap = payload.shape[1]
    pay_rows = payload.T  # [CAP, 16]
    bounds = gauss_bins.bounds.to(torch.int64)
    rows = torch.arange(CHUNK_SIZE, device=dev)
    lanes = torch.arange(PBLOCK, device=dev)
    result = torch.ones(n_points + 1, dtype=torch.float32, device=dev)  # [N] is padding's
    for b0 in range(0, pbins.n_blocks, REF_BLOCK_GROUP):
        blk = torch.arange(b0, min(b0 + REF_BLOCK_GROUP, pbins.n_blocks), device=dev)
        tile = pbins.block_tile[blk].long()
        seg_s, seg_e = bounds[tile], bounds[tile + 1]
        base = (seg_s // CHUNK_SIZE) * CHUNK_SIZE
        nc = torch.where(seg_e > seg_s, (seg_e - base + CHUNK_SIZE - 1) // CHUNK_SIZE,
                         torch.zeros_like(seg_s))
        slots = blk[:, None] * PBLOCK + lanes[None, :]  # [G, PBLOCK]
        rx = pbins.rx[slots][:, None, :]  # [G, 1, PBLOCK]
        ry = pbins.ry[slots][:, None, :]
        z = pbins.depth[slots][:, None, :]
        T = torch.ones(slots.shape, dtype=torch.float32, device=dev)
        for c in range(int(nc.max()) if len(blk) else 0):
            g = base[:, None] + c * CHUNK_SIZE + rows[None, :]  # [G, 128]
            seg = (g >= seg_s[:, None]) & (g < seg_e[:, None])
            p = pay_rows[torch.clamp(g, 0, cap - 1)]  # [G, 128, 16]

            def col(k):
                return p[..., k:k + 1]  # [G, 128, 1]

            d0 = col(4) * rx + col(5) * ry + col(6)
            d1 = col(7) * rx + col(8) * ry + col(9)
            d2 = col(10) * rx + col(11) * ry + col(12)
            ud = col(13) * d0 + col(14) * d1 + col(15) * d2
            dd = d0 * d0 + d1 * d1 + d2 * d2 + 1e-12
            t = -ud / dd
            # clamp the evaluation depth to the query point (forward.cu:1173-1176)
            t_star = torch.minimum(t, z)
            v0 = col(13) + t_star * d0
            v1 = col(14) + t_star * d1
            v2 = col(15) + t_star * d2
            mv = v0 * v0 + v1 * v1 + v2 * v2
            opE = col(3) * torch.exp(-0.5 * mv)
            a_raw = torch.where(opE > ALPHA_MAX, torch.full_like(opE, ALPHA_MAX), opE)
            active = (t > NEAR_PLANE) & (a_raw >= ALPHA_MIN) & seg[..., None]
            a = torch.where(active, a_raw, torch.zeros_like(a_raw))
            T = torch.cumprod(torch.cat([T[:, None], 1.0 - a], dim=1), dim=1)[:, CHUNK_SIZE]
        result[pbins.point_of_slot[slots].long()] = T
    return result[:n_points]


def integrate_transmittance(payload: torch.Tensor, gauss_bins: Binning, pbins: PointBins,
                            n_points: int) -> torch.Tensor:
    """Per-point transmittance T in one view, [n_points] f32; 1 for points
    that do not project (gof_tpu's integrate_transmittance_pallas).

    payload: [16, CAP] in the rasterizer's layout (ops/rasterize.py
    build_payload16); gauss_bins: its binning; pbins: bin_points' output.
    CPU tensors take `integrate_transmittance_reference`; CUDA tensors
    launch csrc/integrate.cu or raise.
    """
    if payload.device.type == "cpu":
        return integrate_transmittance_reference(payload, gauss_bins, pbins, n_points)
    dev = payload.device
    bounds = gauss_bins.bounds
    ps = pbins.point_of_slot
    cuda_lib.require(payload.is_cuda and all(x.device == dev for x in (
        bounds, pbins.block_tile, pbins.rx, pbins.ry, pbins.depth, ps)),
        "integrate: payload, bins and point rays must share one CUDA device")
    cuda_lib.require(payload.dtype == torch.float32 and bounds.dtype == torch.int32
                     and ps.dtype == torch.int32
                     and all(x.dtype == torch.float32 for x in (pbins.rx, pbins.ry, pbins.depth)),
                     "integrate: dtypes (need float32 payload and rays, int32 indices)")
    cuda_lib.require(payload.dim() == 2 and payload.shape[0] == 16
                     and payload.shape[1] % CHUNK_SIZE == 0,
                     f"integrate: payload {tuple(payload.shape)} (need [16, k*128])")
    nslots = ps.shape[0]
    cuda_lib.require(nslots == pbins.n_blocks * PBLOCK
                     and all(x.shape == (nslots,) for x in (pbins.rx, pbins.ry, pbins.depth)),
                     "integrate: point slots must be n_blocks * PBLOCK long")
    cuda_lib.require(payload.is_contiguous() and bounds.is_contiguous() and ps.is_contiguous(),
                     "integrate: non-contiguous input")
    tile = pbins.block_tile.long()
    seg_s = bounds[tile].contiguous()
    seg_e = bounds[tile + 1].contiguous()
    rays = torch.stack([pbins.rx, pbins.ry, pbins.depth]).contiguous()  # [3, S]
    out = torch.ones(n_points, dtype=torch.float32, device=dev)
    if pbins.n_blocks == 0:
        return out
    rc = cuda_lib.library().gof_integrate(
        dev.index, payload.data_ptr(), payload.shape[1], seg_s.data_ptr(),
        seg_e.data_ptr(), pbins.n_blocks, rays.data_ptr(), nslots, ps.data_ptr(), n_points,
        out.data_ptr(), cuda_lib.stream_ptr(payload))
    cuda_lib.check(rc, "integrate")
    INTEGRATE.launches += 1
    return out


def integrate_transmittance_dense(points, camera, op_eff, M, u0, valid) -> torch.Tensor:
    """Dense O(N*P) twin: transmittance of each point in one view, with no
    tile culling (tests only)."""
    rx, ry, z, _, _, ok = _ray_and_pixel(points, camera)
    r = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)  # [N, 3]
    d = torch.einsum("pij,nj->pni", M, r)  # [P, N, 3]
    dd = torch.sum(d * d, dim=-1) + 1e-12
    ud = torch.einsum("pi,pni->pn", u0, d)
    t_peak = -ud / dd
    t_star = torch.minimum(t_peak, z[None, :])
    v = u0[:, None, :] + t_star[..., None] * d
    mv = torch.sum(v * v, dim=-1)
    a = torch.clamp_max((op_eff * valid)[:, None] * torch.exp(-0.5 * mv), ALPHA_MAX)
    a = torch.where((t_peak > NEAR_PLANE) & (a >= ALPHA_MIN), a, torch.zeros_like(a))
    T = torch.prod(1.0 - a, dim=0)
    return torch.where(ok, T, torch.ones_like(T))
