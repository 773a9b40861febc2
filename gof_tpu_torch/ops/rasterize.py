"""Tiled ray-Gaussian blend, forward (counterpart of
gof_tpu/ops/rasterize_pallas.py).

`rasterize_fwd` runs kernel csrc/rasterize_fwd.cu on CUDA tensors and its
plain PyTorch version `rasterize_fwd_reference` on CPU tensors. Both follow
gof_tpu's `_fwd_kernel` (rasterize_pallas.py:344) in every convention the
backward port will rely on:

- each tile walks CHUNK_SIZE-row windows that start at the aligned-down
  `base = floor(seg_s / 128) * 128`, masking rows outside [seg_s, seg_e);
  CH_LIVEC counts these windows;
- CH_MEDIDX is relative to `base` (c * 128 + row), not to the segment start;
- the early exit is tested only at window boundaries, by a vote over all
  1024 lanes of the tile, out-of-image pixels of edge tiles included;
- inside a window T keeps multiplying through every active row after a
  pixel saturates; only the contributions are masked by T > 1e-4;
- CH_CSTART, the tile's start in the backward's compact layout, is an
  exclusive scan of CH_LIVEC * 128 over tiles, taken after the blend (the
  TPU kernel carried it in a cursor across its in-order grid).

Unlike gof_tpu, rows outside the segment or inactive are skipped by a
branch (kernel) or a select (plain version), never multiplied by zero, so
a non-finite payload row cannot leak into another tile's pixels.

The plain version runs each window as one [NTILES, 128, 1024] step. Its
in-window transmittance is a cumprod over [T, 1 - a_0, 1 - a_1, ...] and its
sums are cumsums seeded with the running value: on CUDA both scan serially
along that axis, so they round exactly as the kernel's serial loop does.
"""

from __future__ import annotations

import torch

from ..constants import (
    ALPHA_MAX,
    ALPHA_MIN,
    FAR_PLANE,
    MEDIAN_THRESHOLD,
    NEAR_PLANE,
    TILE_W,
    TRANSMITTANCE_EPS,
)
from . import cuda_lib
from .binning import CHUNK_SIZE, Binning

# Payload layout: one 16-f32 column per (tile, Gaussian) slot, [16, CAP]
P_COLS = 16
C_RGB = 0  # 0:3
C_OP = 3
C_M = 4  # 4:13 row-major
C_U0 = 13  # 13:16

NPIX = 1024
OUT_CH = 16
CH_TFINAL = 9
CH_DFINAL = 10
CH_MEDIDX = 11
CH_LIVEC = 12
CH_CSTART = 13

FWD = cuda_lib.LaunchCounter("rasterize_fwd")


def build_payload16(rgb, op_eff, M, u0, binning: Binning) -> torch.Tensor:
    """Gather per-Gaussian rows into the sorted slot layout, [16, CAP] f32.
    Sentinel slots (id P) gather an appended zero row."""
    P = rgb.shape[0]
    flat = torch.cat([rgb, op_eff[:, None], M.reshape(P, 9), u0], dim=1).to(torch.float32)
    flat = torch.cat([flat, flat.new_zeros((1, P_COLS))], dim=0)
    return flat[binning.slot_to_gaussian.long()].T.contiguous()


def _meta_vec(focal_x, focal_y, bg, width, height) -> torch.Tensor:
    """[1, 8] f32: fx, fy, bg rgb, width / 2, height / 2, 0."""
    dev = bg.device
    vals = [torch.as_tensor(focal_x, dtype=torch.float32, device=dev),
            torch.as_tensor(focal_y, dtype=torch.float32, device=dev),
            bg[0].to(torch.float32), bg[1].to(torch.float32), bg[2].to(torch.float32),
            torch.tensor(width / 2.0, dtype=torch.float32, device=dev),
            torch.tensor(height / 2.0, dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.float32, device=dev)]
    return torch.stack(vals)[None, :]


def _ndc_m(t):
    tc = torch.clamp_min(t, NEAR_PLANE)
    return (FAR_PLANE * tc - FAR_PLANE * NEAR_PLANE) / ((FAR_PLANE - NEAR_PLANE) * tc)


def _compact_layout(out: torch.Tensor, livec: torch.Tensor) -> torch.Tensor:
    """Write CH_LIVEC and CH_CSTART (exclusive scan of livec * 128)."""
    rows = livec.to(torch.int64) * CHUNK_SIZE
    cstart = torch.cumsum(rows, 0) - rows
    out[:, CH_LIVEC, :] = livec.to(torch.float32)[:, None]
    out[:, CH_CSTART, :] = cstart.to(torch.float32)[:, None]
    return out


def rasterize_fwd_reference(payload: torch.Tensor, binning: Binning, meta_vec: torch.Tensor,
                            ntx: int, ntiles: int, with_reg: bool = True) -> torch.Tensor:
    """Plain version of the forward blend: [16, CAP] payload ->
    [NTILES, 16, 1024], window by window over all tiles at once."""
    dev = payload.device
    cap = payload.shape[1]
    pay_rows = payload.T  # [CAP, 16]
    bounds = binning.bounds.to(torch.int64)
    seg_s, seg_e = bounds[:-1], bounds[1:]
    base = (seg_s // CHUNK_SIZE) * CHUNK_SIZE
    nc = torch.where(seg_e > seg_s, (seg_e - base + CHUNK_SIZE - 1) // CHUNK_SIZE,
                     torch.zeros_like(seg_s))
    fx, fy = meta_vec[0, 0], meta_vec[0, 1]
    half_w, half_h = meta_vec[0, 5], meta_vec[0, 6]

    lane = torch.arange(NPIX, device=dev)
    lx = (lane % TILE_W).to(torch.float32)
    ly = (lane // TILE_W).to(torch.float32)
    tid = torch.arange(ntiles, device=dev)
    tx = ((tid % ntx) * TILE_W).to(torch.float32)
    ty = ((tid // ntx) * TILE_W).to(torch.float32)
    rx = (((tx[:, None] + lx[None, :]) + 0.5 - half_w) / fx)[:, None, :]  # [NT, 1, PIX]
    ry = (((ty[:, None] + ly[None, :]) + 0.5 - half_h) / fy)[:, None, :]

    def zeros():
        return torch.zeros((ntiles, NPIX), dtype=torch.float32, device=dev)

    T = torch.ones((ntiles, NPIX), dtype=torch.float32, device=dev)
    r0, r1, r2, m0, m1, m2, acc, s1, s2, depth = (zeros() for _ in range(10))
    med = torch.full((ntiles, NPIX), -1, dtype=torch.int64, device=dev)
    livec = torch.zeros(ntiles, dtype=torch.int64, device=dev)
    rows = torch.arange(CHUNK_SIZE, device=dev)

    def scan_sum(x0, contrib):
        # x0 + contrib[:, 0] + contrib[:, 1] + ..., in row order
        return torch.cumsum(torch.cat([x0[:, None], contrib], dim=1), dim=1)[:, -1]

    c = 0
    while True:
        running = (c < nc) & (T.amax(dim=1) >= TRANSMITTANCE_EPS)
        if not bool(running.any()):
            break
        g = base[:, None] + c * CHUNK_SIZE + rows[None, :]  # [NT, 128]
        seg = (g >= seg_s[:, None]) & (g < seg_e[:, None]) & running[:, None]
        p = pay_rows[torch.clamp(g, 0, cap - 1)]  # [NT, 128, 16]

        def col(k):
            return p[..., k:k + 1]  # [NT, 128, 1]

        d0 = col(4) * rx + col(5) * ry + col(6)
        d1 = col(7) * rx + col(8) * ry + col(9)
        d2 = col(10) * rx + col(11) * ry + col(12)
        ud = col(13) * d0 + col(14) * d1 + col(15) * d2
        dd = d0 * d0 + d1 * d1 + d2 * d2 + 1e-12
        t = -ud / dd
        v0 = col(13) + t * d0
        v1 = col(14) + t * d1
        v2 = col(15) + t * d2
        mv = v0 * v0 + v1 * v1 + v2 * v2
        opE = col(3) * torch.exp(-0.5 * mv)
        a_raw = torch.where(opE > ALPHA_MAX, torch.full_like(opE, ALPHA_MAX), opE)
        active = (t > NEAR_PLANE) & (a_raw >= ALPHA_MIN) & seg[..., None]
        a = torch.where(active, a_raw, torch.zeros_like(a_raw))

        cp = torch.cumprod(torch.cat([T[:, None], 1.0 - a], dim=1), dim=1)
        T_excl = cp[:, :CHUNK_SIZE]
        wmask = active & (T_excl > TRANSMITTANCE_EPS)
        zero = torch.zeros_like(a)
        w = torch.where(wmask, a * T_excl, zero)

        def contrib(x):
            return torch.where(wmask, x, zero)

        r0 = scan_sum(r0, contrib(col(0) * w))
        r1 = scan_sum(r1, contrib(col(1) * w))
        r2 = scan_sum(r2, contrib(col(2) * w))
        acc = scan_sum(acc, w)
        if with_reg:
            m = _ndc_m(t)
            wm = w * m
            n0 = col(4) * d0 + col(7) * d1 + col(10) * d2
            n1 = col(5) * d0 + col(8) * d1 + col(11) * d2
            n2 = col(6) * d0 + col(9) * d1 + col(12) * d2
            inv_len = torch.rsqrt(n0 * n0 + n1 * n1 + n2 * n2 + 1e-7)
            sneg = inv_len * w
            m0 = scan_sum(m0, contrib(-(n0 * sneg)))
            m1 = scan_sum(m1, contrib(-(n1 * sneg)))
            m2 = scan_sum(m2, contrib(-(n2 * sneg)))
            s1 = scan_sum(s1, contrib(wm))
            s2 = scan_sum(s2, contrib(wm * m))

            med_mask = wmask & (T_excl > MEDIAN_THRESHOLD)
            idxloc = torch.where(med_mask, rows[None, :, None], -1).amax(dim=1)  # [NT, PIX]
            has = idxloc >= 0
            tmed = torch.gather(t, 1, torch.clamp_min(idxloc, 0)[:, None, :])[:, 0]
            depth = torch.where(has, tmed, depth)
            med = torch.where(has, c * CHUNK_SIZE + idxloc, med)

        T = cp[:, CHUNK_SIZE]
        livec += running.to(torch.int64)
        c += 1

    omT = 1.0 - T
    dist = (acc * s2 - s1 * s1) / (omT * omT + 1e-7)
    bg0, bg1, bg2 = meta_vec[0, 2], meta_vec[0, 3], meta_vec[0, 4]
    z = zeros()
    out = torch.stack([r0 + T * bg0, r1 + T * bg1, r2 + T * bg2, m0, m1, m2, depth, acc,
                       dist, T, s1, med.to(torch.float32), z, z, z, z], dim=1)
    return _compact_layout(out, livec)


def rasterize_fwd(payload: torch.Tensor, binning: Binning, meta_vec: torch.Tensor,
                  ntx: int, ntiles: int, with_reg: bool = True) -> torch.Tensor:
    """Forward blend -> [NTILES, 16, 1024] f32 (channels as in gof_tpu).

    CPU tensors take `rasterize_fwd_reference`; CUDA tensors launch
    csrc/rasterize_fwd.cu or raise.
    """
    if payload.device.type == "cpu":
        return rasterize_fwd_reference(payload, binning, meta_vec, ntx, ntiles, with_reg)
    bounds = binning.bounds
    cuda_lib.require(payload.is_cuda and bounds.device == payload.device
                     and meta_vec.device == payload.device,
                     "rasterize_fwd: payload, bounds and meta must share one CUDA device")
    cuda_lib.require(payload.dtype == torch.float32 and meta_vec.dtype == torch.float32
                     and bounds.dtype == torch.int32, "rasterize_fwd: dtypes")
    cuda_lib.require(payload.dim() == 2 and payload.shape[0] >= P_COLS
                     and payload.shape[1] % CHUNK_SIZE == 0,
                     f"rasterize_fwd: payload {tuple(payload.shape)} (need [16, k*128])")
    cuda_lib.require(tuple(bounds.shape) == (ntiles + 1,) and tuple(meta_vec.shape) == (1, 8),
                     "rasterize_fwd: bounds [NTILES+1], meta [1, 8]")
    cuda_lib.require(payload.is_contiguous() and bounds.is_contiguous()
                     and meta_vec.is_contiguous(), "rasterize_fwd: non-contiguous input")
    out = torch.empty((ntiles, OUT_CH, NPIX), dtype=torch.float32, device=payload.device)
    livec = torch.empty((ntiles,), dtype=torch.int32, device=payload.device)
    rc = cuda_lib.library().gof_rasterize_fwd(
        payload.device.index, payload.data_ptr(), payload.shape[1], bounds.data_ptr(),
        meta_vec.data_ptr(), ntx, ntiles, int(with_reg), out.data_ptr(), livec.data_ptr(),
        cuda_lib.stream_ptr(payload))
    cuda_lib.check(rc, "rasterize_fwd")
    FWD.launches += 1
    return _compact_layout(out, livec)
