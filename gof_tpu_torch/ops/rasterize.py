"""Tiled ray-Gaussian blend, forward and backward (counterpart of
gof_tpu/ops/rasterize_pallas.py).

`rasterize_fwd` runs kernel csrc/rasterize_fwd.cu on CUDA tensors and its
plain PyTorch version `rasterize_fwd_reference` on CPU tensors;
`rasterize_bwd` likewise runs csrc/rasterize_bwd.cu or
`rasterize_bwd_reference`. `rasterize` (a `torch.autograd.Function`) joins
them with the per-gaussian reduction (ops/reduce.py) and the per-gaussian
chain back to (M, u0), returning gof_tpu's cotangents. Both directions
follow gof_tpu's `_fwd_kernel` (rasterize_pallas.py:344) in every
convention the backward relies on:

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
in-window transmittance is a cumprod over [T, 1 - a_0, 1 - a_1, ...], which
scans serially along that axis, so T, the median depth and the median
visit round exactly as the kernel's chain (csrc/ray_alpha.cuh) does; its
sums are cumsums seeded with the running value, which the kernel forms on
FMAs, so the colour, alpha, normal, distortion and s1 channels agree to a
tolerance.

The backward recomputes T with that same serial arithmetic (not gof_tpu's
`T * shift_down(prod_incl)`), so its T > 1e-4 cutoff and median visit agree
with the forward bit for bit, and rebuilds the suffix sums by subtraction
from the forward totals, as gof_tpu does, but takes them as exactly zero
past the T > 1e-4 cutoff (gof_tpu keeps the subtraction's rounding residue
there, so a row's gradient depended on where the walk's windows end). It keeps gof_tpu's quirks
(rasterize_pallas.py:46-53): the distortion gradient flows through the
mapped depth m only, the median-depth gradient goes to the median visit
only, the 0.99 alpha clamp is ignored in dop and dL/dmv, and the caller
detaches the dilation coef. Its gradient rows cover the live windows only,
packed at each tile's CH_CSTART, with the gaussian ids in an int32 stream.
Both versions write the rows into one row-major buffer, [R, 16] or [R, 24]
with the statistics in columns 16:24 (`bwd_rows`, which the train step
calls and whose buffer `reduce_compact_rows` reduces as it is);
`rasterize_bwd` returns gof_tpu's [16, R] and [8, R] arrays as views of it.
"""

from __future__ import annotations

from typing import NamedTuple

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
# densification-statistics payload: conic 16:19 | mean2d 19:21 | pad 21:24
PAYLOAD_STATS_COLS = 24
# statistics rows of the backward: 0 gx | 1 gy | 2 |gx|+|gy| | 3:8 pad
STAT_COLS = 8

NPIX = 1024
OUT_CH = 16
CH_TFINAL = 9
CH_DFINAL = 10
CH_MEDIDX = 11
CH_LIVEC = 12
CH_CSTART = 13

FWD = cuda_lib.LaunchCounter("rasterize_fwd")
BWD = cuda_lib.LaunchCounter("rasterize_bwd")
# tiles per step of the plain backward: bounds its [tiles, 128, 1024]
# temporaries to ~64 MB each at full size
BWD_TILE_BLOCK = 128


def build_payload16(rgb, op_eff, M, u0, binning: Binning, conic=None, mean2d=None) -> torch.Tensor:
    """Gather per-Gaussian rows into the sorted slot layout, [16, CAP] f32,
    or [24, CAP] with the statistics columns (conic 16:19, mean2d 19:21,
    zero pad) when conic and mean2d are given. Sentinel slots (id P) gather
    an appended zero row."""
    P = rgb.shape[0]
    cols = [rgb, op_eff[:, None], M.reshape(P, 9), u0]
    if conic is not None:
        cols += [conic, mean2d, rgb.new_zeros((P, PAYLOAD_STATS_COLS - 21))]
    flat = torch.cat(cols, dim=1).to(rgb.dtype)
    flat = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))], dim=0)
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


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------


def compact_capacity_for(capacity: int, ntiles: int) -> int:
    """Compact-buffer size that can never overflow (every tile fully live)."""
    return capacity + ntiles * CHUNK_SIZE


def _bwd_tiles(payload, fout, gout, binning, meta_vec, ntx, tids, halfw, halfh,
               with_stats, with_reg, dslot, gidc, stats):
    """Plain backward of tiles `tids`, window by window as [NT, 128, 1024]
    steps; writes their gradient rows, ids and statistics in place."""
    dev = payload.device
    cap = payload.shape[1]
    R = dslot.shape[1]
    pay_rows = payload.T  # [CAP, pcols]
    bounds = binning.bounds.to(torch.int64)
    seg_s, seg_e = bounds[tids], bounds[tids + 1]
    base = (seg_s // CHUNK_SIZE) * CHUNK_SIZE
    nc = torch.where(seg_e > seg_s, (seg_e - base + CHUNK_SIZE - 1) // CHUNK_SIZE,
                     torch.zeros_like(seg_s))
    fo, go = fout[tids], gout[tids]
    livec = fo[:, CH_LIVEC, 0].to(torch.int64)
    cst = fo[:, CH_CSTART, 0].to(torch.int64)
    avail = torch.clamp_min((R - cst) // CHUNK_SIZE, 0)
    nc = torch.minimum(torch.minimum(nc, livec), avail)
    n_windows = int(nc.max()) if len(tids) else 0
    if n_windows == 0:
        return

    fx, fy = meta_vec[0, 0], meta_vec[0, 1]
    bg0, bg1, bg2 = meta_vec[0, 2], meta_vec[0, 3], meta_vec[0, 4]
    half_w, half_h = meta_vec[0, 5], meta_vec[0, 6]
    lane = torch.arange(NPIX, device=dev)
    lx = (lane % TILE_W).to(torch.float32)
    ly = (lane // TILE_W).to(torch.float32)
    tx = ((tids % ntx) * TILE_W).to(torch.float32)
    ty = ((tids // ntx) * TILE_W).to(torch.float32)
    pxc = (tx[:, None] + lx[None, :]) + 0.5
    pyc = (ty[:, None] + ly[None, :]) + 0.5
    rx = ((pxc - half_w) / fx)[:, None, :]  # [NT, 1, PIX]
    ry = ((pyc - half_h) / fy)[:, None, :]
    pxm, pym = (pxc - 0.5)[:, None, :], (pyc - 0.5)[:, None, :]
    rxx, rxy, ryy = rx * rx, rx * ry, ry * ry

    def pix(src, ch):
        return src[:, ch][:, None, :]  # [NT, 1, PIX]

    g0, g1, g2, ga = pix(go, 0), pix(go, 1), pix(go, 2), pix(go, 7)
    T_fin, acc_tot = pix(fo, CH_TFINAL), pix(fo, 7)
    tot = (g0 * (pix(fo, 0) - T_fin * bg0) + g1 * (pix(fo, 1) - T_fin * bg1)
           + g2 * (pix(fo, 2) - T_fin * bg2) + ga * acc_tot)
    if with_reg:
        gn0, gn1, gn2 = pix(go, 3), pix(go, 4), pix(go, 5)
        gdep, gdist = pix(go, 6), pix(go, 8)
        d1_tot, med = pix(fo, CH_DFINAL), pix(fo, CH_MEDIDX)
        tot = tot + (gn0 * pix(fo, 3) + gn1 * pix(fo, 4) + gn2 * pix(fo, 5))
    t_bg = T_fin * (bg0 * g0 + bg1 * g1 + bg2 * g2)

    nt = len(tids)
    T = torch.ones((nt, NPIX), dtype=torch.float32, device=dev)
    PwF = torch.zeros((nt, NPIX), dtype=torch.float32, device=dev)
    rows = torch.arange(CHUNK_SIZE, device=dev)
    for c in range(n_windows):
        run = c < nc
        g = base[:, None] + c * CHUNK_SIZE + rows[None, :]  # [NT, 128]
        seg = (g >= seg_s[:, None]) & (g < seg_e[:, None]) & run[:, None]
        p = pay_rows[torch.clamp(g, 0, cap - 1)]  # [NT, 128, pcols]

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
        E = torch.exp(-0.5 * mv)
        op = col(3)
        opE = op * E
        a_raw = torch.where(opE > ALPHA_MAX, torch.full_like(opE, ALPHA_MAX), opE)
        active = (t > NEAR_PLANE) & (a_raw >= ALPHA_MIN) & seg[..., None]
        zero = torch.zeros_like(a_raw)
        a = torch.where(active, a_raw, zero)

        cp = torch.cumprod(torch.cat([T[:, None], 1.0 - a], dim=1), dim=1)
        T_excl = cp[:, :CHUNK_SIZE]
        cutoff = T_excl > TRANSMITTANCE_EPS
        w = torch.where(active & cutoff, a * T_excl, zero)
        F = col(0) * g0 + col(1) * g1 + col(2) * g2 + ga
        if with_reg:
            n0 = col(4) * d0 + col(7) * d1 + col(10) * d2
            n1 = col(5) * d0 + col(8) * d1 + col(11) * d2
            n2 = col(6) * d0 + col(9) * d1 + col(12) * d2
            inv_len = torch.rsqrt(n0 * n0 + n1 * n1 + n2 * n2 + 1e-7)
            F = F + (-n0 * inv_len) * gn0 + (-n1 * inv_len) * gn1 + (-n2 * inv_len) * gn2
        wF = torch.where(active, w * F, zero)
        incl = torch.cumsum(torch.cat([PwF[:, None], wF], dim=1), dim=1)[:, 1:]
        # past the cutoff every later weight is zero, so the suffix is exactly
        # zero: the subtraction's rounding residue is dropped
        sf = torch.where(cutoff, tot - incl, zero)
        dL_da = torch.where(cutoff, T_excl * F, zero) - (sf + t_bg) / (1.0 - a)
        dop_pix = E * dL_da
        dL_dmv = -0.5 * E * op * dL_da
        s_mv = t * dL_dmv
        if with_reg:
            tc = torch.clamp_min(t, NEAR_PLANE)
            m = _ndc_m(t)
            dL_dm = 2.0 * w * (m * acc_tot - d1_tot) * gdist
            # a tensor numerator: `scalar / tensor` would round twice (reciprocal, then mul)
            dm_dt = (torch.full_like(tc, FAR_PLANE * NEAR_PLANE)
                     / ((FAR_PLANE - NEAR_PLANE) * tc * tc))
            glob_row = (c * CHUNK_SIZE + rows).to(torch.float32)[None, :, None]
            dL_dt = dL_dm * dm_dt + torch.where(glob_row == med, gdep, zero)
            q_t = dL_dt * (1.0 / dd)
            A_ud = 2.0 * s_mv - q_t
            A_dd = t * (s_mv - q_t)
            dnh0, dnh1, dnh2 = w * gn0, w * gn1, w * gn2
            dot_nh = dnh0 * n0 + dnh1 * n1 + dnh2 * n2
            il2 = inv_len * inv_len
            dn0 = (-dnh0 + dot_nh * n0 * il2) * inv_len
            dn1 = (-dnh1 + dot_nh * n1 * il2) * inv_len
            dn2 = (-dnh2 + dot_nh * n2 * il2) * inv_len
            sig = [A_dd * rxx + dn0 * rx,
                   2.0 * (A_dd * rxy) + (dn0 * ry + dn1 * rx),
                   2.0 * (A_dd * rx) + (dn0 + dn2 * rx),
                   A_dd * ryy + dn1 * ry,
                   2.0 * (A_dd * ry) + (dn1 + dn2 * ry),
                   A_dd + dn2]
        else:
            A_ud = 2.0 * s_mv
            A_dd = t * s_mv
            sig = [A_dd * rxx, 2.0 * (A_dd * rxy), 2.0 * (A_dd * rx), A_dd * ryy,
                   2.0 * (A_dd * ry), A_dd]
        terms = [w * g0, w * g1, w * g2, dop_pix, *sig,
                 A_ud * rx, A_ud * ry, A_ud, dL_dmv]
        if with_stats:
            dxp = col(19) - pxm
            dyp = col(20) - pym
            dL_dG2 = op * dL_da
            gx = dL_dG2 * (-E) * (col(16) * dxp + col(17) * dyp) * halfw
            gy = dL_dG2 * (-E) * (col(17) * dxp + col(18) * dyp) * halfh
            terms += [gx, gy, gx.abs() + gy.abs()]
        # inactive pairs contribute nothing, whatever their payload holds
        sums = torch.stack([torch.where(active, x, zero).sum(-1) for x in terms])  # [NS, NT, 128]

        dst = (cst[:, None] + c * CHUNK_SIZE + rows[None, :])[run]  # [n_run, 128]
        dslot[:14, dst] = sums[:14][:, run]
        gidc[dst] = binning.slot_to_gaussian[g[run]]
        if with_stats:
            stats[:3, dst] = sums[14:][:, run]
        T = cp[:, CHUNK_SIZE]
        PwF = incl[:, CHUNK_SIZE - 1]


def _bwd_views(rows, gidc, with_stats: bool):
    """gof_tpu's outputs as views of the row buffer: (dslot [16, R], gidc,
    stats [8, R] or None)."""
    return rows[:, :P_COLS].T, gidc, (rows[:, P_COLS:].T if with_stats else None)


def bwd_rows_reference(payload, fout, gout, binning: Binning, meta_vec, ntx: int, ntiles: int,
                       halfw: float, halfh: float, with_stats: bool = True,
                       with_reg: bool = True, compact_cap: int = 0):
    """Plain version of `bwd_rows`, walking BWD_TILE_BLOCK tiles at a time
    to bound its memory."""
    dev = payload.device
    R = compact_cap or compact_capacity_for(payload.shape[1], ntiles)
    rows = torch.zeros((R, P_COLS + (STAT_COLS if with_stats else 0)), dtype=payload.dtype,
                       device=dev)
    gidc = torch.zeros((R,), dtype=torch.int32, device=dev)
    dslot, _, stats = _bwd_views(rows, gidc, with_stats)
    for t0 in range(0, ntiles, BWD_TILE_BLOCK):
        tids = torch.arange(t0, min(t0 + BWD_TILE_BLOCK, ntiles), device=dev)
        _bwd_tiles(payload, fout, gout, binning, meta_vec, ntx, tids, halfw, halfh,
                   with_stats, with_reg, dslot, gidc, stats)
    return rows, gidc


def rasterize_bwd_reference(payload, fout, gout, binning: Binning, meta_vec, ntx: int,
                            ntiles: int, halfw: float, halfh: float, with_stats: bool = True,
                            with_reg: bool = True, compact_cap: int = 0):
    """Plain version of `rasterize_bwd`."""
    return _bwd_views(*bwd_rows_reference(payload, fout, gout, binning, meta_vec, ntx, ntiles,
                                          halfw, halfh, with_stats, with_reg, compact_cap),
                      with_stats)


def bwd_rows(payload, fout, gout, binning: Binning, meta_vec, ntx: int, ntiles: int,
             halfw: float, halfh: float, with_stats: bool = True, with_reg: bool = True,
             compact_cap: int = 0, t_mismatch=None):
    """The backward blend into one row-major buffer.

    payload: [16, CAP], or [24, CAP] with the statistics columns when
    with_stats; fout: the forward's [NTILES, 16, 1024]; gout: its cotangent.
    Returns (rows [R, 16] f32, or [R, 24] with the statistics in columns
    16:24; gid [R] int32), R = compact_cap or compact_capacity_for(CAP,
    ntiles): each tile's live windows land at the forward's CH_CSTART, one
    row per slot; rows past the walked windows stay zero with gid 0 (a zero
    add in the reduction). CPU tensors take `bwd_rows_reference`; CUDA
    tensors launch csrc/rasterize_bwd.cu or raise. t_mismatch (CUDA only):
    an int32 [1] tensor to which the kernel adds the pixels of the tiles it
    walked whole whose recomputed T differs from the forward's CH_TFINAL (0
    when its transmittance chain keeps the forward's bits).
    """
    if payload.device.type == "cpu":
        return bwd_rows_reference(payload, fout, gout, binning, meta_vec, ntx, ntiles, halfw,
                                  halfh, with_stats, with_reg, compact_cap)
    pcols = PAYLOAD_STATS_COLS if with_stats else P_COLS
    dev = payload.device
    sg, bounds = binning.slot_to_gaussian, binning.bounds
    cuda_lib.require(payload.is_cuda and all(x.device == dev for x in (fout, gout, meta_vec, sg,
                                                                       bounds)),
                     "rasterize_bwd: all tensors must share one CUDA device")
    cuda_lib.require(all(x.dtype == torch.float32 for x in (payload, fout, gout, meta_vec))
                     and sg.dtype == torch.int32 and bounds.dtype == torch.int32,
                     "rasterize_bwd: dtypes")
    cuda_lib.require(payload.dim() == 2 and payload.shape[0] == pcols
                     and payload.shape[1] % CHUNK_SIZE == 0,
                     f"rasterize_bwd: payload {tuple(payload.shape)} (need [{pcols}, k*128])")
    cuda_lib.require(tuple(fout.shape) == (ntiles, OUT_CH, NPIX)
                     and tuple(gout.shape) == (ntiles, OUT_CH, NPIX),
                     "rasterize_bwd: fout and gout [NTILES, 16, 1024]")
    cuda_lib.require(tuple(bounds.shape) == (ntiles + 1,) and tuple(meta_vec.shape) == (1, 8)
                     and tuple(sg.shape) == (payload.shape[1],),
                     "rasterize_bwd: bounds [NTILES+1], meta [1, 8], slot ids [CAP]")
    cuda_lib.require(all(x.is_contiguous() for x in (payload, fout, gout, meta_vec, sg, bounds)),
                     "rasterize_bwd: non-contiguous input")
    if t_mismatch is not None:
        cuda_lib.require(t_mismatch.device == dev and t_mismatch.dtype == torch.int32,
                         "rasterize_bwd: t_mismatch is an int32 tensor on the payload's device")
    R = compact_cap or compact_capacity_for(payload.shape[1], ntiles)
    rows = torch.zeros((R, P_COLS + (STAT_COLS if with_stats else 0)), dtype=torch.float32,
                       device=dev)
    gidc = torch.zeros((R,), dtype=torch.int32, device=dev)
    order = torch.empty((ntiles,), dtype=torch.int32, device=dev)
    rc = cuda_lib.library().gof_rasterize_bwd(
        dev.index, payload.data_ptr(), payload.shape[1], sg.data_ptr(), bounds.data_ptr(),
        fout.data_ptr(), gout.data_ptr(), meta_vec.data_ptr(), ntx, ntiles, float(halfw),
        float(halfh), int(with_stats), int(with_reg), R, rows.data_ptr(), gidc.data_ptr(),
        order.data_ptr(), None if t_mismatch is None else t_mismatch.data_ptr(),
        cuda_lib.stream_ptr(payload))
    cuda_lib.check(rc, "rasterize_bwd")
    BWD.launches += 1
    return rows, gidc


def rasterize_bwd(payload, fout, gout, binning: Binning, meta_vec, ntx: int, ntiles: int,
                  halfw: float, halfh: float, with_stats: bool = True, with_reg: bool = True,
                  compact_cap: int = 0, t_mismatch=None):
    """Backward blend in gof_tpu's layout: `bwd_rows`, returned as (dslot
    [16, R] f32, gid [R] int32, stats [8, R] f32 or None), views of its row
    buffer."""
    return _bwd_views(*bwd_rows(payload, fout, gout, binning, meta_vec, ntx, ntiles, halfw,
                                halfh, with_stats, with_reg, compact_cap, t_mismatch),
                      with_stats)


def reduce_compact_rows(rows, gidc, P: int):
    """Per-gaussian sums of the backward's row buffer (`bwd_rows`): ([P, 16],
    [P, 3] or None), through one reduction over its 16 (+3 statistics)
    columns that reads the buffer as it is (ops/reduce.py::reduce_row_major).
    gof_tpu's reduce_compact_rows takes the [16, R] and [8, R] arrays."""
    from .reduce import reduce_row_major

    with_stats = rows.shape[1] > P_COLS
    per = reduce_row_major(rows, gidc, P, P_COLS + (3 if with_stats else 0))
    return per[:, :P_COLS], (per[:, P_COLS:] if with_stats else None)


def quadric_chain(per_g, M, u0):
    """Per-gaussian chain from the quadric invariants back to the factored
    form (gof_tpu's _raster_bwd, rasterize_pallas.py:1018-1039):
      Sigma = M^T M:  dM_ab += sum_k M_ak H_kb,
        H = [[2 s0, s1, s2], [s1, 2 s3, s4], [s2, s4, 2 s5]]
      b = M^T u0:     dM_ab += u0_a db_b,   du0 += M db
      uu = u0 . u0:   du0 += 2 duu u0
    per_g: [P, 16] reduced rows. Returns (dM [P, 3, 3], du0 [P, 3]) in M's
    dtype, computed in float64: M H + u0 db cancels, and for a near-isotropic
    gaussian the rotation's gradient is a small residual of dM, which the
    chain's own f32 rounding moved by 1e-2 of its largest magnitude at
    trained scales (ROADMAP C30)."""
    dt = M.dtype
    per_g, M, u0 = per_g.double(), M.double(), u0.double()
    sp = [per_g[:, 4 + i] for i in range(6)]
    db = [per_g[:, 10 + i] for i in range(3)]
    duu = per_g[:, 13]
    H = ((2.0 * sp[0], sp[1], sp[2]),
         (sp[1], 2.0 * sp[3], sp[4]),
         (sp[2], sp[4], 2.0 * sp[5]))
    Mc = [[M[:, a, k] for k in range(3)] for a in range(3)]
    dM = torch.stack(
        [torch.stack([Mc[a][0] * H[0][bc] + Mc[a][1] * H[1][bc] + Mc[a][2] * H[2][bc]
                      + u0[:, a] * db[bc] for bc in range(3)], dim=-1)
         for a in range(3)], dim=-2)
    du0 = torch.stack([Mc[a][0] * db[0] + Mc[a][1] * db[1] + Mc[a][2] * db[2]
                       + 2.0 * duu * u0[:, a] for a in range(3)], dim=-1)
    return dM.to(dt), du0.to(dt)


class RasterMeta(NamedTuple):
    """Static rasterization settings (gof_tpu's RasterMeta without the TPU's
    interpret flag and static compact capacity)."""

    ntx: int
    nty: int
    width: int
    height: int
    with_stats: bool = True  # statistics columns in the payload and backward
    with_reg: bool = True  # regularizer channels (normals, depth, distortion)


class RasterizeFn(torch.autograd.Function):
    """Differentiable tiled rasterization -> [NTILES, 16, 1024].

    Backward (gof_tpu's _raster_bwd): the backward blend, the per-gaussian
    reduction and the quadric chain give (drgb, dop, dM, du0); `carrier`
    receives the densification statistics (gx, gy, |gx|+|gy|) and conic,
    mean2d, the focal lengths and bg get zero cotangent. The compact buffer
    is sized to the forward's compact demand, read to the host once.

    The zero cotangents are returned as None, so autograd does not carry
    them into the preprocess: a gaussian in the camera's plane has an
    inf / NaN conic, and a materialized zero times its partials would give
    its xyz, scaling and rotation NaN gradients, which Adam keeps for good
    (ROADMAP C26; gof_tpu's step leaves them 0).
    """

    @staticmethod
    def forward(ctx, meta: RasterMeta, rgb, op_eff, M, u0, conic, mean2d, carrier, focal_x,
                focal_y, bg, binning: Binning):
        P = rgb.shape[0]
        mv = _meta_vec(focal_x, focal_y, bg, meta.width, meta.height)
        payload = build_payload16(rgb, op_eff, M, u0, binning,
                                  conic=conic if meta.with_stats else None,
                                  mean2d=mean2d if meta.with_stats else None)
        out = rasterize_fwd(payload, binning, mv, meta.ntx, meta.ntx * meta.nty,
                            with_reg=meta.with_reg)
        ctx.meta, ctx.binning, ctx.P = meta, binning, P
        ctx.save_for_backward(payload, out, mv, M, u0)
        return out

    @staticmethod
    def backward(ctx, gout):
        payload, fout, mv, M, u0 = ctx.saved_tensors
        meta, P = ctx.meta, ctx.P
        ntiles = meta.ntx * meta.nty
        last = fout[ntiles - 1]
        demand = int(last[CH_CSTART, 0] + last[CH_LIVEC, 0] * CHUNK_SIZE)  # host read
        rows, gidc = bwd_rows(
            payload, fout, gout.contiguous(), ctx.binning, mv, meta.ntx, ntiles,
            meta.width / 2.0, meta.height / 2.0, with_stats=meta.with_stats,
            with_reg=meta.with_reg, compact_cap=max(demand, CHUNK_SIZE))
        per_g, per_s = reduce_compact_rows(rows, gidc, P)
        dM, du0 = quadric_chain(per_g, M, u0)
        dcarrier = per_s if per_s is not None else torch.zeros((P, 3), device=M.device)
        return (None, per_g[:, 0:3], per_g[:, 3], dM, du0, None, None, dcarrier,
                None, None, None, None)


def rasterize(meta: RasterMeta, rgb, op_eff, M, u0, conic, mean2d, carrier, focal_x, focal_y,
              bg, binning: Binning) -> torch.Tensor:
    """Differentiable tiled rasterization -> [NTILES, 16, 1024] (gof_tpu's
    `rasterize`, rasterize_pallas.py:966, same argument list).

    carrier: [P, 3] zeros whose gradient carries the densification
    statistics (the reference's screenspace_points trick)."""
    return RasterizeFn.apply(meta, rgb, op_eff, M, u0, conic, mean2d, carrier, focal_x,
                             focal_y, bg, binning)
