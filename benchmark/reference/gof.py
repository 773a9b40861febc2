"""Plain PyTorch math of Gaussian Opacity Fields, the benchmark's yardstick.

A frozen, self-contained copy of the rasterizer's semantics as the port's
plain paths state them (renderCUDA and preprocessCUDA of GOF's
diff-gaussian-rasterization, with the documented deviation that every
contribution is zeroed once the transmittance falls below 1e-4). It imports
nothing of the program: the benchmark holds the program to it, so a later
change to the program cannot move it.

Every function follows its argument's dtype, so the same code computed in
bfloat16 is the precision control of the correctness check.

A camera here is a `View` of plain tensors; a model is a dict of tensors
(xyz, features_dc, features_rest, scaling, rotation, opacity, filter_3d,
active).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

NEAR_PLANE = 0.2
FAR_PLANE = 100.0
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
TRANSMITTANCE_EPS = 1e-4
MEDIAN_THRESHOLD = 0.5
FRUSTUM_NEAR = 0.2
TILE = 32
TILE_PIXELS = TILE * TILE

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792,
         0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


@dataclass
class View:
    """A pinhole camera: world->view and full projection matrices (4x4),
    camera centre, tan of the half fields of view, image size."""

    width: int
    height: int
    world_view: torch.Tensor
    full_proj: torch.Tensor
    cam_center: torch.Tensor
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor

    @property
    def focal_x(self):
        return self.tan_fovx.new_tensor(float(self.width)) / (2.0 * self.tan_fovx)

    @property
    def focal_y(self):
        return self.tan_fovy.new_tensor(float(self.height)) / (2.0 * self.tan_fovy)

    def cast(self, dtype) -> "View":
        return View(self.width, self.height, *(getattr(self, f).to(dtype) for f in
                                               ("world_view", "full_proj", "cam_center",
                                                "tan_fovx", "tan_fovy")))


def tile_grid(width: int, height: int):
    return -(-width // TILE), -(-height // TILE)


# --------------------------------------------------------------------------
# per-gaussian preprocess
# --------------------------------------------------------------------------

def ndc_to_pixel(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


def eval_sh(degree: int, sh, dirs):
    result = SH_C0 * sh[..., 0, :]
    if degree > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - SH_C1 * y * sh[..., 1, :] + SH_C1 * z * sh[..., 2, :]
                  - SH_C1 * x * sh[..., 3, :])
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result + SH_C2[0] * xy * sh[..., 4, :] + SH_C2[1] * yz * sh[..., 5, :]
                      + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                      + SH_C2[3] * xz * sh[..., 7, :] + SH_C2[4] * (xx - yy) * sh[..., 8, :])
            if degree > 2:
                result = (result + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                          + SH_C3[1] * xy * z * sh[..., 10, :]
                          + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                          + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                          + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                          + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                          + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
    return result


def sh_to_rgb(degree: int, sh, means, campos):
    dirs = means - campos
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    c = eval_sh(degree, sh, dirs) + 0.5
    return torch.maximum(c, torch.zeros_like(c))


def rot_comps(rotation):
    q = rotation / (torch.linalg.norm(rotation, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))


def cov3d(scaling, rotation):
    R = rot_comps(rotation)
    s2 = (scaling[..., 0] ** 2, scaling[..., 1] ** 2, scaling[..., 2] ** 2)

    def sig(i, k):
        return R[i][0] * R[k][0] * s2[0] + R[i][1] * R[k][1] * s2[1] + R[i][2] * R[k][2] * s2[2]

    return torch.stack([sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)], -1)


def view_to_gaussian(mean, scaling, rotation, wv):
    """M = S^-1 R^T W^T-ish factor and u0, the camera origin in the
    gaussian's unit frame (the ray-gaussian quadric in factored form)."""
    Rg = rot_comps(rotation)
    W, tvec = wv[:3, :3], wv[:3, 3]
    Rv = tuple(tuple(W[i, 0] * Rg[0][j] + W[i, 1] * Rg[1][j] + W[i, 2] * Rg[2][j]
                     for j in range(3)) for i in range(3))
    mx, my, mz = mean[..., 0], mean[..., 1], mean[..., 2]
    tg = tuple(W[i, 0] * mx + W[i, 1] * my + W[i, 2] * mz + tvec[i] for i in range(3))
    s_eff = torch.sqrt(scaling * scaling + 1e-7)
    se = (s_eff[..., 0], s_eff[..., 1], s_eff[..., 2])
    M = torch.stack([torch.stack([Rv[j][i] / se[i] for j in range(3)], -1) for i in range(3)], -2)
    u0 = torch.stack([-(Rv[0][i] * tg[0] + Rv[1][i] * tg[1] + Rv[2][i] * tg[2]) / se[i]
                      for i in range(3)], -1)
    return M, u0


def cov2d_ewa(mean, c3, wv, focal_x, focal_y, tan_fovx, tan_fovy, kernel_size):
    W, tvec = wv[:3, :3], wv[:3, 3]
    mx, my, mz = mean[..., 0], mean[..., 1], mean[..., 2]
    pv = tuple(W[i, 0] * mx + W[i, 1] * my + W[i, 2] * mz + tvec[i] for i in range(3))
    tz = pv[2]
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx = torch.clamp(pv[0] / tz, -limx, limx) * tz
    ty = torch.clamp(pv[1] / tz, -limy, limy) * tz
    inv_tz = 1.0 / tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz * inv_tz
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz * inv_tz
    a0 = tuple(j00 * W[0, k] + j02 * W[2, k] for k in range(3))
    a1 = tuple(j11 * W[1, k] + j12 * W[2, k] for k in range(3))
    s0, s1, s2, s3, s4, s5 = (c3[..., i] for i in range(6))

    def quad(a, b):
        return (a[0] * b[0] * s0 + a[1] * b[1] * s3 + a[2] * b[2] * s5
                + (a[0] * b[1] + a[1] * b[0]) * s1 + (a[0] * b[2] + a[2] * b[0]) * s2
                + (a[1] * b[2] + a[2] * b[1]) * s4)

    cxx, cxy, cyy = quad(a0, a0), quad(a0, a1), quad(a1, a1)
    det0 = torch.clamp_min(cxx * cyy - cxy * cxy, 1e-6)
    det1 = torch.clamp_min((cxx + kernel_size) * (cyy + kernel_size) - cxy * cxy, 1e-6)
    coef = torch.sqrt(det0 / (det1 + 1e-6) + 1e-6)
    raw0 = cxx * cyy - cxy * cxy
    raw1 = (cxx + kernel_size) * (cyy + kernel_size) - cxy * cxy
    coef = torch.where((raw0 <= 1e-6) | (raw1 <= 1e-6), torch.zeros_like(coef), coef)
    return torch.stack([cxx + kernel_size, cxy, cyy + kernel_size], -1), coef


def screen_extent(cov2d, coef, opacities):
    det = cov2d[..., 0] * cov2d[..., 2] - cov2d[..., 1] * cov2d[..., 1]
    mid = 0.5 * (cov2d[..., 0] + cov2d[..., 2])
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    if opacities is not None:
        nsig = torch.sqrt(2.0 * torch.log(torch.clamp_min(opacities * coef * 255.0, 1.001)))
        nsig = torch.clamp_max(nsig, 3.0)
    else:
        nsig = torch.full_like(lambda1, 3.0)
    radius = nsig * torch.sqrt(torch.clamp_min(lambda1, 1e-12))
    radius_xy = nsig[..., None] * torch.sqrt(torch.clamp_min(cov2d[..., [0, 2]], 1e-12))
    return radius, radius_xy


@dataclass
class Pre:
    valid: torch.Tensor
    depth: torch.Tensor
    mean2d: torch.Tensor
    coef: torch.Tensor
    radius_xy: torch.Tensor
    rgb: torch.Tensor
    M: torch.Tensor
    u0: torch.Tensor


def preprocess(means, scales, rotations, shs, sh_degree, view: View, kernel_size, active,
               opacities=None) -> Pre:
    """Per-gaussian view quantities; `scales` / `opacities` 3D-filtered."""
    W, H = view.width, view.height
    wv, fp = view.world_view, view.full_proj
    mx, my, mz = means[..., 0], means[..., 1], means[..., 2]
    depth = wv[2, 0] * mx + wv[2, 1] * my + wv[2, 2] * mz + wv[2, 3]
    pw = fp[3, 0] * mx + fp[3, 1] * my + fp[3, 2] * mz + fp[3, 3] + 1e-7
    ndc_x = (fp[0, 0] * mx + fp[0, 1] * my + fp[0, 2] * mz + fp[0, 3]) / pw
    ndc_y = (fp[1, 0] * mx + fp[1, 1] * my + fp[1, 2] * mz + fp[1, 3]) / pw
    mean2d = torch.stack([ndc_to_pixel(ndc_x, W), ndc_to_pixel(ndc_y, H)], -1)
    c2, coef = cov2d_ewa(means, cov3d(scales, rotations), wv, view.focal_x, view.focal_y,
                         view.tan_fovx, view.tan_fovy, kernel_size)
    det = c2[..., 0] * c2[..., 2] - c2[..., 1] * c2[..., 1]
    radius, radius_xy = screen_extent(c2, coef, opacities)
    radius, radius_xy = torch.ceil(radius), torch.ceil(radius_xy)
    rgb = sh_to_rgb(sh_degree, shs, means, view.cam_center)
    M, u0 = view_to_gaussian(means, scales, rotations, wv)
    valid = (depth > FRUSTUM_NEAR) & (det != 0.0) & (radius > 0) & active
    return Pre(valid=valid, depth=depth, mean2d=mean2d, coef=coef, radius_xy=radius_xy, rgb=rgb,
               M=M, u0=u0)


# --------------------------------------------------------------------------
# binning: which gaussians each tile blends, in depth order
# --------------------------------------------------------------------------

def _floor_to_int(x, hi: int):
    return torch.clamp(torch.floor(x.float()), -1.0, hi + 1.0).to(torch.int64)


def tile_rects(mean2d, radius_xy, valid, ntx: int, nty: int):
    """Each gaussian's tile rect (x0, y0, w, h), getRect's rule."""
    px, py = mean2d[:, 0], mean2d[:, 1]
    rx, ry = radius_xy[:, 0], radius_xy[:, 1]
    x0 = torch.clamp(_floor_to_int((px - rx) / TILE, ntx), 0, ntx)
    y0 = torch.clamp(_floor_to_int((py - ry) / TILE, nty), 0, nty)
    x1 = torch.clamp(_floor_to_int((px + rx + TILE - 1) / TILE, ntx), 0, ntx)
    y1 = torch.clamp(_floor_to_int((py + ry + TILE - 1) / TILE, nty), 0, nty)
    w = torch.where(valid, torch.clamp_min(x1 - x0, 0), torch.zeros_like(x0))
    h = torch.where(valid, torch.clamp_min(y1 - y0, 0), torch.zeros_like(y0))
    return x0, y0, w, h


@dataclass
class Bins:
    gid: torch.Tensor  # [K] gaussian of each key, sorted by (tile, depth, id)
    start: torch.Tensor  # [NT] first key of each tile
    length: torch.Tensor  # [NT] keys of each tile


def bin_tiles(depth, rects, ntx: int, nty: int) -> Bins:
    """The (tile, gaussian) keys of every rect, sorted by tile, then depth,
    then gaussian id."""
    x0, y0, w, h = rects
    dev = depth.device
    counts = (w * h).to(torch.int64)
    gid = torch.repeat_interleave(torch.arange(len(counts), device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    j = torch.arange(len(gid), device=dev) - first[gid]
    wg = w[gid].clamp_min(1)
    tile = (y0[gid] + j // wg) * ntx + x0[gid] + j % wg
    o = torch.sort(depth.float()[gid], stable=True).indices
    o = o[torch.sort(tile[o], stable=True).indices]
    gid, tile = gid[o], tile[o]
    length = torch.bincount(tile, minlength=ntx * nty)
    return Bins(gid=gid, start=torch.cumsum(length, 0) - length, length=length)


# --------------------------------------------------------------------------
# blending
# --------------------------------------------------------------------------

def ndc_depth(t):
    t = torch.clamp_min(t, NEAR_PLANE)
    return (FAR_PLANE * t - FAR_PLANE * NEAR_PLANE) / ((FAR_PLANE - NEAR_PLANE) * t)


def ray_terms(p, rx, ry):
    """Alpha, depth and normal of keys x pixels. p: [..., L, 16] rows (rgb
    0:3, op 3, M 4:13 row-major, u0 13:16); rx / ry: [..., 1, PIX]."""
    c = [p[..., k:k + 1] for k in range(16)]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = c[4:13]
    u0x, u0y, u0z, op = c[13], c[14], c[15], c[3]
    d0 = m00 * rx + m01 * ry + m02
    d1 = m10 * rx + m11 * ry + m12
    d2 = m20 * rx + m21 * ry + m22
    dd = d0 * d0 + d1 * d1 + d2 * d2
    t = -(u0x * d0 + u0y * d1 + u0z * d2) / (dd + 1e-12)
    v0, v1, v2 = u0x + t * d0, u0y + t * d1, u0z + t * d2
    alpha = torch.clamp_max(op * torch.exp(-0.5 * (v0 * v0 + v1 * v1 + v2 * v2)), ALPHA_MAX)
    alpha = torch.where((t > NEAR_PLANE) & (alpha >= ALPHA_MIN), alpha, torch.zeros_like(alpha))
    n0 = m00 * d0 + m10 * d1 + m20 * d2
    n1 = m01 * d0 + m11 * d1 + m21 * d2
    n2 = m02 * d0 + m12 * d1 + m22 * d2
    inv = 1.0 / torch.sqrt(n0 * n0 + n1 * n1 + n2 * n2 + 1e-7)
    return alpha, t, -n0 * inv, -n1 * inv, -n2 * inv


def blend(p, inside, rx, ry, carry):
    """Blend one depth-ordered chunk of rows [..., L, 16] (`inside` [..., L,
    1] marks real rows; the others are zero) into the per-pixel carry (T,
    acc, rgb [3], normal [3], depth, s1, s2, visited, active); returns the
    new carry. visited / active count the (pixel, row) pairs the pixel
    needs: real rows met while its T is above 1e-4, and of those the rows
    whose alpha passes."""
    T0, acc, rgb, nrm, depth, s1, s2, vis, act, s1d, s2d = carry
    a, t, n0, n1, n2 = ray_terms(p, rx, ry)
    prod = torch.cumprod(1.0 - a, dim=-2)
    T = T0.unsqueeze(-2) * torch.cat([torch.ones_like(prod[..., :1, :]), prod[..., :-1, :]], -2)
    live = T > TRANSMITTANCE_EPS
    w = a * T * live
    need = live & inside
    m = ndc_depth(t)
    wm = w * m
    wdm = w.detach() * m
    rgb = rgb + p[..., 0:3].transpose(-1, -2) @ w
    nrm = nrm + torch.stack([(n0 * w).sum(-2), (n1 * w).sum(-2), (n2 * w).sum(-2)], -2)
    med = (a > 0) & (T > MEDIAN_THRESHOLD)
    g = torch.arange(a.shape[-2], device=a.device)[:, None]
    last = torch.where(med, g, -1).amax(dim=-2)
    pick = (g == last.unsqueeze(-2)) & med
    depth = torch.where(last >= 0, torch.where(pick, t, torch.zeros_like(t)).sum(-2), depth)
    return (T0 * prod[..., -1, :], acc + w.sum(-2), rgb, nrm, depth, s1 + wm.sum(-2),
            s2 + (wm * m).sum(-2), vis + need.sum(-2), act + (need & (a > 0)).sum(-2),
            s1d + wdm.sum(-2), s2d + (wdm * m).sum(-2))


def empty_carry(shape, dtype, device):
    z = torch.zeros(shape, dtype=dtype, device=device)
    z3 = torch.zeros(shape[:-1] + (3, shape[-1]), dtype=dtype, device=device)
    zi = torch.zeros(shape, dtype=torch.int64, device=device)
    return (torch.ones(shape, dtype=dtype, device=device), z, z3, z3.clone(), z.clone(),
            z.clone(), z.clone(), zi, zi.clone(), z.clone(), z.clone())


def finalize(carry, bg):
    """[..., 9, PIX]: rgb, normal, median depth, alpha, distortion.

    The distortion's value is (A S2 - S1^2) / ((1 - T)^2 + 1e-7); its
    gradient is GOF's (backward.cu with the detached weight): through each
    row's mapped depth m alone, d/dm_i = 2 w_i (m_i A - S1), with the
    weights, totals and normalisation held constant. Everything else is
    differentiated exactly."""
    T, acc, rgb, nrm, depth, s1, s2 = carry[:7]
    s1d, s2d = carry[9], carry[10]
    rgb = rgb + T.unsqueeze(-2) * bg[:, None]
    value = ((acc * s2 - s1 * s1) / ((1.0 - T) ** 2 + 1e-7)).detach()
    surrogate = acc.detach() * s2d - 2.0 * s1.detach() * s1d
    dist = value + (surrogate - surrogate.detach())
    return torch.cat([rgb, nrm, depth.unsqueeze(-2), acc.unsqueeze(-2), dist.unsqueeze(-2)], -2)


def tile_rays(tiles, ntx: int, view: View, dtype):
    """Ray slopes [NT, 1, PIX] of the pixels of tiles [NT]; lane l of a tile
    is pixel (row l // 32, column l % 32) inside it."""
    dev = tiles.device
    lane = torch.arange(TILE_PIXELS, device=dev)
    px = ((tiles % ntx) * TILE)[:, None] + lane % TILE
    py = ((tiles // ntx) * TILE)[:, None] + lane // TILE
    fx = view.focal_x.float()
    fy = view.focal_y.float()
    rx = (px.float() + 0.5 - view.width / 2.0) / fx
    ry = (py.float() + 0.5 - view.height / 2.0) / fy
    return rx.to(dtype)[:, None, :], ry.to(dtype)[:, None, :]


def rows_of(pre: Pre, opacities):
    """Per-gaussian blend rows [P, 16]: rgb, effective opacity (the 2D
    dilation's compensation detached), M, u0."""
    coef = pre.coef.detach()
    op = opacities * torch.where(pre.valid, coef, torch.zeros_like(coef))
    P = op.shape[0]
    return torch.cat([pre.rgb, op[:, None], pre.M.reshape(P, 9), pre.u0], 1)


def tile_blocks(bins: Bins, tiles, budget: int, chunk: int = 256):
    """Split `tiles` (longest first) into (tiles, chunk length) blocks whose
    [tiles, chunk, PIX] temporaries hold at most `budget` elements."""
    lens = bins.length[tiles]
    order = torch.argsort(lens, descending=True)
    tiles, lens = tiles[order].tolist(), lens[order].tolist()
    out, i = [], 0
    while i < len(tiles):
        c = max(1, min(max(int(lens[i]), 1), chunk, budget // TILE_PIXELS))
        n = max(1, budget // (TILE_PIXELS * c))
        out.append((tiles[i:i + n], c))
        i += n
    return out


def render_block(rows, bins: Bins, tiles: list, chunk: int, ntx: int, view: View, bg):
    """Blend tiles' lists `chunk` rows at a time: -> [NT, 9, PIX] image and
    the (visited, active) (pixel, row) pair counts [NT, PIX]. A tile stops
    after the chunk in which its last pixel's T fell below 1e-4, as GOF's
    tile does: every later row would add nothing."""
    carry = blend_tiles(rows, bins, tiles, chunk, ntx, view)
    return finalize(carry, bg), carry[7], carry[8]


def blend_tiles(rows, bins: Bins, tiles: list, chunk: int, ntx: int, view: View,
                stop: float = TRANSMITTANCE_EPS):
    """The per-pixel carry (see blend) after tiles' whole lists, `chunk`
    rows at a time; a tile stops after the chunk in which its last pixel's
    T fell to `stop` or below (0: never)."""
    dev, dt = rows.device, rows.dtype
    t = torch.as_tensor(tiles, device=dev)
    rx, ry = tile_rays(t, ntx, view, dt)
    start, length = bins.start[t], bins.length[t]
    carry = empty_carry((len(tiles), TILE_PIXELS), dt, dev)
    k = torch.arange(chunk, device=dev)
    live = torch.arange(len(tiles), device=dev)
    for c0 in range(0, int(length.max()), chunk):
        live = live[(length[live] > c0) & (carry[0][live].amax(-1) > stop)]
        if len(live) == 0:
            break
        idx = c0 + k[None, :]
        inside = idx < length[live][:, None]
        key = torch.where(inside, start[live][:, None] + idx, torch.zeros_like(idx))
        p = rows[bins.gid[key]] * inside[..., None]
        part = blend(p, inside[..., None], rx[live], ry[live], tuple(x[live] for x in carry))
        carry = tuple(x.index_copy(0, live, y) for x, y in zip(carry, part))
    return carry


def assemble(tile_out, tiles, ntx, nty, width, height):
    """[NT, C, PIX] of `tiles` -> [C, H, W] (tiles not given stay zero)."""
    C = tile_out.shape[1]
    full = tile_out.new_zeros((ntx * nty, C, TILE_PIXELS))
    full[tiles] = tile_out
    img = full.reshape(nty, ntx, C, TILE, TILE).permute(2, 0, 3, 1, 4)
    return img.reshape(C, nty * TILE, ntx * TILE)[:, :height, :width]


# --------------------------------------------------------------------------
# model helpers, loss and optimizer
# --------------------------------------------------------------------------

def filtered_scaling(scaling, filter_3d):
    return torch.sqrt(torch.exp(scaling) ** 2 + filter_3d[:, None] ** 2)


def filtered_opacity(scaling, opacity, filter_3d):
    s2 = torch.exp(scaling) ** 2
    det1 = torch.prod(s2, dim=-1)
    det2 = torch.prod(s2 + filter_3d[:, None] ** 2, dim=-1)
    return torch.sigmoid(opacity) * torch.sqrt(det1 / det2)


def features(model, active_degree: int):
    shs = torch.cat([model["features_dc"], model["features_rest"]], 1)
    keep = torch.arange(shs.shape[1], device=shs.device) < (active_degree + 1) ** 2
    return shs * keep[None, :, None]


def pixel_rays(width, height, focal_x, focal_y):
    px = torch.arange(width, dtype=torch.float32, device=focal_x.device) + 0.5
    py = torch.arange(height, dtype=torch.float32, device=focal_x.device) + 0.5
    rx = (px[None, :] - width / 2.0) / focal_x.float()
    ry = (py[:, None] - height / 2.0) / focal_y.float()
    return rx.expand(height, width), ry.expand(height, width)


def depth_to_normal(view: View, depth):
    H, W = view.height, view.width
    rx, ry = pixel_rays(W, H, view.focal_x, view.focal_y)
    dirs = torch.stack([rx, ry, torch.ones_like(rx)], -1).to(depth.dtype)
    R_c2w = view.world_view[:3, :3].T
    pts = depth[..., None] * (dirs @ R_c2w.T) + view.cam_center
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    return F.pad(n, (0, 0, 1, 1, 1, 1)).permute(2, 0, 1)


def _window(dtype, device):
    x = np.arange(11) - 5
    g = np.exp(-(x ** 2) / (2 * 1.5 ** 2))
    return torch.as_tensor((g / g.sum()).astype(np.float32), device=device).to(dtype)


def _blur(x):
    C = x.shape[0]
    w = _window(x.dtype, x.device)
    y = F.conv2d(x[None], w.view(1, 1, 11, 1).expand(C, 1, 11, 1), padding=(5, 0), groups=C)
    return F.conv2d(y, w.view(1, 1, 1, 11).expand(C, 1, 1, 11), padding=(0, 5), groups=C)[0]


def ssim(a, b):
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = _blur(a), _blur(b)
    s1 = _blur(a * a) - mu1 * mu1
    s2 = _blur(b * b) - mu2 * mu2
    s12 = _blur(a * b) - mu1 * mu2
    return torch.mean(((2 * mu1 * mu2 + C1) * (2 * s12 + C2))
                      / ((mu1 * mu1 + mu2 * mu2 + C1) * (s1 + s2 + C2)))


def train_loss(image, gt, view: View, opt: dict, step: int):
    """GOF's loss with the regularizers on: (1 - l) L1 + l (1 - SSIM) +
    distortion and depth-normal terms from their start steps."""
    rgb = image[:3]
    loss = ((1.0 - opt["lambda_dssim"]) * torch.mean(torch.abs(rgb - gt))
            + opt["lambda_dssim"] * (1.0 - ssim(rgb, gt)))
    distortion = torch.mean(image[8])
    d2n = depth_to_normal(view, image[6])
    rn = image[3:6]
    rn = rn * torch.rsqrt(torch.sum(rn * rn, dim=0, keepdim=True) + 1e-12)
    rn_world = torch.einsum("ij,jhw->ihw", view.world_view[:3, :3].T, rn)
    depth_normal = torch.mean(1.0 - torch.sum(rn_world * d2n, dim=0))
    lam_dist = opt["lambda_distortion"] if step >= opt["distortion_from_iter"] else 0.0
    lam_dn = opt["lambda_depth_normal"] if step >= opt["depth_normal_from_iter"] else 0.0
    return loss + lam_dist * distortion + lam_dn * depth_normal


def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int) -> float:
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def adam_lrs(opt: dict, count: int, spatial_lr_scale: float) -> dict:
    return {"xyz": expon_lr(count, opt["position_lr_init"] * spatial_lr_scale,
                            opt["position_lr_final"] * spatial_lr_scale,
                            opt["position_lr_max_steps"]),
            "features_dc": opt["feature_lr"], "features_rest": opt["feature_lr"] / 20.0,
            "scaling": opt["scaling_lr"], "rotation": opt["rotation_lr"],
            "opacity": opt["opacity_lr"]}


def adam_leaf(g, m, v, lr: float, count: int, b1=0.9, b2=0.999, eps=1e-15):
    """One Adam update of a leaf at update number `count` (1-based)."""
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    return -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps), m, v
