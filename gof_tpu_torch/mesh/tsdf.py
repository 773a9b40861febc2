"""TSDF fusion from rendered depth maps, the DTU mesh path (counterpart of
gof_tpu/mesh/tsdf.py).

Two fusion layouts, as gof_tpu:

- sparse block grid (the VoxelBlockGrid equivalent at the reference
  protocol: voxel 0.002, 16^3 blocks, depth 1-6, extract_mesh_tsdf.py:22-46):
  blocks are DISCOVERED from the depth maps (each valid pixel unprojected at
  d - trunc, d, d + trunc), fused in batches of blocks with per-voxel
  color, and triangulated per block with (R+1)^3 samples so cube corners
  never cross block boundaries;
- dense z-slab grid (small scenes).

Both triangulate by marching tetrahedra (6 tets per crossing cube, the
port's mesh/tetmesh.py) with linear interpolation.

Everything runs in torch on the device of the cameras and depth maps: the
fused `tsdf`, `weight` and `color` stay there (20 bytes per sample, so
Nb * 17^3 * 20 bytes for Nb blocks; gof_tpu copies each batch back to the
host), and only the marching-tets edges and the final mesh come to the
host. Blocks come out in np.unique's lexicographic row order (torch.unique
over rows sorts the same way), so block, vertex and sample order match
gof_tpu's. The projections are f32 products (TF32 off); a sample whose sdf
sits on -1, or whose pixel coordinate sits on an image edge, may round to
the other side of that test than in gof_tpu and flip its update.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import tetmesh

# the 6-tetrahedra decomposition of a cube (corner ids in (x, y, z) bit
# order: corner = x | y << 1 | z << 2)
_CUBE_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 1, 7, 5],
        [0, 5, 7, 4],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
    ],
    np.int64,
)
_CORNER_OFFS = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64)


def _device(cameras) -> torch.device:
    return cameras[0].world_view.device


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32, device=device)


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s rounded as a true division on every device (CUDA rounds a
    division by a Python number as a product with its reciprocal)."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def _project_update(pts, t, w, c, depth_map, rgb, world_view, full_proj, sdf_trunc,
                    depth_min, depth_max):
    """One view's weighted-average update of the samples `pts` [N, 3]:
    returns new (tsdf, weight, color or None) for flat t, w [N] and c [N, 3]
    (gof_tpu's slab_update / batch_update)."""
    H, W = depth_map.shape
    pv = pts @ world_view[:3, :3].T + world_view[:3, 3]
    z = pv[:, 2]
    ph = pts @ full_proj[:3, :3].T + full_proj[:3, 3]
    pw = pts @ full_proj[3, :3] + full_proj[3, 3]
    ndc = ph / (pw[:, None] + 1e-7)
    px = ((ndc[:, 0] + 1) * W - 1) * 0.5
    py = ((ndc[:, 1] + 1) * H - 1) * 0.5
    # the int conversion truncates toward zero; `valid` tests the float px
    xi = torch.clamp(px.to(torch.int32), 0, W - 1).long()
    yi = torch.clamp(py.to(torch.int32), 0, H - 1).long()
    d = depth_map[yi, xi]
    valid = ((z > 1e-4) & (px >= 0) & (px < W) & (py >= 0) & (py < H)
             & (d > depth_min) & (d < depth_max))
    # the depth channel stores t with ray z = 1, i.e. the view-space z
    sdf = _div(d - z, sdf_trunc)
    upd = valid & (sdf > -1.0)
    sdf = torch.clamp(sdf, -1.0, 1.0)
    u = upd.to(torch.float32)
    new_w = w + u
    denom = torch.clamp_min(new_w, 1.0)
    new_t = torch.where(new_w > 0, (t * w + sdf * u) / denom, t)
    new_c = None
    if c is not None:
        rgb_s = rgb[:, yi, xi].T  # [N, 3]
        new_c = torch.where(new_w[:, None] > 0, (c * w[:, None] + rgb_s * u[:, None])
                            / denom[:, None], c)
    return new_t, new_w, new_c


@torch.no_grad()
def fuse_depth_maps(
    depths: List,  # per view [H, W] median depth (0 = invalid)
    cameras,  # list of Cameras
    origin,
    voxel_size: float,
    dims: tuple[int, int, int],
    sdf_trunc: float,
    depth_min: float = 0.5,
    depth_max: float = 6.0,
    slab: int = 32,
):
    """Weighted-average TSDF over a dense grid, fused slab by slab of `slab`
    z-planes. Returns (tsdf, weight), [X, Y, Z] f32 tensors on the cameras'
    device (tsdf positive outside, +1 where unobserved)."""
    dev = _device(cameras)
    X, Y, Z = dims
    origin = np.asarray(origin, np.float32)
    depths = [_on(d, dev) for d in depths]
    tsdf = torch.ones((X, Y, Z), dtype=torch.float32, device=dev)
    weight = torch.zeros((X, Y, Z), dtype=torch.float32, device=dev)
    xs = torch.arange(X, dtype=torch.float32, device=dev) * voxel_size + float(origin[0])
    ys = torch.arange(Y, dtype=torch.float32, device=dev) * voxel_size + float(origin[1])
    for z0 in range(0, Z, slab):
        z1 = min(z0 + slab, Z)
        zs = torch.arange(z0, z1, dtype=torch.float32, device=dev) * voxel_size + float(origin[2])
        pts = torch.stack(torch.meshgrid(xs, ys, zs, indexing="ij"), dim=-1).reshape(-1, 3)
        t_s = torch.ones(pts.shape[0], dtype=torch.float32, device=dev)
        w_s = torch.zeros_like(t_s)
        for cam, depth in zip(cameras, depths):
            t_s, w_s, _ = _project_update(pts, t_s, w_s, None, depth, None, cam.world_view,
                                          cam.full_proj, sdf_trunc, depth_min, depth_max)
        tsdf[:, :, z0:z1] = t_s.reshape(X, Y, z1 - z0)
        weight[:, :, z0:z1] = w_s.reshape(X, Y, z1 - z0)
    tsdf[weight == 0] = 1.0  # unobserved = outside
    return tsdf, weight


# ---------------------------------------------------------------------------
# Sparse block grid (VoxelBlockGrid equivalent)
# ---------------------------------------------------------------------------


@torch.no_grad()
def discover_blocks(
    depths: List,
    cameras,
    voxel_size: float,
    block_res: int = 16,
    sdf_trunc: float = 0.016,
    depth_min: float = 1.0,
    depth_max: float = 6.0,
    max_blocks: int = 500_000,
) -> torch.Tensor:
    """Unique block coordinates touched by any view's truncation band
    (compute_unique_block_coordinates, extract_mesh_tsdf.py:78-79): each
    valid depth pixel is unprojected at d - trunc, d, d + trunc and the
    containing blocks collected. Returns [Nb, 3] int32 block coords (world
    position = coord * block_res * voxel_size) in lexicographic order, on
    the cameras' device."""
    dev = _device(cameras)
    bs = block_res * voxel_size
    found = []
    for cam, depth in zip(cameras, depths):
        d = _on(depth, dev)
        H, W = d.shape
        xs = (torch.arange(W, dtype=torch.float32, device=dev) - (W - 1) / 2.0) / cam.focal_x
        ys = (torch.arange(H, dtype=torch.float32, device=dev) - (H - 1) / 2.0) / cam.focal_y
        ry, rx = torch.meshgrid(ys, xs, indexing="ij")
        valid = ((d > depth_min) & (d < depth_max)).reshape(-1)
        R = cam.world_view[:3, :3]
        t = cam.world_view[:3, 3]
        pts = []
        for dd in (d - sdf_trunc, d, d + sdf_trunc):
            pv = torch.stack([rx * dd, ry * dd, dd], dim=-1)  # [H, W, 3]
            pts.append(((pv - t) @ R).reshape(-1, 3)[valid])  # R^T (pv - t), world coords
        pw = torch.cat(pts)
        if pw.shape[0] == 0:
            continue
        found.append(torch.unique(torch.floor(_div(pw, bs)).to(torch.int32), dim=0))
    if not found:
        return torch.zeros((0, 3), dtype=torch.int32, device=dev)
    blocks = torch.unique(torch.cat(found), dim=0)
    if blocks.shape[0] > max_blocks:
        raise RuntimeError(
            f"{blocks.shape[0]} TSDF blocks exceed max_blocks={max_blocks}; "
            f"raise --max_blocks or the voxel size")
    return blocks


@torch.no_grad()
def fuse_blocks(
    depths: List,
    colors,  # per view [3, H, W] rgb (or None for no color fusion)
    cameras,
    blocks,  # [Nb, 3] int32
    voxel_size: float,
    block_res: int = 16,
    sdf_trunc: float = 0.016,
    depth_min: float = 1.0,
    depth_max: float = 6.0,
    batch: int = 1024,
):
    """Weighted-average TSDF (+color) over sparse (block_res+1)^3 sample
    blocks, `batch` blocks at a time. Returns (tsdf [Nb, R1^3], weight
    [Nb, R1^3], color [Nb, R1^3, 3] or None) on the cameras' device; samples
    live at block_origin + idx * voxel, idx in [0, block_res], so each block
    triangulates its block_res^3 cubes without touching neighbors (boundary
    samples are duplicated, fused identically)."""
    dev = _device(cameras)
    blocks = torch.as_tensor(blocks, device=dev)
    Nb = blocks.shape[0]
    R1 = block_res + 1
    S = R1**3
    with_color = colors is not None
    depths = [_on(d, dev) for d in depths]
    rgbs = [_on(c, dev) for c in colors] if with_color else [None] * len(depths)
    tsdf = torch.ones((Nb, S), dtype=torch.float32, device=dev)
    weight = torch.zeros((Nb, S), dtype=torch.float32, device=dev)
    color = torch.zeros((Nb, S, 3), dtype=torch.float32, device=dev) if with_color else None

    g = torch.arange(R1, dtype=torch.float32, device=dev)
    offs = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1).reshape(-1, 3)
    offs = offs * voxel_size  # [S, 3]
    bs = block_res * voxel_size
    for b0 in range(0, Nb, batch):
        b1 = min(b0 + batch, Nb)
        origins = blocks[b0:b1].to(torch.float32) * bs
        pts = (origins[:, None, :] + offs[None, :, :]).reshape(-1, 3)
        t_b = torch.ones(pts.shape[0], dtype=torch.float32, device=dev)
        w_b = torch.zeros_like(t_b)
        c_b = torch.zeros((pts.shape[0], 3), dtype=torch.float32, device=dev) if with_color else None
        for cam, depth, rgb in zip(cameras, depths, rgbs):
            t_b, w_b, c_b = _project_update(pts, t_b, w_b, c_b, depth, rgb, cam.world_view,
                                            cam.full_proj, sdf_trunc, depth_min, depth_max)
        tsdf[b0:b1] = t_b.reshape(b1 - b0, S)
        weight[b0:b1] = w_b.reshape(b1 - b0, S)
        if with_color:
            color[b0:b1] = c_b.reshape(b1 - b0, S, 3)
    tsdf[weight == 0] = 1.0
    return tsdf, weight, color


def _crossing_cubes(inside: torch.Tensor, observed: torch.Tensor) -> torch.Tensor:
    """[..., A, B, C] sample masks -> [..., A-1, B-1, C-1]: cubes whose 8
    corners are all observed and not all on one side."""
    A, B, C = inside.shape[-3:]
    first = inside[..., :-1, :-1, :-1]
    agree = torch.ones_like(first)
    obs = observed[..., :-1, :-1, :-1].clone()
    for dx, dy, dz in _CORNER_OFFS[1:]:
        agree &= inside[..., dx:A - 1 + dx, dy:B - 1 + dy, dz:C - 1 + dz] == first
        obs &= observed[..., dx:A - 1 + dx, dy:B - 1 + dy, dz:C - 1 + dz]
    return (~agree) & obs


def _interpolate(out, vcol=None):
    """Vertices (and colors) on the crossing edges by linear interpolation
    of the sdf, as gof_tpu (numpy, on the host)."""
    ep = out["edge_points"]
    es = out["edge_sdf"]
    denom = es[:, 0] - es[:, 1]
    tlin = np.where(np.abs(denom) > 1e-12, es[:, 0] / np.where(denom == 0, 1, denom), 0.5)
    tlin = np.clip(tlin, 0.0, 1.0)[:, None]
    verts = (ep[:, 0] * (1 - tlin) + ep[:, 1] * tlin).astype(np.float32)
    vcolors = None
    if vcol is not None:
        ec = vcol[out["edge_verts"]]  # [E, 2, 3]
        vcolors = (ec[:, 0] * (1 - tlin) + ec[:, 1] * tlin).astype(np.float32)
    return verts, vcolors


@torch.no_grad()
def blocks_to_mesh(tsdf, weight, color, blocks, voxel_size: float, block_res: int = 16):
    """Triangulate the 0 level set of a sparse block grid. Returns numpy
    (verts, faces, vertex_colors or None). Seam vertices are deduplicated by
    quantized world position (adjacent blocks fuse identical samples).
    Faces come in marching-tets' tet order (gof_tpu's numpy path emits them
    by case): the same set of faces, in another row order."""
    blocks = torch.as_tensor(blocks, device=tsdf.device)
    Nb = blocks.shape[0]
    R = block_res
    R1 = R + 1
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
             None if color is None else np.zeros((0, 3), np.float32))
    if Nb == 0:
        return empty
    dev = tsdf.device
    t = tsdf.reshape(Nb, R1, R1, R1)
    w = weight.reshape(Nb, R1, R1, R1)
    idx = torch.nonzero(_crossing_cubes(t < 0, w > 0))  # [C, 4]: (block, x, y, z)
    if idx.shape[0] == 0:
        return empty

    offs = torch.as_tensor(_CORNER_OFFS, device=dev)
    corner = idx[:, None, 1:] + offs[None, :, :]  # [C, 8, 3]
    flat = (idx[:, 0:1] * (R1**3)
            + corner[..., 0] * (R1 * R1) + corner[..., 1] * R1 + corner[..., 2])  # [C, 8]
    verts_used, inv = torch.unique(flat.reshape(-1), return_inverse=True)
    local = inv.reshape(-1, 8)
    vb = verts_used // (R1**3)
    vr = verts_used % (R1**3)
    vxyz = torch.stack([vr // (R1 * R1), (vr // R1) % R1, vr % R1], -1)
    bs = block_res * voxel_size
    vpos = blocks[vb].to(torch.float32) * bs + vxyz.to(torch.float32) * voxel_size
    vsdf = tsdf.reshape(-1)[verts_used]
    tets = local[:, torch.as_tensor(_CUBE_TETS, device=dev)].reshape(-1, 4)
    out = tetmesh.marching_tetrahedra(vpos, tets, vsdf, None)
    vcol = None if color is None else color.reshape(-1, 3)[verts_used].cpu().numpy()
    verts, vcolors = _interpolate(out, vcol)
    faces = out["faces"]

    # dedupe seam vertices (identical world positions from adjacent blocks)
    qv = np.round(verts / (voxel_size * 1e-3)).astype(np.int64)
    _, uidx, uinv = np.unique(qv, axis=0, return_index=True, return_inverse=True)
    verts = verts[uidx]
    faces = uinv.reshape(-1)[faces]
    if vcolors is not None:
        vcolors = vcolors[uidx]
    # drop degenerate faces created by the dedupe
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts, faces[good], vcolors


@torch.no_grad()
def grid_to_mesh(tsdf, weight, origin, voxel_size: float):
    """Triangulate the 0 level set of a dense grid: 6 tets per crossing cube
    + linear interpolation. Returns numpy (verts, faces); faces in tet order
    (blocks_to_mesh says why)."""
    dev = tsdf.device
    X, Y, Z = tsdf.shape
    idx = torch.nonzero(_crossing_cubes(tsdf < 0, weight > 0))  # [C, 3]
    if idx.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # per crossing cube: the 8 corner voxel ids
    corner_idx = idx[:, None, :] + torch.as_tensor(_CORNER_OFFS, device=dev)[None]  # [C, 8, 3]
    flat = corner_idx[..., 0] * (Y * Z) + corner_idx[..., 1] * Z + corner_idx[..., 2]
    verts_used, inv = torch.unique(flat.reshape(-1), return_inverse=True)
    local = inv.reshape(-1, 8)  # [C, 8] -> local vertex ids
    vx = verts_used // (Y * Z)
    vy = (verts_used // Z) % Y
    vz = verts_used % Z
    vpos = (torch.stack([vx, vy, vz], -1).to(torch.float32) * voxel_size
            + torch.as_tensor(np.asarray(origin, np.float32), device=dev))
    vsdf = tsdf.reshape(-1)[verts_used]
    tets = local[:, torch.as_tensor(_CUBE_TETS, device=dev)].reshape(-1, 4)  # [C*6, 4]
    out = tetmesh.marching_tetrahedra(vpos, tets, vsdf, None)
    verts, _ = _interpolate(out)
    return verts, out["faces"]
