"""Level-set mesh extraction: marching tetrahedra + binary search
(counterpart of gof_tpu/mesh/extract.py).

Pipeline (the reference's marching_tetrahedra_with_binary_search,
extract_mesh.py:37-126):
 1. tetra points = per-gaussian oriented box corners at 3x the filtered
    scale (x2 box) + centres, frustum-masked over the training views;
 2. Delaunay tetrahedralization on the host (scipy Qhull in float64), cached
    in `cells.npy` with gof_tpu's header, so the caches are interchangeable;
 3. field(x) = 1 - min over views of (1 - T_view(x)), sdf = field - 0.5,
    T_view from the integrate kernel (ops/integrate.py, csrc/integrate.cu);
 4. marching tets on the crossing edges (mesh/tetmesh.py: torch ops on the
    model's CUDA device, numpy on the CPU);
 5. binary-search steps re-evaluating the field at interval midpoints;
 6. optional face filter: drop faces whose edge interval is longer than the
    sum of the endpoint gaussians' scales.

Unlike gof_tpu there is no jit cache and no key-capacity overflow loop: the
binnings are sized per view from the demand.
"""

from __future__ import annotations

import os
import time
from typing import List

import numpy as np
import torch

from ..model import gaussians as gm
from ..ops import binning, integrate, preprocess
from ..ops import rasterize as rz
from ..parallel import sharding
from ..transforms import ndc_to_pixel, project_points, quat_to_rot
from ..utils import ply, trace
from . import tetmesh

# the eight corners of the reference's trimesh box scaled x2: (+-1)^3
_BOX = np.array(
    [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32
)


def frustum_mask(points, world_views, focals_x, focals_y, widths, heights,
                 near: float = 0.02, far: float = 1e6) -> torch.Tensor:
    """Visible in ANY view: depth in [near, far], pixel in [0, W-1]x[0, H-1]
    (get_frustum_mask, gaussian_model.py:30-72)."""
    pv = torch.einsum("nij,pj->npi", world_views[:, :3, :3], points) + world_views[:, None, :3, 3]
    z = pv[..., 2]
    zc = torch.clamp_min(z, 1e-6)
    u = pv[..., 0] / zc * focals_x[:, None] + widths[:, None] / 2.0
    v = pv[..., 1] / zc * focals_y[:, None] + heights[:, None] / 2.0
    ok = ((z >= near) & (z <= far)
          & (u >= 0) & (u <= widths[:, None] - 1)
          & (v >= 0) & (v <= heights[:, None] - 1))
    return ok.any(dim=0)


@torch.no_grad()
def get_tetra_points(params: gm.GaussianParams, state: gm.GaussianState, cam_meta,
                     near: float = 0.02, far: float = 1e6):
    """Gaussian-aligned tetrahedralization points and per-point scale, as
    host numpy arrays (get_tetra_points, gaussian_model.py:432-463)."""
    idx = torch.nonzero(state.active).squeeze(1)
    xyz = params.xyz[idx]
    rot = params.rotation[idx]
    scale = gm.filtered_scaling(
        gm.GaussianParams(xyz=xyz, features_dc=None, features_rest=None,
                          scaling=params.scaling[idx], rotation=rot, opacity=None),
        state.filter_3d[idx]) * 3.0

    R = quat_to_rot(rot)  # [P, 3, 3]
    # corner = xyz + R @ (box_corner * scale)
    box = torch.as_tensor(_BOX, device=xyz.device)
    corners = xyz[:, None, :] + torch.einsum("pij,pcj->pci", R, box[None] * scale[:, None, :])
    pts = torch.cat([corners.reshape(-1, 3), xyz], dim=0)
    smax = scale.amax(dim=-1)
    pscale = torch.cat([torch.repeat_interleave(smax, 8), smax], dim=0)

    mask = frustum_mask(pts, *cam_meta, near=near, far=far)
    return pts[mask].cpu().numpy(), pscale[mask].cpu().numpy()


def delaunay(points: np.ndarray, cache_path: str | None = None) -> np.ndarray:
    """Host Delaunay tetrahedralization (Qhull), cached like cells.pt.

    The cache's first row records the point count it was built for; a cache
    built for another count is ignored.
    """
    if cache_path and os.path.exists(cache_path):
        cached = np.load(cache_path, allow_pickle=False)
        n_cached = int(cached[0, 0]) if cached.shape[0] > 0 else -1
        if n_cached == len(points):
            return cached[1:]
    from scipy.spatial import Delaunay

    cells = Delaunay(points.astype(np.float64)).simplices.astype(np.int32)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        header = np.full((1, 4), len(points), dtype=np.int32)
        np.save(cache_path, np.concatenate([header, cells], axis=0))
    return cells


class FieldEvaluator:
    """min-over-views opacity field of a model on its device.

    Each view runs the preprocess (ops/preprocess.py) with the screen radius
    kept at 3 sigma (not opacity-tightened), tile binning (K2), the payload
    gather, point binning and the integrate kernel (K5). `devices` (gof_tpu's `mesh`,
    `extract_mesh --shard N`): the model is replicated on each, the points
    are split over them (parallel.sharding.sharded_min_transmittance) and
    every shard runs each view's whole chain on its device; a device may
    appear more than once. A point's value does not depend on the other
    points of its launch, so the sharded field equals the unsharded one.
    """

    def __init__(self, params: gm.GaussianParams, state: gm.GaussianState, cameras: List,
                 sh_degree: int, kernel_size: float, devices=None, bg=None):
        self.cameras = cameras
        self.device = params.xyz.device
        self.devices = [self.device] if devices is None else list(devices)
        self.sh_degree = sh_degree
        self.kernel_size = kernel_size
        self.bg = torch.as_tensor(np.zeros(3) if bg is None else bg, dtype=torch.float32,
                                  device=self.device)
        with torch.no_grad():
            self.model = dict(
                xyz=params.xyz, scales=gm.filtered_scaling(params, state.filter_3d),
                rot=params.rotation, op=gm.filtered_opacity(params, state.filter_3d),
                active=state.active,
            )
        self.leaves = preprocess.Leaves.of(params, state)  # the colours' render
        self._replicas = {sharding.as_device(d): {k: v.to(d) for k, v in self.model.items()}
                          for d in [self.device, *self.devices]}
        self.calls = 0  # alpha() calls made: the id of the next `field_call` unit

    @torch.no_grad()
    def view_inputs(self, points: torch.Tensor, camera):
        """The integrate kernel's inputs for `points` in one view, on the
        points' device (the model's replica there): (payload [16, CAP],
        gaussian binning, point bins)."""
        m = self._replicas[sharding.as_device(points.device)]
        camera = camera.to(points.device)
        ntx, nty = binning.tile_grid(camera.width, camera.height)
        with trace.span("preprocess"):
            vp = preprocess.preprocess_view(camera, m["xyz"], m["scales"], m["rot"], m["op"],
                                            None, 0, self.kernel_size, m["active"],
                                            tight_radius=False)
            pre = vp.pre
        with trace.span("binning"):
            b = binning.bin_gaussians(pre.depth, vp.rects, ntx, nty, mean2d=pre.mean2d,
                                      radius=pre.radius)
        with trace.span("payload"):
            payload = rz.build_payload16(pre.rgb, vp.op_eff, pre.v2g_M, pre.v2g_u0, b)
        with trace.span("point_bins"):
            pbins = integrate.bin_points(points, camera, ntx, nty)
        return payload, b, pbins

    def _points(self, points) -> torch.Tensor:
        return torch.as_tensor(np.asarray(points, np.float32), device=self.device)

    def alpha(self, points: np.ndarray, cameras=None) -> np.ndarray:
        """field(x) = 1 - min over views of (1 - T_view(x))
        (evaluage_alpha, extract_mesh.py:16-34), as a numpy array. One
        `field_call` unit of the program's spans (utils/trace.py), a
        `field_view` span per camera, tagged with its index."""
        cams = self.cameras if cameras is None else cameras

        def shard_alpha(pts: torch.Tensor) -> torch.Tensor:
            n = pts.shape[0]
            final_alpha = torch.ones(n, dtype=torch.float32, device=pts.device)
            for k, cam in enumerate(cams):
                with trace.span("field_view", tag=k):
                    payload, b, pbins = self.view_inputs(pts, cam)
                    with trace.span("k5"):
                        T = integrate.integrate_transmittance(payload, b, pbins, n)
                    final_alpha = torch.minimum(final_alpha, 1.0 - T)
            return 1.0 - final_alpha

        self.calls += 1
        with trace.unit("field_call", self.calls - 1, self.device):
            return sharding.sharded_min_transmittance(shard_alpha, self.devices)(points)

    @torch.no_grad()
    def _view_color(self, pts: torch.Tensor, camera):
        """Rendered image of one view sampled at each point's pixel (the
        reference's color_integrated: the blended colour C + T*bg of the
        pixel p projects into, forward.cu:1003,1208), and whether p projects
        inside the view."""
        from ..ops import render as render_lib

        m = self.model
        out = render_lib.render(camera, m["xyz"], None, m["rot"], None, None, self.sh_degree,
                                self.kernel_size, self.bg, active_mask=m["active"],
                                with_stats=False, with_reg=False, leaves=self.leaves)
        W, H = camera.width, camera.height
        ndc = project_points(pts, camera.full_proj)
        px = ndc_to_pixel(ndc[:, 0], W)
        py = ndc_to_pixel(ndc[:, 1], H)
        wv = camera.world_view
        z = pts @ wv[2, :3] + wv[2, 3]
        inside = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (z > 1e-4)
        xi = torch.clamp(px, 0, W - 1).to(torch.int64)  # truncation, as gof_tpu's int cast
        yi = torch.clamp(py, 0, H - 1).to(torch.int64)
        color = out.image[:3, yi, xi].T  # [N, 3]
        return color.cpu().numpy(), inside.cpu().numpy()

    def alpha_color(self, points: np.ndarray):
        """(alpha, color) per point: alpha as in alpha(); each point keeps
        the colour of the view where its alpha_integrated is lowest
        (initialised to white; extract_mesh.py:26-29), and a view donates
        colour only where the point projects inside it, as in gof_tpu."""
        n = len(points)
        final_alpha = np.ones((n,), np.float32)
        final_color = np.ones((n, 3), np.float32)
        pts = self._points(points)
        for cam in self.cameras:
            a_v = self.alpha(points, cameras=[cam])
            c_v, inside = self._view_color(pts, cam)
            upd = (a_v < final_alpha) & inside
            final_color = np.where(upd[:, None], c_v, final_color)
            final_alpha = np.minimum(final_alpha, a_v)
        return final_alpha, final_color


def extract_level_set_mesh(
    params, state, cameras: List, cam_meta, out_dir: str, sh_degree: int,
    kernel_size: float, n_binary_steps: int = 8, filter_faces: bool = True,
    near: float = 0.02, far: float = 1e6, quiet: bool = False, shard=0,
    texture_mesh: bool = False, bg=None,
) -> dict:
    """Write `mesh_binary_search_{n_binary_steps - 1}.ply` to out_dir from a
    model on its device (CUDA: the kernels; CPU: their plain versions).

    shard: N > 1 splits the field's points over the first N devices of the
    model's kind (parallel.sharding.make_mesh: N CUDA devices, raising where
    fewer are visible, or N CPU shards); a list of devices splits them over
    those (FieldEvaluator's `devices`).

    Returns {"path", "tetra_points", "tets", "crossing_edges", "faces",
    "vertices", "seconds"}: faces and vertices as written, and the host-clock
    seconds of each stage (each ends in a host read, which waits for the
    device).
    """
    devices = None
    if isinstance(shard, int) and shard > 1:
        devices = sharding.make_mesh(shard, params.xyz.device.type, f"--shard {shard}")
    elif not isinstance(shard, int):
        devices = list(shard)
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        seconds[name] = now - t0
        t0 = now

    def say(msg):
        if not quiet:
            print(msg)

    os.makedirs(out_dir, exist_ok=True)
    points, pscale = get_tetra_points(params, state, cam_meta, near, far)
    lap("tetra_points")
    say(f"tetra points: {len(points)}")
    cells = delaunay(points, os.path.join(out_dir, "cells.npy"))
    lap("delaunay")
    say(f"tets: {len(cells)}")

    if devices:
        say(f"field evaluation sharded over {len(devices)} devices")
    ev = FieldEvaluator(params, state, cameras, sh_degree, kernel_size, devices=devices, bg=bg)
    alpha = ev.alpha(points)
    lap("field")
    sdf = alpha - 0.5
    mt = tetmesh.marching_tetrahedra(
        points, cells, torch.as_tensor(sdf, device=ev.device) if ev.device.type == "cuda" else sdf,
        pscale)
    lap("marching_tets")
    faces = mt["faces"]
    left = mt["edge_points"][:, 0].copy()
    right = mt["edge_points"][:, 1].copy()
    left_sdf = mt["edge_sdf"][:, 0:1].copy()
    right_sdf = mt["edge_sdf"][:, 1:2].copy()
    distance = np.linalg.norm(left - right, axis=-1)
    scale_sum = mt["edge_scale"][:, 0] + mt["edge_scale"][:, 1]
    say(f"crossing edges: {len(left)}, faces: {len(faces)}")

    verts = (left + right) / 2.0
    for step in range(n_binary_steps):
        say(f"binary search step {step}")
        mid = (left + right) / 2.0
        mid_sdf = (ev.alpha(mid) - 0.5)[:, None]
        ind_low = ((mid_sdf < 0) & (left_sdf < 0)) | ((mid_sdf > 0) & (left_sdf > 0))
        left_sdf = np.where(ind_low, mid_sdf, left_sdf)
        right_sdf = np.where(~ind_low, mid_sdf, right_sdf)
        m = ind_low[:, 0]
        left[m] = mid[m]
        right[~m] = mid[~m]
        verts = (left + right) / 2.0
        lap(f"bisection_{step}")

    vcolors = None
    if texture_mesh:
        # vertex colours from the view-selected integrated colour
        # (extract_mesh.py:106-111; forward.cu:1182-1217)
        say("evaluating vertex colors")
        _, vcolors = ev.alpha_color(verts)
        vcolors = (np.clip(vcolors, 0.0, 1.0) * 255).astype(np.uint8)
        lap("colors")

    if filter_faces and len(faces):
        keep_v = distance <= scale_sum
        keep_f = keep_v[faces].all(axis=1)
        faces = faces[keep_f]
        # compact vertices
        used, faces = np.unique(faces.reshape(-1), return_inverse=True)
        faces = faces.reshape(-1, 3)
        verts = verts[used]
        if vcolors is not None:
            vcolors = vcolors[used]

    out_path = os.path.join(out_dir, f"mesh_binary_search_{n_binary_steps - 1}.ply")
    props = {"x": verts[:, 0], "y": verts[:, 1], "z": verts[:, 2]}
    if vcolors is not None:
        props.update(red=vcolors[:, 0], green=vcolors[:, 1], blue=vcolors[:, 2])
    ply.write_ply(out_path, props, faces=faces)
    lap("ply")
    return {"path": out_path, "tetra_points": len(points), "tets": len(cells),
            "crossing_edges": len(mt["edge_points"]), "faces": len(faces),
            "vertices": len(verts),
            "seconds": seconds}
