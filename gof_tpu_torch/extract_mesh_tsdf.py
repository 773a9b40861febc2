"""TSDF mesh extraction CLI (python -m gof_tpu_torch.extract_mesh_tsdf -m
<model>; counterpart of gof_tpu/extract_mesh_tsdf.py).

Renders median depth + alpha for every training view (render_cli's
render_eval), masks depth by accumulated alpha >= 0.5 and by the dataset's
gt alpha mask where the camera carries one (as gof_tpu: info.alpha),
fuses a TSDF and writes {model}/test/ours_{iter}/tsdf/tsdf.ply: the mesh
the DTU evaluation consumes (evaluate_dtu_mesh.py:166-167). Sparse blocks
by default, a dense z-slab grid with --dense. Runs on CUDA (raises when
CUDA is absent); `--cpu` selects the CPU. `main` returns the counts and
each stage's seconds.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def masked_depth(depth: torch.Tensor, alpha: torch.Tensor, gt_alpha) -> torch.Tensor:
    """Depth where the render is opaque (alpha >= 0.5,
    extract_mesh_tsdf.py:38-40) and inside the gt alpha mask, else 0."""
    depth = torch.where(alpha >= 0.5, depth, torch.zeros_like(depth))
    if gt_alpha is not None:
        from PIL import Image

        m = gt_alpha
        if m.shape != tuple(depth.shape):
            m = np.asarray(Image.fromarray((m * 255).astype(np.uint8)).resize(
                (depth.shape[1], depth.shape[0])), np.float32) / 255.0
        keep = torch.as_tensor(np.asarray(m) > 0.5, device=depth.device)
        depth = torch.where(keep, depth, torch.zeros_like(depth))
    return depth


def dense_grid(gauss, gstate, voxel_size: float, max_dim: int):
    """The --dense grid: bounds from the active gaussians with a 4-voxel
    margin, the voxel grown where the grid would exceed max_dim per axis.
    Returns (origin [3] f32, voxel, dims)."""
    xyz = gauss.xyz.detach().cpu().numpy()[gstate.active.cpu().numpy()]
    # a non-finite gaussian (pruned on the next densify, but possibly
    # alive in a snapshot) would poison min/max into a negative grid
    xyz = xyz[np.isfinite(xyz).all(axis=1)]
    lo = xyz.min(axis=0) - 4 * voxel_size
    hi = xyz.max(axis=0) + 4 * voxel_size
    dims = np.minimum(np.ceil((hi - lo) / voxel_size).astype(int) + 1, max_dim)
    voxel = float(max((hi - lo) / np.maximum(dims - 1, 1)))
    dims = tuple(int(d) for d in np.ceil((hi - lo) / voxel).astype(int) + 1)
    return lo.astype(np.float32), voxel, dims


def main(argv=None):
    parser = argparse.ArgumentParser(description="gof_tpu_torch TSDF mesh extraction")
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=30_000)
    # reference protocol (extract_mesh_tsdf.py:22-46 + Open3D defaults):
    # voxel 0.002, trunc 8 * voxel, depth range [1, 6], 16^3 blocks
    parser.add_argument("--voxel_size", type=float, default=0.002)
    parser.add_argument("--sdf_trunc", type=float, default=0.016)
    parser.add_argument("--depth_min", type=float, default=1.0)
    parser.add_argument("--depth_max", type=float, default=6.0)
    parser.add_argument("--block_res", type=int, default=16)
    parser.add_argument("--max_blocks", type=int, default=500_000)
    parser.add_argument("--dense", action="store_true",
                        help="dense z-slab grid instead of sparse blocks "
                             "(small scenes; capped at --max_dim per axis)")
    parser.add_argument("--max_dim", type=int, default=512)
    parser.add_argument("--no_color", action="store_true",
                        help="skip per-voxel color fusion")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    ns = parser.parse_args(argv)
    if ns.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --cpu for the CPU path")
        device = torch.device("cuda")

    from . import config as config_lib
    from .data import scene as scene_lib
    from .mesh import tsdf as tsdf_lib
    from .render_cli import render_eval
    from .utils import ply

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    model_cfg, pipe, _opt = config_lib.load_cfg(ns.model_path)
    model_cfg.model_path = ns.model_path
    pc_dir = os.path.join(ns.model_path, "point_cloud")
    iteration = ns.iteration
    if not os.path.isdir(os.path.join(pc_dir, f"iteration_{iteration}")):
        iteration = max(int(d.split("_")[1]) for d in os.listdir(pc_dir))

    sc = scene_lib.Scene(
        model_cfg.source_path, "", images=model_cfg.images,
        resolution=model_cfg.resolution, white_background=model_cfg.white_background,
        eval_split=model_cfg.eval, shuffle=False,
    )
    gauss, gstate = scene_lib.load_gaussians_ply(
        os.path.join(pc_dir, f"iteration_{iteration}", "point_cloud.ply"),
        model_cfg.sh_degree, device=device,
    )
    bg = torch.tensor([1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0],
                      device=device)

    seconds = {}
    t0 = clock()
    depths, colors, cams = [], [], []
    for info in sc.train_cameras:
        camera, _gt = sc.camera(info, device=device)
        img = render_eval(gauss, gstate, camera, model_cfg, bg, pipe.backend).image
        depths.append(masked_depth(img[6], img[7], info.alpha))
        colors.append(img[:3])
        cams.append(camera)
    seconds["render"] = clock() - t0

    out_dir = os.path.join(ns.model_path, "test", f"ours_{iteration}", "tsdf")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "tsdf.ply")
    result = {"path": out, "views": len(cams)}
    if not ns.dense:
        # sparse block grid at the reference protocol (no dimension cap)
        t0 = clock()
        blocks = tsdf_lib.discover_blocks(
            depths, cams, ns.voxel_size, ns.block_res, ns.sdf_trunc,
            ns.depth_min, ns.depth_max, ns.max_blocks)
        seconds["discover"] = clock() - t0
        print(f"TSDF blocks: {len(blocks)} x {ns.block_res}^3 voxels "
              f"(voxel {ns.voxel_size})")
        t0 = clock()
        tsdf, weight, color = tsdf_lib.fuse_blocks(
            depths, None if ns.no_color else colors, cams, blocks,
            ns.voxel_size, ns.block_res, ns.sdf_trunc, ns.depth_min,
            ns.depth_max)
        seconds["fuse"] = clock() - t0
        t0 = clock()
        verts, faces, vcol = tsdf_lib.blocks_to_mesh(
            tsdf, weight, color, blocks, ns.voxel_size, ns.block_res)
        seconds["mesh"] = clock() - t0
        result.update(blocks=len(blocks), voxels=len(blocks) * ns.block_res**3,
                      samples=int(tsdf.numel()), observed=int((weight > 0).sum()))
        props = {"x": verts[:, 0], "y": verts[:, 1], "z": verts[:, 2]}
        if vcol is not None:
            c8 = (np.clip(vcol, 0, 1) * 255).astype(np.uint8)
            props.update(red=c8[:, 0], green=c8[:, 1], blue=c8[:, 2])
    else:
        lo, voxel, dims = dense_grid(gauss, gstate, ns.voxel_size, ns.max_dim)
        print(f"TSDF grid {dims} voxel {voxel:.4f}")
        t0 = clock()
        tsdf, weight = tsdf_lib.fuse_depth_maps(
            depths, cams, lo, voxel, dims, ns.sdf_trunc, ns.depth_min, ns.depth_max,
        )
        seconds["fuse"] = clock() - t0
        t0 = clock()
        verts, faces = tsdf_lib.grid_to_mesh(tsdf, weight, lo, voxel)
        seconds["mesh"] = clock() - t0
        result.update(dims=dims, voxel=voxel, voxels=int(np.prod(dims)),
                      observed=int((weight > 0).sum()))
        props = {"x": verts[:, 0], "y": verts[:, 1], "z": verts[:, 2]}
    t0 = clock()
    ply.write_ply(out, props, faces=faces)
    seconds["write"] = clock() - t0
    print(f"TSDF mesh: {len(verts)} verts, {len(faces)} faces -> {out}")
    result.update(verts=len(verts), faces=len(faces), seconds=seconds)
    return result


if __name__ == "__main__":
    main()
