"""DTU geometry evaluation (python -m gof_tpu_torch.eval.dtu ...;
counterpart of gof_tpu/eval/dtu.py, a copy reading the port's scenes).

Replaces evaluate_dtu_mesh.py + dtu_eval/eval.py, end to end:
 1. cull the TSDF mesh by the dilated train-view masks
    (evaluate_dtu_mesh.py:77-139: keep a vertex iff EVERY view sees it
    inside the disk(6)-dilated mask or not at all)
 2. align predicted camera centers to the DTU calibration: normalize both
    camera clouds by mean center distance, then a rigid SVD best-fit
    (evaluate_dtu_mesh.py:141-183)
 3. sample the aligned mesh at 0.2 density, filter by the ObsMask grid and
    the ground plane, bidirectional chamfer with distances > 20 discarded
    (dtu_eval/eval.py:36-168)

Two entry modes:
  --model_path <dir>   full protocol from a trained model directory
                       (culls + aligns + evaluates {model}/test/ours_{it}/
                       tsdf/tsdf.ply, like scripts/run_dtu.py:26-42)
  --input_mesh <ply>   evaluate a mesh that is already in DTU world frame
                       (step 3 only)

Requires the official DTU eval data layout:
  {dtu_dir}/ObsMask/ObsMask{scan}_10.mat  (ObsMask, BB, Res)
  {dtu_dir}/ObsMask/Plane{scan}.mat       (P)
  {dtu_dir}/Points/stl/stl{scan:03d}_total.ply
  {dtu_dir}/Calibration/cal18/pos_XXX.txt (for --model_path alignment)
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..utils import ply
from . import geometry as geo


def _disk(radius: int) -> np.ndarray:
    y, x = np.ogrid[-radius : radius + 1, -radius : radius + 1]
    return (x * x + y * y) <= radius * radius


def cull_mesh_by_masks(verts, faces, cameras, masks, dilate_px: int = 6):
    """Reference semantics (evaluate_dtu_mesh.py:77-139): a vertex survives
    iff for EVERY view it is either outside the frustum or lands inside the
    view's disk(dilate_px)-dilated alpha mask. Faces survive iff all three
    vertices do."""
    from scipy.ndimage import binary_dilation

    keep_v = np.ones(len(verts), bool)
    footprint = _disk(dilate_px)
    for cam, mask in zip(cameras, masks):
        wv = np.asarray(cam.world_view)
        z = verts @ wv[2, :3] + wv[2, 3]
        x = verts @ wv[0, :3] + wv[0, 3]
        y = verts @ wv[1, :3] + wv[1, 3]
        zs = np.where(z > 1e-6, z, 1e-6)
        px = float(cam.focal_x) * x / zs + cam.width / 2.0
        py = float(cam.focal_y) * y / zs + cam.height / 2.0
        inside = (z > 0) & (px > 0) & (px < cam.width - 1) & (py > 0) & (py < cam.height - 1)
        ok_view = ~inside  # out-of-view vertices pass this view's test
        if mask is not None:
            m = binary_dilation(np.asarray(mask) > 0.5, structure=footprint)
            xi = np.clip(np.round(px).astype(int), 0, cam.width - 1)
            yi = np.clip(np.round(py).astype(int), 0, cam.height - 1)
            ok_view |= m[yi, xi]
        else:
            ok_view |= inside
        keep_v &= ok_view
    if faces is None:
        return keep_v, None
    keep_f = keep_v[faces].all(axis=1)
    # reindex faces to the surviving vertices
    new_idx = np.cumsum(keep_v) - 1
    return keep_v, new_idx[faces[keep_f]]


def load_dtu_calibration(dtu_dir: str, n: int = 64) -> np.ndarray:
    """Camera centers from Calibration/cal18/pos_XXX.txt projection matrices
    (evaluate_dtu_mesh.py:59-76). The center is the projection matrix's null
    space (no cv2 dependency)."""
    centers = []
    for i in range(1, n + 1):
        fname = os.path.join(dtu_dir, "Calibration", "cal18", f"pos_{i:03d}.txt")
        P = np.loadtxt(fname, dtype=np.float64).reshape(3, 4)
        _, _, Vt = np.linalg.svd(P)
        c = Vt[-1]
        centers.append(c[:3] / c[3])
    return np.asarray(centers)


def _image_index(image_name: str) -> int:
    """DTU image index from a file name like rect_012_3_r5000 or 00012."""
    import re

    nums = re.findall(r"\d+", image_name)
    return int(nums[0]) if nums else 1


def dtu_alignment(pred_centers: np.ndarray, gt_centers: np.ndarray):
    """Scale-normalize then rigid best-fit (evaluate_dtu_mesh.py:157-165).
    Returns (scale, R, t): aligned = (x * scale) @ R.T + t.

    pred_centers[i] must correspond to gt_centers[i]: the caller pairs by
    the DTU image index parsed from each camera's image name (an --eval
    split removes every 8th train camera, so positional pairing is wrong).
    """
    assert len(pred_centers) == len(gt_centers)
    gt = gt_centers
    s_pred = np.linalg.norm(pred_centers - pred_centers.mean(0), axis=1).mean()
    s_gt = np.linalg.norm(gt - gt.mean(0), axis=1).mean()
    scale = s_gt / max(s_pred, 1e-12)
    R, t, _ = geo.best_fit_transform(pred_centers * scale, gt, rigid=True)
    return scale, R, t


def dtu_chamfer(data_pts: np.ndarray, stl_pts: np.ndarray, obs_mask, bb, res,
                plane, max_dist: float = 20.0, patch: float = 60.0):
    """dtu_eval/eval.py:78-160: ObsMask-filter data->stl, plane-filter
    stl->data, distances > max_dist discarded."""
    # data points inside the observability grid
    idx = ((data_pts - bb[0:1]) / res).astype(int)
    good = np.all((idx >= 0) & (idx < np.array(obs_mask.shape)), axis=1)
    grid_ok = np.zeros(len(data_pts), bool)
    gi = idx[good]
    grid_ok[good] = obs_mask[gi[:, 0], gi[:, 1], gi[:, 2]] > 0
    d2s = geo.nn_distances(data_pts[grid_ok], stl_pts) if grid_ok.any() else np.array([np.inf])
    d2s = np.minimum(d2s, max_dist)

    # stl points above the plane
    if plane is not None:
        above = (np.concatenate([stl_pts, np.ones((len(stl_pts), 1))], 1) @ plane.reshape(4)) > 0
    else:
        above = np.ones(len(stl_pts), bool)
    s2d = geo.nn_distances(stl_pts[above], data_pts) if len(data_pts) else np.array([np.inf])
    s2d = np.minimum(s2d, max_dist)
    return {
        "mean_d2s": float(d2s.mean()),
        "mean_s2d": float(s2d.mean()),
        "overall": float((d2s.mean() + s2d.mean()) / 2.0),
    }


def _load_model_mesh_and_cameras(model_path: str, iteration: int, mesh_rel: str):
    """Trained-model inputs: mesh, train cameras (+ alpha masks when the
    dataset provides them)."""
    from ..config import load_cfg
    from ..data.scene import Scene

    cfg, _, _ = load_cfg(model_path)
    scene = Scene(
        cfg.source_path, model_path="", images=cfg.images,
        resolution=cfg.resolution, white_background=cfg.white_background,
        eval_split=cfg.eval, shuffle=False,
    )
    mesh_file = os.path.join(model_path, "test", f"ours_{iteration}", mesh_rel)
    verts_d, faces = ply.read_ply(mesh_file)
    verts = np.stack([verts_d["x"], verts_d["y"], verts_d["z"]], -1).astype(np.float64)

    from ..data.readers import load_alpha

    cams, masks, image_ids = [], [], []
    for info in scene.train_cameras:
        from .. import cameras as cameras_lib

        W, H = scene._scaled_size(info)
        cams.append(cameras_lib.make_camera(info.R, info.T, info.fovx, info.fovy,
                                            W, H, uid=info.uid))
        masks.append(load_alpha(info, scene.resolution))
        image_ids.append(_image_index(info.image_name))
    return verts, faces, cams, masks, image_ids, mesh_file


def evaluate_model(model_path: str, scan_id: int, dtu_dir: str, iteration: int = 30000,
                   mesh_rel: str = os.path.join("tsdf", "tsdf.ply"),
                   downsample_density: float = 0.2, output_dir: str | None = None):
    """Full reference protocol from a trained model dir. Returns results dict."""
    verts, faces, cams, masks, image_ids, mesh_file = _load_model_mesh_and_cameras(
        model_path, iteration, mesh_rel)

    # 1. mask culling
    keep_v, faces_c = cull_mesh_by_masks(verts, faces, cams, masks)
    verts_c = verts[keep_v]
    ply.write_ply(mesh_file.replace(".ply", "_culled.ply"),
                  {"x": verts_c[:, 0], "y": verts_c[:, 1], "z": verts_c[:, 2]},
                  faces=faces_c)

    # 2. camera-center alignment to the DTU calibration
    pred_centers = np.asarray([np.asarray(c.cam_center) for c in cams], np.float64)
    calib = load_dtu_calibration(dtu_dir)
    # pair each camera with its calibration entry by DTU image index
    # (1-based pos_###.txt); an --eval split leaves holes in train_cameras.
    # Fail loudly on out-of-range indices: silently clamping a misparsed
    # filename would mis-align the SVD fit and wreck the chamfer numbers.
    bad = [i for i in image_ids if not (1 <= i <= len(calib))]
    if bad:
        raise ValueError(
            f"camera image indices {bad[:5]} out of range for DTU calibration "
            f"with {len(calib)} entries; check image filenames (expected "
            "1-based indices parseable from the name)")
    gt_centers = np.asarray([calib[i - 1] for i in image_ids], np.float64)
    scale, R, t = dtu_alignment(pred_centers, gt_centers)
    verts_a = (verts_c * scale) @ R.T + t
    ply.write_ply(mesh_file.replace(".ply", "_aligned.ply"),
                  {"x": verts_a[:, 0], "y": verts_a[:, 1], "z": verts_a[:, 2]},
                  faces=faces_c)

    # 3. chamfer against the reference scan
    out_dir = output_dir or os.path.dirname(mesh_file)
    return _chamfer_against_stl(verts_a, faces_c, scan_id, dtu_dir,
                                downsample_density, out_dir)


def _chamfer_against_stl(verts, faces, scan_id, dtu_dir, downsample_density, output_dir):
    from scipy.io import loadmat

    obs = loadmat(os.path.join(dtu_dir, "ObsMask", f"ObsMask{scan_id}_10.mat"))
    obs_mask, bb, res = obs["ObsMask"], obs["BB"], float(obs["Res"])
    try:
        plane = loadmat(os.path.join(dtu_dir, "ObsMask", f"Plane{scan_id}.mat"))["P"]
    except FileNotFoundError:
        plane = None
    stl_d, _ = ply.read_ply(
        os.path.join(dtu_dir, "Points", "stl", f"stl{scan_id:03d}_total.ply")
    )
    stl = np.stack([stl_d["x"], stl_d["y"], stl_d["z"]], -1).astype(np.float64)
    stl = geo.reduce_pcd(stl, downsample_density)

    pts = geo.sample_mesh_surface(verts, faces, downsample_density) if faces is not None and len(faces) else verts
    pts = geo.reduce_pcd(pts, downsample_density)
    res_json = dtu_chamfer(pts, stl, obs_mask, bb, res, plane)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "results.json"), "w") as f:
        json.dump(res_json, f, indent=2)
    print(json.dumps(res_json))
    return res_json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input_mesh", help="mesh already in DTU world frame")
    ap.add_argument("--model_path", help="trained model dir (full protocol)")
    ap.add_argument("--iteration", type=int, default=30000)
    ap.add_argument("--mesh", default=os.path.join("tsdf", "tsdf.ply"),
                    help="mesh path relative to {model}/test/ours_{iteration}/")
    ap.add_argument("--scan_id", type=int, required=True)
    ap.add_argument("--DTU", required=True, help="official DTU eval data dir")
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--downsample_density", type=float, default=0.2)
    ns = ap.parse_args(argv)

    if ns.model_path:
        evaluate_model(ns.model_path, ns.scan_id, ns.DTU, ns.iteration, ns.mesh,
                       ns.downsample_density, ns.output_dir)
        return
    if not ns.input_mesh:
        ap.error("one of --model_path / --input_mesh is required")
    verts_d, faces = ply.read_ply(ns.input_mesh)
    verts = np.stack([verts_d["x"], verts_d["y"], verts_d["z"]], -1).astype(np.float64)
    _chamfer_against_stl(verts, faces, ns.scan_id, ns.DTU, ns.downsample_density,
                         ns.output_dir or os.path.dirname(ns.input_mesh) or ".")


if __name__ == "__main__":
    main()
