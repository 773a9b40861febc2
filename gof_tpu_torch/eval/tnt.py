"""Tanks and Temples geometry evaluation (python -m gof_tpu_torch.eval.tnt ...;
counterpart of gof_tpu/eval/tnt.py, a copy).

Replaces eval_tnt/run.py + evaluation.py + registration.py + trajectory_io.py:

 1. initial alignment from camera trajectories: the reconstruction's COLMAP
    trajectory (--traj-path, .log format) is registered to the dataset's
    GT-frame trajectory {scene}_COLMAP_SfM.log (transformed by
    {scene}_trans.txt) with a scaled best-fit over index-corresponded camera
    centers, robustified by RANSAC (registration.py:65-108, which uses
    o3d RANSAC over identity correspondences with scaling enabled);
 2. staged ICP refinement at decreasing thresholds 80*tau -> 20*tau -> 2*tau
    on crop-volume-filtered clouds (run.py:155-161);
 3. precision / recall / F-score at the per-scene tau
    (eval_tnt/config.py:33-41, evaluation.py:144-165).

If no trajectory is supplied, a precomputed {scene}_trans.txt applied to the
reconstruction is accepted as the initial alignment (legacy mode).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..utils import ply
from . import geometry as geo

# per-scene distance thresholds tau (eval_tnt/config.py:33-41)
SCENE_TAU = {
    "Barn": 0.01, "Caterpillar": 0.005, "Courthouse": 0.025,
    "Ignatius": 0.003, "Meetingroom": 0.01, "Truck": 0.005,
}


def load_points(path):
    verts, faces = ply.read_ply(path)
    pts = np.stack([verts["x"], verts["y"], verts["z"]], -1).astype(np.float64)
    return pts, faces


def read_trajectory_log(path) -> np.ndarray:
    """TNT .log trajectory: blocks of one metadata line + a 4x4 pose
    (camera-to-world), eval_tnt/trajectory_io.py:23-35. Returns [N, 4, 4]."""
    poses = []
    with open(path) as f:
        meta = f.readline()
        while meta.strip():
            mat = np.array([np.fromstring(f.readline(), dtype=float, sep=" \t")
                            for _ in range(4)])
            poses.append(mat)
            meta = f.readline()
    return np.asarray(poses)


def similarity_to_matrix(R, t, s):
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = t
    return T


def trajectory_alignment(pred_centers: np.ndarray, gt_centers: np.ndarray,
                         inlier_thresh: float = 0.2, iters: int = 1000, rng=None):
    """Scaled best-fit over index-corresponded camera centers with a RANSAC
    loop (the reference's registration_ransac_based_on_correspondence with
    with_scaling=True, registration.py:98-108). Returns (T 4x4, info dict)."""
    rng = rng or np.random.default_rng(0)
    n = min(len(pred_centers), len(gt_centers))
    A, B = pred_centers[:n], gt_centers[:n]
    if n < 3:
        raise ValueError("need at least 3 corresponded camera poses")

    def fit(idx):
        R, t, s = geo.best_fit_transform(A[idx], B[idx])
        return R, t, s

    best = None
    for _ in range(iters):
        idx = rng.choice(n, size=min(6, n), replace=False)
        try:
            R, t, s = fit(idx)
        except np.linalg.LinAlgError:
            continue
        resid = np.linalg.norm((A * s) @ R.T + t - B, axis=1)
        inl = resid < inlier_thresh
        score = int(inl.sum())
        if best is None or score > best[0]:
            best = (score, inl)
    score, inl = best
    if score >= 3:
        R, t, s = fit(np.nonzero(inl)[0])
    else:  # degenerate: fall back to all correspondences
        R, t, s = fit(np.arange(n))
    resid = np.linalg.norm((A * s) @ R.T + t - B, axis=1)
    info = {"n_poses": int(n), "inliers": int((resid < inlier_thresh).sum()),
            "rmse": float(np.sqrt((resid**2).mean()))}
    return similarity_to_matrix(R, t, s), info


def load_crop_volume(path):
    """Official TNT crop file: polygon in an axis-aligned plane + slice range."""
    with open(path) as f:
        crop = json.load(f)
    poly = np.array(crop["bounding_polygon"])
    axis_names = {"X": 0, "Y": 1, "Z": 2}
    axis = axis_names[crop["orthogonal_axis"].upper()]
    return poly, axis, crop["axis_min"], crop["axis_max"]


def crop_points(pts, poly, axis, amin, amax):
    keep = (pts[:, axis] >= amin) & (pts[:, axis] <= amax)
    dims = [d for d in range(3) if d != axis]
    px, py = pts[:, dims[0]], pts[:, dims[1]]
    vx, vy = poly[:, dims[0]], poly[:, dims[1]]
    inside = np.zeros(len(pts), bool)
    j = len(poly) - 1
    for i in range(len(poly)):
        cond = ((vy[i] > py) != (vy[j] > py)) & (
            px < (vx[j] - vx[i]) * (py - vy[i]) / (vy[j] - vy[i] + 1e-30) + vx[i]
        )
        inside ^= cond
        j = i
    return pts[keep & inside]


def apply_T(pts, T):
    return pts @ T[:3, :3].T + T[:3, 3]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset-dir", required=True,
                    help="dir with {scene}.ply (gt), {scene}.json (crop), "
                         "{scene}_COLMAP_SfM.log (gt-frame trajectory), "
                         "{scene}_trans.txt (gt trajectory alignment)")
    ap.add_argument("--traj-path", default="",
                    help="reconstruction trajectory (.log) for alignment")
    ap.add_argument("--ply-path", required=True, help="reconstructed mesh/points")
    ap.add_argument("--out-dir", default="")
    ns = ap.parse_args(argv)

    scene = os.path.basename(ns.dataset_dir.rstrip("/"))
    tau = SCENE_TAU.get(scene, 0.01)
    pred, faces = load_points(ns.ply_path)
    if faces is not None and len(faces):
        pred = geo.sample_mesh_surface(pred, faces, density=tau / 2, max_points=5_000_000)
    gt, _ = load_points(os.path.join(ns.dataset_dir, f"{scene}.ply"))

    report = {"scene": scene, "tau": tau}
    trans_path = os.path.join(ns.dataset_dir, f"{scene}_trans.txt")
    gt_trans = np.loadtxt(trans_path).reshape(4, 4) if os.path.exists(trans_path) else None

    gt_log = os.path.join(ns.dataset_dir, f"{scene}_COLMAP_SfM.log")
    if ns.traj_path and os.path.exists(gt_log):
        # reference path: align the reconstruction's trajectory to the
        # gt_trans-transformed GT SfM trajectory (run.py:110-130)
        traj_pred = read_trajectory_log(ns.traj_path)
        traj_gt = read_trajectory_log(gt_log)
        gt_centers = traj_gt[:, :3, 3]
        if gt_trans is not None:
            gt_centers = apply_T(gt_centers, gt_trans)
        T0, align_info = trajectory_alignment(traj_pred[:, :3, 3], gt_centers)
        report["trajectory_alignment"] = align_info
        pred = apply_T(pred, T0)
    elif gt_trans is not None:
        # legacy: a precomputed reconstruction->gt transform
        pred = apply_T(pred, gt_trans)
        report["trajectory_alignment"] = {"mode": "precomputed _trans.txt"}
    else:
        report["trajectory_alignment"] = {"mode": "none (identity init)"}

    crop_path = os.path.join(ns.dataset_dir, f"{scene}.json")
    crop = load_crop_volume(crop_path) if os.path.exists(crop_path) else None

    def cropped(p):
        return crop_points(p, *crop) if crop is not None else p

    # staged ICP refinement on crop-filtered clouds (run.py:155-161:
    # dTau*80 -> dTau*20 -> 2*dTau), with convergence reporting
    gt_c = cropped(gt)
    stages = []
    for thr, iters in ((tau * 80, 20), (tau * 20, 20), (tau * 2, 20)):
        pred_c = cropped(pred)
        if len(pred_c) < 100 or len(gt_c) < 100:
            stages.append({"threshold": thr, "status": "skipped (too few points)"})
            continue
        T, err = geo.icp_point_to_point(pred_c, gt_c, max_iters=iters,
                                        threshold=thr, return_error=True)
        pred = apply_T(pred, T)
        stages.append({"threshold": thr, "rmse": err["rmse"],
                       "inlier_frac": err["inlier_frac"], "iters": err["iters"]})
    report["icp_stages"] = stages
    if stages and isinstance(stages[-1], dict) and "inlier_frac" in stages[-1]:
        report["icp_converged"] = stages[-1]["inlier_frac"] > 0.1
        if not report["icp_converged"]:
            print(f"WARNING: ICP likely diverged (final inlier fraction "
                  f"{stages[-1]['inlier_frac']:.3f} at threshold {stages[-1]['threshold']})")

    pred_c = cropped(pred)
    res = geo.precision_recall_fscore(pred_c, gt_c, tau)
    res.update(report)
    out = ns.out_dir or os.path.dirname(ns.ply_path)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "tnt_results.json"), "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
