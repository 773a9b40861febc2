"""Geometry evaluation primitives: mesh sampling, chamfer, F-score, ICP
(counterpart of gof_tpu/eval/geometry.py, a copy: numpy and scipy only).

Replaces the cores of dtu_eval/eval.py (bidirectional chamfer with outlier
rejection and mesh surface sampling at a target density) and
eval_tnt/evaluation.py (precision / recall / F-score at a per-scene tau,
after trajectory alignment + ICP refinement). Open3D is not available here;
everything is numpy + scipy cKDTree.
"""

from __future__ import annotations

import numpy as np


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray, density: float = 0.2,
                        max_points: int = 10_000_000, rng=None) -> np.ndarray:
    """Uniform surface samples at ~1 point per `density`^2 area units plus the
    vertices themselves (mirroring dtu_eval/eval.py:36-76's downsampled union)."""
    rng = rng or np.random.default_rng(0)
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    n_per_face = np.minimum((area / (density**2)).astype(np.int64) + 1, 10_000)
    total = int(min(n_per_face.sum(), max_points))
    probs = area / max(area.sum(), 1e-12)
    face_idx = rng.choice(len(faces), size=total, p=probs)
    u = rng.random((total, 1))
    v = rng.random((total, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    pts = v0[face_idx] + u * (v1[face_idx] - v0[face_idx]) + v * (v2[face_idx] - v0[face_idx])
    return np.concatenate([pts, verts], axis=0).astype(np.float64)


def reduce_pcd(pts: np.ndarray, voxel: float) -> np.ndarray:
    """Keep one point per voxel (the reference's reduce_pts, dtu_eval)."""
    q = np.floor(pts / voxel).astype(np.int64)
    _, keep = np.unique(q, axis=0, return_index=True)
    return pts[np.sort(keep)]


def nn_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    from scipy.spatial import cKDTree

    tree = cKDTree(dst)
    d, _ = tree.query(src, k=1, workers=-1)
    return d


def chamfer_dtu(data_pts: np.ndarray, gt_pts: np.ndarray, max_dist: float = 20.0):
    """DTU-style chamfer: mean of point-to-point NN distances, discarding
    distances > max_dist (dtu_eval/eval.py:37-39,146-160)."""
    d2s = nn_distances(data_pts, gt_pts)
    s2d = nn_distances(gt_pts, data_pts)
    d2s = d2s[d2s < max_dist]
    s2d = s2d[s2d < max_dist]
    mean_d2s = float(d2s.mean()) if len(d2s) else float("inf")
    mean_s2d = float(s2d.mean()) if len(s2d) else float("inf")
    return {"mean_d2s": mean_d2s, "mean_s2d": mean_s2d,
            "overall": (mean_d2s + mean_s2d) / 2.0}


def precision_recall_fscore(pred: np.ndarray, gt: np.ndarray, tau: float):
    """TNT-style P/R/F1 at threshold tau (eval_tnt/evaluation.py:144-165)."""
    d_p2g = nn_distances(pred, gt)
    d_g2p = nn_distances(gt, pred)
    precision = float((d_p2g < tau).mean())
    recall = float((d_g2p < tau).mean())
    f = 2 * precision * recall / max(precision + recall, 1e-12)
    return {"precision": precision, "recall": recall, "fscore": f, "tau": tau}


def best_fit_transform(A: np.ndarray, B: np.ndarray, rigid: bool = False):
    """Similarity transform (R, t, s) minimizing ||s R A + t - B|| (Umeyama;
    evaluate_dtu_mesh.py:15-56 uses the rigid special case).

    rigid=True fixes s = 1 and returns t consistent with applying R alone —
    using the similarity fit's t while dropping its s biases every point by
    (1 - s) R @ centroid(A)."""
    ca = A.mean(axis=0)
    cb = B.mean(axis=0)
    A0 = A - ca
    B0 = B - cb
    H = A0.T @ B0
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    if rigid:
        s = 1.0
    else:
        var = (A0**2).sum()
        s = float(np.trace(np.diag(S) @ D) / max(var, 1e-12))
    t = cb - s * R @ ca
    return R, t, s


def icp_point_to_point(src: np.ndarray, dst: np.ndarray, max_iters: int = 30,
                       threshold: float | None = None, sample: int = 100_000,
                       rng=None, return_error: bool = False):
    """Rigid point-to-point ICP (the reference refines the TNT alignment with
    o3d registration_icp, eval_tnt/registration.py). Returns a 4x4 transform
    (and, with return_error, {"rmse", "inlier_frac", "iters"} over the final
    correspondences — the analog of o3d's RegistrationResult)."""
    rng = rng or np.random.default_rng(0)
    from scipy.spatial import cKDTree

    if len(src) > sample:
        src_s = src[rng.choice(len(src), sample, replace=False)]
    else:
        src_s = src
    tree = cKDTree(dst)
    T = np.eye(4)
    cur = src_s.copy()
    prev_err = np.inf
    d = np.full(len(cur), np.inf)
    keep = np.zeros(len(cur), bool)
    it = 0
    for it in range(1, max_iters + 1):
        d, idx = tree.query(cur, k=1, workers=-1)
        if threshold is not None:
            keep = d < threshold
            if keep.sum() < 100:
                break
        else:
            keep = np.ones(len(d), bool)
        R, t, _s = best_fit_transform(cur[keep], dst[idx[keep]], rigid=True)
        cur = cur @ R.T + t
        Ti = np.eye(4)
        Ti[:3, :3] = R
        Ti[:3, 3] = t
        T = Ti @ T
        err = float(d[keep].mean())
        if abs(prev_err - err) < 1e-7:
            break
        prev_err = err
    if return_error:
        inl = keep if threshold is not None else d < np.inf
        rmse = float(np.sqrt((d[inl] ** 2).mean())) if inl.any() else float("inf")
        return T, {"rmse": rmse, "inlier_frac": float(inl.mean()), "iters": it}
    return T
