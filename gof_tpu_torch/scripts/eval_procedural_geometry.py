"""Score extracted meshes against the procedural scene's ANALYTIC ground
truth (gt_mesh.ply from gof_tpu_torch.scripts.make_procedural_scene):
DTU-style chamfer + TNT F-score on both the marching-tets and TSDF meshes
(counterpart of scripts/eval_procedural_geometry.py, the same
geometry_vs_gt.json).

The GT surface is exact by construction, so this is an end-to-end geometry
accuracy proof that needs no downloaded data.

Usage: python -m gof_tpu_torch.scripts.eval_procedural_geometry -m <model_dir>
       -s <scene_dir> [--iteration 30000] [--tau 0.02]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from gof_tpu_torch.eval import geometry as geo
from gof_tpu_torch.utils import ply


def load_mesh_points(path, density):
    verts_d, faces = ply.read_ply(path)
    verts = np.stack([verts_d["x"], verts_d["y"], verts_d["z"]], -1).astype(np.float64)
    if faces is not None and len(faces):
        return geo.sample_mesh_surface(verts, faces, density=density,
                                       max_points=2_000_000)
    return verts


def score(pred_pts, gt_pts, tau):
    res = geo.precision_recall_fscore(pred_pts, gt_pts, tau)
    ch = geo.chamfer_dtu(pred_pts, gt_pts, max_dist=1.0)
    res.update({f"chamfer_{k}": v for k, v in ch.items()})
    return res


def visible_mask(gt_pts, ncams=12):
    """Keep GT samples visible from >= 1 train-ring camera, computed with the
    scene's own analytic ray tracer: the analog of DTU's ObsMask
    (dtu_eval/eval.py:95-122) — unobserved regions (sphere/box undersides,
    occluded faces) are excluded from recall there too."""
    from gof_tpu_torch.scripts import make_procedural_scene as mps

    vis = np.zeros(len(gt_pts), bool)
    eyes = mps.camera_ring(36, seed=0)
    for eye in eyes[:: max(1, len(eyes) // ncams)]:
        todo = ~vis
        if not todo.any():
            break
        d = gt_pts[todo] - eye
        dist = np.linalg.norm(d, axis=-1)
        t, _ = mps.trace(eye.astype(np.float64), d / dist[:, None])
        vis[np.nonzero(todo)[0][t >= dist - 1e-3]] = True
    return vis


def crop_to_gt(pred_pts, gt_pts, margin):
    """Keep predicted points inside the GT bounding box (+margin): the
    analog of the TNT crop polygon (eval_tnt/run.py crop_volume) and DTU
    ObsMask (dtu_eval/eval.py:95-122) — both reference protocols score only
    the observed/cropped region, so raw level-set envelopes and out-of-view
    floaters are excluded there too."""
    lo = gt_pts.min(0) - margin
    hi = gt_pts.max(0) + margin
    keep = np.all((pred_pts >= lo) & (pred_pts <= hi), axis=1)
    return pred_pts[keep]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("-s", "--scene_path", required=True)
    ap.add_argument("--iteration", type=int, default=30_000)
    ap.add_argument("--tau", type=float, default=0.02,
                    help="F-score threshold in scene units")
    ap.add_argument("--density", type=float, default=0.01,
                    help="surface sampling density (points per density^2)")
    ap.add_argument("--crop_margin", type=float, default=0.1,
                    help="GT-bbox crop margin for the protocol-style score")
    ns = ap.parse_args(argv)

    gt_pts = load_mesh_points(os.path.join(ns.scene_path, "gt_mesh.ply"),
                              ns.density)
    vis = visible_mask(gt_pts)
    gt_vis = gt_pts[vis]
    print(f"gt surface samples: {len(gt_pts)} ({len(gt_vis)} camera-visible)")

    out = {}
    base = os.path.join(ns.model_path, "test", f"ours_{ns.iteration}")
    candidates = {
        "marching_tets": os.path.join(base, "fusion", "mesh_binary_search_7.ply"),
        "tsdf": os.path.join(base, "tsdf", "tsdf.ply"),
    }
    for name, path in candidates.items():
        if not os.path.exists(path):
            # accept any available binary-search depth
            alt_dir = os.path.dirname(path)
            if os.path.isdir(alt_dir):
                cands = sorted(f for f in os.listdir(alt_dir)
                               if f.startswith("mesh_binary_search"))
                if cands:
                    path = os.path.join(alt_dir, cands[-1])
        if not os.path.exists(path):
            print(f"{name}: missing ({path})")
            continue
        pred = load_mesh_points(path, ns.density)
        cropped = crop_to_gt(pred, gt_pts, ns.crop_margin)
        res = score(cropped, gt_vis, ns.tau)
        raw = score(pred, gt_pts, ns.tau)
        res.update({f"raw_{k}": v for k, v in raw.items()})
        res["mesh"] = os.path.relpath(path, ns.model_path)
        res["pred_samples"] = int(len(pred))
        res["cropped_samples"] = int(len(cropped))
        out[name] = res
        print(f"{name}: fscore@{ns.tau}={res['fscore']:.3f} "
              f"precision={res['precision']:.3f} recall={res['recall']:.3f} "
              f"chamfer={res['chamfer_overall']:.4f} "
              f"(raw fscore={raw['fscore']:.3f} chamfer={raw['chamfer_overall']:.4f})")

    dst = os.path.join(ns.model_path, "geometry_vs_gt.json")
    with open(dst, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {dst}")
    return out


if __name__ == "__main__":
    main()
