"""gof_tpu_torch's evaluation modules against gof_tpu's: eval/{geometry,
dtu,tnt}.py (copies in the port: numpy and scipy), metrics.py, utils/lpips.py
and create_fused_ply.py.

The geometry tests are ports of tests/test_eval_geometry.py on the port's
modules, each also run through gof_tpu's function on the same inputs and
required to give the same result (the same numpy code: exactly). Metrics:
PSNR and SSIM within rtol 1e-5, LPIPS within 1e-4 relative (the bound of
tests/test_lpips.py). The fused PLY: the same properties in the same order,
values within rtol 1e-6 (exp and sqrt may round one ulp apart).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from gof_tpu import cameras as jcam
from gof_tpu import create_fused_ply as jfused
from gof_tpu import metrics as jmetrics
from gof_tpu.eval import dtu as jdtu
from gof_tpu.eval import geometry as jgeo
from gof_tpu.eval import tnt as jtnt
from gof_tpu.utils import lpips as jlpips
from gof_tpu_torch import cameras as tcam
from gof_tpu_torch import config as tconfig
from gof_tpu_torch import create_fused_ply as tfused
from gof_tpu_torch import metrics as tmetrics
from gof_tpu_torch.data import scene as tscene
from gof_tpu_torch.eval import dtu as tdtu
from gof_tpu_torch.eval import geometry as geo
from gof_tpu_torch.eval import tnt as ttnt
from gof_tpu_torch.mesh import extract as tex
from gof_tpu_torch.model import gaussians as tgm
from gof_tpu_torch.utils import lpips as tlpips
from gof_tpu_torch.utils import ply

from test_lpips import make_random_npz, torch_lpips

torch.set_num_threads(2)


def sphere_points(n, r, rng, center=(0, 0, 0)):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * r + np.asarray(center)


def both(name, *args, module=(geo, jgeo), **kw):
    """Call `name` in the port's module and in gof_tpu's on the same inputs
    and require equal results; return the port's."""
    got = getattr(module[0], name)(*args, **kw)
    want = getattr(module[1], name)(*args, **kw)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if isinstance(a, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    return got


class TestGeometryEval:
    def test_chamfer_identical(self, rng):
        p = sphere_points(2000, 1.0, rng)
        res = both("chamfer_dtu", p, p.copy())
        assert res["overall"] < 1e-9

    def test_chamfer_scales_with_offset(self, rng):
        gt = sphere_points(3000, 1.0, rng)
        res = both("chamfer_dtu", gt + np.array([0.1, 0, 0]), gt)
        assert 0.01 < res["overall"] < 0.12

    def test_fscore(self, rng):
        gt = sphere_points(3000, 1.0, rng)
        res = both("precision_recall_fscore", gt + 0.001, gt, tau=0.01)
        assert res["fscore"] > 0.95
        res2 = both("precision_recall_fscore", gt + 0.05, gt, tau=0.01)
        assert res2["fscore"] < res["fscore"]

    def test_best_fit_transform(self, rng):
        A = rng.normal(size=(500, 3))
        Rtrue, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(Rtrue) < 0:
            Rtrue[:, 0] *= -1
        B = 1.7 * A @ Rtrue.T + np.array([1, 2, 3])
        R, t, s = both("best_fit_transform", A, B)
        np.testing.assert_allclose(R, Rtrue, atol=1e-8)
        assert abs(s - 1.7) < 1e-8
        np.testing.assert_allclose(s * A @ R.T + t, B, atol=1e-8)
        R1, t1, s1 = both("best_fit_transform", A, B, rigid=True)
        assert s1 == 1.0

    def test_icp_recovers_small_offset(self, rng):
        gt = sphere_points(5000, 1.0, rng)
        Rz = np.array([[np.cos(0.05), -np.sin(0.05), 0],
                       [np.sin(0.05), np.cos(0.05), 0], [0, 0, 1]])
        pred = gt @ Rz.T + np.array([0.02, -0.01, 0.03])
        T = both("icp_point_to_point", pred, gt, threshold=0.5)
        aligned = pred @ T[:3, :3].T + T[:3, 3]
        assert geo.nn_distances(aligned, gt).mean() < 0.01

    def test_sample_mesh_surface(self):
        verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], float)
        faces = np.array([[0, 1, 2], [0, 2, 3]])
        pts = geo.sample_mesh_surface(verts, faces, density=0.05, rng=np.random.default_rng(0))
        want = jgeo.sample_mesh_surface(verts, faces, density=0.05, rng=np.random.default_rng(0))
        np.testing.assert_array_equal(pts, want)
        assert len(pts) > 300
        assert pts[:, 2].max() == 0
        assert pts[:, 0].min() >= 0 and pts[:, 0].max() <= 1

    def test_reduce_pcd(self, rng):
        red = both("reduce_pcd", rng.random((5000, 3)), 0.2)
        assert 50 < len(red) <= 6**3


class TestTrajectoryAlignment:
    def _make_traj(self, rng, n=60):
        poses = np.tile(np.eye(4), (n, 1, 1))
        poses[:, :3, 3] = rng.normal(size=(n, 3)) * 3.0
        return poses

    def test_log_roundtrip(self, rng, tmp_path):
        poses = self._make_traj(rng, 12)
        p = tmp_path / "traj.log"
        with open(p, "w") as f:
            for i, m in enumerate(poses):
                f.write(f"{i} {i} 0\n")
                for row in m:
                    f.write(" ".join(str(v) for v in row) + "\n")
        got = both("read_trajectory_log", str(p), module=(ttnt, jtnt))
        np.testing.assert_allclose(got, poses, atol=1e-12)

    def test_recovers_known_similarity(self, rng):
        pred = rng.normal(size=(80, 3)) * 2.0
        Rtrue, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(Rtrue) < 0:
            Rtrue[:, 0] *= -1
        strue, ttrue = 2.3, np.array([0.5, -1.0, 2.0])
        gt = strue * pred @ Rtrue.T + ttrue
        T, info = both("trajectory_alignment", pred, gt, module=(ttnt, jtnt))
        np.testing.assert_allclose(T[:3, :3], strue * Rtrue, atol=1e-6)
        np.testing.assert_allclose(T[:3, 3], ttrue, atol=1e-6)
        assert info["inliers"] == 80

    def test_robust_to_outliers(self, rng):
        pred = rng.normal(size=(100, 3)) * 2.0
        gt = 1.5 * pred + np.array([1.0, 0.0, 0.0])
        gt[::10] += rng.normal(size=(10, 3)) * 5.0  # 10% corrupted poses
        T, info = both("trajectory_alignment", pred, gt, module=(ttnt, jtnt))
        np.testing.assert_allclose(T[:3, :3], 1.5 * np.eye(3), atol=1e-3)
        assert info["inliers"] >= 85

    def test_icp_reports_convergence(self, rng):
        gt = sphere_points(3000, 1.0, rng)
        T, err = both("icp_point_to_point", gt + np.array([0.02, 0.0, 0.0]), gt, threshold=0.5,
                      return_error=True)
        assert err["inlier_frac"] > 0.99 and err["rmse"] < 0.02 and err["iters"] >= 1

    def test_tnt_main_matches(self, rng, tmp_path):
        """python -m gof_tpu_torch.eval.tnt on a synthetic dataset dir (gt
        cloud, crop volume, no trajectory): the same tnt_results.json."""
        data = tmp_path / "Barn"
        data.mkdir()
        gt = sphere_points(4000, 1.0, rng)
        pred = gt + np.array([0.004, 0.0, 0.0])
        for path, pts in ((data / "Barn.ply", gt), (tmp_path / "pred.ply", pred)):
            ply.write_ply(str(path), {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]})
        with open(data / "Barn.json", "w") as f:
            json.dump({"bounding_polygon": [[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]],
                       "orthogonal_axis": "Y", "axis_min": -0.5, "axis_max": 2.0}, f)
        res = []
        for lib, out in ((ttnt, "port"), (jtnt, "gof")):
            lib.main(["--dataset-dir", str(data), "--ply-path", str(tmp_path / "pred.ply"),
                      "--out-dir", str(tmp_path / out)])
            res.append(json.load(open(tmp_path / out / "tnt_results.json")))
        assert res[0] == res[1]
        assert res[0]["tau"] == 0.01 and res[0]["fscore"] > 0.9


class TestDtuProtocol:
    def test_alignment_scale_normalization(self, rng):
        pred = rng.normal(size=(49, 3))
        Rtrue, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(Rtrue) < 0:
            Rtrue[:, 0] *= -1
        gt = 7.0 * pred @ Rtrue.T + np.array([10.0, -3.0, 5.0])
        scale, R, t = both("dtu_alignment", pred, gt, module=(tdtu, jdtu))
        np.testing.assert_allclose((pred * scale) @ R.T + t, gt, atol=1e-6)

    def test_cull_mesh_all_views_semantics(self):
        """evaluate_dtu_mesh.py:118-127: keep a vertex iff EVERY view sees it
        in the dilated mask or not at all; with the port's camera."""
        kw = dict(eye=(0, 0, 0), target=(0, 0, 5.0), width=64, height=64)
        verts = np.array([[0, 0, 5.0], [-1.5, 0, 5.0], [100.0, 0, 5.0]])
        mask = np.zeros((64, 64), np.float32)
        mask[20:44, 20:44] = 1.0
        faces = np.array([[0, 1, 2]])
        keep_v, faces_k = tdtu.cull_mesh_by_masks(verts, faces, [tcam.look_at_camera(**kw)],
                                                  [mask], dilate_px=2)
        want_v, want_f = jdtu.cull_mesh_by_masks(verts, faces, [jcam.look_at_camera(**kw)],
                                                 [mask], dilate_px=2)
        np.testing.assert_array_equal(keep_v, want_v)
        np.testing.assert_array_equal(faces_k, want_f)
        assert keep_v.tolist() == [True, False, True] and len(faces_k) == 0

    def test_cull_without_mask_keeps_all(self):
        cam = tcam.look_at_camera(eye=(0, 0, 0), target=(0, 0, 5.0), width=64, height=64)
        verts = np.array([[0, 0, 5.0], [0.5, 0.2, 4.0], [100.0, 0, 5.0]])
        keep_v, _ = tdtu.cull_mesh_by_masks(verts, None, [cam], [None])
        assert keep_v.all()

    def test_model_protocol_matches(self, tmp_path):
        """evaluate_model (cull, align to the calibration, chamfer against
        the scan under the ObsMask and plane) on a trained-model layout and a
        synthetic DTU eval dir: the port's results.json equals gof_tpu's."""
        rng = np.random.default_rng(3)
        src, model, dtu_dir = tmp_path / "scene", tmp_path / "model", tmp_path / "dtu"
        (src / "images").mkdir(parents=True)
        cams, frames = [], []
        for i, a in enumerate(np.linspace(0, 2 * np.pi, 6, endpoint=False)):
            cam = tcam.look_at_camera(eye=(3 * np.sin(a), 1.0, 3 * np.cos(a)), target=(0, 0, 0),
                                      width=48, height=48)
            cams.append(cam)
            c2w = np.linalg.inv(cam.world_view.numpy().astype(np.float64))
            c2w[:3, 1:3] *= -1
            rgba = np.zeros((48, 48, 4), np.uint8)
            rgba[8:40, 8:40] = 255
            Image.fromarray(rgba, "RGBA").save(src / "images" / f"rect_{i + 1:03d}.png")
            frames.append({"file_path": f"images/rect_{i + 1:03d}",
                           "transform_matrix": c2w.tolist()})
        for split in ("train", "test"):
            with open(src / f"transforms_{split}.json", "w") as f:
                json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
        tconfig.save_cfg(str(model), tconfig.ModelParams(source_path=str(src),
                                                         model_path=str(model)),
                         tconfig.PipelineParams(), tconfig.OptimizationParams())
        verts = sphere_points(600, 0.6, rng)
        faces = rng.integers(0, 600, (800, 3))
        mesh_dir = model / "test" / "ours_7" / "tsdf"
        mesh_dir.mkdir(parents=True)
        ply.write_ply(str(mesh_dir / "tsdf.ply"), {"x": verts[:, 0], "y": verts[:, 1],
                                                   "z": verts[:, 2]}, faces=faces)
        (dtu_dir / "Calibration" / "cal18").mkdir(parents=True)
        (dtu_dir / "ObsMask").mkdir()
        (dtu_dir / "Points" / "stl").mkdir(parents=True)
        for i in range(64):
            cam = cams[i % 6]
            K = np.array([[float(cam.focal_x), 0, 24], [0, float(cam.focal_y), 24], [0, 0, 1]])
            P = K @ cam.world_view.numpy().astype(np.float64)[:3] * 100.0
            np.savetxt(dtu_dir / "Calibration" / "cal18" / f"pos_{i + 1:03d}.txt", P)
        from scipy.io import savemat

        stl = sphere_points(3000, 60.0, rng)
        ply.write_ply(str(dtu_dir / "Points" / "stl" / "stl024_total.ply"),
                      {"x": stl[:, 0], "y": stl[:, 1], "z": stl[:, 2]})
        savemat(dtu_dir / "ObsMask" / "ObsMask24_10.mat",
                {"ObsMask": np.ones((30, 30, 30), np.uint8),
                 "BB": np.array([[-150.0, -150, -150], [150, 150, 150]]), "Res": 10.0})
        savemat(dtu_dir / "ObsMask" / "Plane24.mat", {"P": np.array([0.0, 1.0, 0.0, 80.0])})
        res = []
        for lib, out in ((tdtu, "port"), (jdtu, "gof")):
            lib.main(["--model_path", str(model), "--iteration", "7", "--scan_id", "24",
                      "--DTU", str(dtu_dir), "--output_dir", str(tmp_path / out)])
            res.append(json.load(open(tmp_path / out / "results.json")))
        assert res[0] == res[1]
        assert np.isfinite(res[0]["overall"])


class TestAnalyticGTChain:
    """tests/test_eval_geometry.py::TestAnalyticGTChain with the port's
    level-set extractor: a Fibonacci shell of gaussians, extracted on the
    CPU, scored against the exact sphere by both packages' F-score and DTU
    chamfer cores, with a negative control."""

    def test_full_chain_fscore_and_chamfer(self, rng, tmp_path):
        r, n = 0.8, 220
        i = np.arange(n) + 0.5
        phi = np.arccos(1 - 2 * i / n)
        th = np.pi * (1 + 5**0.5) * i
        centers = np.stack([np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th),
                            np.cos(phi)], -1).astype(np.float32) * r
        op = np.float32(0.95)
        params = dict(xyz=centers,
                      features_dc=np.full((n, 1, 3), (0.6 - 0.5) / 0.28209479177387814,
                                          np.float32),
                      features_rest=np.zeros((n, 0, 3), np.float32),
                      scaling=np.log(np.full((n, 3), 0.12, np.float32)),
                      rotation=np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1)),
                      opacity=np.full((n,), np.log(op / (1 - op)), np.float32))
        z = np.zeros((n,), np.float32)
        state = dict(active=np.ones((n,), bool), filter_3d=z + 1e-4, max_radii2d=z,
                     grad_accum=z, grad_abs_accum=z, denom=z)
        from gof_tpu.model import gaussians as jgm

        tp, ts = tgm.from_numpy(jgm.GaussianParams(**params), jgm.GaussianState(**state))
        cams = [tcam.look_at_camera(eye=(3.2 * np.sin(t), 1.2 * np.sin(2 * t), 3.2 * np.cos(t)),
                                    target=(0, 0, 0), width=64, height=64, uid=k)
                for k, t in enumerate(np.linspace(0, 2 * np.pi, 8, endpoint=False))]
        meta = (torch.stack([c.world_view for c in cams]), torch.stack([c.focal_x for c in cams]),
                torch.stack([c.focal_y for c in cams]), torch.full((8,), 64.0),
                torch.full((8,), 64.0))
        out = tex.extract_level_set_mesh(tp, ts, cams, meta, str(tmp_path / "fusion"),
                                         sh_degree=0, kernel_size=0.1, n_binary_steps=5,
                                         quiet=True)
        verts_d, faces = ply.read_ply(out["path"])
        verts = np.stack([verts_d["x"], verts_d["y"], verts_d["z"]], -1).astype(np.float64)
        assert len(verts) > 100
        sigma = 0.12
        rad = np.linalg.norm(verts, axis=1)
        assert r < np.median(rad) < r + 2 * sigma, np.median(rad)
        assert np.std(rad) < 0.05

        gt = sphere_points(20000, r, rng)
        pred_pts = geo.sample_mesh_surface(verts, faces, density=0.02, max_points=100_000)
        tau = 0.25
        res = both("precision_recall_fscore", pred_pts, gt, tau)
        assert res["fscore"] > 0.95, res
        bb = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]])
        dims = np.ceil((bb[1] - bb[0]) / 0.05).astype(int) + 1
        obs = np.ones(tuple(dims), np.uint8)
        ch = both("dtu_chamfer", pred_pts, gt, obs, bb, 0.05, plane=None, module=(tdtu, jdtu))
        assert ch["overall"] < 2 * sigma, ch
        res_bad = geo.precision_recall_fscore(pred_pts + 0.6, gt, tau)
        assert res_bad["fscore"] < res["fscore"] * 0.5
        ch_bad = tdtu.dtu_chamfer(pred_pts + 0.6, gt, obs, bb, 0.05, plane=None)
        assert ch_bad["overall"] > ch["overall"] * 2


# ---------------------------------------------------------------------------
# metrics, LPIPS, the fused PLY
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def render_dir(tmp_path_factory):
    """A tiny {model}/test/ours_3 of three 40x53 render/gt pairs."""
    model = tmp_path_factory.mktemp("metrics")
    base = model / "test" / "ours_3"
    rng = np.random.default_rng(0)
    for sub in ("renders", "gt"):
        (base / sub).mkdir(parents=True)
    for k in range(3):
        gt = rng.uniform(0, 1, (40, 53, 3))
        ren = np.clip(gt + rng.normal(0, 0.05 * (k + 1), gt.shape), 0, 1)
        for sub, im in (("renders", ren), ("gt", gt)):
            Image.fromarray((im * 255).astype(np.uint8)).save(base / sub / f"{k:05d}.png")
    return str(model), str(base)


def test_lpips_matches_gof_tpu_with_random_weights(tmp_path):
    """tests/test_lpips.py:77's recipe: random weights in the torchvision
    .npz layout; the port's LPIPS equals gof_tpu's and the hand-written
    torch reference, and is ~0 for identical images."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "w.npz")
    data = make_random_npz(path, rng)
    img0 = rng.uniform(0, 1, (3, 32, 32)).astype(np.float32)
    img1 = np.clip(img0 + rng.normal(0, 0.1, img0.shape).astype(np.float32), 0, 1)
    fn = tlpips.lpips_fn(path)
    got = float(fn(torch.from_numpy(img0), torch.from_numpy(img1)))
    want = float(jlpips.lpips_fn(path)(img0, img1))
    ref = torch_lpips(data, torch.tensor(img0)[None], torch.tensor(img1)[None])
    assert abs(got - want) < 1e-4 * max(1.0, abs(want))
    assert abs(got - ref) < 1e-4 * max(1.0, abs(ref))
    assert abs(float(fn(img0, img0))) < 1e-6
    assert tlpips.lpips_fn("") is None and tlpips.lpips_fn(str(tmp_path / "none.npz")) is None


@pytest.mark.parametrize("weights", [False, True], ids=["no_lpips", "lpips"])
def test_evaluate_dir_matches_gof_tpu(render_dir, tmp_path, weights, monkeypatch):
    _, base = render_dir
    monkeypatch.delenv("GOF_LPIPS_WEIGHTS", raising=False)
    path = ""
    if weights:
        path = str(tmp_path / "w.npz")
        make_random_npz(path, np.random.default_rng(1))
    got = tmetrics.evaluate_dir(base, path)
    want = jmetrics.evaluate_dir(base, path)
    assert set(got) == set(want) and set(got["per_view"]) == set(want["per_view"])
    for name, pv in want["per_view"].items():
        for k in ("PSNR", "SSIM"):
            assert got["per_view"][name][k] == pytest.approx(pv[k], rel=1e-5)
    assert got["PSNR"] == pytest.approx(want["PSNR"], rel=1e-5)
    assert got["SSIM"] == pytest.approx(want["SSIM"], rel=1e-5)
    if weights:
        assert got["LPIPS"] == pytest.approx(want["LPIPS"], rel=1e-4)
        assert "LPIPS_reason" not in got
    else:
        assert got["LPIPS"] is None and got["LPIPS_reason"] == want["LPIPS_reason"]


def test_metrics_main_writes_gof_tpu_files(render_dir, tmp_path, monkeypatch):
    monkeypatch.delenv("GOF_LPIPS_WEIGHTS", raising=False)
    model, _ = render_dir
    copy = str(tmp_path / "gof")
    shutil.copytree(model, copy)
    tmetrics.main(["-m", model, "--cpu"])
    jmetrics.main(["-m", copy, "--cpu"])
    for name in ("results.json", "per_view.json"):
        got = json.load(open(os.path.join(model, name)))
        want = json.load(open(os.path.join(copy, name)))
        assert list(got) == list(want) == ["ours_3"]
        assert json.dumps(got, sort_keys=True).count("LPIPS") == json.dumps(
            want, sort_keys=True).count("LPIPS")
    res = json.load(open(os.path.join(model, "results.json")))["ours_3"]
    assert np.isfinite(res["PSNR"]) and res["LPIPS"] is None and "LPIPS_reason" in res


def test_metrics_requires_cuda_without_cpu_flag(render_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmetrics.main(["-m", render_dir[0]])


def test_create_fused_ply_matches_gof_tpu(tmp_path):
    rng = np.random.default_rng(4)
    n, cap = 30, 40
    from test_torch_train import model as random_model

    params, state = random_model(rng, cap, n, sh_degree=2)
    state = state._replace(filter_3d=rng.uniform(1e-3, 5e-2, cap).astype(np.float32))
    g, s = tgm.from_numpy(params, state)
    model = tmp_path / "port"
    tscene.save_gaussians_ply(str(model / "point_cloud" / "iteration_9" / "point_cloud.ply"),
                              g, s, 2)
    tconfig.save_cfg(str(model), tconfig.ModelParams(model_path=str(model), sh_degree=2),
                     tconfig.PipelineParams(), tconfig.OptimizationParams())
    shutil.copytree(model, tmp_path / "gof")
    out = tfused.main(["-m", str(model), "--cpu"])
    jfused.main(["-m", str(tmp_path / "gof"), "--cpu"])
    got, _ = ply.read_ply(out)
    want, _ = ply.read_ply(str(tmp_path / "gof" / "fused" / "point_cloud.ply"))
    assert list(got) == list(want) and len(got["x"]) == n
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
