"""gof_tpu_torch.scripts.make_procedural_scene and eval_procedural_geometry
against the original scripts (scripts/make_procedural_scene.py,
scripts/eval_procedural_geometry.py), run in this process.

The scene writer must give byte-equal files at a small size; the scorer
the same geometry_vs_gt.json on the same meshes (the same numpy code)."""

import filecmp
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from gof_tpu_torch.scripts import eval_procedural_geometry as teval
from gof_tpu_torch.scripts import make_procedural_scene as tmps
from gof_tpu_torch.utils import ply

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def original(name, monkeypatch):
    """Import scripts/<name>.py as the original runs it (scripts/ on the
    path, for its `import _path`)."""
    monkeypatch.syspath_prepend(SCRIPTS)
    spec = importlib.util.spec_from_file_location(f"orig_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    return mod.main()


SMALL = ["--width", "64", "--height", "48", "--views", "3", "--test-views", "2",
         "--points", "500"]


@pytest.mark.parametrize("knobs", [[], ["--tex-freq", "2.5", "--octaves", "4", "--specular",
                                        "0.6"]], ids=["default", "knobs"])
def test_scene_writer_byte_equal(tmp_path, monkeypatch, knobs):
    orig = original("make_procedural_scene", monkeypatch)
    run_main(orig, ["--out", str(tmp_path / "orig")] + SMALL + knobs, monkeypatch)
    res = tmps.main(["--out", str(tmp_path / "port")] + SMALL + knobs)
    names = sorted(os.listdir(tmp_path / "orig"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert {"gt_mesh.ply", "points3d.ply", "transforms_train.json", "r_2.png",
            "t_1.png"} <= set(names)
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "orig", tmp_path / "port", names,
                                               shallow=False)
    assert mismatch == [] and errors == [] and len(match) == len(names)
    assert res["train_views"] == 3 and res["test_views"] == 2 and res["points"] == 496


def test_scene_defaults_match():
    """The port's defaults are the original's (1237x822, 36 + 6 views, 40k
    points, the seeds of the ring and the points)."""
    import inspect

    src = open(os.path.join(SCRIPTS, "make_procedural_scene.py")).read()
    for flag in ('"--width", type=int, default=1237', '"--height", type=int, default=822',
                 '"--views", type=int, default=36', '"--test-views", type=int, default=6',
                 '"--points", type=int, default=40_000', "camera_ring(args.views, seed=0)",
                 "radius=4.3, seed=7", "np.random.default_rng(3)"):
        assert flag in src and flag in inspect.getsource(tmps), flag


@pytest.fixture(scope="module")
def scored_model(tmp_path_factory):
    """A model dir whose test/ours_5 holds a marching-tets and a TSDF mesh:
    the scene's gt mesh shifted by 0.01 and by 0.03, with 200 stray
    vertices outside the gt bounding box."""
    root = tmp_path_factory.mktemp("proc_eval")
    scene = str(root / "scene")
    os.makedirs(scene)
    gv, gf = tmps.gt_mesh()
    ply.write_ply(os.path.join(scene, "gt_mesh.ply"), {
        "x": gv[:, 0].astype(np.float32), "y": gv[:, 1].astype(np.float32),
        "z": gv[:, 2].astype(np.float32)}, faces=gf)
    rng = np.random.default_rng(0)
    model = str(root / "model")
    for sub, name, shift in (("fusion", "mesh_binary_search_7.ply", 0.01),
                             ("tsdf", "tsdf.ply", 0.03)):
        d = os.path.join(model, "test", "ours_5", sub)
        os.makedirs(d)
        v = np.concatenate([gv + shift, rng.uniform(8, 9, (200, 3))]).astype(np.float32)
        ply.write_ply(os.path.join(d, name), {"x": v[:, 0], "y": v[:, 1], "z": v[:, 2]},
                      faces=gf)
    return model, scene


def test_geometry_scores_equal(scored_model, monkeypatch):
    model, scene = scored_model
    argv = ["-m", model, "-s", scene, "--iteration", "5", "--density", "0.05"]
    got = teval.main(argv)
    on_disk = json.load(open(os.path.join(model, "geometry_vs_gt.json")))
    orig = original("eval_procedural_geometry", monkeypatch)
    run_main(orig, argv, monkeypatch)
    want = json.load(open(os.path.join(model, "geometry_vs_gt.json")))
    assert on_disk == want
    assert json.loads(json.dumps(got)) == want
    assert set(want) == {"marching_tets", "tsdf"}
    # the crop drops the strays; the smaller shift scores better
    assert got["marching_tets"]["cropped_samples"] < got["marching_tets"]["pred_samples"]
    assert got["marching_tets"]["fscore"] > got["tsdf"]["fscore"]
    assert got["marching_tets"]["chamfer_mean_d2s"] < got["tsdf"]["chamfer_mean_d2s"] < 0.05


def test_visible_mask_uses_the_ring(monkeypatch):
    """The camera-visible gt samples come from the port's own tracer; the
    sphere's underside (hidden from the ring above the plane) is not
    visible, its top is."""
    top = np.array([[0.0, -0.2 + 0.8, 0.0]])
    bottom = np.array([[0.0, -0.2 - 0.8 + 1e-3, 0.0]])
    vis = teval.visible_mask(np.concatenate([top, bottom]))
    orig = original("eval_procedural_geometry", monkeypatch)
    np.testing.assert_array_equal(vis, orig.visible_mask(np.concatenate([top, bottom])))
    assert vis.tolist() == [True, False]
