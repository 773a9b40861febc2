"""The port's host-only tools against gof_tpu's: the viewer socket, the
mesh viewer, COLMAP conversion, the evaluation sweep, chunked host copies,
the native COLMAP reader and the two report scripts. No device work; every
comparison is exact unless stated.
"""

import importlib.util
import io
import json
import os
import socket
import struct
import sys
import threading
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from gof_tpu import convert as jconvert
from gof_tpu import mesh_viewer as jviewer
from gof_tpu import network_gui as jgui
from gof_tpu.utils import hostio as jhostio
from gof_tpu_torch import convert as tconvert
from gof_tpu_torch import full_eval
from gof_tpu_torch import mesh_viewer as tviewer
from gof_tpu_torch import native
from gof_tpu_torch import network_gui as tgui
from gof_tpu_torch.data import colmap as tcolmap
from gof_tpu_torch.scripts import run_benchmarks, show_results, summarize_run
from gof_tpu_torch.utils import hostio

from test_data import write_colmap_binary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name):
    """A module of the repo's scripts/ directory, loaded from its path."""
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# network_gui
# ---------------------------------------------------------------------------

REQUEST = {"width": 40, "height": 30, "fovx": 0.9, "fovy": 0.7, "scaling_modifier": 1.0,
           "world_view": [[1, 0, 0, 0.1], [0, 1, 0, -0.2], [0, 0, 1, 3.0], [0, 0, 0, 1]]}


def test_network_gui_round_trip():
    """A localhost client sends a request; the server reads it, builds the
    port's camera (equal to gof_tpu's), renders and replies with the RGB
    bytes gof_tpu's send would produce."""
    tgui.init("127.0.0.1", 0)
    port = tgui._listener.getsockname()[1]
    image = np.random.default_rng(0).uniform(-0.1, 1.1, (3, 30, 40)).astype(np.float32)
    reply = {}

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=10) as c:
            body = json.dumps(REQUEST).encode()
            c.sendall(struct.pack("<I", len(body)) + body)
            (n,) = struct.unpack("<I", tgui._read_exact(c, 4))
            reply["rgb"] = tgui._read_exact(c, n)

    th = threading.Thread(target=client)
    th.start()
    try:
        for _ in range(2000):
            if tgui.try_connect():
                break
            threading.Event().wait(0.005)
        req = tgui.receive()
        assert req == REQUEST
        cam = tgui.camera_from_request(req, device="cpu")
        tgui.send(torch.from_numpy(image).numpy())
        th.join(10)
    finally:
        tgui._listener.close()
        tgui._listener = tgui._conn = None
    want = jgui.camera_from_request(REQUEST)
    for k in ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy"):
        np.testing.assert_array_equal(getattr(cam, k).numpy(), np.asarray(getattr(want, k)), k)
    assert (cam.width, cam.height) == (want.width, want.height) == (40, 30)
    rgb = (np.clip(image, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
    assert reply["rgb"] == rgb.tobytes()


def test_network_gui_camera_defaults_to_the_card():
    """With no device given the camera is built on the card, and without
    one the call raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert tgui.camera_from_request(REQUEST).world_view.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tgui.camera_from_request(REQUEST)


def test_network_gui_receive_without_client():
    assert tgui.receive() is None and not tgui.try_connect()


# ---------------------------------------------------------------------------
# mesh_viewer
# ---------------------------------------------------------------------------


def test_mesh_viewer_render_frame_matches_gof_tpu():
    rng = np.random.default_rng(1)
    verts = rng.normal(size=(60, 3))
    faces = rng.integers(0, 60, (90, 3))
    eye, target = np.array([0.5, 0.8, 4.0]), np.zeros(3)
    got = tviewer.render_frame(verts, faces, eye, target, size=64)
    want = jviewer.render_frame(verts, faces, eye, target, size=64)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any()


def test_mesh_viewer_writes_frames(tmp_path):
    from gof_tpu_torch.utils import ply

    rng = np.random.default_rng(2)
    v = rng.normal(size=(20, 3)).astype(np.float32)
    path = str(tmp_path / "mesh.ply")
    ply.write_ply(path, {"x": v[:, 0], "y": v[:, 1], "z": v[:, 2]},
                  rng.integers(0, 20, (30, 3)).astype(np.int32))
    tviewer.main([path, "--frames", "2", "--size", "32"])
    assert sorted(os.listdir(tmp_path / "turntable")) == ["frame_000.png", "frame_001.png"]


# ---------------------------------------------------------------------------
# convert and full_eval
# ---------------------------------------------------------------------------


class Recorder:
    def __init__(self):
        self.cmds = []

    def __call__(self, cmd, *a, **k):
        self.cmds.append(list(cmd))
        return type("R", (), {"returncode": 0})()


@pytest.mark.parametrize("flags", [[], ["--no_gpu", "--camera", "PINHOLE"], ["--skip_matching"],
                                   ["--skip_matching", "--resize"]],
                         ids=["default", "no_gpu", "skip_matching", "resize"])
def test_convert_commands_match_gof_tpu(tmp_path, monkeypatch, flags):
    cmds = {}
    for name, mod in (("port", tconvert), ("gof", jconvert)):
        src = tmp_path / name
        (src / "sparse").mkdir(parents=True)
        rec = Recorder()
        monkeypatch.setattr(mod.subprocess, "run", rec)
        monkeypatch.setattr(mod.shutil, "which", lambda exe: "/bin/" + exe)
        mod.main(["-s", str(src), *flags])
        cmds[name] = [[a.replace(str(src), "<src>") for a in c] for c in rec.cmds]
    assert cmds["port"] == cmds["gof"]
    assert len(cmds["port"]) == (1 if "--skip_matching" in flags else 4)


def test_convert_exits_without_colmap(tmp_path, monkeypatch):
    monkeypatch.setattr(tconvert.shutil, "which", lambda exe: None)
    with pytest.raises(SystemExit):
        tconvert.main(["-s", str(tmp_path)])


def test_full_eval_runs_the_ports_chain(tmp_path, monkeypatch):
    """Every command line reaches subprocess in order; each scene's chain is
    gof_tpu's scene_job (scripts/run_benchmarks.py) with the port's modules;
    a failing command ends only its own scene's chain."""
    bench = load_script("run_benchmarks")
    rec = Recorder()
    monkeypatch.setattr(full_eval.subprocess, "run", rec)
    out = str(tmp_path / "eval")
    assert full_eval.main(["--mipnerf360", "/d/360", "--nerf_synthetic", "/d/syn",
                           "--output_path", out]) == []
    want = []
    for scene, factor in zip(bench.MIPNERF360["scenes"], bench.MIPNERF360["factors"]):
        want += bench.scene_job(f"/d/360/{scene}", os.path.join(out, "mipnerf360", scene),
                                ["-r", str(factor), "--eval"])
    for scene in bench.NERF_SYNTHETIC:
        want += bench.scene_job(f"/d/syn/{scene}", os.path.join(out, "nerf_synthetic", scene),
                                ["--white_background", "--eval"])
    want = [[a.replace("gof_tpu.", "gof_tpu_torch.") for a in c] for c in want]
    assert rec.cmds == want and len(want) == (9 + 8) * 4

    rec = Recorder()
    monkeypatch.setattr(full_eval.subprocess, "run", rec)
    full_eval.main(["--nerf_synthetic", "/d/syn", "--skip_training", "--skip_metrics", "--cpu"])
    assert [c[2] for c in rec.cmds[:2]] == ["gof_tpu_torch.render_cli",
                                            "gof_tpu_torch.extract_mesh"]
    assert all(c[-1] == "--cpu" for c in rec.cmds) and len(rec.cmds) == 16

    calls = []

    def fail_render(cmd, *a, **k):
        calls.append(cmd[2])
        return type("R", (), {"returncode": 3 if cmd[2].endswith("render_cli") else 0})()

    monkeypatch.setattr(full_eval.subprocess, "run", fail_render)
    failures = full_eval.main(["--nerf_synthetic", "/d/syn"])
    assert len(failures) == 8 and all(rc == 3 for _, rc in failures)
    assert calls == ["gof_tpu_torch.train", "gof_tpu_torch.render_cli"] * 8


# ---------------------------------------------------------------------------
# scripts/run_benchmarks.py: the scene dispatcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dataset", ["mipnerf360", "dtu", "tnt", "nerf_synthetic"])
def test_run_benchmarks_jobs_match_gof_tpu(tmp_path, monkeypatch, dataset):
    """Every dataset's scene chains (lists, flags, TSDF, the DTU / TNT eval
    tails) are gof_tpu's with the port's modules; --pin cpu adds the
    CLIs' --cpu to the device commands only."""
    bench = load_script("run_benchmarks")
    data = tmp_path / "data"
    os.makedirs(data / "Barn")
    (data / "Barn" / "Barn_COLMAP_SfM.log").write_text("")  # one TNT trajectory
    argv = [dataset, "--data_root", str(data), "--out_root", str(tmp_path / "out"),
            "--dtu_eval_data", "/gt/dtu", "--tnt_eval_data", "/gt/tnt",
            "--train_args", "--iterations 1000"]
    got = []
    monkeypatch.setattr(bench, "dispatch", lambda jobs, workers, pin: got.extend(jobs) or [])
    monkeypatch.setattr(sys, "argv", ["run_benchmarks.py", *argv])
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code == 0
    want = [[[a.replace("gof_tpu.", "gof_tpu_torch.") for a in c] for c in job] for job in got]
    ns = run_benchmarks.parse_args(argv)
    assert run_benchmarks.jobs(ns) == want and len(want) == {
        "mipnerf360": 9, "dtu": 15, "tnt": 6, "nerf_synthetic": 8}[dataset]
    cpu = run_benchmarks.jobs(run_benchmarks.parse_args(argv + ["--pin", "cpu"]))
    for job, job_cpu in zip(want, cpu):
        for c, c_cpu in zip(job, job_cpu):
            device_cli = c[2].split(".", 1)[1] in ("train", "render_cli", "metrics",
                                                    "extract_mesh", "extract_mesh_tsdf")
            assert c_cpu == (c + ["--cpu"] if device_cli else c)


def test_run_benchmarks_pin_env():
    assert run_benchmarks.pin_env(3, "cuda") == {"CUDA_VISIBLE_DEVICES": "3"}
    assert run_benchmarks.pin_env(3, "cpu") == {"CUDA_VISIBLE_DEVICES": ""}
    assert run_benchmarks.pin_env(3, "none") == {}


def test_run_benchmarks_dispatch_ends_only_the_failed_chain(tmp_path):
    """Two workers over python -c commands: dispatch returns exactly the
    failed commands, a failure ends only its own scene's chain, and each
    worker's commands see its CUDA_VISIBLE_DEVICES."""
    def cmd(tag, rc=0):
        return [sys.executable, "-c",
                f"import os, sys; open(os.path.join({str(tmp_path)!r}, {tag!r} + '.' + "
                f"os.environ['CUDA_VISIBLE_DEVICES']), 'w').close(); sys.exit({rc})"]

    jobs = [[cmd("a0"), cmd("a1", 3), cmd("a2")], [cmd("b0"), cmd("b1")],
            [cmd("c0", 5), cmd("c1")], [cmd("d0")]]
    failures = run_benchmarks.dispatch(jobs, 2, "cuda")
    assert sorted((c, rc) for _, c, rc in failures) == sorted([(jobs[0][1], 3), (jobs[2][0], 5)])
    ran = {f.split(".")[0]: f.split(".")[1] for f in os.listdir(tmp_path)}
    assert sorted(ran) == ["a0", "a1", "b0", "b1", "c0", "d0"]
    assert set(ran.values()) <= {"0", "1"}
    for scene in "abcd":  # a chain stays on its worker
        assert len({w for t, w in ran.items() if t[0] == scene}) == 1


# ---------------------------------------------------------------------------
# hostio
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [((1000, 7), torch.float32), ((33, 4, 5), torch.int32),
                                         ((3,), torch.float32), ((), torch.float32)])
def test_hostio_chunks_match_gof_tpu(shape, dtype):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.asarray(rng.normal(size=shape) * 100)).to(dtype)
    got = hostio.device_get(x, chunk_bytes=1000)
    want = jhostio.device_get(jax.numpy.asarray(x.numpy()), chunk_bytes=1000)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and isinstance(got, np.ndarray)
    if x.dim():
        row = x[0].numel() * x.element_size()
        sl = hostio.row_slices(x.shape[0], row, 1000)
        assert sl[0][0] == 0 and sl[-1][1] == x.shape[0]
        assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
        assert all((hi - lo) * row <= max(1000, row) for lo, hi in sl)
        assert len(sl) == -(-x.shape[0] // max(1, 1000 // row))


def test_hostio_tree_get_keeps_structure():
    from collections import namedtuple

    from gof_tpu_torch.model import gaussians as gm

    NT = namedtuple("NT", "a b")
    s = gm.GaussianState(*[torch.arange(6, dtype=torch.float32) for _ in range(6)])
    tree = {"x": [torch.ones(2, 3), (torch.zeros(1), 5)], "nt": NT(torch.arange(4), "s"),
            "state": s}
    got = hostio.tree_get(tree, chunk_bytes=8)
    assert isinstance(got["x"], list) and isinstance(got["x"][1], tuple)
    assert got["x"][1][1] == 5 and got["nt"].b == "s" and isinstance(got["nt"], NT)
    np.testing.assert_array_equal(got["nt"].a, np.arange(4))
    assert isinstance(got["state"], gm.GaussianState)
    np.testing.assert_array_equal(got["state"].denom, np.arange(6, dtype=np.float32))


# ---------------------------------------------------------------------------
# The native COLMAP reader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    return native.load() is not None


def test_native_reader_matches_python_parsers(built, tmp_path):
    if not built:
        pytest.skip("native reader unavailable (no g++)")
    assert str(native.lib_path()).startswith(os.path.join(REPO, "build", "gof_tpu_torch"))
    sparse = str(tmp_path / "sparse" / "0")
    write_colmap_binary(sparse, n_images=12)
    py_cams = tcolmap.read_cameras_binary(f"{sparse}/cameras.bin")
    py_imgs = tcolmap.read_images_binary(f"{sparse}/images.bin")
    py_xyz, py_rgb, py_err = tcolmap.read_points3d_binary(f"{sparse}/points3D.bin")
    cams, imgs, (xyz, rgb, err) = tcolmap._load_model_native(sparse)
    assert set(cams) == set(py_cams)
    c, pc = cams[1], py_cams[1]
    assert (c.model, c.width, c.height) == (pc.model, pc.width, pc.height)
    np.testing.assert_array_equal(c.params, pc.params)
    assert set(imgs) == set(py_imgs)
    for k in imgs:
        np.testing.assert_array_equal(imgs[k].qvec, py_imgs[k].qvec)
        np.testing.assert_array_equal(imgs[k].tvec, py_imgs[k].tvec)
        assert (imgs[k].name, imgs[k].camera_id) == (py_imgs[k].name, py_imgs[k].camera_id)
    np.testing.assert_array_equal(xyz, py_xyz)
    np.testing.assert_array_equal(rgb, py_rgb)
    np.testing.assert_array_equal(err, py_err)


def test_load_model_says_which_reader(built, tmp_path, monkeypatch, capsys):
    sparse = str(tmp_path / "sparse" / "0")
    write_colmap_binary(sparse, n_images=3)
    monkeypatch.setattr(tcolmap, "_READER_SAID", False)
    cams, imgs, pts = tcolmap.load_model(sparse)
    tcolmap.load_model(sparse)
    said = [line for line in capsys.readouterr().out.splitlines() if "COLMAP reader" in line]
    assert said == ["COLMAP reader: " + ("native (gof_tpu_torch/native)" if built else
                                         "Python parsers (the native reader did not load)")]
    assert len(imgs) == 3 and len(pts[0]) > 0


def test_native_reader_falls_back_without_a_library(tmp_path, monkeypatch, capsys):
    sparse = str(tmp_path / "sparse" / "0")
    write_colmap_binary(sparse, n_images=3)
    monkeypatch.setattr(native, "_TRIED", True)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(tcolmap, "_READER_SAID", False)
    cams, imgs, pts = tcolmap.load_model(sparse)
    assert "Python parsers" in capsys.readouterr().out and len(imgs) == 3


# ---------------------------------------------------------------------------
# show_results and summarize_run
# ---------------------------------------------------------------------------


@pytest.fixture
def results_dir(tmp_path):
    root = tmp_path / "out"
    for i, scene in enumerate(("garden", "bonsai", "room")):
        (root / scene).mkdir(parents=True)
        res = {"ours_7000": {"PSNR": 20.0 + i, "SSIM": 0.7, "LPIPS": 0.3},
               "ours_30000": {"PSNR": 25.5 + i, "SSIM": 0.8 + 0.01 * i,
                              "LPIPS": None if i == 1 else 0.2}}
        (root / scene / "results.json").write_text(json.dumps(res))
    (root / "empty").mkdir()
    recs = []
    for it in range(100, 3100, 100):
        recs.append({"iter": it, "loss": 0.1, "ema": 0.1, "psnr": 20 + it / 1000,
                     "points": 1000 + it, "keys": 5000 + 2 * it, "elapsed": it / 7.5})
    recs.insert(12, {"iter": 1200, "eval": {"psnr": 22.5, "views": 4}})
    with open(root / "train_log.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    return str(root)


def run_main(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def run_script(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


@pytest.mark.parametrize("latex", [False, True])
def test_show_results_matches_gof_tpu(results_dir, monkeypatch, latex):
    argv = [results_dir] + (["--latex"] if latex else [])
    got = run_main(show_results.main, argv)
    want = run_script(load_script("show_results"), argv, monkeypatch)
    assert got == want and "bonsai" in got and "mean" in got


def test_summarize_run_matches_gof_tpu(results_dir, monkeypatch):
    got = run_main(summarize_run.main, [results_dir])
    want = run_script(load_script("summarize_run"), [results_dir], monkeypatch)
    assert got == want and "PSNR 22.500" in got and "it/s" in got


def test_host_tools_never_import_jax(tmp_path):
    code = ("import sys\n"
            "import gof_tpu_torch.network_gui, gof_tpu_torch.mesh_viewer, "
            "gof_tpu_torch.convert, gof_tpu_torch.full_eval, gof_tpu_torch.utils.hostio, "
            "gof_tpu_torch.native, gof_tpu_torch.scripts.show_results, "
            "gof_tpu_torch.scripts.summarize_run, gof_tpu_torch.ops.oracle\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'gof_tpu.'))"
            " or m == 'gof_tpu']\n"
            "assert not bad, bad\n")
    import subprocess

    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
