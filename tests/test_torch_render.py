"""The whole serving slice of gof_tpu_torch against gof_tpu.

A padded model (300 gaussians, SH degree 3, some inactive slots) is made
with numpy. gof_tpu renders it with its eval recipe (train.build_eval_fn:
filtered scales and opacities, Pallas kernels in interpret mode); the port
renders it on the CPU after the weights are carried across — through
`from_numpy` and through a PLY written by gof_tpu. image[:9] and
transmittance agree within atol 1e-5, rtol 1e-4 (the repo's Pallas-vs-XLA
tolerance); radii, visibility, key slots and the compact demand are exact.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gof_tpu import cameras as jcam
from gof_tpu import config as jconfig
from gof_tpu.data import scene as jscene
from gof_tpu.model import gaussians as jgm
from gof_tpu.ops import render as jrender
from gof_tpu_torch import cameras as tcam
from gof_tpu_torch import config as tconfig
from gof_tpu_torch import render_cli
from gof_tpu_torch.data import scene as tscene
from gof_tpu_torch.model import gaussians as tgm
from gof_tpu_torch.ops import render as trender

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
W, H = 64, 32
N, N_ACTIVE = 320, 300
CAM = dict(eye=(0.2, -0.1, 0.0), target=(0, 0, 5.0), width=W, height=H)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_model():
    """bench.py-style random model in a padded pool of N slots."""
    rng = np.random.default_rng(5)
    z = rng.uniform(3, 9, N)
    xyz = np.stack([rng.uniform(-1, 1, N) * z * 0.3, rng.uniform(-1, 1, N) * z * 0.2, z], -1)
    q = rng.normal(size=(N, 4))
    op = rng.uniform(0.3, 0.95, N)
    params = jgm.GaussianParams(
        xyz=jnp.asarray(xyz, jnp.float32),
        features_dc=jnp.asarray(rng.normal(0, 1, (N, 1, 3)), jnp.float32),
        features_rest=jnp.asarray(rng.normal(0, 0.2, (N, 15, 3)), jnp.float32),
        scaling=jnp.asarray(rng.normal(-1.6, 0.4, (N, 3)), jnp.float32),
        rotation=jnp.asarray(q, jnp.float32),
        opacity=jnp.asarray(np.log(op / (1 - op)), jnp.float32))
    zf = jnp.zeros((N,), jnp.float32)
    state = jgm.GaussianState(
        active=jnp.arange(N) < N_ACTIVE, filter_3d=jnp.asarray(rng.uniform(1e-4, 5e-3, N), jnp.float32),
        max_radii2d=zf, grad_accum=zf, grad_abs_accum=zf, denom=zf)
    return params, state


def jax_eval(params, state, cam, bg):
    """gof_tpu's eval render (train.build_eval_fn's body), Pallas interpreted."""
    return jrender.render(
        cam, params.xyz, jgm.filtered_scaling(params, state.filter_3d), params.rotation,
        jgm.filtered_opacity(params, state.filter_3d), jgm.get_features(params), 3, 0.1, bg,
        active_mask=state.active, capacity=1 << 14, backend="pallas", interpret=True)


@pytest.fixture(scope="module")
def reference():
    params, state = make_model()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    out = jax_eval(params, state, jcam.look_at_camera(**CAM), jnp.asarray(bg))
    return jax.device_get(params), jax.device_get(state), bg, jax.device_get(out)


def assert_matches(ref, got, keep=None):
    """ref: gof_tpu RenderOut (numpy); got: port RenderOut. keep: slots of
    ref that the port's pool holds (a PLY keeps only active gaussians)."""
    np.testing.assert_allclose(got.image.numpy(), ref.image[:9], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.transmittance.numpy(), ref.transmittance, atol=ATOL, rtol=RTOL)
    keep = slice(None) if keep is None else keep
    np.testing.assert_array_equal(got.radii.numpy(), ref.radii[keep])
    np.testing.assert_array_equal(got.visibility.numpy(), ref.visibility[keep])
    assert int(got.num_keys) == int(ref.num_keys)
    assert int(got.compact_demand) == int(ref.compact_demand)
    assert not bool(got.overflow) and not bool(got.compact_overflow)


def test_render_api_matches(reference):
    """Port render on gof_tpu's filtered inputs, field by field."""
    params, state, bg, ref = reference
    scales = np.asarray(jgm.filtered_scaling(params, state.filter_3d))
    opac = np.asarray(jgm.filtered_opacity(params, state.filter_3d))
    shs = np.asarray(jgm.get_features(params))

    def t(a):
        return torch.from_numpy(np.array(a))

    got = trender.render(tcam.look_at_camera(**CAM), t(params.xyz), t(scales), t(params.rotation),
                         t(opac), t(shs), 3, 0.1, t(bg), active_mask=t(state.active))
    assert_matches(ref, got)
    assert got.image.shape == (9, H, W)
    assert ref.visibility.sum() > 200 and (ref.image[7] > 0.5).mean() > 0.5
    # live_counts is the forward's CH_LIVEC, as gof_tpu's pallas render reports it
    np.testing.assert_array_equal(got.live_counts.numpy(), ref.live_counts)
    assert got.live_counts.shape == (2,) and got.live_counts.all()


def test_weights_via_from_numpy(reference):
    params, state, bg, ref = reference
    g, s = tgm.from_numpy(params, state)
    assert g.features_rest.shape == (N, 15, 3) and s.active.dtype == torch.bool
    for name in ("filtered_scaling", "filtered_opacity"):
        np.testing.assert_allclose(getattr(tgm, name)(g, s.filter_3d).numpy(),
                                   np.asarray(getattr(jgm, name)(params, state.filter_3d)),
                                   atol=1e-6, rtol=1e-6)
    cfg = tconfig.ModelParams(sh_degree=3, kernel_size=0.1)
    got = render_cli.render_eval(g, s, tcam.look_at_camera(**CAM), cfg, torch.from_numpy(bg))
    assert_matches(ref, got)


def test_weights_via_gof_tpu_ply(reference, tmp_path):
    params, state, bg, ref = reference
    path = str(tmp_path / "point_cloud.ply")
    jscene.save_gaussians_ply(path, params, state, 3)
    g, s = tscene.load_gaussians_ply(path, 3)
    assert g.xyz.shape[0] == N_ACTIVE and bool(s.active.all())
    cfg = tconfig.ModelParams(sh_degree=3, kernel_size=0.1)
    got = render_cli.render_eval(g, s, tcam.look_at_camera(**CAM), cfg, torch.from_numpy(bg))
    assert_matches(ref, got, keep=np.asarray(state.active))


def test_port_ply_loads_in_gof_tpu(reference, tmp_path):
    params, state, _, _ = reference
    g, s = tgm.from_numpy(params, state)
    path = str(tmp_path / "port.ply")
    tscene.save_gaussians_ply(path, g, s, 3)
    jg, js = jscene.load_gaussians_ply(path, 3)
    act = np.asarray(state.active)
    for name in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, name)), getattr(params, name)[act])
    np.testing.assert_array_equal(np.asarray(js.filter_3d), state.filter_3d[act])


def test_load_cfg_reads_gof_tpu_config(tmp_path):
    model = jconfig.ModelParams(source_path="/data/scene", sh_degree=2, kernel_size=0.1,
                                white_background=True, resolution=2)
    jconfig.save_cfg(str(tmp_path), model, jconfig.PipelineParams(key_capacity=123),
                     jconfig.OptimizationParams(iterations=77))
    m, p, o = tconfig.load_cfg(str(tmp_path))
    assert (m.source_path, m.sh_degree, m.kernel_size, m.white_background, m.resolution) == \
        ("/data/scene", 2, 0.1, True, 2)
    assert p.key_capacity == 123 and o.iterations == 77


def write_blender_scene(root, n_views=2):
    os.makedirs(os.path.join(root, "images"))
    frames = []
    for i, th in enumerate(np.linspace(-0.3, 0.3, n_views)):
        cam = jcam.look_at_camera(eye=(np.sin(th), 0.1, 0.0), target=(0, 0, 5.0), width=W, height=H)
        c2w = np.linalg.inv(np.asarray(cam.world_view, np.float64))
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL axes
        Image.fromarray(np.full((H, W, 3), 60 * i, np.uint8)).save(
            os.path.join(root, "images", f"{i}.png"))
        frames.append({"file_path": f"images/{i}", "transform_matrix": c2w.tolist()})
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)


def test_render_cli_cpu(reference, tmp_path):
    """A gof_tpu model directory rendered by the port's CLI on the CPU."""
    params, state, _, _ = reference
    src, model = str(tmp_path / "scene"), str(tmp_path / "model")
    write_blender_scene(src)
    jscene.save_gaussians_ply(os.path.join(model, "point_cloud", "iteration_7", "point_cloud.ply"),
                              params, state, 3)
    jconfig.save_cfg(model, jconfig.ModelParams(source_path=src, model_path=model, sh_degree=3,
                                                kernel_size=0.1),
                     jconfig.PipelineParams(), jconfig.OptimizationParams())
    stats = render_cli.main(["-m", model, "--cpu"])
    assert [len(stats[k]) for k in ("train", "test")] == [2, 2]
    assert all(s["num_keys"] > 0 for s in stats["test"])
    for split in ("train", "test"):
        for sub in ("renders", "gt"):
            d = os.path.join(model, split, "ours_7", sub)
            assert sorted(os.listdir(d)) == ["00000.png", "00001.png"]
        img = np.asarray(Image.open(os.path.join(model, split, "ours_7", "renders", "00000.png")))
        assert img.shape == (H, W, 3) and img.std() > 0


def test_render_cli_requires_cuda_without_cpu_flag(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_cli.main(["-m", str(tmp_path)])


def test_port_never_imports_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "from gof_tpu_torch import cameras\n"
        "from gof_tpu_torch.ops import render\n"
        "from gof_tpu_torch import extract_mesh\n"
        "from gof_tpu_torch.mesh import extract, tetmesh\n"
        "from gof_tpu_torch.ops import integrate\n"
        "from gof_tpu_torch.ops import gather_probes\n"
        "from gof_tpu_torch.scripts import mxu_gather_probe, pallas_gather_probe\n"
        "assert gather_probes.take_gather(torch.zeros((1, 1, 4), dtype=torch.int32),"
        " torch.ones((2, 3))).shape == (4, 3)\n"
        "rng = np.random.default_rng(0); n = 50\n"
        "z = rng.uniform(3, 8, n)\n"
        "xyz = np.stack([rng.uniform(-1, 1, n) * z * .2, rng.uniform(-1, 1, n) * z * .2, z], -1)\n"
        "f = lambda a: torch.tensor(a, dtype=torch.float32)\n"
        "out = render.render(cameras.look_at_camera(eye=(0, 0, 0), target=(0, 0, 5.), width=64,"
        " height=32), f(xyz), f(rng.uniform(.1, .3, (n, 3))), f(rng.normal(size=(n, 4))),"
        " f(rng.uniform(.3, .9, n)), f(rng.normal(size=(n, 1, 3))), 0, 0.1, torch.zeros(3))\n"
        "assert out.image.shape == (9, 32, 64) and bool(torch.isfinite(out.image).all())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'gof_tpu')]\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_view_with_nothing_visible_is_background():
    """Every gaussian behind the camera: zero slot demand, the image is the
    background exactly and T is 1 (the verify skill's first probe)."""
    rng = np.random.default_rng(2)
    n = 20
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), -rng.uniform(2, 5, n)], -1)

    def f(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    bg = torch.tensor([0.1, 0.2, 0.3])
    out = trender.render(tcam.look_at_camera(**CAM), f(xyz), f(np.full((n, 3), 0.2)),
                         f(rng.normal(size=(n, 4))), f(np.full(n, 0.8)),
                         f(rng.normal(size=(n, 1, 3))), 0, 0.1, bg)
    assert bool((out.image[:3] == bg[:, None, None]).all())
    assert bool((out.image[3:] == 0).all()) and bool((out.transmittance == 1).all())
    assert int(out.num_keys) == 0 and int(out.compact_demand) == 0 and not out.visibility.any()
