"""The training slice of gof_tpu_torch against gof_tpu.

Inputs are made with numpy and fed to both packages; the JAX side runs its
Pallas kernels in interpret mode (each train step built once per module).
Tolerances: the loss helpers, schedules, the 3D filter, init and the
densification statistics within 1e-5 relative; Adam within rtol 1e-6 of
gof_tpu's arithmetic and 1e-5 of torch.optim.Adam; gradients within
gof_tpu's Pallas-vs-XLA bound max|port - jax| / max|jax| < 1e-4
(tests/test_rasterize.py:154-157).
"""

import argparse
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import cameras as jcam
from gof_tpu import config as jconfig
from gof_tpu import train as jtrain
from gof_tpu.data import scene as jscene
from gof_tpu.model import gaussians as jgm
from gof_tpu.utils import losses as jlosses
from gof_tpu.utils import schedules as jsched
from gof_tpu_torch import cameras as tcam
from gof_tpu_torch import config as tconfig
from gof_tpu_torch import render_cli
from gof_tpu_torch import train as ttrain
from gof_tpu_torch.data import scene as tscene
from gof_tpu_torch.model import gaussians as tgm
from gof_tpu_torch.utils import losses as tlosses
from gof_tpu_torch.utils import schedules as tsched

from make_synthetic_scene import make_scene

torch.set_num_threads(2)

BOUND = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-12))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


# ---------------------------------------------------------------------------
# Losses, schedules, model helpers
# ---------------------------------------------------------------------------


def test_losses_match():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, 40, 53)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    for name in ("l1_loss", "ssim", "psnr"):
        got = float(getattr(tlosses, name)(t(a), t(b)))
        want = float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)))
        assert abs(got - want) <= 1e-5 * abs(want), name
    assert float(tlosses.ssim(t(a), t(a))) == pytest.approx(1.0, abs=1e-6)


def test_expon_lr_matches():
    for kw in (dict(lr_init=1.6e-4 * 5, lr_final=1.6e-6 * 5, max_steps=30_000,
                    lr_delay_mult=0.01),
               dict(lr_init=1e-2, lr_final=1e-4, max_steps=100, lr_delay_steps=20,
                    lr_delay_mult=0.1),
               dict(lr_init=0.0, lr_final=1e-4, max_steps=100)):
        for step in (-1, 0, 1, 7, 50, 5000, 29_999, 40_000):
            got = float(tsched.expon_lr(step, **kw))
            want = float(jsched.expon_lr(step, **kw))
            assert got == pytest.approx(want, rel=1e-5, abs=1e-12), (kw, step)


def cam_pair(**kw):
    return jcam.look_at_camera(**kw), tcam.look_at_camera(**kw)


def test_depth_to_normal_matches():
    rng = np.random.default_rng(1)
    jc, tc = cam_pair(eye=(0.3, -0.2, -1.0), target=(0, 0, 4.0), width=48, height=36)
    depth = rng.uniform(3, 6, (36, 48)).astype(np.float32)
    depth[:10, :10] = 0.0  # background: zero normals
    got = ttrain.depth_to_normal(tc, t(depth)).numpy()
    want = np.asarray(jtrain.depth_to_normal(jc, jnp.asarray(depth)))
    close(got, want)
    assert got.shape == (3, 36, 48) and (got[:, 0] == 0).all()


def test_masked_shs_matches():
    rng = np.random.default_rng(2)
    params, _ = model(rng, 20, 20, sh_degree=3)
    g, _ = tgm.from_numpy(params, jgm.GaussianState(*[np.zeros(20)] * 6))
    for deg in (0, 1, 3):
        got = ttrain.masked_shs(g, deg, 3).numpy()
        want = np.asarray(jtrain.masked_shs(params, jnp.int32(deg), 3))
        np.testing.assert_array_equal(got, want)
        assert (got[:, (deg + 1) ** 2:] == 0).all()


def model(rng, n, n_active, sh_degree=1):
    """A bench-style random model in a padded pool (inactive slots carry
    init's padding values)."""
    K = (sh_degree + 1) ** 2
    z = rng.uniform(4, 7, n)
    xyz = np.stack([rng.uniform(-1, 1, n) * z * 0.2, rng.uniform(-1, 1, n) * z * 0.2, z], -1)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    scaling = np.log(rng.uniform(0.2, 0.5, (n, 3)))
    op = rng.uniform(-1, 1, n)
    xyz[n_active:], scaling[n_active:], op[n_active:] = 0.0, -10.0, 0.0
    q[n_active:] = (1.0, 0, 0, 0)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    params = jgm.GaussianParams(
        xyz=f32(xyz), features_dc=f32(rng.normal(0, 0.5, (n, 1, 3))),
        features_rest=f32(rng.normal(0, 0.1, (n, K - 1, 3))), scaling=f32(scaling),
        rotation=f32(q), opacity=f32(op))
    zf = jnp.zeros((n,), jnp.float32)
    state = jgm.GaussianState(active=jnp.arange(n) < n_active, filter_3d=zf + 1e-4,
                              max_radii2d=zf, grad_accum=zf, grad_abs_accum=zf, denom=zf)
    return jax.device_get(params), jax.device_get(state)


def test_init_from_points_matches():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    cap = ttrain.pool_capacity(300)
    assert cap == 1024
    for n in (1, 511, 512, 513, 100_000):
        assert ttrain.pool_capacity(n) == 1 << max(int(np.ceil(np.log2(max(n * 2, 1024)))), 10)
    assert ttrain.pool_capacity(100_000) == 262_144
    jp, js = jgm.init_from_points(pts, cols, 2, cap)
    tp_, ts = tgm.init_from_points(pts, cols, 2, cap)
    for f in ttrain.GAUSS_FIELDS:
        close(getattr(tp_, f).numpy(), np.asarray(getattr(jp, f)))
    for f in ("active", "filter_3d", "max_radii2d", "grad_accum", "grad_abs_accum", "denom"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))


def test_compute_3d_filter_matches():
    rng = np.random.default_rng(4)
    params, state = model(rng, 200, 180)
    cams = [jcam.look_at_camera(eye=(3 * np.sin(a), 0.5, 3 * np.cos(a) - 6), target=(0, 0, 5.5),
                                width=80, height=60) for a in np.linspace(-0.6, 0.6, 5)]
    wv = np.stack([np.asarray(c.world_view) for c in cams])
    fx = np.array([float(c.focal_x) for c in cams], np.float32)
    fy = np.array([float(c.focal_y) for c in cams], np.float32)
    ws, hs = np.full(5, 80, np.float32), np.full(5, 60, np.float32)
    args = (wv, fx, fy, ws, hs)
    got = tgm.compute_3d_filter(t(params.xyz), t(state.active), *map(t, args)).numpy()
    want = np.asarray(jgm.compute_3d_filter(jnp.asarray(params.xyz), jnp.asarray(state.active),
                                            *map(jnp.asarray, args)))
    close(got, want)


def test_scene_cameras_meta_matches(tmp_path):
    root = str(tmp_path / "scene")
    make_scene(root, n_gaussians=4, n_views=3, size=32)
    js = jscene.Scene(root, "", shuffle=False)
    ts = tscene.Scene(root, "", shuffle=False)
    for a, b in zip(ts.all_cameras_meta(ts.train_cameras), js.all_cameras_meta(js.train_cameras)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert [ts._scaled_size(c) for c in ts.train_cameras] == \
        [js._scaled_size(c) for c in js.train_cameras]


def test_add_densification_stats_and_reset_opacity_match():
    rng = np.random.default_rng(5)
    params, state = model(rng, 64, 50)
    state = state._replace(grad_accum=rng.uniform(0, 1, 64).astype(np.float32),
                           max_radii2d=rng.uniform(0, 5, 64).astype(np.float32),
                           filter_3d=rng.uniform(1e-4, 1e-2, 64).astype(np.float32))
    carrier = rng.normal(size=(64, 3)).astype(np.float32)
    radii = rng.uniform(0, 8, 64).astype(np.float32)
    vis = rng.uniform(size=64) < 0.7
    want = jgm.add_densification_stats(state, jnp.asarray(carrier), jnp.asarray(radii),
                                       jnp.asarray(vis))
    g, s = tgm.from_numpy(params, state)
    got = tgm.add_densification_stats(s, t(carrier), t(radii), t(vis))
    for f in ("grad_accum", "grad_abs_accum", "max_radii2d"):
        close(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(got.denom.numpy(), np.asarray(want.denom))
    close(tgm.reset_opacity(g, s.filter_3d).opacity.numpy(),
          np.asarray(jgm.reset_opacity(params, state.filter_3d).opacity))


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------


def test_adam_matches_gof_tpu_and_torch_adam():
    rng = np.random.default_rng(6)
    params, _ = model(rng, 32, 32, sh_degree=2)
    opt = jconfig.OptimizationParams()
    jtx = jtrain.make_optimizer(opt, 4.0)
    jtp = jtrain.TrainParams(gauss=params, app_net=None, app_emb=None)
    jstate = jtx.init(jtp)
    # a state carried across mid-run: nonzero moments, count 41
    jstate = jstate._replace(count=jnp.int32(41),
                             mu_flat=jnp.asarray(rng.normal(0, 1e-3, jstate.mu_flat.shape),
                                                 jnp.float32),
                             nu_flat=jnp.asarray(rng.uniform(0, 1e-6, jstate.nu_flat.shape),
                                                 jnp.float32))
    g, _ = tgm.from_numpy(params, jgm.GaussianState(*[np.zeros(32)] * 6))
    ttx = ttrain.make_optimizer(tconfig.OptimizationParams(), 4.0)
    tstate = ttrain.from_numpy(jax.device_get(jstate), g)
    assert tstate.count == 41
    grads = [jgm.GaussianParams(*[rng.normal(0, 1e-2, np.shape(getattr(params, f)))
                                  .astype(np.float32) for f in ttrain.GAUSS_FIELDS])
             for _ in range(3)]
    jp = params
    tp_ = [getattr(g, f).clone() for f in ttrain.GAUSS_FIELDS]
    for gr in grads:
        jgr = jtrain.TrainParams(gauss=jax.tree.map(jnp.asarray, gr), app_net=None, app_emb=None)
        upd, jstate = jtx.update(jgr, jstate)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd.gauss)
        tupd, tstate = ttx.update(tgm.GaussianParams(*[t(x) for x in gr]), tstate)
        tp_ = [x + getattr(tupd, f) for x, f in zip(tp_, ttrain.GAUSS_FIELDS)]
    assert tstate.count == int(jstate.count) == 44
    jmu = jtrain.unflatten_gauss_t(jstate.mu_flat, params)
    jnu = jtrain.unflatten_gauss_t(jstate.nu_flat, params)
    for i, f in enumerate(ttrain.GAUSS_FIELDS):
        close(tp_[i].numpy(), np.asarray(getattr(jp, f)), rtol=1e-6)
        close(getattr(tstate.mu, f).numpy(), np.asarray(getattr(jmu, f)), rtol=1e-6)
        close(getattr(tstate.nu, f).numpy(), np.asarray(getattr(jnu, f)), rtol=1e-6)

    # torch.optim.Adam from zero moments, per-group lrs set per step
    ref = [getattr(g, f).clone().requires_grad_(True) for f in ttrain.GAUSS_FIELDS]
    topt = torch.optim.Adam([{"params": [x]} for x in ref], lr=1.0, betas=(0.9, 0.999),
                            eps=1e-15)
    mine = [getattr(g, f).clone() for f in ttrain.GAUSS_FIELDS]
    st = ttx.init(ttrain.TrainParams(gauss=tgm.GaussianParams(*mine)))
    for gr in grads:
        lrs = ttx.group_lrs(st.count)
        for grp, x, f in zip(topt.param_groups, ref, ttrain.GAUSS_FIELDS):
            grp["lr"] = float(lrs[f])
            x.grad = t(getattr(gr, f))
        topt.step()
        upd, st = ttx.update(tgm.GaussianParams(*[t(x) for x in gr]), st)
        mine = [x + getattr(upd, f) for x, f in zip(mine, ttrain.GAUSS_FIELDS)]
    for x, y in zip(mine, ref):
        close(x.numpy(), y.detach().numpy())


# ---------------------------------------------------------------------------
# One train step against gof_tpu's
# ---------------------------------------------------------------------------

N_POOL, N_ACTIVE = 48, 40
STEP_W, STEP_H = 96, 64


@pytest.fixture(scope="module")
def step_case():
    rng = np.random.default_rng(7)
    params, state = model(rng, N_POOL, N_ACTIVE)
    state = state._replace(filter_3d=rng.uniform(1e-4, 5e-3, N_POOL).astype(np.float32))
    gt = rng.uniform(0, 1, (3, STEP_H, STEP_W)).astype(np.float32)
    cam = dict(eye=(0.1, -0.05, 0.0), target=(0, 0, 5.0), width=STEP_W, height=STEP_H)
    model_cfg = jconfig.ModelParams(sh_degree=1, kernel_size=0.1)
    runs = {}
    for name, (reg_from, with_reg) in {"stats": (15_000, False), "reg": (0, True)}.items():
        opt = jconfig.OptimizationParams(distortion_from_iter=reg_from,
                                         depth_normal_from_iter=reg_from)
        tx = jtrain.make_optimizer(opt, 5.0)
        tp0 = jtrain.TrainParams(gauss=jax.tree.map(jnp.asarray, params), app_net=None,
                                 app_emb=None)
        s0 = tx.init(tp0)
        step = jtrain.build_train_step(opt, model_cfg, jconfig.PipelineParams(key_capacity=8192),
                                       tx, interpret=True, with_stats=True, with_reg=with_reg)
        tp, s, g, m = step(tp0, s0, jax.tree.map(jnp.asarray, state), jnp.asarray(gt),
                           jnp.int32(100), jcam.look_at_camera(**cam), jnp.zeros(3))
        runs[name] = (reg_from, with_reg, jax.device_get((tp.gauss, s, g, m)),
                      jax.device_get(s0))
    return params, state, gt, cam, runs


def port_step(params, state, gt, cam, reg_from, with_reg, s0):
    opt = tconfig.OptimizationParams(distortion_from_iter=reg_from,
                                     depth_normal_from_iter=reg_from)
    g, s = tgm.from_numpy(params, state)
    tx = ttrain.make_optimizer(opt, 5.0)
    st0 = ttrain.from_numpy(s0, g)
    step = ttrain.build_train_step(opt, tconfig.ModelParams(sh_degree=1, kernel_size=0.1),
                                   tconfig.PipelineParams(), tx, with_stats=True,
                                   with_reg=with_reg)
    return step(ttrain.TrainParams(gauss=g), st0, s, t(gt), 100, tcam.look_at_camera(**cam),
                torch.zeros(3))


@pytest.mark.parametrize("phase", ["stats", "reg"])
def test_train_step_matches_gof_tpu(step_case, phase):
    params, state, gt, cam, runs = step_case
    reg_from, with_reg, (jg, js, jgs, jm), s0 = runs[phase]
    tp, st, gs, m = port_step(params, state, gt, cam, reg_from, with_reg, s0)
    for k in ("loss", "l1", "ssim", "psnr", "distortion", "depth_normal"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-7), k
    for k in ("num_keys", "compact_demand"):
        assert int(m[k]) == int(jm[k]), k
    assert not bool(m["key_overflow"]) and not bool(m["compact_overflow"])
    np.testing.assert_allclose(m["packed"].numpy()[[0, 1, 2, 4, 6]],
                               np.asarray(jm["packed"])[[0, 1, 2, 4, 6]], rtol=1e-5)
    if with_reg:
        assert float(jm["distortion"]) > 0 and float(jm["depth_normal"]) > 0
    # gradients: after one step from zero moments, mu = (1 - b1) * grad
    jmu = jtrain.unflatten_gauss_t(jnp.asarray(js.mu_flat), params)
    for f in ttrain.GAUSS_FIELDS:
        got, want = getattr(st.mu, f).numpy(), np.asarray(getattr(jmu, f))
        assert np.isfinite(got).all(), f
        if f != "features_rest":  # SH degree 0 at step 100: no rest gradient
            assert np.abs(want).max() > 0, f
        assert rel_err(got, want) <= BOUND, (f, rel_err(got, want))
        # post-Adam params where the gradient is not near zero
        gmag = np.abs(want)
        sel = gmag > 1e-3 * gmag.max()
        if sel.any():
            close(getattr(tp.gauss, f).detach().numpy()[sel],
                  np.asarray(getattr(jg, f))[sel], rtol=1e-5)
    # densification statistics (the carrier's gradient)
    for f in ("grad_accum", "grad_abs_accum"):
        assert rel_err(getattr(gs, f).numpy(), np.asarray(getattr(jgs, f))) <= BOUND, f
        assert np.abs(np.asarray(getattr(jgs, f))).max() > 0
    np.testing.assert_array_equal(gs.denom.numpy(), np.asarray(jgs.denom))
    np.testing.assert_array_equal(gs.max_radii2d.numpy(), np.asarray(jgs.max_radii2d))
    assert gs.denom.numpy()[N_ACTIVE:].sum() == 0 and gs.denom.numpy().sum() > 30


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    make_scene(root, n_gaussians=16, n_views=8, size=64)
    return root


def test_train_main_cpu_writes_log_and_ply(synth_scene, tmp_path):
    out = str(tmp_path / "out")
    tp, gs = ttrain.main(["-s", synth_scene, "-m", out, "--cpu", "--iterations", "5",
                          "--sh_degree", "1", "--kernel_size", "0.1", "--test_iterations", "5",
                          "--quiet"])
    recs = [json.loads(line) for line in open(os.path.join(out, "train_log.jsonl"))]
    assert [r["iter"] for r in recs] == [1, 5]
    assert np.isfinite(recs[0]["loss"]) and recs[0]["points"] == 64 and recs[0]["keys"] > 0
    assert recs[1]["eval"]["views"] == 2 and np.isfinite(recs[1]["eval"]["psnr"])
    assert gs.active.sum() == 64 and tp.gauss.xyz.shape[0] == 1024
    assert float(gs.denom.sum()) > 0  # statistics accumulated over the steps
    ply = os.path.join(out, "point_cloud", "iteration_5", "point_cloud.ply")
    jg, js = jscene.load_gaussians_ply(ply, 1)  # gof_tpu reads the port's PLY
    assert int(np.asarray(js.active).sum()) == 64
    m, _, o = tconfig.load_cfg(out)
    assert (m.sh_degree, o.iterations) == (1, 5)
    stats = render_cli.main(["-m", out, "--cpu", "--skip_train"])
    assert len(stats["test"]) == 2 and all(s["num_keys"] > 0 for s in stats["test"])
    assert os.path.exists(os.path.join(out, "test", "ours_5", "renders", "00001.png"))


def test_train_densify_cadence_raises(synth_scene, tmp_path):
    """The densify-and-prune cadence is not ported: it raises at the first
    iteration where gof_tpu would densify (iteration 3 here), not later."""
    with pytest.raises(NotImplementedError, match=r"densify_and_prune.*iteration 3.*A\.8"):
        ttrain.main(["-s", synth_scene, "-m", str(tmp_path / "d"), "--cpu", "--iterations",
                     "50", "--sh_degree", "0", "--densify_from_iter", "1",
                     "--densification_interval", "3", "--quiet"])
    recs = [json.loads(line) for line in open(tmp_path / "d" / "train_log.jsonl")]
    assert [r["iter"] for r in recs] == [1]


@pytest.mark.parametrize("extra", [
    ["--start_checkpoint", "chkpnt10.pkl"], ["--use_decoupled_appearance"], ["--dp", "2"],
    ["--debug_image_interval", "5"], ["--checkpoint_iterations", "2"],
], ids=["start_checkpoint", "appearance", "dp", "debug_image", "checkpoint"])
def test_train_unported_options_raise(synth_scene, tmp_path, extra):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.main(["-s", synth_scene, "-m", str(tmp_path / "x"), "--cpu", "--iterations",
                     "3", "--sh_degree", "0", "--quiet", *extra])


def test_train_requires_cuda_without_cpu_flag(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["-s", str(tmp_path), "-m", str(tmp_path / "o")])


def test_flags_match_gof_tpu():
    """The argparse groups give gof_tpu's flag names and defaults (the one
    difference: data_device names each package's device kind; neither reads
    it), and parse the same argv alike."""
    def parse(lib, argv):
        p = argparse.ArgumentParser()
        for cls in (lib.ModelParams, lib.PipelineParams, lib.OptimizationParams):
            lib.add_group(p, cls)
        return vars(p.parse_args(argv))

    argv = ["-s", "/data", "-m", "/out", "-r", "2", "--distortion_from_iter", "7",
            "--lambda_dssim", "0.3", "--eval", "--backend", "xla", "--key_capacity", "123",
            "--compact_capacity", "5", "--live_capacity", "9"]
    for args in ([], argv):
        got, want = parse(tconfig, args), parse(jconfig, args)
        assert got.pop("data_device") == "cuda" and want.pop("data_device") == "tpu"
        assert got == want
    ns = argparse.Namespace(**parse(tconfig, argv))
    assert tconfig.extract(tconfig.OptimizationParams, ns).distortion_from_iter == 7


def test_train_step_never_imports_jax(tmp_path):
    code = (
        "import sys, numpy as np, torch\n"
        "from gof_tpu_torch import cameras, config, train\n"
        "from gof_tpu_torch.model import gaussians as gm\n"
        "rng = np.random.default_rng(0); n = 30\n"
        "pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.3 + [0, 0, 4]\n"
        "g, s = gm.init_from_points(pts, rng.uniform(0, 1, (n, 3)), 1, 64)\n"
        "opt = config.OptimizationParams(distortion_from_iter=0, depth_normal_from_iter=0)\n"
        "tx = train.make_optimizer(opt, 1.0)\n"
        "tp = train.TrainParams(gauss=g)\n"
        "step = train.build_train_step(opt, config.ModelParams(sh_degree=1, kernel_size=0.1),"
        " config.PipelineParams(), tx)\n"
        "cam = cameras.look_at_camera(eye=(0, 0, 0), target=(0, 0, 4.), width=40, height=32)\n"
        "tp, st, s, m = step(tp, tx.init(tp), s, torch.rand(3, 32, 40), 5, cam, torch.zeros(3))\n"
        "assert bool(torch.isfinite(m['loss'])) and st.count == 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'gof_tpu')]\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
