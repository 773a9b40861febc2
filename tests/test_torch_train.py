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
from gof_tpu_torch.model import appearance as tapp
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


def test_train_with_decoupled_appearance(synth_scene, tmp_path, monkeypatch):
    """--use_decoupled_appearance trains: every step's L1 goes through
    appearance_l1 at the camera's uid; the embeddings of the trained uids
    move and every other row keeps its initial bits; every network weight
    moves; the checkpoint carries app_net, app_emb and their moments bit for
    bit."""
    from gof_tpu_torch.model import appearance as tapp

    out = str(tmp_path / "app")
    uids = []
    spy_on(monkeypatch, tapp, "appearance_l1", uids, lambda a, r: a[4])
    ttrain.main(["-s", synth_scene, "-m", out, "--cpu", "--iterations", "10", "--sh_degree",
                 "1", "--kernel_size", "0.1", "--use_decoupled_appearance",
                 "--checkpoint_iterations", "10", "--test_iterations", "99", "--quiet"])
    assert len(uids) == 10
    recs = [r for r in log_records(out) if "loss" in r]
    assert recs[-1]["iter"] == 10 and np.isfinite(recs[-1]["loss"])
    path = os.path.join(out, "chkpnt10.pkl")
    tp, st, gs, it = ttrain.load_checkpoint(path)
    net0, emb0 = tapp.init_appearance(torch.Generator().manual_seed(0))
    trained = np.isin(np.arange(2048), uids)
    moved = (tp.app_emb != emb0).any(dim=1).numpy()
    assert (moved == trained).all()
    for (n, a), b in zip(tp.app_net.named_parameters(), net0.parameters()):
        assert not torch.equal(a.detach(), b), n
    assert st.count == 10 and (st.mu_app["emb"][~torch.from_numpy(trained)] == 0).all()
    path2 = ttrain.save_checkpoint(str(tmp_path), 10, tp, st, gs)
    tp2, st2, _, _ = ttrain.load_checkpoint(path2)
    for k, a in ttrain.app_leaves(tp).items():
        assert torch.equal(a, ttrain.app_leaves(tp2)[k]), k
        assert torch.equal(st.mu_app[k], st2.mu_app[k]) and torch.equal(st.nu_app[k],
                                                                        st2.nu_app[k]), k


def test_opacity_reset_keeps_opacity_moments(synth_scene, tmp_path):
    """ROADMAP C14: a loop that resets the opacities at step 3 keeps
    opacity's Adam moments as they were, in the port and in gof_tpu (the
    original's reset replaces the optimizer's tensor and zeroes them). Each
    package runs 3 steps twice, with and without the reset, and checkpoints
    at 3: the opacities differ, the moments are bit-equal."""
    from gof_tpu import config as jconfig_

    argv = ["-s", synth_scene, "--cpu", "--iterations", "3", "--sh_degree", "1",
            "--kernel_size", "0.1", "--densify_from_iter", "100", "--densify_until_iter", "10",
            "--checkpoint_iterations", "3", "--test_iterations", "99", "--quiet"]
    port, gof = {}, {}
    for reset in (3, 1000):
        out = str(tmp_path / f"port{reset}")
        ttrain.main(argv + ["-m", out, "--opacity_reset_interval", str(reset)])
        port[reset] = ttrain.load_checkpoint(os.path.join(out, "chkpnt3.pkl"))
        out = str(tmp_path / f"gof{reset}")
        jtrain.training(
            jconfig_.ModelParams(source_path=synth_scene, model_path=out, sh_degree=1,
                                 kernel_size=0.1),
            jconfig_.OptimizationParams(iterations=3, densify_from_iter=100,
                                        densify_until_iter=10, opacity_reset_interval=reset),
            jconfig_.PipelineParams(backend="xla", key_capacity=512), test_iterations=set(),
            save_iterations=set(), checkpoint_iterations={3}, quiet=True)
        gof[reset] = jtrain.load_checkpoint(os.path.join(out, "chkpnt3.pkl"))
    (tp_r, st_r, gs_r, _), (tp_n, st_n, *_) = port[3], port[1000]
    assert not torch.equal(tp_r.gauss.opacity, tp_n.gauss.opacity)
    assert float(tgm.filtered_opacity(tp_r.gauss, gs_r.filter_3d)[gs_r.active].max()) <= 0.0101
    for m in ("mu", "nu"):
        assert torch.equal(getattr(st_r, m).opacity, getattr(st_n, m).opacity), m
        assert float(getattr(st_r, m).opacity.abs().max()) > 0, m
    (jtp_r, jst_r, *_), (jtp_n, jst_n, *_) = gof[3], gof[1000]
    assert not np.array_equal(np.asarray(jtp_r.gauss.opacity), np.asarray(jtp_n.gauss.opacity))
    for m in ("mu_flat", "nu_flat"):
        a, b = np.asarray(getattr(jst_r, m))[-1], np.asarray(getattr(jst_n, m))[-1]  # opacity row
        np.testing.assert_array_equal(a, b)
        assert np.abs(a).max() > 0, m


# ---------------------------------------------------------------------------
# The loop: densification, pool growth, checkpoints, --debug, debug images,
# the profiler and TensorBoard
# ---------------------------------------------------------------------------


def spy_on(monkeypatch, module, name, calls, record):
    """Wrap module.name so every call appends record(args, result)."""
    orig = getattr(module, name)

    def spy(*args, **kw):
        res = orig(*args, **kw)
        calls.append(record(args, res))
        return res

    monkeypatch.setattr(module, name, spy)


def log_records(out):
    return [json.loads(line) for line in open(os.path.join(out, "train_log.jsonl"))]


@pytest.fixture(scope="module")
def loop_run(synth_scene, tmp_path_factory):
    """One CPU run with densification every 4 steps in (3, 17), debug
    images every 6 steps, the profiler, checkpoints at 8 and 18 and the
    TensorBoard writer; densify_and_prune is spied on."""
    out = str(tmp_path_factory.mktemp("loop") / "out")
    prof = os.path.join(out, "prof")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        spy_on(mp, tgm, "densify_and_prune", calls,
               lambda a, r: (int(a[1].active.sum()), [int(x) for x in r[3]]))
        tp, gs = ttrain.main(["-s", synth_scene, "-m", out, "--cpu", "--iterations", "18",
                              "--sh_degree", "1", "--kernel_size", "0.1",
                              "--densify_from_iter", "3", "--densification_interval", "4",
                              "--densify_until_iter", "17", "--opacity_reset_interval", "100",
                              "--checkpoint_iterations", "8", "18", "--test_iterations", "18",
                              "--debug_image_interval", "6", "--profile_dir", prof, "--quiet"])
    return out, prof, calls, tp, gs


def test_train_densifies_at_gof_tpu_iterations(loop_run):
    """densify_and_prune runs at gof_tpu's iterations (train.py:921-923:
    from < it < until, it % interval == 0), and the run reaches its end."""
    out, _, calls, tp, gs = loop_run
    want = [i for i in range(1, 19) if 3 < i < 17 and i % 4 == 0]
    recs = log_records(out)
    assert len(calls) == len(want) == 4
    # each densification starts from the count the one before left
    assert calls[0][0] == 64
    for (n, (cloned, split, pruned, overflow)), (n_next, _) in zip(calls, calls[1:]):
        assert n_next == n + cloned + split - pruned and not overflow
    assert all(rep[1] > 0 for _, rep in calls)  # splits every time
    assert recs[-1]["iter"] == 18 and "eval" in recs[-1]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert int(gs.active.sum()) != 64
    assert tp.gauss.xyz.shape[0] == (2048 if calls[-1][1][3] else 1024)
    ply = os.path.join(out, "point_cloud", "iteration_18", "point_cloud.ply")
    assert int(np.asarray(jscene.load_gaussians_ply(ply, 1)[1].active).sum()) == int(
        gs.active.sum())


def test_train_debug_images_match_gof_tpu_grid(loop_run):
    from PIL import Image

    from gof_tpu.utils import vis as jvis
    from gof_tpu_torch.utils import vis as tvis

    out = loop_run[0]
    pngs = sorted(os.listdir(os.path.join(out, "debug")))
    assert pngs == ["iter_000006.png", "iter_000012.png", "iter_000018.png"]
    assert np.asarray(Image.open(os.path.join(out, "debug", pngs[0]))).shape == (128, 192, 3)
    rng = np.random.default_rng(11)
    img9 = rng.normal(0.5, 0.6, (9, 20, 30)).astype(np.float32)
    gt = rng.uniform(0, 1, (3, 20, 30)).astype(np.float32)
    np.testing.assert_array_equal(tvis.debug_grid(img9, gt), jvis.debug_grid(img9, gt))


def test_train_profile_dir_writes_a_trace(loop_run):
    """--profile_dir traces the run's first 20 iterations (all 18 here),
    the program's spans among the profiler's events, and writes them to
    spans.jsonl beside trace.json."""
    trace = json.load(open(os.path.join(loop_run[1], "trace.json")))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    assert {"step", "k1", "adam"} <= names
    with open(os.path.join(loop_run[1], "spans.jsonl")) as f:
        spans = [json.loads(line) for line in f]
    steps = sorted(s["uid"] for s in spans if s["name"] == "step" and s["kind"] == "step")
    assert steps == list(range(1, 19))


def test_train_writes_tensorboard_scalars(loop_run):
    import glob

    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    files = glob.glob(os.path.join(loop_run[0], "events.out.tfevents.*"))
    assert len(files) == 1
    acc = EventAccumulator(files[0])
    acc.Reload()
    tags = acc.Tags()["scalars"]
    assert set(tags) == {"train_loss_patches/total_loss", "train/psnr", "total_points",
                         "iter_time"}
    assert [e.step for e in acc.Scalars("total_points")] == [1, 10]


def test_train_e2e_with_densify(synth_scene, tmp_path):
    """tests/test_train_e2e.py::test_pallas_interpret_with_densify on the
    plain CPU path: densify at 10 and 20, opacity reset at 25, a finite
    loss, and a checkpoint that loads."""
    out = str(tmp_path / "out2")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        spy_on(mp, tgm, "densify_and_prune", calls, lambda a, r: "densify")
        spy_on(mp, tgm, "reset_opacity", calls, lambda a, r: "reset")
        ttrain.main(["-s", synth_scene, "-m", out, "--cpu", "--iterations", "30",
                     "--sh_degree", "1", "--kernel_size", "0.1", "--densify_from_iter", "9",
                     "--densify_until_iter", "30", "--densification_interval", "10",
                     "--opacity_reset_interval", "25", "--distortion_from_iter", "5",
                     "--depth_normal_from_iter", "5", "--checkpoint_iterations", "30",
                     "--test_iterations", "99", "--quiet"])
    assert calls == ["densify", "densify", "reset"]
    final = [r for r in log_records(out) if "loss" in r][-1]
    assert final["iter"] == 30 and np.isfinite(final["loss"])
    tp, st, gs, it = ttrain.load_checkpoint(os.path.join(out, "chkpnt30.pkl"))
    assert it == 30 and st.count == 30 and int(gs.active.sum()) == final["points"]
    # the reset at 25 left every filtered opacity at 0.01; 5 steps move it little
    op = tgm.filtered_opacity(tp.gauss, gs.filter_3d)[gs.active]
    assert float(op.max()) < 0.05


def test_train_grows_the_pool_on_overflow(synth_scene, tmp_path, monkeypatch):
    """A pool too small for one densification: the step drops the excess
    (C12), reports pool_overflow, and the loop doubles the pool and trains
    on."""
    out = str(tmp_path / "grow")
    reports, grows = [], []
    monkeypatch.setattr(ttrain, "pool_capacity", lambda n: 80)
    spy_on(monkeypatch, tgm, "densify_and_prune", reports, lambda a, r: r[3])
    spy_on(monkeypatch, ttrain, "grow_capacity", grows, lambda a, r: a[3:])
    # densify at 3 only
    tp, gs = ttrain.main(["-s", synth_scene, "-m", out, "--cpu", "--iterations", "10",
                          "--sh_degree", "1", "--densify_from_iter", "1",
                          "--densification_interval", "3", "--densify_until_iter", "4",
                          "--densify_grad_threshold", "1e-12", "--quiet"])
    assert len(reports) == 1 and bool(reports[0].pool_overflow)
    assert grows == [(80, 160)]
    assert tp.gauss.xyz.shape[0] == 160 and gs.active.shape[0] == 160
    assert int(reports[0].n_split) + int(reports[0].n_cloned) > 16
    recs = [r for r in log_records(out) if "loss" in r]
    assert recs[-1]["iter"] == 10 and np.isfinite(recs[-1]["loss"])
    assert recs[-1]["points"] <= 80  # nothing was placed past the old pool


def random_train_state(seed, cap=64, n_active=50):
    rng = np.random.default_rng(seed)
    params, state = model(rng, cap, n_active)
    state = state._replace(grad_accum=rng.uniform(0, 1, cap).astype(np.float32),
                           denom=rng.integers(0, 4, cap).astype(np.float32))
    g, s = tgm.from_numpy(params, state)
    ncol = sum(jtrain._gauss_cols(params))
    adam = jtrain.FusedAdamState(count=np.int32(23),
                                 mu_flat=rng.normal(0, 1e-3, (ncol, cap)).astype(np.float32),
                                 nu_flat=rng.uniform(0, 1e-6, (ncol, cap)).astype(np.float32))
    return params, state, adam, ttrain.TrainParams(gauss=g), ttrain.from_numpy(adam, g), s


def assert_same_state(a, b):
    """(TrainParams, AdamState, GaussianState) pairs equal bit for bit."""
    (tp1, st1, gs1), (tp2, st2, gs2) = a, b
    for f in ttrain.GAUSS_FIELDS:
        assert torch.equal(getattr(tp1.gauss, f).detach(), getattr(tp2.gauss, f).detach()), f
        for m in ("mu", "nu"):
            assert torch.equal(getattr(getattr(st1, m), f), getattr(getattr(st2, m), f)), (m, f)
    for f in ttrain.STATE_FIELDS:
        assert torch.equal(getattr(gs1, f), getattr(gs2, f)), f
    assert st1.count == st2.count


def test_checkpoint_save_load_round_trip(tmp_path):
    import pickle

    *_, tp, st, gs = random_train_state(12)
    path = ttrain.save_checkpoint(str(tmp_path), 7, tp, st, gs)
    assert path == str(tmp_path / "chkpnt7.pkl")
    tp2, st2, gs2, it = ttrain.load_checkpoint(path)
    assert it == 7
    assert_same_state((tp, st, gs), (tp2, st2, gs2))
    blob = pickle.load(open(path, "rb"))  # plain dicts of numpy arrays and ints
    assert sorted(blob) == ["adam", "gauss", "gstate", "iter"]
    assert all(type(v) is np.ndarray for k in ("gauss", "gstate") for v in blob[k].values())
    assert blob["adam"]["mu_flat"].shape == (23, 64) and type(blob["adam"]["count"]) is int


def test_load_gof_tpu_checkpoint(tmp_path):
    """A checkpoint written by gof_tpu.train.save_checkpoint (appearance
    network included) loads into the port bit for bit."""
    from gof_tpu.model import appearance as japp

    params, state, adam, *_ = random_train_state(13)
    net, emb = japp.init_appearance(jax.random.PRNGKey(0))
    jtp = jtrain.TrainParams(gauss=jax.tree.map(jnp.asarray, params), app_net=net, app_emb=emb)
    moments = jax.tree.map(jnp.zeros_like, (net, emb))
    jst = adam._replace(mu_app=moments, nu_app=moments)
    jtrain.save_checkpoint(str(tmp_path), 40, jtp, jst, jax.tree.map(jnp.asarray, state))
    path = str(tmp_path / "chkpnt40.pkl")
    tp, st, gs, it = ttrain.load_checkpoint(path)
    wtp, wst, wgs, wit = jtrain.load_checkpoint(path)
    assert it == wit == 40
    for f in ttrain.GAUSS_FIELDS:
        np.testing.assert_array_equal(getattr(tp.gauss, f).numpy(),
                                      np.asarray(getattr(wtp.gauss, f)))
    for f in ttrain.STATE_FIELDS:
        np.testing.assert_array_equal(getattr(gs, f).numpy(), np.asarray(getattr(wgs, f)))
    back = ttrain.adam_to_numpy(st)
    assert back.count == int(wst.count) == 23
    np.testing.assert_array_equal(back.mu_flat, np.asarray(wst.mu_flat))
    np.testing.assert_array_equal(back.nu_flat, np.asarray(wst.nu_flat))


def test_checkpoint_unpickler_maps_main_and_refuses_other_modules(tmp_path, monkeypatch):
    """gof_tpu's classes pickled under __main__ (by `python -m
    gof_tpu.train`) load; a checkpoint naming any other module is refused
    with that module's name."""
    import collections
    import pickle
    import sys

    params, state, adam, *_ = random_train_state(14)
    main = sys.modules["__main__"]
    for cls in (jtrain.TrainParams, jtrain.FusedAdamState):
        monkeypatch.setattr(cls, "__module__", "__main__")
        monkeypatch.setattr(main, cls.__name__, cls, raising=False)
    blob = {"tp": jtrain.TrainParams(gauss=params, app_net=None, app_emb=None),
            "opt_state": adam, "gstate": state, "iter": 5}
    with open(tmp_path / "main.pkl", "wb") as f:
        pickle.dump(blob, f)
    assert b"__main__" in open(tmp_path / "main.pkl", "rb").read()
    tp, st, gs, it = ttrain.load_checkpoint(str(tmp_path / "main.pkl"))
    assert it == 5 and st.count == 23
    np.testing.assert_array_equal(tp.gauss.xyz.numpy(), params.xyz)
    with open(tmp_path / "bad.pkl", "wb") as f:
        pickle.dump({"iter": collections.OrderedDict()}, f)
    with pytest.raises(pickle.UnpicklingError, match="collections.OrderedDict"):
        ttrain.load_checkpoint(str(tmp_path / "bad.pkl"))


class _LoadsAFile:
    """Pickles as a call of numpy.load(path, None, True): allow_pickle on."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return np.load, (self.path, None, True)


def test_checkpoint_unpickler_refuses_numpy_functions(tmp_path):
    """Of numpy, only what arrays and scalars need loads: a checkpoint that
    calls numpy.load (which could unpickle any file) is refused."""
    import pickle

    np.save(tmp_path / "x.npy", np.arange(3))
    with open(tmp_path / "bad.pkl", "wb") as f:
        pickle.dump({"iter": _LoadsAFile(str(tmp_path / "x.npy"))}, f)
    with pytest.raises(pickle.UnpicklingError, match="numpy.load"):
        ttrain.load_checkpoint(str(tmp_path / "bad.pkl"))


def legacy_opt_state(count, mu, nu):
    """An older gof_tpu's optimizer state: Adam's moments as TrainParams
    trees (numpy leaves) in a 3-field FusedAdamState, as gof_tpu's legacy
    migration (train.py:1231-1244) reads it."""
    return jtrain.FusedAdamState(np.int32(count), mu, nu)


def assert_loads_like_gof_tpu(path, with_app):
    """Both packages' load_checkpoint of `path` agree bit for bit: the
    gaussians, the GaussianState, Adam's count and moments, and the
    appearance network, embeddings and their moments."""
    tp, st, gs, it = ttrain.load_checkpoint(path)
    wtp, wst, wgs, wit = jtrain.load_checkpoint(path)
    assert it == wit
    for f in ttrain.GAUSS_FIELDS:
        got, want = getattr(tp.gauss, f).numpy(), np.asarray(getattr(wtp.gauss, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    for f in ttrain.STATE_FIELDS:
        np.testing.assert_array_equal(getattr(gs, f).numpy(), np.asarray(getattr(wgs, f)))
    back = ttrain.adam_to_numpy(st)
    assert back.count == int(wst.count)
    for m in ("mu_flat", "nu_flat"):
        got, want = getattr(back, m), np.asarray(getattr(wst, m))
        assert got.dtype == want.dtype and np.array_equal(got, want), m
    if not with_app:
        assert tp.app_net is None and st.mu_app is None and wst.mu_app is None
        return tp, st, gs
    pairs = [(tapp.app_to_numpy(tp.app_net, tp.app_emb), (wtp.app_net, wtp.app_emb)),
             (back.mu_app, wst.mu_app), (back.nu_app, wst.nu_app)]
    for got, want in pairs:
        got, want = jax.tree.leaves(got), jax.tree.leaves(want)
        assert len(got) == len(want) == 15
        for a, b in zip(got, want):
            assert np.array_equal(a, np.asarray(b))
    return tp, st, gs


@pytest.mark.parametrize("with_app", [False, True], ids=["gaussians", "appearance"])
def test_load_legacy_gof_tpu_checkpoint_matches_gof_tpu(tmp_path, with_app):
    """A legacy gof_tpu checkpoint (moments stored as TrainParams trees in a
    3-field FusedAdamState) loads into the port as gof_tpu's migration
    loads it, every field bit for bit, with and without the appearance
    state."""
    import pickle

    from gof_tpu.model import appearance as japp

    params, state, *_ = random_train_state(15)
    rng = np.random.default_rng(16)
    net = emb = None
    if with_app:
        net, emb = jax.tree.map(np.asarray, japp.init_appearance(jax.random.PRNGKey(1)))

    def moments(draw):
        app = jax.tree.map(lambda x: draw(np.shape(x)), (net, emb)) if with_app else (None, None)
        return jtrain.TrainParams(jgm.GaussianParams(*[draw(np.shape(x)) for x in params]), *app)

    mu = moments(lambda shape: rng.normal(0, 1e-3, shape).astype(np.float32))
    nu = moments(lambda shape: rng.uniform(0, 1e-6, shape).astype(np.float32))
    blob = {"tp": jtrain.TrainParams(gauss=params, app_net=net, app_emb=emb),
            "opt_state": legacy_opt_state(3, mu, nu), "gstate": state, "iter": 9}
    with open(tmp_path / "legacy.pkl", "wb") as f:
        pickle.dump(blob, f)
    tp, st, _ = assert_loads_like_gof_tpu(str(tmp_path / "legacy.pkl"), with_app)
    assert st.count == 3
    for f in ttrain.GAUSS_FIELDS:
        assert torch.equal(getattr(st.nu, f), torch.from_numpy(getattr(nu.gauss, f))), f


def test_chip_smoke_writes_legacy_checkpoints_gof_tpu_migrates(tmp_path):
    """chip_smoke.write_legacy_checkpoint (its resume entry's legacy file on
    the card) writes, without gof_tpu, a checkpoint that gof_tpu's loader
    migrates as a legacy one and the port loads bit for bit alike, equal to
    the state written."""
    import pickle

    import chip_smoke

    *_, tp, st, gs = random_train_state(17)
    path = chip_smoke.write_legacy_checkpoint(str(tmp_path / "legacy.pkl"), tp, st, gs, 20)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert type(raw["opt_state"]) is jtrain.FusedAdamState and raw["opt_state"].mu_app is None
    assert type(raw["opt_state"].mu_flat) is jtrain.TrainParams
    assert type(raw["gstate"]) is jgm.GaussianState
    got = assert_loads_like_gof_tpu(path, False)
    assert_same_state((tp, st, gs), got)


def test_resume_from_legacy_gof_tpu_checkpoint_matches_gof_tpu(synth_scene, tmp_path):
    """gof_tpu trains 3 steps with the appearance network and checkpoints;
    the checkpoint is rewritten in the legacy layout, its active gaussians
    at gof_tpu's gradient-test scales (ROADMAP C9); both packages load it
    bit for bit alike and resume one step from it with the flag. Over the
    active slots, Adam's moments lie within BOUND of their largest and the
    params within rtol 1e-5 where the step's gradient exceeds 1e-3 of its
    largest (test_torch_full_run.py::test_resumed_step_matches_gof_tpu);
    the appearance leaves within 1e-5 and their moments within BOUND."""
    import pickle

    ck = str(tmp_path / "gof")
    common = dict(densify_from_iter=100, densify_until_iter=10)
    model = dict(sh_degree=1, kernel_size=0.1, use_decoupled_appearance=True)
    pipe = jconfig.PipelineParams(backend="xla", key_capacity=512)
    jtrain.training(jconfig.ModelParams(source_path=synth_scene, model_path=ck, **model),
                    jconfig.OptimizationParams(iterations=3, **common), pipe,
                    test_iterations=set(), save_iterations=set(), checkpoint_iterations={3},
                    quiet=True)
    with open(os.path.join(ck, "chkpnt3.pkl"), "rb") as f:
        blob = pickle.load(f)
    tp, st = blob["tp"], blob["opt_state"]
    active = np.asarray(blob["gstate"].active)
    scaling = np.array(tp.gauss.scaling)
    scaling[active] = np.log(np.random.default_rng(3).uniform(
        0.3, 1.0, (int(active.sum()), 3))).astype(np.float32)
    blob["tp"] = tp._replace(gauss=tp.gauss._replace(scaling=scaling))

    def tree(flat, app):
        gauss = jax.tree.map(np.asarray, jtrain.unflatten_gauss_t(jnp.asarray(flat), tp.gauss))
        return jtrain.TrainParams(gauss, *app)

    blob["opt_state"] = legacy_opt_state(st.count, tree(st.mu_flat, st.mu_app),
                                         tree(st.nu_flat, st.nu_app))
    path = str(tmp_path / "legacy.pkl")
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    _, st0, _ = assert_loads_like_gof_tpu(path, True)
    out = str(tmp_path / "gof_resumed")
    jtrain.training(jconfig.ModelParams(source_path=synth_scene, model_path=out, **model),
                    jconfig.OptimizationParams(iterations=4, **common), pipe,
                    test_iterations=set(), save_iterations=set(), checkpoint_iterations={4},
                    start_checkpoint=path, quiet=True)
    want_tp, want_st, _, _ = ttrain.load_checkpoint(os.path.join(out, "chkpnt4.pkl"))
    port = str(tmp_path / "port_resumed")
    ttrain.main(["-s", synth_scene, "-m", port, "--cpu", "--sh_degree", "1", "--kernel_size",
                 "0.1", "--use_decoupled_appearance", "--iterations", "4",
                 "--densify_from_iter", "100", "--densify_until_iter", "10",
                 "--start_checkpoint", path, "--checkpoint_iterations", "4",
                 "--test_iterations", "99", "--quiet"])
    got_tp, got_st, _, it = ttrain.load_checkpoint(os.path.join(port, "chkpnt4.pkl"))
    assert it == 4 and got_st.count == want_st.count == 4 and st0.count == 3
    act = torch.from_numpy(active)
    assert int(act.sum()) > 0
    for f in ttrain.GAUSS_FIELDS:
        for m in ("mu", "nu"):
            got = getattr(getattr(got_st, m), f)[act].numpy()
            want = getattr(getattr(want_st, m), f)[act].numpy()
            assert rel_err(got, want) <= BOUND, (m, f, rel_err(got, want))
        grad = ((getattr(want_st.mu, f)[act].double() - 0.9 * getattr(st0.mu, f)[act].double())
                / 0.1).numpy()
        sel = np.abs(grad) > 1e-3 * np.abs(grad).max()
        if f != "features_rest":  # SH degree 0 at step 4: no rest gradient
            assert sel.any(), f
        if sel.any():
            close(getattr(got_tp.gauss, f)[act].detach().numpy()[sel],
                  getattr(want_tp.gauss, f)[act].detach().numpy()[sel])
    got, want = ttrain.app_leaves(got_tp), ttrain.app_leaves(want_tp)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].detach().numpy(),
                                   atol=1e-5, err_msg=k)
        for m in ("mu_app", "nu_app"):
            assert rel_err(getattr(got_st, m)[k].numpy(),
                           getattr(want_st, m)[k].numpy()) <= BOUND, (m, k)


def test_start_checkpoint_resumes_bit_exact(synth_scene, tmp_path, monkeypatch):
    """--start_checkpoint k: the loaded state equals, bit for bit, what the
    loop handed to save_checkpoint at k; one step from each gives the same
    state bit for bit; the resumed run logs k + 1 first."""
    out = str(tmp_path / "res")
    held = []

    def copy_state(args, _):
        tp, st, gs = args[2:5]
        grow = ttrain.grow_capacity  # a copy at the same capacity
        cap = gs.active.shape[0]
        return grow(tp, gs, st, cap, cap)

    spy_on(monkeypatch, ttrain, "save_checkpoint", held, copy_state)
    argv = ["-s", synth_scene, "-m", out, "--cpu", "--sh_degree", "1", "--kernel_size", "0.1",
            "--densify_from_iter", "1", "--densification_interval", "2",
            "--densify_until_iter", "6", "--quiet"]
    ttrain.main(argv + ["--iterations", "4", "--checkpoint_iterations", "4"])
    ckpt = os.path.join(out, "chkpnt4.pkl")
    tp, st, gs, it = ttrain.load_checkpoint(ckpt)
    htp, hgs, hst = held[0]
    assert it == 4 and len(held) == 1
    assert_same_state((htp, hst, hgs), (tp, st, gs))

    sc = tscene.Scene(synth_scene, "", shuffle=False)
    camera, gt = sc.camera(sc.train_cameras[2])
    opt = tconfig.OptimizationParams(densify_until_iter=6)
    mcfg = tconfig.ModelParams(sh_degree=1, kernel_size=0.1)
    tx = ttrain.make_optimizer(opt, sc.cameras_extent)
    step = ttrain.build_train_step(opt, mcfg, tconfig.PipelineParams(), tx, with_reg=False)
    a = step(htp, hst, hgs, t(gt), 5, camera, torch.zeros(3))
    b = step(tp, st, gs, t(gt), 5, camera, torch.zeros(3))
    assert_same_state(a[:3], b[:3])
    assert torch.equal(a[3]["loss"], b[3]["loss"])

    n_before = len(log_records(out))
    ttrain.main(argv + ["--iterations", "6", "--start_checkpoint", ckpt])
    recs = log_records(out)[n_before:]
    assert [r["iter"] for r in recs] == [5] and np.isfinite(recs[0]["loss"])


def test_train_debug_dumps_on_nonfinite_loss(synth_scene, tmp_path):
    """tests/test_train_e2e.py::test_debug_dumps_on_nonfinite_loss: a
    poisoned checkpoint resumed under --debug aborts with FloatingPointError
    after writing a snapshot npz of every render input."""
    import glob

    out = str(tmp_path / "dbg")
    argv = ["-s", synth_scene, "-m", out, "--cpu", "--sh_degree", "1", "--kernel_size", "0.1",
            "--densify_from_iter", "10000", "--densify_until_iter", "0",
            "--opacity_reset_interval", "100000", "--distortion_from_iter", "5",
            "--depth_normal_from_iter", "5", "--debug", "--quiet"]
    ttrain.main(argv + ["--iterations", "10", "--checkpoint_iterations", "10"])
    ckpt = os.path.join(out, "chkpnt10.pkl")
    tp, st, gs, _ = ttrain.load_checkpoint(ckpt)
    tp.gauss.features_dc[0] = float("nan")  # rgb -> NaN -> image -> loss
    ttrain.save_checkpoint(out, 10, tp, st, gs)
    with pytest.raises(FloatingPointError, match="snapshot_iter"):
        ttrain.main(argv + ["--iterations", "30", "--start_checkpoint", ckpt])
    dumps = glob.glob(os.path.join(out, "debug", "snapshot_iter*.npz"))
    assert [os.path.basename(d) for d in dumps] == ["snapshot_iter000011.npz"]
    blob = np.load(dumps[0])
    assert {"gauss_xyz", "gstate_active", "adam_count", "adam_mu_flat", "adam_nu_flat",
            "packed_metrics"} <= set(blob.files)
    assert not {"key_capacity", "compact_capacity", "n_inner"} & set(blob.files)
    assert not np.isfinite(blob["packed_metrics"][:, 0]).all()
    assert np.isnan(blob["gauss_features_dc"][0]).any()
    assert blob["adam_mu_flat"].shape == (23, 1024) and int(blob["adam_count"]) == 11


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
    """A train step, loading a checkpoint that gof_tpu wrote and importing
    the parallel package import neither jax nor gof_tpu."""
    params, state, adam, *_ = random_train_state(15)
    jtrain.save_checkpoint(str(tmp_path), 3, jtrain.TrainParams(
        gauss=params, app_net=None, app_emb=None), adam, state)
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
        f"tp, st, s, it = train.load_checkpoint({str(tmp_path / 'chkpnt3.pkl')!r})\n"
        "assert it == 3 and st.count == 23 and tp.gauss.xyz.shape == (64, 3)\n"
        "from gof_tpu_torch.parallel import sharding, steps\n"
        "from gof_tpu_torch.scripts import run_benchmarks\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'gof_tpu')]\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
