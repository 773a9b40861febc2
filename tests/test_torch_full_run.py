"""The default training schedule at length (A.20), scaled down: gof_tpu's
loop against gof_tpu_torch's on the CPU.

The full-length run itself runs on the card (`python3 chip_smoke.py
--full`, and the default smoke's `full_run` phase compresses it to 4500
steps). Here tests/make_synthetic_scene.py's scene (16 gaussians, 8 views
at 64x64) trains 19 steps with the default schedule's transitions in
order: densification every 3 steps in (2, 15), the opacity reset at the
last densification, the statistics in the step up to 15, the regularizers
from 15, culling from 16 (the port; C19). A reset is kept at the last
densification: a densification fewer than ~30 steps after a reset prunes
every gaussian (the loop's 0.05 opacity literal). The SH degree steps at
every 1000 steps, so a checkpoint gof_tpu wrote past densify_until_iter
is resumed at 2998 in both packages (its gaussians at gof_tpu's
gradient-test scales, C9), and each package's step, as its loop built
it, is also called at 999 / 1000 and 1999 / 2000.

gof_tpu runs its Pallas kernels in interpret mode. The state after the first
resumed step is held to tests/test_torch_train.py::
test_train_step_matches_gof_tpu's bounds over the active slots (C15):
Adam's moments within 1e-4 of their largest magnitude, the params within
rtol 1e-5 where the step's gradient exceeds 1e-3 of its largest. At the
checkpoint's own trained scales both packages' f32 steps are held against
the port's step in float64 instead (C30). A slow case runs both loops a
few hundred steps on the procedural scene (C27).
"""

import inspect
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import train as jtrain
from gof_tpu.model import gaussians as jgm
from gof_tpu_torch import train as ttrain
from gof_tpu_torch.model import gaussians as tgm
from gof_tpu_torch.ops import binning as tb

from make_synthetic_scene import make_scene

torch.set_num_threads(2)

BOUND = 1e-4
UNTIL, RESET, ITERS = 15, 12, 19
SCHEDULE = ["--sh_degree", "3", "--kernel_size", "0.1", "--densify_from_iter", "2",
            "--densification_interval", "3", "--densify_until_iter", str(UNTIL),
            "--opacity_reset_interval", str(RESET), "--distortion_from_iter", str(UNTIL),
            "--depth_normal_from_iter", str(UNTIL), "--key_capacity", "4096", "--quiet"]
RESUME_AT = 2998  # the resumed runs take steps 2999 and 3000 (SH degree 2, then 3)
SH_CALLS = (999, 1000, 1999, 2000)


class Spy:
    """Records, per loop step, the iteration, the built step's flags, the
    cache row it got, the SH degree its render used; every densify call's
    iteration, size-prune flag and active count after it; every opacity
    reset's iteration. Keeps the first step built and the arguments of its
    first call. With `gof_noise` the port's densify calls take gof_tpu's
    draws instead of the loop's own."""

    def __init__(self, gof_noise: bool = False):
        self.steps, self.densify, self.resets, self.degrees = [], [], [], []
        self.step, self.args, self.counts, self.gof_noise = None, None, [], gof_noise

    @property
    def iteration(self):
        return self.steps[-1]["iter"]


def port_copy(tp, st, gs):
    """A copy of the loop's (TrainParams, AdamState, GaussianState)."""
    cap = gs.active.shape[0]
    tp, gs, st = ttrain.grow_capacity(tp, gs, st, cap, cap)
    return tp, st, gs


def port_spies(mp, spy: Spy):
    """The port's loop calls, their arguments read by name."""
    build, densify, reset, shs = (ttrain.build_train_step, tgm.densify_and_prune,
                                  tgm.reset_opacity, ttrain.masked_shs)
    build_sig, densify_sig = inspect.signature(build), inspect.signature(densify)

    def built(*a, **k):
        step = build(*a, **k)
        flags = build_sig.bind(*a, **k)
        flags.apply_defaults()
        if spy.step is None:
            spy.step = step

        def recorded(*args, lim=None):
            if spy.args is None:
                spy.args = port_copy(*args[:3]), args[3:]
            spy.degrees.clear()
            res = step(*args, lim=lim)
            spy.steps.append({"iter": int(args[4]), "stats": flags.arguments["with_stats"],
                              "reg": flags.arguments["with_reg"],
                              "lim": None if lim is None else lim.clone(),
                              "degree": list(spy.degrees)})
            return res

        return recorded

    key = [jax.random.PRNGKey(0)]

    def densified(*a, **k):
        args = densify_sig.bind(*a, **k).arguments
        spy.densify.append((spy.iteration, bool(args["use_size_prune"])))
        if spy.gof_noise:  # gof_tpu's draws (its loop's key chain, C13)
            key[0], sub = jax.random.split(key[0])
            cap = args["params"].xyz.shape[0]
            args["noise"] = tuple(torch.from_numpy(np.array(jax.random.normal(k, (cap, 3))))
                                  for k in jax.random.split(sub, 3))
        res = densify(**args)
        spy.counts.append(int(res.state.active.sum()))
        return res

    def reset_op(*a):
        spy.resets.append(spy.iteration)
        return reset(*a)

    def masked(params, degree, max_degree):
        spy.degrees.append(int(degree))
        return shs(params, degree, max_degree)

    mp.setattr(ttrain, "build_train_step", built)
    mp.setattr(tgm, "densify_and_prune", densified)
    mp.setattr(tgm, "reset_opacity", reset_op)
    mp.setattr(ttrain, "masked_shs", masked)


def gof_spies(mp, spy: Spy):
    """gof_tpu's loop jits densify_and_prune and reset_opacity itself; the
    densify call goes through train._densify, the reset through the jit of
    gm.reset_opacity (wrapped where jax.jit makes it); the SH degree is
    traced, so its masked_shs reports it through jax.debug.callback."""
    build, densify, jit, shs = jtrain.build_train_step, jtrain._densify, jax.jit, \
        jtrain.masked_shs

    def built(*a, **k):
        step = build(*a, **k)
        if spy.step is None:
            spy.step = step

        def recorded(*args, **kw):
            if spy.args is None:
                spy.args = jax.tree.map(jnp.copy, args[:3]), args[3:]
            spy.degrees.clear()
            res = step(*args, **kw)
            jax.block_until_ready(res)
            jax.effects_barrier()
            spy.steps.append({"iter": int(args[4]), "stats": k["with_stats"],
                              "reg": k["with_reg"], "lim": k.get("live_ntiles", 0) or None,
                              "degree": sorted(set(spy.degrees))})
            return res

        return recorded

    def densified(fn, tp, gstate, opt_state, key, use_size):
        spy.densify.append((spy.iteration, bool(use_size)))
        res = densify(fn, tp, gstate, opt_state, key, use_size)
        spy.counts.append(int(np.asarray(res[1].active).sum()))
        return res

    def jit_spy(fun, *a, **kw):
        out = jit(fun, *a, **kw)
        if fun is not jgm.reset_opacity:
            return out

        def reset_op(*args):
            spy.resets.append(spy.iteration)
            return out(*args)

        return reset_op

    def masked(params, degree, max_degree):
        jax.debug.callback(lambda d: spy.degrees.append(int(d)), degree)
        return shs(params, degree, max_degree)

    mp.setattr(jtrain, "build_train_step", built)
    mp.setattr(jtrain, "_densify", densified)
    mp.setattr(jax, "jit", jit_spy)
    mp.setattr(jtrain, "masked_shs", masked)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both loops through the scaled schedule, spied on; gof_tpu also
    checkpoints at 17 (past densify_until_iter)."""
    root = tmp_path_factory.mktemp("full_run")
    scene = str(root / "scene")
    make_scene(scene, n_gaussians=16, n_views=8, size=64)
    argv = ["-s", scene, "--iterations", str(ITERS), *SCHEDULE, "--test_iterations", "99",
            "--cpu"]
    spies = {"port": Spy(gof_noise=True), "gof": Spy()}
    with pytest.MonkeyPatch.context() as mp:
        port_spies(mp, spies["port"])
        ttrain.main(argv + ["-m", str(root / "port")])
    with pytest.MonkeyPatch.context() as mp:
        gof_spies(mp, spies["gof"])
        jtrain.main(argv + ["-m", str(root / "gof"), "--checkpoint_iterations", "17"])
    return scene, root, spies


def test_schedule_transitions_match_gof_tpu(runs):
    """Densify (and its size-prune flag), the opacity reset, the statistics
    leaving the step, the regularizers joining and the SH degree at the
    same iterations in both loops, each where the schedule puts it; the
    port's cache rows from densify_until_iter + 1, where gof_tpu drops the
    statistics (its culling also needs its TPU scan windows, C19)."""
    _, _, spies = runs
    port, gof = spies["port"], spies["gof"]
    its = list(range(1, ITERS + 1))
    for spy in (port, gof):
        assert [s["iter"] for s in spy.steps] == its
        assert spy.densify == [(i, False) for i in (3, 6, 9, 12)]
        assert spy.resets == [RESET]
        assert [s["iter"] for s in spy.steps if s["stats"]] == list(range(1, UNTIL + 1))
        assert [s["iter"] for s in spy.steps if s["reg"]] == list(range(UNTIL, ITERS + 1))
        assert all(s["degree"] == [0] for s in spy.steps)
    for key in ("stats", "reg", "degree"):
        assert [s[key] for s in port.steps] == [s[key] for s in gof.steps], key
    assert [s["iter"] for s in port.steps if s["lim"] is not None] == list(
        range(UNTIL + 1, ITERS + 1))
    assert all(s["lim"] is None for s in gof.steps)  # interpret mode: no culling (C19)
    # the first culled step of each camera walks a fresh row
    assert (port.steps[UNTIL]["lim"] == tb.LIM_INF).all()


def test_densification_follows_gof_tpu_given_its_noise(runs):
    """The loop densifies as gof_tpu's does when it draws gof_tpu's noise
    (C13): the same active count after every densification of the scaled
    schedule. The full-length run ends with more gaussians than
    VALIDATION.md's gof_tpu run (ROADMAP C27); at this size the two loops
    do not part."""
    _, _, spies = runs
    port, gof = spies["port"], spies["gof"]
    assert port.counts == gof.counts
    assert port.counts[-1] > 16 and len(set(port.counts)) > 1


def relabel(src: str, dst: str, iteration: int, rescale: bool = True) -> str:
    """gof_tpu's checkpoint `src` as written at `iteration`, with `rescale`
    its active gaussians at gof_tpu's gradient-test scales (0.3-1.0,
    seeded): at the trained scales (0.02-0.08 here) both packages' scaling
    and rotation gradients sit off float64 by the f32 cancellation of
    ROADMAP C9 (test_trained_scales_against_float64 holds them there)."""
    with open(src, "rb") as f:
        blob = pickle.load(f)
    if rescale:
        g, active = blob["tp"].gauss, np.asarray(blob["gstate"].active)
        scaling = np.array(g.scaling)
        rng = np.random.default_rng(3)
        scaling[active] = np.log(rng.uniform(0.3, 1.0, (int(active.sum()), 3))).astype(
            np.float32)
        blob["tp"] = blob["tp"]._replace(gauss=g._replace(scaling=scaling))
    blob["iter"] = iteration
    with open(dst, "wb") as f:
        pickle.dump(blob, f)
    return dst


@pytest.fixture(scope="module")
def resumed(runs):
    """gof_tpu's checkpoint at 17, relabelled 2998, resumed by both loops
    for two steps (gof_tpu's Pallas kernels in interpret mode), each
    checkpointing both; then each package's first built step called at
    SH_CALLS on copies of its first step's inputs."""
    scene, root, _ = runs
    ckpt = relabel(str(root / "gof" / "chkpnt17.pkl"), str(root / "relabelled.pkl"), RESUME_AT)
    argv = ["-s", scene, "--iterations", str(RESUME_AT + 2), *SCHEDULE,
            "--start_checkpoint", ckpt, "--checkpoint_iterations", str(RESUME_AT + 1),
            str(RESUME_AT + 2), "--save_iterations", "99999", "--cpu"]
    out, calls = {}, {}
    for name, lib, spies in (("port", ttrain, port_spies), ("gof", jtrain, gof_spies)):
        spy = Spy()
        with pytest.MonkeyPatch.context() as mp:
            spies(mp, spy)
            lib.main(argv + ["-m", str(root / f"{name}_resumed")])
            degrees = []
            for it in SH_CALLS:
                head, (gt, _, cam, bg) = spy.args
                if name == "port":
                    spy.degrees.clear()
                    spy.step(*port_copy(*head), gt, it, cam, bg)
                    degrees.append(list(spy.degrees))
                else:
                    spy.degrees.clear()
                    jax.block_until_ready(spy.step(*jax.tree.map(jnp.copy, head), gt,
                                                   jnp.int32(it), cam, bg))
                    jax.effects_barrier()
                    degrees.append(sorted(set(spy.degrees)))
        out[name] = spy
        calls[name] = degrees
    return root, ckpt, out, calls


def test_resume_past_densification_starts_late_and_sh_steps_match(resumed):
    """The first resumed step has the statistics off and the regularizers
    on in both packages, and in the port a fresh cache row; the SH degree
    steps at 3000 in both loops, and each package's step at 1000 and 2000."""
    _, _, spies, calls = resumed
    for name, spy in spies.items():
        assert [s["iter"] for s in spy.steps] == [RESUME_AT + 1, RESUME_AT + 2], name
        first = spy.steps[0]
        assert not first["stats"] and first["reg"], name
        assert [s["degree"] for s in spy.steps] == [[2], [3]], name
        assert calls[name] == [[0], [1], [1], [2]], name
        assert not spy.densify and not spy.resets, name
    assert (spies["port"].steps[0]["lim"] == tb.LIM_INF).all()


def test_resumed_step_matches_gof_tpu(resumed):
    """The state after the first resumed step, over the active slots:
    Adam's moments within BOUND of their largest magnitude, the params
    within rtol 1e-5 where the step's gradient exceeds 1e-3 of its largest,
    the same count and active set, the 3D filter within rtol 1e-5, the
    statistics as test_train_step_matches_gof_tpu holds them."""
    root, ckpt, _, _ = resumed
    it = RESUME_AT + 1
    _, st0, gs0, _ = ttrain.load_checkpoint(ckpt)
    tp, st, gs, k = ttrain.load_checkpoint(str(root / "port_resumed" / f"chkpnt{it}.pkl"))
    jtp, jst, jgs, jk = ttrain.load_checkpoint(str(root / "gof_resumed" / f"chkpnt{it}.pkl"))
    assert k == jk == it and st.count == jst.count == st0.count + 1
    act = gs0.active
    assert torch.equal(gs.active, act) and torch.equal(jgs.active, act) and int(act.sum()) > 0
    np.testing.assert_allclose(gs.filter_3d.numpy(), jgs.filter_3d.numpy(), rtol=1e-5)
    for f in ("max_radii2d", "denom"):
        np.testing.assert_array_equal(getattr(gs, f).numpy(), getattr(jgs, f).numpy(), f)
    for f in ("grad_accum", "grad_abs_accum"):
        np.testing.assert_allclose(getattr(gs, f).numpy(), getattr(jgs, f).numpy(), rtol=1e-5,
                                   atol=1e-5 * np.abs(getattr(jgs, f).numpy()).max(), err_msg=f)
    for f in ttrain.GAUSS_FIELDS:
        for m in ("mu", "nu"):
            got = getattr(getattr(st, m), f)[act].double().numpy()
            want = getattr(getattr(jst, m), f)[act].double().numpy()
            assert np.isfinite(got).all(), (m, f)
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= BOUND, (m, f, err)
        grad = ((getattr(jst.mu, f)[act].double() - 0.9 * getattr(st0.mu, f)[act].double())
                / 0.1).numpy()
        sel = np.abs(grad) > 1e-3 * np.abs(grad).max()
        if f != "features_rest":  # SH degree 2 at 2999: its bands have gradients too
            assert sel.any(), f
        if sel.any():
            got = getattr(tp.gauss, f)[act].detach().double().numpy()[sel]
            want = getattr(jtp.gauss, f)[act].detach().double().numpy()[sel]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                       err_msg=f)


# a quantity of the port's f32 step passes where it lies within BOUND of the
# float64 step, or within FP64_RATIO times gof_tpu's f32 distance from it
# (chip_smoke.py holds the card to the CPU's distance the same way)
FP64_RATIO = 2.0
FD_STEP = 1e-7  # the central differences' step on the float64 params
FD_RTOL = 1e-3  # of the field's largest gradient


@pytest.fixture(scope="module")
def trained_scales(runs):
    """gof_tpu's checkpoint at 17, its trained scales kept, relabelled 2998
    and resumed by both loops for one step, each checkpointing it; the
    port's built step and the inputs of its call."""
    scene, root, _ = runs
    ckpt = relabel(str(root / "gof" / "chkpnt17.pkl"), str(root / "trained.pkl"), RESUME_AT,
                   rescale=False)
    argv = ["-s", scene, "--iterations", str(RESUME_AT + 1), *SCHEDULE, "--start_checkpoint",
            ckpt, "--checkpoint_iterations", str(RESUME_AT + 1), "--save_iterations", "99999",
            "--cpu"]
    spies = {}
    for name, lib, spy_on in (("port", ttrain, port_spies), ("gof", jtrain, gof_spies)):
        spies[name] = Spy()
        with pytest.MonkeyPatch.context() as mp:
            spy_on(mp, spies[name])
            lib.main(argv + ["-m", str(root / f"{name}_trained")])
    return root, ckpt, spies["port"]


def test_trained_scales_against_float64(trained_scales):
    """At the trained scales (0.02-0.08) the f32 chain of the scales and
    rotations cancels (ROADMAP C9), in both packages, so their steps part by
    more than test_train_step_matches_gof_tpu's bounds. The port's step in
    float64 on the same inputs is the witness: (1) in the statistics'
    instance with kernel_size 0 (the 2D dilation's opacity compensation is
    detached, as in gof_tpu and the reference, which a finite difference
    cannot follow; ROADMAP C30), its gradients of the xyz, scaling and
    rotation of the four gaussians with the largest scaling gradient agree
    with central differences of its loss within FD_RTOL of the field's
    largest; (2) as the loop built it, the port's f32 loss lies within 1e-5
    of its loss; (3) every moment of the port's f32 step lies within BOUND
    of it, or within FP64_RATIO times gof_tpu's distance, at its largest and
    in the L2 norm."""
    from dataclasses import replace

    from gof_tpu_torch import config as tconfig

    root, ckpt, spy = trained_scales
    it = RESUME_AT + 1
    _, st0, gs0, _ = ttrain.load_checkpoint(ckpt)
    act = gs0.active
    head, (gt, step_i, cam, bg) = spy.args
    lim = spy.steps[0]["lim"]

    def step64(step, perturb=None, **kw):
        tp, st, gs, c = ttrain.as_float64(*head, cam)
        if perturb is not None:
            f, i, j, h = perturb
            with torch.no_grad():
                getattr(tp.gauss, f)[i, j] += h
        return step(tp, st, gs, gt.double(), step_i, c, bg.double(), **kw)

    def grads(st):
        return {f: (getattr(st.mu, f) - 0.9 * getattr(st0.mu, f).double()) / 0.1
                for f in ttrain.GAUSS_FIELDS}

    cfg, pipe, opt = tconfig.load_cfg(str(root / "port_trained"))
    fd_step = ttrain.build_train_step(opt, replace(cfg, kernel_size=0.0), pipe,
                                      ttrain.make_optimizer(opt, 1.0), with_stats=True,
                                      with_reg=False)
    grad = grads(step64(fd_step)[1])
    top = torch.topk(torch.where(act, grad["scaling"].norm(dim=1), 0.0), 4).indices.tolist()
    for f in ("xyz", "scaling", "rotation"):
        for i in top:
            for j in range(grad[f].shape[1]):
                lo = float(step64(fd_step, (f, i, j, -FD_STEP))[3]["loss"])
                hi = float(step64(fd_step, (f, i, j, FD_STEP))[3]["loss"])
                fd = (hi - lo) / (2 * FD_STEP)
                err = abs(fd - float(grad[f][i, j])) / float(grad[f][act].abs().max())
                assert err <= FD_RTOL, (f, i, j, fd, float(grad[f][i, j]), err)
    _, st64, _, m64 = step64(spy.step, lim=lim.clone())
    loss32 = float(spy.step(*port_copy(*head), gt, step_i, cam, bg, lim=lim.clone())[3]["loss"])
    assert abs(loss32 - float(m64["loss"])) <= 1e-5 * float(m64["loss"])
    states = {}
    for name in ("port", "gof"):
        _, st, gs, k = ttrain.load_checkpoint(str(root / f"{name}_trained" / f"chkpnt{it}.pkl"))
        assert k == it and torch.equal(gs.active, act)
        states[name] = st
    bad = []
    for f in ttrain.GAUSS_FIELDS:
        for m in ("mu", "nu"):
            want = getattr(getattr(st64, m), f)[act]
            dist = {}
            for name, st in states.items():
                got = getattr(getattr(st, m), f)[act].double()
                dist[name] = (float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30),
                              float((got - want).norm()) / max(float(want.norm()), 1e-30))
            print(f"{m}.{f} against float64, max and L2: port {dist['port']}, gof_tpu "
                  f"{dist['gof']}")
            bad += [(m, f, k, dist) for k in (0, 1)
                    if not dist["port"][k] <= max(BOUND, FP64_RATIO * dist["gof"][k])]
    assert not bad, bad


def test_gaussian_in_the_camera_plane_keeps_finite_moments():
    """ROADMAP C26, found by the full-length run: a gaussian whose view
    depth is ~0 (it sits in the camera's plane) has an inf / NaN conic;
    the port's step carried the rasterizer's zero cotangent for the conic
    into the preprocess, where 0 times its partials gave its xyz, scaling
    and rotation NaN gradients, and Adam kept them for good. gof_tpu's step
    leaves them 0. Both packages take test_train_step_matches_gof_tpu's
    "reg" step on its scene (statistics and regularizers on, step 100) with
    gaussian 0 moved to view depth ~0: its moments are 0 in both, every
    moment of the port's is finite, and every other slot of the port's
    state is bit-equal to the step with gaussian 0 inactive."""
    from gof_tpu import cameras as jcam
    from gof_tpu import config as jconfig
    from gof_tpu_torch import cameras as tcam
    from gof_tpu_torch import config as tconfig

    rng = np.random.default_rng(7)
    n, n_active, width, height = 48, 40, 96, 64
    z = rng.uniform(4, 7, n)
    xyz = np.stack([rng.uniform(-1, 1, n) * z * 0.2, rng.uniform(-1, 1, n) * z * 0.2, z], -1)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    scaling = np.log(rng.uniform(0.2, 0.5, (n, 3)))
    op = rng.uniform(-1, 1, n)
    xyz[n_active:], scaling[n_active:], op[n_active:], q[n_active:] = 0.0, -10.0, 0.0, (1, 0, 0, 0)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    dc, rest = f32(rng.normal(0, 0.5, (n, 1, 3))), f32(rng.normal(0, 0.1, (n, 3, 3)))
    zf = np.zeros((n,), np.float32)
    filter_3d = f32(rng.uniform(1e-4, 5e-3, n))
    gt = rng.uniform(0, 1, (3, height, width)).astype(np.float32)
    cam = dict(eye=(0.1, -0.05, 0.0), target=(0, 0, 5.0), width=width, height=height)
    wv = tcam.look_at_camera(**cam).world_view.numpy().astype(np.float64)
    xyz[0, :2] = (0.7, 0.3)  # view depth wv[2] . (x, y, z, 1) = 0
    xyz[0, 2] = -(wv[2, 0] * 0.7 + wv[2, 1] * 0.3 + wv[2, 3]) / wv[2, 2]
    params = jgm.GaussianParams(xyz=f32(xyz), features_dc=dc, features_rest=rest,
                                scaling=f32(scaling), rotation=f32(q), opacity=f32(op))
    state = jgm.GaussianState(active=np.arange(n) < n_active, filter_3d=filter_3d,
                              max_radii2d=zf, grad_accum=zf, grad_abs_accum=zf, denom=zf)
    opt = jconfig.OptimizationParams(distortion_from_iter=0, depth_normal_from_iter=0)
    mcfg = dict(sh_degree=1, kernel_size=0.1)
    tx = jtrain.make_optimizer(opt, 5.0)
    tp0 = jtrain.TrainParams(gauss=jax.tree.map(jnp.asarray, params), app_net=None, app_emb=None)
    s0 = tx.init(tp0)
    jstep = jtrain.build_train_step(opt, jconfig.ModelParams(**mcfg),
                                    jconfig.PipelineParams(key_capacity=8192), tx, interpret=True,
                                    with_stats=True, with_reg=True)
    _, js, _, _ = jstep(tp0, s0, jax.tree.map(jnp.asarray, state), jnp.asarray(gt),
                        jnp.int32(100), jcam.look_at_camera(**cam), jnp.zeros(3))
    jmu = jtrain.unflatten_gauss_t(jnp.asarray(js.mu_flat), params)

    topt = tconfig.OptimizationParams(distortion_from_iter=0, depth_normal_from_iter=0)
    ttx = ttrain.make_optimizer(topt, 5.0)
    step = ttrain.build_train_step(topt, tconfig.ModelParams(**mcfg), tconfig.PipelineParams(),
                                   ttx, with_stats=True, with_reg=True)
    out = []
    for st0 in (state, state._replace(active=state.active & (np.arange(n) > 0))):
        g, s = tgm.from_numpy(params, st0)
        out.append(step(ttrain.TrainParams(gauss=g), ttrain.from_numpy(jax.device_get(s0), g),
                        s, torch.from_numpy(gt), 100, tcam.look_at_camera(**cam),
                        torch.zeros(3)))
    (tp, st, gs, _), (tp_b, st_b, gs_b, _) = out
    assert not bool(gs.denom[0]) and float(gs.max_radii2d[0]) == 0
    for f in ttrain.GAUSS_FIELDS:
        for m in ("mu", "nu"):
            got = getattr(getattr(st, m), f)
            assert torch.isfinite(got).all(), (m, f)
            # the invalid gaussian changes no other slot
            assert torch.equal(got[1:], getattr(getattr(st_b, m), f)[1:]), (m, f)
        np.testing.assert_array_equal(getattr(st.mu, f)[0].numpy().ravel(),
                                      np.asarray(getattr(jmu, f))[0].ravel(), err_msg=f)
        assert not np.asarray(getattr(jmu, f))[0].any(), f
        assert torch.equal(getattr(tp.gauss, f)[1:], getattr(tp_b.gauss, f)[1:]), f


# both loops a few hundred steps on the procedural scene, scaled down
# (ROADMAP C27): 96x64, 8 training views, ~1000 points; densification every
# 25 steps in (50, 260), the opacity reset at 200 and the size prune after
# it, the regularizers from 260. The counts may part by a few gaussians as
# the two packages' f32 roundings cross densify's thresholds differently;
# PARITY_RTOL (set before the first run) is far below C27's 1.7x.
PARITY = ["--iterations", "300", "--densify_from_iter", "50", "--densification_interval", "25",
          "--densify_until_iter", "260", "--opacity_reset_interval", "200",
          "--distortion_from_iter", "260", "--depth_normal_from_iter", "260",
          "--test_iterations", "99999", "--quiet", "--cpu"]
PARITY_RTOL = 0.05


@pytest.mark.slow
def test_procedural_scene_densifies_as_gof_tpu(tmp_path):
    """gof_tpu's loop (its Pallas kernels in interpret mode, ~6 s a step
    here) and the port's, the port drawing gof_tpu's densify noise (C13),
    through PARITY on the procedural scene: the same densify calls, each
    leaving an active count within PARITY_RTOL of gof_tpu's, and densification
    grows the model."""
    from gof_tpu_torch.scripts import make_procedural_scene as mps

    scene = str(tmp_path / "scene")
    mps.main(["--out", scene, "--width", "96", "--height", "64", "--views", "8",
              "--test-views", "2", "--points", "1000"])
    spies = {"port": Spy(gof_noise=True), "gof": Spy()}
    for name, lib, spy_on in (("port", ttrain, port_spies), ("gof", jtrain, gof_spies)):
        with pytest.MonkeyPatch.context() as mp:
            spy_on(mp, spies[name])
            lib.main(["-s", scene, "-m", str(tmp_path / name), *PARITY])
    port, gof = spies["port"], spies["gof"]
    print(f"active after each densify call: port {port.counts}, gof_tpu {gof.counts}")
    assert port.densify == gof.densify and len(gof.densify) == 8
    assert gof.counts[-1] > 1.2 * gof.counts[0]
    for got, want in zip(port.counts, gof.counts):
        assert abs(got - want) <= PARITY_RTOL * want, (port.counts, gof.counts)
