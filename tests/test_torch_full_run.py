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
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
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
    iteration, size-prune flag, active count after it and
    chip_smoke.densify_breakdown's record of it; every opacity reset's
    iteration. Keeps the first step built and the arguments of its first
    call. With `gof_noise` the port's densify calls take gof_tpu's draws
    instead of the loop's own."""

    def __init__(self, gof_noise: bool = False):
        self.steps, self.densify, self.resets, self.degrees = [], [], [], []
        self.step, self.args, self.counts, self.gof_noise = None, None, [], gof_noise
        self.breakdown, self.consts, self.builds = [], None, []

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
        spy.breakdown.append(chip_smoke.densify_breakdown(
            args["params"], args["state"], res.params, res.state, res.report, args["max_grad"],
            args["min_opacity"], args["extent"], args["percent_dense"], args["use_size_prune"]))
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
    gm.reset_opacity (wrapped where jax.jit makes it); densify's thresholds
    are read where the jit traces gm.densify_and_prune; the SH degree is
    traced, so its masked_shs reports it through jax.debug.callback."""
    build, densify, jit, shs = jtrain.build_train_step, jtrain._densify, jax.jit, \
        jtrain.masked_shs
    densify_and_prune = jgm.densify_and_prune

    build_sig = inspect.signature(build)

    def built(*a, **k):
        step = build(*a, **k)
        if spy.step is None:
            spy.step = step
        pipe = build_sig.bind(*a, **k).arguments["pipe"]
        spy.builds.append({"iter": spy.iteration if spy.steps else 0,
                           "keys": pipe.key_capacity, "compact": pipe.compact_capacity})

        def recorded(*args, **kw):
            if spy.args is None:
                spy.args = jax.tree.map(jnp.copy, args[:3]), args[3:]
            spy.degrees.clear()
            res = step(*args, **kw)
            jax.block_until_ready(res)
            jax.effects_barrier()
            # the packed metrics of each step the call ran: a step whose
            # keys or compact rows overflowed (or, where the row has it, whose
            # liveness bound was stale) made no update
            mp = np.atleast_2d(np.asarray(res[3].get("packed_all", res[3].get("packed"))))
            skip = (mp[:, 3] > 0) | (mp[:, 5] > 0) | ((mp[:, 9] > 0) if mp.shape[1] > 9 else False)
            spy.steps.append({"iter": int(args[4]), "stats": k["with_stats"],
                              "reg": k["with_reg"], "lim": k.get("live_ntiles", 0) or None,
                              "degree": sorted(set(spy.degrees)), "keys": int(mp[:, 2].max()),
                              "skipped": int(skip.sum())})
            return res

        return recorded

    def traced(p, s, o, k, max_grad, min_opacity, extent, percent_dense, use_size):
        spy.consts = (max_grad, min_opacity, float(extent), percent_dense)
        return densify_and_prune(p, s, o, k, max_grad, min_opacity, extent, percent_dense,
                                 use_size)

    def densified(fn, tp, gstate, opt_state, key, use_size):
        spy.densify.append((spy.iteration, bool(use_size)))
        res = densify(fn, tp, gstate, opt_state, key, use_size)
        spy.counts.append(int(np.asarray(res[1].active).sum()))
        spy.breakdown.append(chip_smoke.densify_breakdown(
            tp.gauss, gstate, res[0].gauss, res[1], res[3], *spy.consts, use_size))
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
    mp.setattr(jgm, "densify_and_prune", traced)
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
        jtrain.main(argv + ["-m", str(root / "gof"), "--checkpoint_iterations", "11", "17"])
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


def test_densify_breakdown_matches_gof_tpu(runs):
    """Given gof_tpu's noise, every densify call of the scaled schedule does
    the same in both loops by chip_smoke.densify_breakdown's record of it
    (the C27 ladder's): the counts before and after, the selection, the
    clones, splits, dropped placements and each prune criterion equal; the
    classic threshold's share of the selection within 2 gaussians and Q
    within 1% (the two loops' statistics part in their last bits: one
    gaussian at the threshold falls to the quantile half in one package
    and Q moves by 0.4%); each record accounts for its call's report."""
    _, _, spies = runs
    port, gof = spies["port"], spies["gof"]
    assert len(port.breakdown) == len(gof.breakdown) == 4
    split = ("classic", "quantile only")
    for a, b in zip(port.breakdown, gof.breakdown):
        assert a["accounted"] and b["accounted"]
        assert ({k: a[k] for k in chip_smoke.BREAKDOWN if k not in split}
                == {k: b[k] for k in chip_smoke.BREAKDOWN if k not in split}), (a, b)
        assert a["classic"] + a["quantile only"] == b["classic"] + b["quantile only"], (a, b)
        assert abs(a["classic"] - b["classic"]) <= 2, (a, b)
        assert a["Q"] == pytest.approx(b["Q"], rel=1e-2), (a, b)
    assert sum(b["clones"] + b["splits"] for b in gof.breakdown) > 0


def test_ladder_rung0_is_the_slow_tests_run():
    """The C27 ladder's rung 0 (chip_smoke.RUNGS, also the smoke's
    trajectory phase) is test_procedural_scene_densifies_as_gof_tpu's run:
    its scene and PARITY's schedule; every rung's schedule densifies,
    resets the opacities, prunes by size after the first reset and turns
    the regularizers on where densification ends; rungs 0-2 reset once and
    run steps past densification."""
    assert chip_smoke.RUNGS[0]["argv"] + ["--cpu"] == PARITY
    assert chip_smoke.RUNGS[0]["scene"] == ["--width", "96", "--height", "64", "--views", "8",
                                            "--test-views", "2", "--points", "1000"]
    for rung in chip_smoke.RUNGS:
        sched = chip_smoke.run_schedule(chip_smoke.rung_argv(rung))
        assert len(sched["densify"]) >= 8 and sched["reset"], rung
        assert sched["size_prune"] and sched["size_prune"][0] > sched["reset"][0], rung
        assert sched["reg_on"] == sched["until"] <= sched["iterations"], rung
        if rung < 3:
            assert len(sched["reset"]) == 1 and sched["until"] < sched["iterations"], rung


def test_ladder_rung3_runs_the_full_runs_regime():
    """Rung 3 has the full run's shape (ROADMAP C27): rung 2's scene, at
    least three opacity resets before densify_until_iter, at least 20
    densify calls at SH degree 3 (19 of them after the third reset), the
    size prune on every call after the first reset, and no key capacity of
    its own (each run sets it); --ladder runs its schedule at full size."""
    spec = chip_smoke.RUNGS[3]
    assert spec["scene"] == chip_smoke.RUNGS[2]["scene"]
    assert "--key_capacity" not in spec["argv"]
    sched = chip_smoke.run_schedule(chip_smoke.rung_argv(3))
    resets = [r for r in sched["reset"] if r < sched["until"]]
    assert len(resets) >= 3, sched["reset"]
    degree = lambda i: min(i // 1000, sched["sh_degree"])  # noqa: E731
    at3 = [i for i in sched["densify"] if degree(i) == 3]
    assert sched["sh_degree"] == 3 and len(at3) >= 20, at3
    assert len([i for i in at3 if i > resets[2]]) >= 19, at3
    assert sched["size_prune"] == [i for i in sched["densify"] if i > resets[0]]
    assert len(sched["densify"]) == 74 and resets == [1000, 2000, 3000]
    assert 3 in chip_smoke.FULL_SIZE_RUNGS


def test_ladder_table_reports_how_far_runs_part(tmp_path):
    """ladder_table (the ladder's table, PERF.md §5) pairs the runs of one
    rung, its calls at the same iterations, by the largest relative
    parting of their active counts, and no runs of two rungs; the card's
    ladder_card.json holds one run per rung."""
    import json

    def rec(afters, step=25):
        return [dict({k: 1 for k in chip_smoke.BREAKDOWN}, iter=step * (i + 1), use_size=False,
                     before=100, after=a, Q=1e-3, accounted=True) for i, a in enumerate(afters)]

    here = os.path.dirname(jtrain.__file__)
    for name, afters in (("a", [100, 200, 400]), ("b", [100, 210, 404])):
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump({"rung": 0, "run": "gof" if name == "a" else "port", "gof_tpu": here,
                       "wall": 1.0, "densify": rec(afters)}, f)
    with open(tmp_path / "card.json", "w") as f:
        json.dump({"card": "a card", "r0": {"wall": 2.0, "densify": rec([100, 200, 396])},
                   "r1": {"wall": 3.0, "densify": rec([50, 60], step=50)}}, f)
    rows = ladder_table([str(tmp_path / n) for n in ("a.json", "b.json", "card.json")])
    pairs = [r for r in rows if " against " in r]
    assert len(pairs) == 3, pairs
    assert pairs[0].startswith("rung 0 gof (gof_tpu at HEAD) against rung 0 port: active after "
                               "each call parts by at most 0.0476 (call 2 of 3, step 50: 200 / "
                               "210), at the last by 0.0099"), pairs[0]
    assert not any("r1 card" in r for r in pairs)
    assert sum(" calls; active after calls " in r for r in rows) == 4


def test_ladder_table_reads_rung3s_records(tmp_path):
    """Rung 3's rows in ladder_table: each two runs' parting over the calls
    after the second reset beside the whole run's; gof_tpu's key capacity
    as each build had it (growths, right-sizes) and its skipped steps; the
    card's peak keys per step; and the card's run of rung 3's schedule at
    full size (full_r3) paired with no CPU run."""
    import json

    def rec(afters, step=500):
        return [dict({k: 1 for k in chip_smoke.BREAKDOWN}, iter=step * (i + 1), use_size=i > 0,
                     before=100, after=a, Q=1e-3, accounted=True) for i, a in enumerate(afters)]

    resets = [1000, 2000]
    with open(tmp_path / "gof.json", "w") as f:
        json.dump({"rung": 3, "run": "gof", "gof_tpu": os.path.dirname(jtrain.__file__),
                   "wall": 1.0, "resets": resets, "keys_max": 700, "skipped": 3,
                   "builds": [{"iter": 0, "keys": 131072, "compact": 0},
                              {"iter": 1210, "keys": 196608, "compact": 65536},
                              {"iter": 2500, "keys": 131072, "compact": 65536}],
                   "densify": rec([100, 300, 500, 1000, 900])}, f)
    with open(tmp_path / "card.json", "w") as f:
        json.dump({"card": "a card",
                   "r3": {"wall": 2.0, "resets": resets, "keys_max": 650,
                          "densify": rec([150, 300, 500, 1030, 920])},
                   "full_r3": {"wall": 3.0, "resets": resets, "keys_max": 9000,
                               "densify": rec([150, 300, 500, 1030, 920])}}, f)
    rows = ladder_table([str(tmp_path / n) for n in ("gof.json", "card.json")])
    pairs = [r for r in rows if " against " in r]
    assert pairs == ["rung 3 gof (gof_tpu at HEAD) against r3 card (a card): active after each "
                     "call parts by at most 0.3333 (call 1 of 5, step 500: 100 / 150), at the "
                     "last by 0.0217; after the second reset (step 2000) by at most 0.0217 "
                     "(call 5, step 2500: 900 / 920)"], pairs
    gof = next(r for r in rows if r.startswith("rung 3 gof (gof_tpu at HEAD): 5 calls"))
    assert gof.endswith("; keys per step at most 700; key capacity 131072, then grew to 196608 "
                        "at 1210, right-sized to 131072 at 2500; 3 steps skipped"), gof
    assert any(r.startswith("full_r3 card (a card): 5 calls") and r.endswith(
        "keys per step at most 9000") for r in rows), rows


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


SH3_AT = 3998  # resumed at SH degree 3 throughout
SH3_CALLS = (4000, 4050)
SH3_ARGS = ["--opacity_reset_interval", "1000", "--densification_interval", "50",
            "--densify_until_iter", str(SH3_CALLS[-1] + 1)]
# at the checkpoint's trained scales the f32 step's rotation and scaling
# moments part by ROADMAP C9's cancellation (test_trained_scales_against_
# float64 holds them against float64), and Adam turns the parted
# rotation and the near-zero gradients of the SH bands into params that
# part past the step test's rtol; the other fields are held to it
SH3_HELD = {"params": ("xyz", "features_dc", "scaling", "opacity"),
            "moments": ("xyz", "features_dc", "features_rest", "opacity")}


def test_densify_after_a_reset_at_sh_degree_3_matches_gof_tpu(runs):
    """The regime no rung before rung 3 reached (ROADMAP C27): densify at SH
    degree 3 with the size prune on, before and after an opacity reset.
    gof_tpu's checkpoint at 11 (before the scaled schedule's reset, at its
    trained scales: at the gradient-test scales the size prune takes every
    gaussian), relabelled 3998 and resumed by both loops through 4050 with
    SH3_ARGS, the port drawing gof_tpu's noise: a densify call (its pool
    full: it drops placements and grows) and the reset at 4000, then the
    call at 4050 that prunes what the reset left under the 0.05 opacity
    (the loop's literal; a call 2 steps after a reset prunes every gaussian,
    so the calls are rung 3's 50 steps apart). Both calls' densify_breakdown
    records and active counts equal gof_tpu's (the classic share within 2
    gaussians and Q within 1%, as test_densify_breakdown_matches_gof_tpu
    holds them), and so do the active sets at their checkpoints. At the
    first call's checkpoint, over the gaussians it kept, SH3_HELD's params
    lie within the step test's rtol 1e-5 of the field's largest and its
    moments within BOUND of theirs; past it only the counts are held."""
    scene, root, _ = runs
    ckpt = relabel(str(root / "gof" / "chkpnt11.pkl"), str(root / "sh3.pkl"), SH3_AT,
                   rescale=False)
    argv = ["-s", scene, "--iterations", str(SH3_CALLS[-1]), *SCHEDULE, *SH3_ARGS,
            "--start_checkpoint", ckpt, "--checkpoint_iterations", *map(str, SH3_CALLS),
            "--save_iterations", "99999", "--test_iterations", "99999", "--cpu"]
    spies = {"port": Spy(gof_noise=True), "gof": Spy()}
    for name, lib, spy_on in (("port", ttrain, port_spies), ("gof", jtrain, gof_spies)):
        with pytest.MonkeyPatch.context() as mp:
            spy_on(mp, spies[name])
            lib.main(argv + ["-m", str(root / f"{name}_sh3")])
    port, gof = spies["port"], spies["gof"]
    for name, spy in spies.items():
        assert spy.densify == [(i, True) for i in SH3_CALLS], (name, spy.densify)
        assert spy.resets == [SH3_CALLS[0]], name
        assert {d for s in spy.steps for d in s["degree"]} == {3}, name
    assert sum(s["skipped"] for s in gof.steps) == 0
    print(f"active after each call: port {port.counts}, gof_tpu {gof.counts}")
    assert port.counts == gof.counts
    split = ("classic", "quantile only")
    for a, b in zip(port.breakdown, gof.breakdown):
        print(", ".join(f"{k} {a[k]} / {b[k]}" for k in chip_smoke.BREAKDOWN + ("Q",)))
        assert a["accounted"] and b["accounted"]
        assert ({k: a[k] for k in chip_smoke.BREAKDOWN if k not in split}
                == {k: b[k] for k in chip_smoke.BREAKDOWN if k not in split}), (a, b)
        assert a["classic"] + a["quantile only"] == b["classic"] + b["quantile only"], (a, b)
        assert abs(a["classic"] - b["classic"]) <= 2, (a, b)
        assert a["Q"] == pytest.approx(b["Q"], rel=1e-2), (a, b)
    first, reset = gof.breakdown
    assert first["dropped"] > 0 and first["splits"] > 0 and first["clones"] > 0, first
    assert reset["pruned opacity"] > 0 and reset["after"] > 0, reset
    active0 = ttrain.load_checkpoint(ckpt)[2].active
    for it in SH3_CALLS:
        tp, st, gs, _ = ttrain.load_checkpoint(str(root / "port_sh3" / f"chkpnt{it}.pkl"))
        jtp, jst, jgs, _ = ttrain.load_checkpoint(str(root / "gof_sh3" / f"chkpnt{it}.pkl"))
        assert torch.equal(gs.active, jgs.active), it
        kept = jgs.active.clone()
        kept[active0.shape[0]:] = False
        kept[:active0.shape[0]] &= active0
        for f in ttrain.GAUSS_FIELDS:
            errs = {}
            for m, got, want in (("params", getattr(tp.gauss, f), getattr(jtp.gauss, f)),
                                 ("mu", getattr(st.mu, f), getattr(jst.mu, f)),
                                 ("nu", getattr(st.nu, f), getattr(jst.nu, f))):
                got, want = (x[kept].detach().double().numpy() for x in (got, want))
                errs[m] = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
            print(f"{it} {f} over the kept gaussians, of the largest: " + ", ".join(
                f"{m} {e:.3e}" for m, e in errs.items()))
            if it == SH3_CALLS[0]:
                if f in SH3_HELD["params"]:
                    assert errs["params"] <= 1e-5, (it, f, errs)
                if f in SH3_HELD["moments"]:
                    assert max(errs["mu"], errs["nu"]) <= BOUND, (it, f, errs)


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


def cotangent_image(g, gs, cam, sh_degree: int, active_degree: int, kernel_size: float, bg,
                    frozen=None, normalized: bool = False):
    """The [9, H, W] render of the port's dense oracle (ops/oracle.py) with
    gof_tpu's documented cotangent choices (gof_tpu/ops/rasterize_pallas.py:
    46-53) made part of the function: the quantities a choice detaches are
    taken from `frozen`, the same render's record at the base point (this
    function's second result, given frozen=None), so that central
    differences of a loss of it follow that backward. Frozen: the depth
    order, the validity, the dilation's coef, the pairs the step's binning
    visits (each gaussian's tiles), each pair's alpha and transmittance
    masks, the 0.99 clamp as an additive correction (its
    gradient ignored), the median depth's contributing visit, and the
    distortion's blend weights and normalization. The distortion's
    gradient flows through the mapped depth m only, and without its
    (1 - T)^2 + 1e-7 normalization (gof_tpu's dL_dm, rasterize_pallas.py:
    659, which omits it as the reference's backward does), or with it as a
    constant where `normalized`."""
    from gof_tpu_torch.constants import (ALPHA_MAX, ALPHA_MIN, MEDIAN_THRESHOLD, NEAR_PLANE,
                                         TRANSMITTANCE_EPS)
    from gof_tpu_torch.ops import blend, quadrics

    base = frozen is None
    opac = tgm.filtered_opacity(g, gs.filter_3d)
    pre = quadrics.preprocess(g.xyz, tgm.filtered_scaling(g, gs.filter_3d), g.rotation,
                              ttrain.masked_shs(g, active_degree, sh_degree), sh_degree, cam,
                              kernel_size, gs.active, opacities=opac)
    if base:
        inf = torch.full_like(pre.depth, float("inf"))
        order = torch.argsort(torch.where(pre.valid, pre.depth, inf).detach(), stable=True)
        order = order[:int(pre.valid.sum())]  # the others have no alpha anywhere
        frozen = {"order": order, "valid": pre.valid[order], "coef": pre.coef[order].detach()}
    order, valid = frozen["order"], frozen["valid"]
    op = opac[order] * torch.where(valid, frozen["coef"], torch.zeros_like(frozen["coef"]))
    M, u0 = pre.v2g_M[order], pre.v2g_u0[order]
    rx, ry = blend.pixel_rays(cam.width, cam.height, cam.focal_x, cam.focal_y)
    rx, ry = rx.reshape(1, -1).to(M.dtype), ry.reshape(1, -1).to(M.dtype)
    d = [M[:, i, 0, None] * rx + M[:, i, 1, None] * ry + M[:, i, 2, None] for i in range(3)]
    dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    t = -sum(u0[:, i, None] * d[i] for i in range(3)) / (dd + 1e-12)
    mv = sum((u0[:, i, None] + t * d[i]) ** 2 for i in range(3))
    raw = op[:, None] * torch.exp(-0.5 * mv)
    nrm = [sum(M[:, j, i, None] * d[j] for j in range(3)) for i in range(3)]
    inv_len = 1.0 / torch.sqrt(nrm[0] ** 2 + nrm[1] ** 2 + nrm[2] ** 2 + 1e-7)
    if base:
        # the pairs the step's binning visits: each gaussian's tiles
        ntx, nty = tb.tile_grid(cam.width, cam.height)
        with torch.no_grad():
            rects = tb.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty,
                                      radius_xy=pre.radius_xy)
            b = tb.bin_gaussians(pre.depth, rects, ntx, nty, mean2d=pre.mean2d,
                                 radius=pre.radius)
        n = int(b.num_keys)
        tile = torch.searchsorted(b.bounds.long(), torch.arange(n), right=True) - 1
        member = torch.zeros((pre.depth.shape[0] + 1, ntx * nty), dtype=torch.bool)
        member[b.slot_to_gaussian[:n].long(), tile] = True
        py, px = torch.meshgrid(torch.arange(cam.height), torch.arange(cam.width), indexing="ij")
        pix_tile = ((py // 32) * ntx + px // 32).reshape(-1)
        clamped = torch.clamp_max(raw, ALPHA_MAX)
        frozen["mask"] = ((t > NEAR_PLANE) & (clamped >= ALPHA_MIN)
                          & member[order][:, pix_tile]).detach()
        frozen["clamp"] = (clamped - raw).detach()
    a = torch.where(frozen["mask"], raw + frozen["clamp"], torch.zeros_like(raw))
    prod = torch.cumprod(1.0 - a, dim=0)
    T = torch.cat([torch.ones_like(prod[:1]), prod[:-1]], dim=0)
    if base:
        frozen["tmask"] = (T > TRANSMITTANCE_EPS).detach()
        med = (a > 0) & (T > MEDIAN_THRESHOLD)
        idx = torch.arange(a.shape[0])[:, None]
        last = torch.where(med, idx, -1).amax(dim=0)
        frozen["median"] = ((idx == last[None]) & med).detach()
    w = a * T * frozen["tmask"]
    m = blend.ndc_depth(t)
    if base:
        frozen["w"] = w.detach()
        frozen["norm"] = ((1.0 - prod[-1]) ** 2 + 1e-7).detach()
    W = frozen["w"]
    acc, d1, d2 = W.sum(0), (W * m).sum(0), (W * m * m).sum(0)
    dist = acc * d2 - d1 * d1
    if base:
        frozen["dist"] = (dist / frozen["norm"]).detach()
    dist = (dist / frozen["norm"] if normalized
            else dist + (frozen["dist"] - dist).detach())
    rgb = pre.rgb[order].transpose(0, 1) @ w + prod[-1][None] * bg[:, None]
    normal = torch.stack([(-n * inv_len * w).sum(0) for n in nrm])
    depth = (torch.where(frozen["median"], t, torch.zeros_like(t))).sum(0)
    image = torch.cat([rgb, normal, depth[None], w.sum(0)[None], dist[None]])
    return image.reshape(9, cam.height, cam.width), frozen


def test_regularizer_gradients_follow_gof_tpus_cotangents(trained_scales):
    """ROADMAP C30's regularizers' half. At test_trained_scales_against_
    float64's state, in the regularizers' instance as the loop builds it
    (statistics off, kernel_size 0.1), the port's float64 step gradient of
    the xyz, scaling, rotation and opacity of the four gaussians with the
    largest rotation gradient agrees within FD_RTOL of the field's largest
    with central differences of train_loss over cotangent_image, the dense
    oracle with gof_tpu's documented cotangent choices: the distortion
    through m only, its weights and normalization left out of the gradient
    (gof_tpu/ops/rasterize_pallas.py:659), the median depth at its visit,
    the 0.99 clamp ignored, coef detached. The loss itself matches the
    step's within 1e-6. With the normalization kept as a constant factor
    (the choice as rasterize_pallas.py:46-48 words it) the xyz gradient
    differs by more than FD_RTOL: the omission is gof_tpu's and the
    reference's, and the port keeps it."""
    root, ckpt, spy = trained_scales
    _, st0, gs0, _ = ttrain.load_checkpoint(ckpt)
    act = gs0.active
    head, (gt, step_i, cam, bg) = spy.args
    from gof_tpu_torch import config as tconfig

    cfg, pipe, opt = tconfig.load_cfg(str(root / "port_trained"))
    step = ttrain.build_train_step(opt, cfg, pipe, ttrain.make_optimizer(opt, 1.0),
                                   with_stats=False, with_reg=True)
    tp, st, gs, c = ttrain.as_float64(*head, cam)
    _, st64, _, m64 = step(tp, st, gs, gt.double(), step_i, c, bg.double())
    grad = {f: (getattr(st64.mu, f) - 0.9 * getattr(st0.mu, f).double()) / 0.1
            for f in ("xyz", "scaling", "rotation", "opacity")}
    degree = min(int(step_i) // 1000, cfg.sh_degree)

    def loss(g, frozen, normalized=False):
        image, frozen = cotangent_image(g, gs, c, cfg.sh_degree, degree, cfg.kernel_size,
                                        bg.double(), frozen, normalized)
        return float(ttrain.train_loss(image, gt.double(), c, opt, step_i, True)[0]), frozen

    g0 = ttrain.as_float64(*head, cam)[0].gauss  # the step updated tp's params in place
    with torch.no_grad():
        base, frozen = loss(g0, None)
    assert abs(base - float(m64["loss"])) <= 1e-6 * float(m64["loss"]), (base, float(m64["loss"]))
    top = torch.topk(torch.where(act, grad["rotation"].norm(dim=1), 0.0), 4).indices.tolist()
    worst = {True: 0.0, False: 0.0}
    for f in grad:
        scale = float(grad[f][act].abs().max())
        for i in top:
            for j in range(grad[f][i].numel()):
                fd = {True: float("nan")}
                for normalized in (False, True) if f == "xyz" else (False,):
                    ends = []
                    for h in (-FD_STEP, FD_STEP):
                        g = replace(g0, **{f: getattr(g0, f).clone()})
                        getattr(g, f).view(g.xyz.shape[0], -1)[i, j] += h
                        with torch.no_grad():
                            ends.append(loss(g, frozen, normalized)[0])
                    fd[normalized] = (ends[1] - ends[0]) / (2 * FD_STEP)
                    err = abs(fd[normalized] - float(grad[f].view(grad[f].shape[0], -1)[i, j]))
                    worst[normalized] = max(worst[normalized], err / scale)
                print(f"{f}[{i}, {j}]: step {float(grad[f].view(grad[f].shape[0], -1)[i, j]):.6e}"
                      f", central differences {fd[False]:.6e}, with the normalization "
                      f"{fd[True]:.6e}")
    print(f"largest error over the field's largest: {worst[False]:.3e}, with the "
          f"normalization kept {worst[True]:.3e}")
    assert worst[False] <= FD_RTOL, worst
    assert worst[True] > FD_RTOL, worst


def test_float32_gap_by_stage(trained_scales):
    """ROADMAP C29 traced at test_trained_scales_against_float64's state:
    the loop's step (the regularizers' instance) in float32, with each of
    chip_smoke.F64_STAGES in float64 (chip_smoke.stage_in_float64), held
    against the step in float64. The blend backward (K3's plain version:
    its suffix sums come by subtraction from the forward's totals) is the
    stage behind the largest share of the scaling's and the rotation's
    first-moment gap: alone in float64 it takes each to under 2/3 of the
    float32 step's (the rotation's to under half), further than any other
    stage alone; the reduce and the preprocess backward move neither by 2%."""
    root, ckpt, spy = trained_scales
    _, st0, gs0, _ = ttrain.load_checkpoint(ckpt)
    act = gs0.active
    head, (gt, step_i, cam, bg) = spy.args
    lim = spy.steps[0]["lim"]
    tp, st, gs, c = ttrain.as_float64(*head, cam)
    res64 = spy.step(tp, st, gs, gt.double(), step_i, c, bg.double(), lim=lim.clone())
    gaps = {}
    for stage in ("float32",) + chip_smoke.F64_STAGES:
        with chip_smoke.stage_in_float64(*() if stage == "float32" else (stage,)):
            res32 = spy.step(*port_copy(*head), gt, step_i, cam, bg, lim=lim.clone())
        gaps[stage] = chip_smoke.step_diffs(res32[:3], 0.0, res64[:3], 0.0, st0, act)
        print(f"{stage}: " + ", ".join(f"{k} {v:.3e}" for k, v in gaps[stage].items()))
    for f, share in (("mu.scaling", 2 / 3), ("mu.rotation", 0.5)):
        gap = {s: gaps[s][f] for s in gaps}
        assert min(chip_smoke.F64_STAGES, key=gap.get) == "blend backward", (f, gap)
        assert gap["blend backward"] < share * gap["float32"], (f, gap)
        for s in ("reduce", "preprocess backward"):
            assert abs(gap[s] - gap["float32"]) < 0.02 * gap["float32"], (f, s, gap)


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


def ladder_run(rung: int, run: str, out: str, extra: tuple = ()) -> dict:
    """One CPU run of the ladder of whole trajectories (ROADMAP C27):
    chip_smoke.RUNGS[rung]'s procedural scene (the port's writer, written
    into OUT/scene if absent) and schedule through gof_tpu's loop ("gof":
    the gof_tpu this process imports, HEAD, or an older commit's extract put
    first on PYTHONPATH), or the port's drawing gof_tpu's densify noise
    ("port_gof_noise") or its own ("port"), spied on; `extra` train
    arguments follow the rung's (a later flag overrides an earlier one: a
    shorter run, checkpoints, a resume). Writes and returns
    OUT/ladder.json: the wall time, the gof_tpu imported, and per densify
    call its iteration, size-prune flag and chip_smoke.densify_breakdown's
    record; the opacity resets."""
    import json
    import time

    from gof_tpu_torch.scripts import make_procedural_scene as mps

    spec = chip_smoke.RUNGS[rung]
    scene = os.path.join(out, "scene")
    if not os.path.exists(os.path.join(scene, "gt_mesh.ply")):
        mps.main(["--out", scene, *spec["scene"]])
    spy = Spy(gof_noise=run == "port_gof_noise")
    lib, spy_on = (jtrain, gof_spies) if run == "gof" else (ttrain, port_spies)
    t0 = time.time()
    with pytest.MonkeyPatch.context() as mp:
        spy_on(mp, spy)
        lib.main(["-s", scene, "-m", os.path.join(out, "model"), *spec["argv"], "--cpu",
                  *extra])
    rec = {"rung": rung, "run": run, "gof_tpu": os.path.dirname(jtrain.__file__),
           "wall": time.time() - t0, "steps": len(spy.steps), "resets": spy.resets,
           "keys_max": max((st.get("keys", 0) for st in spy.steps), default=0),
           "skipped": sum(st.get("skipped", 0) for st in spy.steps), "builds": spy.builds,
           "densify": [{"iter": it, "use_size": size, **b}
                       for (it, size), b in zip(spy.densify, spy.breakdown)]}
    with open(os.path.join(out, "ladder.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def ladder_table(paths: list) -> list:
    """The ladder's table from ladder.json files (one run each) and
    chip_smoke.py --ladder's ladder_card.json (the card's runs): per run,
    the active count after the densify calls at 1/4, 1/2, 3/4 and the last,
    the breakdown's totals, the classic and the quantile-only selections as
    shares of the active counts before the calls, the wall time, the peak
    keys per step where recorded, and gof_tpu's key capacity at each build
    and its skipped steps; and for each two runs of one rung (or two
    card runs of one full-size key), how far their active counts part, over
    all calls and over those after the second reset. Returns the rows
    (also printed)."""
    import itertools
    import json

    runs = []
    for path in paths:
        with open(path) as f:
            rec = json.load(f)
        if "densify" in rec:
            here = os.path.join(os.path.dirname(os.path.abspath(chip_smoke.__file__)), "gof_tpu")
            which = "at HEAD" if os.path.samefile(rec["gof_tpu"], here) else (
                f"from {os.path.dirname(rec['gof_tpu'])}")
            runs.append((f"rung {rec['rung']} {rec['run']}" + (
                f" (gof_tpu {which})" if rec["run"] == "gof" else ""), rec["rung"], rec))
        else:  # r<N>: rung N; full_run, full_r<N>: the full-size scene
            runs += [(f"{k} card ({rec['card']})", int(k[1:]) if k[1:].isdigit() else k, v)
                     for k, v in rec.items() if k != "card"]
    rows = []
    for (name, rung, rec), (other, rung_b, want) in itertools.combinations(runs, 2):
        a, b = rec["densify"], want["densify"]
        if rung != rung_b or [c["iter"] for c in a] != [c["iter"] for c in b]:
            continue  # another rung or scene
        part = [abs(x["after"] - y["after"]) / max(y["after"], 1) for x, y in zip(a, b)]
        worst = int(np.argmax(part))
        row = (f"{name} against {other}: active after each call parts by at most "
               f"{part[worst]:.4f} (call {worst + 1} of {len(a)}, step {a[worst]['iter']}: "
               f"{a[worst]['after']} / {b[worst]['after']}), at the last by {part[-1]:.4f}")
        resets = rec.get("resets", [])
        if len(resets) >= 2:  # the calls after the second reset
            late = [i for i, c in enumerate(a) if c["iter"] > resets[1]]
            if late:
                w = max(late, key=lambda i: part[i])
                row += (f"; after the second reset (step {resets[1]}) by at most {part[w]:.4f} "
                        f"(call {w + 1}, step {a[w]['iter']}: {a[w]['after']} / "
                        f"{b[w]['after']})")
        print(row)
        rows.append(row)
    for name, _, rec in runs:
        d = rec["densify"]
        n = len(d)
        at = [d[max(int(round(n * q)) - 1, 0)] for q in (0.25, 0.5, 0.75, 1.0)]
        tot = {k: sum(c[k] for c in d) for k in chip_smoke.BREAKDOWN[2:]}
        before = sum(c["before"] for c in d)
        row = (f"{name}: {n} calls; active after calls " + ", ".join(
            f"{c['iter']}: {c['after']}" for c in at) + "; totals " + ", ".join(
            f"{k} {v}" for k, v in tot.items()) + f"; classic {tot['classic'] / before:.4f}, "
            f"quantile only {tot['quantile only'] / before:.4f} of the active before; "
            f"all accounted {all(c['accounted'] for c in d)}; wall {rec['wall']:.1f} s")
        if rec.get("keys_max"):
            row += f"; keys per step at most {rec['keys_max']}"
        if rec.get("builds"):  # gof_tpu's loop: its key capacity by build, its skipped steps
            caps = [(c["iter"], c["keys"]) for c in rec["builds"]]
            moves = [(it, "grew" if k > k0 else "right-sized", k)
                     for (_, k0), (it, k) in zip(caps, caps[1:]) if k != k0]
            row += (f"; key capacity {caps[0][1] if caps else None}, then " + (", ".join(
                f"{how} to {k} at {it}" for it, how, k in moves) or "unchanged")
                + f"; {rec['skipped']} steps skipped")
        print(row)
        rows.append(row)
    return rows


def ladder_ops(path: str, scene: str) -> dict:
    """The ladder's narrowing to one operation (ROADMAP C27) at the state of
    one checkpoint of gof_tpu's, on the CPU: gof_tpu's and the port's
    reset_opacity on its params, and their densify_and_prune on its params,
    statistics and moments with the same draws (gof_tpu's, from
    PRNGKey(0) as its loop's first call takes them), at the loop's
    thresholds, the size prune on and the scene's extent. Returns (and
    prints) the largest difference of the reset opacities (of their
    largest) and how many differ, each package's densify_breakdown record
    and report, whether the active sets are equal, and the largest
    difference of each param over them (of the field's largest)."""
    from gof_tpu import config as jconfig
    from gof_tpu_torch.data import scene as scene_lib

    jtp, jst, jgs, it = jtrain.load_checkpoint(path)
    tp, st, gs, _ = ttrain.load_checkpoint(path)
    opt = jconfig.OptimizationParams()
    kw = dict(max_grad=opt.densify_grad_threshold, min_opacity=0.05,
              extent=scene_lib.Scene(scene, "", shuffle=False).cameras_extent,
              percent_dense=opt.percent_dense)
    use_size = True  # every call of rung 3 after its first reset
    out = {"iter": it, "active": int(gs.active.sum())}
    want = np.asarray(jax.jit(jgm.reset_opacity)(jtp.gauss, jgs.filter_3d).opacity)
    got = tgm.reset_opacity(tp.gauss, gs.filter_3d).opacity.numpy()
    act = gs.active.numpy()
    out["reset"] = (float(np.abs(got - want)[act].max() / np.abs(want[act]).max()),
                    int((got != want)[act].sum()))
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    cap = tp.gauss.xyz.shape[0]
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (cap, 3))))
                  for k in jax.random.split(sub, 3))
    jres = jax.device_get(jax.jit(lambda p, g, o, k: jgm.densify_and_prune(
        p, g, o, k, *kw.values(), use_size))(jtp.gauss, jgs, jst, sub))
    res = tgm.densify_and_prune(tp.gauss, gs, st, noise, *kw.values(), use_size)
    for name, (p, g, r) in (("gof", (jres[0], jres[1], jres[3])),
                            ("port", (res.params, res.state, res.report))):
        out[name] = chip_smoke.densify_breakdown(jtp.gauss, jgs, p, g, r, *kw.values(), use_size)
        out[name]["report"] = [int(x) for x in r]
    new_act = np.asarray(jres[1].active)
    out["same active"] = bool((res.state.active.numpy() == new_act).all())
    out["params"] = {f: float(np.abs(getattr(res.params, f).numpy()[new_act]
                                     - np.asarray(getattr(jres[0], f))[new_act]).max()
                              / np.abs(np.asarray(getattr(jres[0], f))[new_act]).max())
                     for f in ttrain.GAUSS_FIELDS}
    print(f"{path} (iteration {it}, {out['active']} active): reset_opacity differs by at most "
          f"{out['reset'][0]:.3e} of the largest, at {out['reset'][1]} gaussians")
    for name in ("gof", "port"):
        print(f"  densify_and_prune, {name}: report {out[name]['report']}; " + ", ".join(
            f"{k} {out[name][k]}" for k in chip_smoke.BREAKDOWN) + f", Q {out[name]['Q']:.6e}")
    print(f"  the same active set {out['same active']}; params over it, of the largest: "
          + ", ".join(f"{f} {v:.3e}" for f, v in out["params"].items()))
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=<repo> python tests/test_torch_full_run.py
    #     --rung N --run gof|port_gof_noise|port --out DIR [--threads T]
    #     [--train_args ARG ...]
    # or --table LADDER_JSON [...]: the ladder's table (ladder_table)
    # or --ops CHECKPOINT [...] --scene DIR: the reset and densify of both
    #     packages at each checkpoint's state (ladder_ops)
    import argparse

    jax.config.update("jax_platforms", "cpu")
    parser = argparse.ArgumentParser(description="one CPU run of the C27 ladder, its table, or "
                                     "its narrowing at checkpoints")
    parser.add_argument("--rung", type=int)
    parser.add_argument("--run", choices=("gof", "port_gof_noise", "port"))
    parser.add_argument("--out")
    parser.add_argument("--threads", type=int, default=2, help="the port's torch threads")
    parser.add_argument("--table", nargs="+", metavar="LADDER_JSON")
    parser.add_argument("--ops", nargs="+", metavar="CHECKPOINT")
    parser.add_argument("--scene", help="with --ops: the checkpoints' scene")
    parser.add_argument("--train_args", nargs=argparse.REMAINDER, default=[],
                        help="train arguments after the rung's (last)")
    ns = parser.parse_args()
    if ns.table:
        ladder_table(ns.table)
    elif ns.ops:
        if ns.scene is None:
            parser.error("--ops needs --scene")
        for ckpt in ns.ops:
            ladder_ops(ckpt, ns.scene)
    else:
        if ns.rung is None or ns.run is None or ns.out is None:
            parser.error("--rung, --run and --out are required without --table")
        torch.set_num_threads(ns.threads)
        ladder_run(ns.rung, ns.run, ns.out, tuple(ns.train_args))
