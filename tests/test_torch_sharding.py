"""gof_tpu_torch.parallel against gof_tpu.parallel on the CPU.

The port's ranks are processes (parallel.sharding.launch, gloo on the CPU)
running the package's entry points (parallel.steps, train.training); the
JAX side runs in this process on the 8 virtual CPU devices of
tests/conftest.py, its Pallas kernels in interpret mode. Tolerances:
gof_tpu's own dp tests (tests/test_sharding.py: xyz rtol 1e-4 / atol 1e-7,
the statistics dp x the single step's) where the port is held against its
own single step; the step bounds of test_torch_train.py::
test_train_step_matches_gof_tpu (gof_tpu's Pallas-vs-XLA bound 1e-4 of max
for gradients) where it is held against gof_tpu; bit-equality where both
sides are the port on one device (replicas, scene 0 alone, point shards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import cameras as jcam
from gof_tpu import config as jconfig
from gof_tpu import train as jtrain
from gof_tpu.mesh import extract as jex
from gof_tpu.model import gaussians as jgm
from gof_tpu.parallel import sharding as jsharding
from gof_tpu_torch import cameras as tcam
from gof_tpu_torch import config as tconfig
from gof_tpu_torch import train as ttrain
from gof_tpu_torch.mesh import extract as tex
from gof_tpu_torch.model import gaussians as tgm
from gof_tpu_torch.parallel import sharding, steps
from gof_tpu_torch.utils import ply as tply

torch.set_num_threads(2)

BOUND = 1e-4
W, H = 64, 48
N_POOL, N_ACTIVE = 48, 40
EYES = [(0.1, -0.05, 0.0), (-0.2, 0.1, 0.1), (0.15, 0.2, -0.1), (-0.1, -0.15, 0.05)]


@pytest.fixture(scope="module")
def meshes():
    if jax.device_count() < 8:
        pytest.skip("needs gof_tpu's 8 virtual CPU devices (tests/conftest.py)")
    return {n: jsharding.make_mesh(n) for n in (2, 4, 8)}


def model(rng, n, n_active):
    """A bench-style random model in a padded pool, SH degree 1, with
    gof_tpu's gradient-test scales (ROADMAP C9: smaller gaussians' scale
    gradients are ill-conditioned in float32)."""
    z = rng.uniform(4, 7, n)
    xyz = np.stack([rng.uniform(-1, 1, n) * z * 0.2, rng.uniform(-1, 1, n) * z * 0.2, z], -1)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    scaling = np.log(rng.uniform(0.3, 1.0, (n, 3)))
    op = rng.uniform(-1, 1, n)
    xyz[n_active:], scaling[n_active:], op[n_active:] = 0.0, -10.0, 0.0
    q[n_active:] = (1.0, 0, 0, 0)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    params = jgm.GaussianParams(
        xyz=f32(xyz), features_dc=f32(rng.normal(0, 0.5, (n, 1, 3))),
        features_rest=f32(rng.normal(0, 0.1, (n, 3, 3))), scaling=f32(scaling), rotation=f32(q),
        opacity=f32(op))
    z0 = np.zeros((n,), np.float32)
    state = jgm.GaussianState(active=np.arange(n) < n_active,
                              filter_3d=f32(rng.uniform(1e-4, 5e-3, n)), max_radii2d=z0,
                              grad_accum=z0, grad_abs_accum=z0, denom=z0)
    return params, state


def scene(seed, with_reg=True, n_views=4, size=(W, H)):
    """(params, state, gts [V, 3, H, W], camera kwargs per view, opt)."""
    rng = np.random.default_rng(seed)
    params, state = model(rng, N_POOL, N_ACTIVE)
    gts = rng.uniform(0, 1, (n_views, 3, size[1], size[0])).astype(np.float32)
    cams = [dict(eye=e, target=(0, 0, 5.0), width=size[0], height=size[1], uid=i)
            for i, e in enumerate(EYES[:n_views])]
    reg_from = 0 if with_reg else 15_000
    return params, state, gts, cams, dict(distortion_from_iter=reg_from,
                                          depth_normal_from_iter=reg_from)


def port_case(sc, ids, step=100, with_reg=True):
    params, state, gts, cams, optkw = sc
    return steps.train_case(params, state, gts, [tcam.look_at_camera(**c).numpy() for c in cams],
                            ids, tconfig.OptimizationParams(**optkw),
                            tconfig.ModelParams(sh_degree=1, kernel_size=0.1),
                            tconfig.PipelineParams(), 5.0, step, with_reg=with_reg)


def gof_step(sc, views, mesh=None, step=100, with_reg=True):
    """gof_tpu's step on `views` (dp = len(views) over `mesh`, or one view)."""
    params, state, gts, cams, optkw = sc
    opt = jconfig.OptimizationParams(**optkw)
    tx = jtrain.make_optimizer(opt, 5.0)
    tp0 = jtrain.TrainParams(gauss=jax.tree.map(jnp.asarray, params), app_net=None, app_emb=None)
    s0 = tx.init(tp0)
    dp = len(views) if mesh is not None else 1
    fn = jtrain.build_train_step(opt, jconfig.ModelParams(sh_degree=1, kernel_size=0.1),
                                 jconfig.PipelineParams(key_capacity=8192), tx, interpret=True,
                                 with_reg=with_reg, dp=dp, mesh=mesh)
    jc = [jcam.look_at_camera(**cams[v]) for v in views]
    if dp > 1:
        cam = jax.tree.map(lambda *xs: jnp.stack(xs), *jc)
        gt = jnp.asarray(gts[list(views)])
    else:
        cam, gt = jc[0], jnp.asarray(gts[views[0]])
    tp, s, g, m = fn(tp0, s0, jax.tree.map(jnp.asarray, state), gt, jnp.int32(step), cam,
                     jnp.zeros(3))
    return jax.device_get((tp.gauss, s, g, m))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def fields(blob):
    """A checkpoint_blob's gaussians, GaussianState and Adam moments as
    numpy, Adam's per field."""
    g = blob["gauss"]
    mu, nu = (np.asarray(blob["adam"][k]) for k in ("mu_flat", "nu_flat"))
    like = jgm.GaussianParams(**g)
    return (g, blob["gstate"], jtrain.unflatten_gauss_t(jnp.asarray(mu), like),
            jtrain.unflatten_gauss_t(jnp.asarray(nu), like))


def assert_matches_gof_params(g, mu, jg, jmu, active):
    """The moments within BOUND of max and the params within rtol 1e-5
    where the gradient is not near zero (test_train_step_matches_gof_tpu),
    over the active slots: gof_tpu's scaling moment of an inactive slot can
    be NaN, the port's is 0 (ROADMAP C15)."""
    for f in ttrain.GAUSS_FIELDS:
        got, want = np.asarray(getattr(mu, f)), np.asarray(getattr(jmu, f))
        assert np.isfinite(got).all() and not got[~active].any(), f
        assert rel_err(got[active], want[active]) <= BOUND, (f, rel_err(got[active],
                                                                      want[active]))
        gmag = np.abs(want[active])
        sel = gmag > 1e-3 * gmag.max()
        if sel.any():
            want_p = np.asarray(getattr(jg, f))[active][sel]
            np.testing.assert_allclose(np.asarray(g[f])[active][sel], want_p, rtol=1e-5,
                                       atol=1e-5 * np.abs(want_p).max(), err_msg=f)


def assert_matches_gof_step(res, jres):
    """test_train_step_matches_gof_tpu's bounds."""
    jg, js, jgs, jm = jres
    g, gs, mu, _ = fields(res["state"])
    m = res["metrics"]
    for k in ("loss", "l1", "ssim", "psnr", "distortion", "depth_normal"):
        assert m[k] == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-7), k
    for k in ("num_keys", "compact_demand"):
        assert int(m[k]) == int(jm[k]), k
    jmu = jtrain.unflatten_gauss_t(jnp.asarray(js.mu_flat), jg)
    assert_matches_gof_params(g, mu, jg, jmu, gs["active"])
    for f in ("grad_accum", "grad_abs_accum"):
        assert rel_err(gs[f], getattr(jgs, f)) <= BOUND, f
        assert np.abs(np.asarray(getattr(jgs, f))).max() > 0
    np.testing.assert_array_equal(gs["denom"], np.asarray(jgs.denom))
    np.testing.assert_array_equal(gs["max_radii2d"], np.asarray(jgs.max_radii2d))


def assert_replicas(results):
    digests = [ttrain.replica_digests(r["state"]) for r in results]
    assert all(d == digests[0] for d in digests[1:])


# ---------------------------------------------------------------------------
# Camera-batch data parallelism
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dp4():
    """One launch of 4 CPU ranks: a step over 4 copies of view 0 of scene
    0, then one over views 0-3 of scene 1."""
    scs = [scene(0), scene(1)]
    cases = [port_case(scs[0], [[0, 0, 0, 0]]), port_case(scs[1], [[0, 1, 2, 3]])]
    return scs, sharding.launch(steps.dp_steps, 4, ["cpu"] * 4, (cases,))


def test_dp_identical_views_match_single_step(dp4):
    """dp=4 over 4 copies of one view reproduces the port's single step
    (the mean of identical gradients) and 4x its statistics, on every
    rank (gof_tpu tests/test_sharding.py:74-100)."""
    scs, res = dp4
    res = [r[0] for r in res]
    one = steps.run(port_case(scs[0], [[0]]), "cpu")
    assert_replicas(res)
    g4, gs4, mu4, nu4 = fields(res[0]["state"])
    g1, gs1, mu1, nu1 = fields(one["state"])
    assert res[0]["metrics"]["loss"] == pytest.approx(one["metrics"]["loss"], rel=1e-5)
    for f in ttrain.GAUSS_FIELDS:
        np.testing.assert_allclose(g4[f], g1[f], rtol=1e-4, atol=1e-7, err_msg=f)
        for a, b in ((mu4, mu1), (nu4, nu1)):
            assert rel_err(getattr(a, f), getattr(b, f)) <= BOUND, f
    np.testing.assert_allclose(gs4["denom"], 4.0 * gs1["denom"], rtol=1e-6)
    np.testing.assert_allclose(gs4["grad_accum"], 4.0 * gs1["grad_accum"], rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(gs4["grad_abs_accum"], 4.0 * gs1["grad_abs_accum"], rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(gs4["max_radii2d"], gs1["max_radii2d"], rtol=1e-5)
    assert gs1["denom"].sum() > 30 and res[0]["launches"] == one["launches"]


def test_dp_distinct_views_match_gof_tpu(dp4, meshes):
    """dp=4 over 4 different views against gof_tpu's build_train_step(dp=4,
    mesh=mesh4): finite loss, params move, num_keys the max over the ranks'
    views, and the step within test_train_step_matches_gof_tpu's bounds."""
    scs, res = dp4
    sc, res = scs[1], [r[1] for r in res]
    assert_replicas(res)
    m = res[0]["metrics"]
    assert np.isfinite(m["loss"]) and not m["key_overflow"]
    assert np.abs(res[0]["state"]["gauss"]["xyz"] - sc[0].xyz).max() > 0
    singles = [steps.run(port_case(sc, [[v]]), "cpu")["metrics"]["num_keys"] for v in range(4)]
    assert m["num_keys"] == max(singles) and len(set(singles)) > 1
    assert_matches_gof_step(res[0], gof_step(sc, [0, 1, 2, 3], meshes[4]))


def test_dp_one_rank_group_equals_the_plain_step():
    """A one-rank group runs the reductions' path (every collective an
    identity, the mean a division by 1) and leaves the state bit-equal to
    the dp == 1 step's."""
    sc = scene(2, with_reg=False)
    ((res,),) = sharding.launch(steps.dp_steps, 1, ["cpu"],
                                ([port_case(sc, [[2]], with_reg=False)],))
    one = steps.run(port_case(sc, [[2]], with_reg=False), "cpu")
    assert ttrain.replica_digests(res["state"]) == ttrain.replica_digests(one["state"])
    assert res["metrics"] == one["metrics"]


def test_launch_raises_when_a_rank_fails():
    """Rank 1's view does not exist: it raises while rank 0 waits in the
    step's collective; launch raises and ends rank 0."""
    sc = scene(0)
    with pytest.raises(Exception, match="IndexError|out of range"):
        sharding.launch(steps.dp_steps, 2, ["cpu"] * 2, ([port_case(sc, [[0, 7]])],))


def test_backend_rule_and_device_lists(monkeypatch):
    assert sharding.backend_for(["cpu", "cpu"]) == "gloo"
    assert sharding.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert sharding.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert sharding.backend_for(["cuda", "cuda:0"]) == "gloo"
    assert sharding.backend_for(["cuda:0"]) == "nccl"
    assert sharding.backend_for(["cpu", "cuda:0"]) == "gloo"
    assert sharding.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sharding.make_mesh(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="--dp 4 needs 4 devices; only 2 visible"):
        sharding.make_mesh(4, "cuda", "--dp 4")
    x = np.arange(12)
    assert sharding.shard_leading(x, 4, 2).tolist() == [6, 7, 8]
    with pytest.raises(ValueError):
        sharding.shard_leading(x, 5, 0)


# ---------------------------------------------------------------------------
# Scene parallelism
# ---------------------------------------------------------------------------


def test_scene_parallel_matches_each_scene_alone_and_gof_tpu(meshes):
    """Two scenes, one per rank, share nothing: rank 0's state is its scene
    stepped alone bit for bit, every rank holds both losses in rank order,
    and scene 0 matches gof_tpu's build_scene_parallel_step within the step
    bounds."""
    scs = [scene(3, size=(32, 32)), scene(4, size=(32, 32))]
    cases = [port_case(scs[0], [[0]]), port_case(scs[1], [[1]])]
    res = sharding.launch(steps.scene_steps, 2, ["cpu"] * 2, (cases,))
    torch.set_num_threads(1)  # the ranks' thread count
    try:
        alone = [steps.run(c, "cpu") for c in cases]
    finally:
        torch.set_num_threads(2)
    for r in range(2):
        assert ttrain.replica_digests(res[r]["state"]) == ttrain.replica_digests(alone[r]["state"])
        np.testing.assert_array_equal(res[r]["losses"][0],
                                      [a["metrics"]["loss"] for a in alone])

    params, state, *_ = scs[0]
    jsetups = []
    for sc, v in ((scs[0], 0), (scs[1], 1)):
        p, s, gts, cams, optkw = sc
        jsetups.append((jtrain.TrainParams(gauss=jax.tree.map(jnp.asarray, p), app_net=None,
                                           app_emb=None), jax.tree.map(jnp.asarray, s),
                        jnp.asarray(gts[v]), jcam.look_at_camera(**cams[v])))
    opt = jconfig.OptimizationParams(**scs[0][4])
    tx = jtrain.make_optimizer(opt, 5.0)
    single = jtrain.build_train_step(opt, jconfig.ModelParams(sh_degree=1, kernel_size=0.1),
                                     jconfig.PipelineParams(key_capacity=8192), tx,
                                     interpret=True)

    def scene_step(tp, opt_state, gstate, gt, camera):
        tp, opt_state, gstate, m = single(tp, opt_state, gstate, gt, jnp.int32(100), camera,
                                          jnp.zeros(3))
        return tp, opt_state, gstate, m["loss"]

    stack = lambda xs: jax.tree.map(lambda *ls: jnp.stack(ls), *xs)  # noqa: E731
    tps, gss, gts, camss = zip(*jsetups)
    opts = [tx.init(tp) for tp in tps]
    par = jsharding.build_scene_parallel_step(scene_step, meshes[2])
    tp_s, opt_s, gs_s, losses = jax.device_get(par(stack(tps), stack(opts), stack(gss),
                                                   jnp.stack(gts), stack(camss)))
    np.testing.assert_allclose(res[0]["losses"][0], losses, rtol=1e-5)
    g0, gs0, mu0, _ = fields(res[0]["state"])
    jg0 = jax.tree.map(lambda x: x[0], tp_s.gauss)
    jmu = jtrain.unflatten_gauss_t(jnp.asarray(opt_s.mu_flat[0]), jg0)
    assert_matches_gof_params(g0, mu0, jg0, jmu, gs0["active"])
    np.testing.assert_array_equal(gs0["denom"], gs_s.denom[0])


# ---------------------------------------------------------------------------
# Point-sharded field evaluation
# ---------------------------------------------------------------------------


def field_setup():
    """gof_tpu's sharded-field test scene (tests/test_sharding.py:264-292)."""
    rng = np.random.default_rng(0)
    n = 128
    pts3d = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    cols = rng.random((n, 3)).astype(np.float32)
    gauss, gstate = jgm.init_from_points(pts3d, cols, sh_degree=0, capacity=n)
    cams = [dict(eye=(2.5 * np.sin(t), 0.5, 2.5 * np.cos(t)), target=(0, 0, 0), width=48,
                 height=48, uid=i) for i, t in enumerate(np.linspace(0, np.pi, 2))]
    # query points NOT a multiple of 8: exercises the far-point padding
    q = rng.normal(size=(101, 3)).astype(np.float32) * 0.5
    return jax.device_get((gauss, gstate)), cams, q


def test_sharded_field_matches_unsharded_and_gof_tpu(meshes):
    (gauss, gstate), cams, q = field_setup()
    tp, ts = tgm.from_numpy(gauss, gstate)
    tcams = [tcam.look_at_camera(**c) for c in cams]
    a0 = tex.FieldEvaluator(tp, ts, tcams, 0, 0.1).alpha(q)
    a8 = tex.FieldEvaluator(tp, ts, tcams, 0, 0.1, devices=["cpu"] * 8).alpha(q)
    assert a8.shape == a0.shape == (101,) and a8.dtype == np.float32
    np.testing.assert_array_equal(a8, a0)
    assert 0 < a0.max() and a0.min() < 1
    jcams = [jcam.look_at_camera(**c) for c in cams]
    want = jex.FieldEvaluator(jax.tree.map(jnp.asarray, gauss), jax.tree.map(jnp.asarray, gstate),
                              jcams, 0, 0.1, 1 << 12, interpret=True, mesh=meshes[8]).alpha(q)
    np.testing.assert_allclose(a8, want, rtol=1e-5, atol=1e-6)


def test_sharded_level_set_mesh_equals_unsharded(tmp_path):
    """extract_level_set_mesh with shard=3 (three CPU shards) writes the
    unsharded mesh: the same vertices and faces (test_torch_mesh.py's known
    scene: 8 opaque gaussians near the origin, 4 views on a ring)."""
    rng = np.random.default_rng(5)
    n, size = 8, 48
    q = rng.normal(size=(n, 4))
    params = jgm.GaussianParams(
        xyz=(rng.normal(size=(n, 3)) * 0.4).astype(np.float32),
        features_dc=np.zeros((n, 1, 3), np.float32), features_rest=np.zeros((n, 0, 3), np.float32),
        scaling=np.log(np.full((n, 3), 0.25, np.float32)),
        rotation=(q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32),
        opacity=np.full((n,), np.log(0.95 / 0.05), np.float32))
    z = np.zeros((n,), np.float32)
    tp, ts = tgm.from_numpy(params, jgm.GaussianState(np.ones((n,), bool), z + 1e-4, z, z, z, z))
    tcams = [tcam.look_at_camera(eye=(3.0 * np.sin(a), 1.0, 3.0 * np.cos(a)), target=(0, 0, 0),
                                 width=size, height=size, uid=i)
             for i, a in enumerate(np.linspace(0, 2 * np.pi, 4, endpoint=False))]
    meta = (torch.stack([c.world_view for c in tcams]), torch.stack([c.focal_x for c in tcams]),
            torch.stack([c.focal_y for c in tcams]), torch.full((4,), float(size)),
            torch.full((4,), float(size)))
    out = {}
    for shard in (0, 3):
        res = tex.extract_level_set_mesh(tp, ts, tcams, meta, str(tmp_path / f"s{shard}"), 0, 0.1,
                                         quiet=True, shard=shard)
        out[shard] = tply.read_ply(res["path"])
        assert res["faces"] > 20
    (v0, f0), (v3, f3) = out[0], out[3]
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(v3[k], v0[k])
    np.testing.assert_array_equal(f3, f0)


@pytest.mark.slow
def test_dp_lr_scaling_tracks_single_camera_sgd():
    """gof_tpu's semantics test (tests/test_sharding.py:120-201) on the
    port: dp=2 at lr x1.41 for 16 steps tracks dp=1 for 32 steps on a
    renderable toy scene."""
    import dataclasses

    from gof_tpu_torch.ops import render as trender

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(128, 3)).astype(np.float32) * 0.5
    cols = rng.random((128, 3)).astype(np.float32)
    gauss, gstate = tgm.init_from_points(pts, cols, 1, 256)
    cams = [dict(eye=(3.0 * np.sin(t), 0.8, 3.0 * np.cos(t)), target=(0, 0, 0), width=48,
                 height=48, uid=i) for i, t in enumerate(np.linspace(0, 2 * np.pi, 8,
                                                                     endpoint=False))]
    tcams = [tcam.look_at_camera(**c) for c in cams]
    tgt = dataclasses.replace(gauss, features_dc=gauss.features_dc + 0.6 * torch.from_numpy(
        rng.standard_normal(gauss.features_dc.shape).astype(np.float32)))

    def render_view(g, cam):
        out = trender.render(cam, g.xyz, tgm.filtered_scaling(g, gstate.filter_3d), g.rotation,
                             tgm.filtered_opacity(g, gstate.filter_3d), tgm.get_features(g), 1,
                             0.1, torch.zeros(3), active_mask=gstate.active, with_stats=False,
                             with_reg=False)
        return out.image[:3]

    with torch.no_grad():
        gts = np.stack([render_view(tgt, c).numpy() for c in tcams])
    numpy_state = jgm.GaussianState(*[getattr(gstate, f).numpy() for f in ttrain.STATE_FIELDS])
    numpy_params = jgm.GaussianParams(*[getattr(gauss, f).numpy() for f in ttrain.GAUSS_FIELDS])

    def run(dp, n_steps, lr_mult):
        o = tconfig.OptimizationParams()
        o = dataclasses.replace(
            o, position_lr_init=o.position_lr_init * lr_mult,
            position_lr_final=o.position_lr_final * lr_mult, feature_lr=o.feature_lr * lr_mult,
            scaling_lr=o.scaling_lr * lr_mult, rotation_lr=o.rotation_lr * lr_mult,
            opacity_lr=o.opacity_lr * lr_mult)
        order = np.concatenate([np.random.default_rng(42).permutation(8)
                                for _ in range(n_steps * dp // 8 + 1)])
        case = steps.train_case(numpy_params, numpy_state, gts, [c.numpy() for c in tcams],
                                order[:max(n_steps, 1) * dp].reshape(-1, dp), o,
                                tconfig.ModelParams(sh_degree=1, kernel_size=0.1),
                                tconfig.PipelineParams(), 1.0, 0, with_reg=False)
        if n_steps == 0:
            blob = ttrain.checkpoint_blob(ttrain.TrainParams(gauss=gauss),
                                          ttrain.make_optimizer(o, 1.0).init(
                                              ttrain.TrainParams(gauss=gauss)), gstate, 0)
        elif dp == 1:
            blob = steps.run(case, "cpu")["state"]
        else:
            blob = sharding.launch(steps.dp_steps, dp, ["cpu"] * dp, ([case],))[0][0]["state"]
        g = ttrain.state_from_blob(blob)[0].gauss
        with torch.no_grad():
            return float(np.mean([float(torch.mean(torch.abs(render_view(g, c) - torch.from_numpy(
                gts[j])))) for j, c in enumerate(tcams)]))

    n = 16
    l_dp1 = run(1, 2 * n, 1.0)
    l_dp2 = run(2, n, 1.41)
    l0 = run(1, 0, 1.0)
    assert l_dp1 < 0.6 * l0
    assert l_dp2 < 0.6 * l0
    assert l_dp2 < l_dp1 * 1.25, (l_dp2, l_dp1)
