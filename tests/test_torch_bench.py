"""gof_tpu_torch.bench and the LPIPS converter against gof_tpu.

The same numpy inputs go through the root bench.py (imported from its file;
it imports JAX only inside its functions) or gof_tpu and through the port;
gof_tpu runs its Pallas kernels in interpret mode. What is held, and how
closely:

- `make_state`: every field bit-equal to bench.py's, and the generator left
  in the same state, for n in {1, 257}, each sigma of bench's points and a
  spread.
- the headline and orbit cameras: gof_tpu's look_at_camera matrices,
  within 1 ulp of float32.
- one step of each bench phase (statistics on at step 5000; regularizers
  on at step 20000) at a few hundred gaussians of make_state's recipe at
  log-scale mean -0.5 (gof_tpu's gradient-test scales, ROADMAP C9), 64x48,
  SH 3, with gof_tpu's
  appearance init carried (app_from_numpy): test_torch_train.py's step
  bounds (losses within rtol 1e-5; gradients within 1e-4 of their largest
  magnitude; params where the gradient is not near zero within rtol 1e-5;
  statistics within 1e-4, counts equal); the appearance state is stepped
  with zero gradients on both sides, so it stays as it was.
- two orbit epochs over 3 cameras against gof_tpu's scan-windowed
  multi-step (n_inner 3, liveness on at live_capacity = key_capacity), at
  learning rates 0 (see ZERO_LR): the cache rows, packed[:, 2], [:, 7] and
  [:, 9] equal, the losses within rtol 1e-5.
- `main(["--cpu", ...])` with the late points and the orbit shrunk: the
  last stdout line parses with exactly bench.py's keys; without --cpu and
  without CUDA, main raises.
- the LPIPS converter: on small fake checkpoints with the real key names,
  the .npz equals gof_tpu's converter's in keys, dtypes and bytes; the
  sha256 prefix check refuses other files.
"""

import hashlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import cameras as jcam
from gof_tpu import config as jconfig
from gof_tpu import train as jtrain
from gof_tpu.model import appearance as japp
from gof_tpu.model import gaussians as jgm
from gof_tpu.ops import binning as jb
from gof_tpu.utils import lpips as jlpips
from gof_tpu_torch import bench
from gof_tpu_torch import config as tconfig
from gof_tpu_torch import train as ttrain
from gof_tpu_torch.model import appearance as tapp
from gof_tpu_torch.ops import binning as tb
from gof_tpu_torch.scripts import convert_lpips_weights as tconv

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 1e-4
W, H = 64, 48
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline",
    *(f"{p}_{k}" for p in ("late", "late3m", "orbit")
      for k in ("iters_per_sec", "keys", "vs_baseline")),
    "orbit_live_frac", "orbit_skip_frac",
}


def load_root_bench():
    spec = importlib.util.spec_from_file_location("gof_root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = load_root_bench()


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-12))


# ---------------------------------------------------------------------------
# make_state and the cameras
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,sigma,spread", [(n, s, 1.0) for n in (1, 257)
                                            for s in (-3.2, -4.3, -4.8)] + [(257, -3.2, 0.5)])
def test_make_state_matches_bench(n, sigma, spread):
    r_port, r_jax = np.random.default_rng(1), np.random.default_rng(1)
    params, state = bench.make_state(n, r_port, spread=spread, sigma=sigma)
    jparams, jstate = jax.device_get(jbench.make_state(n, r_jax, spread=spread, sigma=sigma))
    for obj, jobj in ((params, jparams), (state, jstate)):
        for f in jobj._fields:
            got, want = getattr(obj, f), np.asarray(getattr(jobj, f))
            assert got.dtype == want.dtype and got.shape == want.shape, f
            assert got.tobytes() == want.tobytes(), f
    assert r_port.uniform() == r_jax.uniform()  # the same draws consumed


def assert_cameras_equal(tc, jc):
    assert (tc.width, tc.height, tc.uid) == (jc.width, jc.height, int(jc.uid))
    for f in ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy"):
        got, want = getattr(tc, f).numpy(), np.asarray(getattr(jc, f))
        np.testing.assert_allclose(got, want, rtol=2**-23, atol=2**-23, err_msg=f)


def test_headline_and_orbit_cameras_match_gof_tpu():
    assert_cameras_equal(bench.headline_camera(1237, 822),
                         jcam.look_at_camera(eye=(0, 0, 0), target=(0, 0, 5.0), width=1237,
                                             height=822))
    for n_cams in (3, 8):
        cams = bench.orbit_cameras(n_cams, 1237, 822)
        assert len(cams) == n_cams
        for i, th in enumerate(np.linspace(-0.7, 0.7, n_cams)):
            assert_cameras_equal(cams[i], jcam.look_at_camera(
                eye=(1.2 * np.sin(th), 0.35 * np.cos(th), 0.0), target=(0, 0, 5.0), width=1237,
                height=822, uid=i))


# ---------------------------------------------------------------------------
# One step of each bench phase
# ---------------------------------------------------------------------------

# make_state's recipe at gof_tpu's gradient-test scales (ROADMAP C9): at
# bench's sigma -3.2 the f32 chain of a small gaussian's scales, rotation
# and means gradients cancels (gof_tpu's own is 3.1e-3 of max off float64)
N_STEP, STEP_SIGMA = 300, -0.5


def jax_app():
    return jax.device_get(japp.init_appearance(jax.random.PRNGKey(0)))


def jax_setup(params, state, pipe, opt=None, **build):
    opt = opt or jconfig.OptimizationParams()
    tx = jtrain.make_optimizer(opt, 5.0)
    net, emb = jax_app()
    tp = jtrain.TrainParams(gauss=jgm.GaussianParams(**jax.tree.map(jnp.asarray, vars(params))),
                            app_net=jax.tree.map(jnp.asarray, net), app_emb=jnp.asarray(emb))
    step = jtrain.build_train_step(opt, jconfig.ModelParams(sh_degree=3, kernel_size=0.1), pipe,
                                   tx, interpret=True, **build)
    return (step, tp, tx.init(tp),
            jgm.GaussianState(**jax.tree.map(jnp.asarray, vars(state))))


def port_setup(params, state):
    net, emb = jax_app()
    return bench.Setup(params, state, "cpu", app=tapp.app_from_numpy(net, emb))


@pytest.fixture(scope="module")
def phase_case():
    rng = np.random.default_rng(1)
    params, state = bench.make_state(N_STEP, rng, sigma=STEP_SIGMA)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    return params, state, gt


@pytest.mark.parametrize("phase", list(bench.PHASES))
def test_bench_phase_step_matches_gof_tpu(phase_case, phase):
    params, state, gt = phase_case
    with_stats, with_reg, step_i = bench.PHASES[phase]
    jstep, jtp, jst, jgs = jax_setup(params, state, jconfig.PipelineParams(key_capacity=8192),
                                     with_stats=with_stats, with_reg=with_reg)
    jtp, jst, jgs, jm = jax.device_get(jstep(jtp, jst, jgs, jnp.asarray(gt), jnp.int32(step_i),
                                             jcam.look_at_camera(eye=(0, 0, 0),
                                                                 target=(0, 0, 5.0), width=W,
                                                                 height=H), jnp.zeros(3)))
    setup = port_setup(params, state)
    tp, st, gs = setup.fresh()
    assert tp.app_net is not None
    tp, st, gs, m = setup.step_fn(with_stats, with_reg)(
        tp, st, gs, t(gt), step_i, bench.headline_camera(W, H), torch.zeros(3))

    for k in ("loss", "l1", "ssim", "psnr", "distortion", "depth_normal"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-7), k
    for k in ("num_keys", "compact_demand"):
        assert int(m[k]) == int(jm[k]), k
    if with_reg:
        assert float(jm["distortion"]) > 0 and float(jm["depth_normal"]) > 0
    assert st.count == int(jst.count) == 1
    jmu = jtrain.unflatten_gauss_t(jnp.asarray(jst.mu_flat), jtp.gauss)
    for f in ttrain.GAUSS_FIELDS:
        got, want = getattr(st.mu, f).numpy(), np.asarray(getattr(jmu, f))
        assert np.isfinite(got).all() and np.abs(want).max() > 0, f
        assert rel_err(got, want) <= BOUND, (f, rel_err(got, want))
        sel = np.abs(want) > 1e-3 * np.abs(want).max()
        close(getattr(tp.gauss, f).detach().numpy()[sel], np.asarray(getattr(jtp.gauss, f))[sel])
    for f in ("grad_accum", "grad_abs_accum"):
        assert rel_err(getattr(gs, f).numpy(), np.asarray(getattr(jgs, f))) <= BOUND, f
    for f in ("denom", "max_radii2d", "active"):
        np.testing.assert_array_equal(getattr(gs, f).numpy(), np.asarray(getattr(jgs, f)), f)
    # the carried appearance state: zero gradients, so Adam leaves it as it was
    net, emb = jax_app()
    np.testing.assert_array_equal(tp.app_emb.numpy(), emb)
    np.testing.assert_array_equal(np.asarray(jtp.app_emb), emb)
    want_net = tapp.app_from_numpy(net, emb)[0].state_dict()
    for k, v in tp.app_net.state_dict().items():
        assert torch.equal(v, want_net[k]), k
    assert all(not x.any() for x in st.mu_app.values())
    assert not any(np.asarray(x).any() for x in jax.tree.leaves(jst.mu_app))


# ---------------------------------------------------------------------------
# Two orbit epochs
# ---------------------------------------------------------------------------

N_ORBIT, ORBIT_SIGMA, ORBIT_CAMS = 800, -0.7, 3
CAP = 1 << 15
# gof_tpu's backward leaves the rows past the T cutoff the suffix
# subtraction's residue (~1e-10), the port exactly zero (ROADMAP C20), and
# Adam's first step turns any nonzero gradient into a full learning-rate
# step, so after one visit the states differ in the gaussians behind
# saturated pixels. The epochs run at learning rates 0 on both sides: the
# loop's own work (cameras, cache rows, limits, counts, losses) is held;
# the step's update is held by the phase tests above and
# test_torch_liveness.py.
ZERO_LR = dict(position_lr_init=0.0, position_lr_final=0.0, feature_lr=0.0, opacity_lr=0.0,
               scaling_lr=0.0, rotation_lr=0.0, appearance_network_lr=0.0,
               appearance_embeddings_lr=0.0)


def test_orbit_epochs_match_gof_tpu():
    rng = np.random.default_rng(1)
    params, state = bench.make_state(N_ORBIT, rng, sigma=ORBIT_SIGMA)
    gts = rng.uniform(0, 1, (ORBIT_CAMS, 3, H, W)).astype(np.float32)
    ntx, nty = tb.tile_grid(W, H)
    jstep, jtp, jst, jgs = jax_setup(
        params, state, jconfig.PipelineParams(key_capacity=CAP, live_capacity=CAP),
        jconfig.OptimizationParams(**ZERO_LR), with_stats=False, with_reg=True,
        n_inner=ORBIT_CAMS, live_ntiles=ntx * nty)
    jcams = [jcam.look_at_camera(eye=(1.2 * np.sin(th), 0.35 * np.cos(th), 0.0),
                                 target=(0, 0, 5.0), width=W, height=H, uid=i)
             for i, th in enumerate(np.linspace(-0.7, 0.7, ORBIT_CAMS))]
    cam_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *jcams)
    jcache = jnp.full((ORBIT_CAMS, ntx * nty), jb.LIM_INF, jnp.int32)
    jstep0 = jnp.asarray(bench.ORBIT_STEP, jnp.int32)

    setup = port_setup(params, state)
    setup.opt = tconfig.OptimizationParams(**ZERO_LR)
    setup.tx = ttrain.make_optimizer(setup.opt, 5.0)
    step_fn = setup.step_fn(False, True)
    pstate = setup.fresh()
    cache = torch.full((ORBIT_CAMS, ntx * nty), tb.LIM_INF, dtype=torch.int32)
    step_i = bench.ORBIT_STEP
    cams = bench.orbit_cameras(ORBIT_CAMS, W, H)
    packs = []
    for epoch in range(2):
        jtp, jst, jgs, out = jstep(jtp, jst, jgs, jnp.asarray(gts),
                                   jnp.arange(ORBIT_CAMS, dtype=jnp.int32), jstep0, cam_stack,
                                   jnp.zeros(3), live_cache=jcache)
        jcache, jstep0 = out["live_cache"], out["step_next"]
        jpacked = np.asarray(out["packed_all"])
        pstate, step_i, packed = bench.orbit_epoch(step_fn, pstate, cams, t(gts),
                                                   torch.zeros(3), cache, step_i)
        packed = packed.numpy()
        np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache), f"epoch {epoch}")
        for col in (2, 7, 9):
            np.testing.assert_array_equal(packed[:, col], jpacked[:, col], f"epoch {epoch}")
        np.testing.assert_allclose(packed[:, 0], jpacked[:, 0], rtol=1e-5)
        assert step_i == int(jstep0) == bench.ORBIT_STEP + ORBIT_CAMS * (epoch + 1)
        packs.append(packed)
    # the one-epoch-stale limits cut: the second epoch walks fewer keys
    assert (packs[1][:, 7] < packs[0][:, 7]).all()
    assert (cache.numpy() < tb.LIM_INF).all()
    assert pstate[1].count == int(jst.count) == 2 * ORBIT_CAMS


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def test_main_cpu_prints_bench_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench, "LATE_POINTS", (("late", 200, -4.3), ("late3m", 300, -4.8)))
    monkeypatch.setattr(bench, "ORBIT_GAUSSIANS", 200)
    rec = bench.main(["--cpu", "--gaussians", "150", "--width", "64", "--height", "48",
                      "--reps", "2", "--orbit", "2"])
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last == rec and set(last) == BENCH_KEYS
    assert len(out.strip().splitlines()) == 1
    assert all(line.startswith("# ") for line in err.strip().splitlines())
    assert last["metric"] == "full_train_step_iters_per_sec" and last["unit"] == "iters/s"
    for k, v in last.items():
        if k.endswith(("iters_per_sec", "vs_baseline")) or k == "value":
            assert np.isfinite(v) and v > 0, k
    assert last["vs_baseline"] == pytest.approx(last["value"] / 11.1, abs=1e-3)
    assert all(last[f"{p}_keys"] > 0 for p in ("late", "late3m", "orbit"))
    assert 0 < last["orbit_live_frac"] <= 1 and 0 <= last["orbit_skip_frac"] <= 1


def test_main_needs_cuda_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--gaussians", "10", "--no-late", "--orbit", "0"])


def test_flags_match_bench_py():
    """bench.py's flags and defaults, --capacity aside."""
    args = bench.parse([])
    assert vars(args) == {"gaussians": 100_000, "width": 1237, "height": 822, "reps": 20,
                          "late": True, "orbit": 8, "cpu": False}
    assert not bench.parse(["--no-late"]).late
    src = open(os.path.join(REPO, "bench.py")).read()
    for flag in ("--gaussians", "--width", "--height", "--reps", "--no-late", "--orbit", "--cpu",
                 "default=100_000", "default=1237", "default=822", "default=20", "default=8"):
        assert flag in src, flag


# ---------------------------------------------------------------------------
# The LPIPS converter
# ---------------------------------------------------------------------------


def fake_checkpoints(tmp_path):
    """Small state dicts under the real checkpoints' key names (torchvision
    vgg16: features.* and classifier.*; LPIPS: lin0..lin4 heads)."""
    g = torch.Generator().manual_seed(0)
    vgg = {}
    for i, (cin, cout) in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
                              [(3, 4), (4, 4), (4, 5), (5, 5), (5, 6), (6, 6), (6, 6),
                               (6, 7), (7, 7), (7, 7), (7, 8), (8, 8), (8, 8)]):
        vgg[f"features.{i}.weight"] = torch.randn((cout, cin, 3, 3), generator=g)
        vgg[f"features.{i}.bias"] = torch.randn((cout,), generator=g)
    vgg["classifier.0.weight"] = torch.randn((3, 5), generator=g)
    vgg["classifier.0.bias"] = torch.randn((3,), generator=g)
    lin = {f"lin{k}.model.1.weight": torch.rand((1, c, 1, 1), generator=g)
           for k, c in enumerate((4, 5, 6, 7, 8))}
    lin["scaling_layer.shift"] = torch.zeros((1, 3, 1, 1))
    paths = str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth")
    torch.save(vgg, paths[0])
    torch.save(lin, paths[1])
    return paths


def test_lpips_converter_matches_gof_tpu(tmp_path):
    vgg, lin = fake_checkpoints(tmp_path)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "gof_tpu.npz")
    tconv.convert_torch_weights(vgg, lin, ours)
    jlpips.convert_torch_weights(vgg, lin, theirs)
    a, b = np.load(ours), np.load(theirs)
    assert list(a.keys()) == list(b.keys())
    assert any(k.startswith("features.") for k in a) and "lin4.model.1.weight" in a
    assert not any(k.startswith(("classifier", "scaling")) for k in a)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_lpips_converter_checks_the_vgg16_hash(tmp_path, capsys):
    vgg, lin = fake_checkpoints(tmp_path)
    out = str(tmp_path / "w.npz")
    with pytest.raises(SystemExit, match=tconv.VGG16_SHA256_PREFIX):
        tconv.main(["--vgg", vgg, "--lpips", lin, "--out", out])
    assert not os.path.exists(out)
    tconv.main(["--vgg", vgg, "--lpips", lin, "--out", out, "--skip_hash_check"])
    assert "WARNING" in capsys.readouterr().out and os.path.exists(out)
    with open(vgg, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest()[:8] != tconv.VGG16_SHA256_PREFIX
