"""The dense oracle, the tiled reference renderer and the `xla` render
backend of gof_tpu_torch against gof_tpu, and the port's kernel path
(plain versions on the CPU) against its own oracle.

- `render_oracle` (image, T, sum w*m), `render_tiles_xla` (all 16 tile
  channels, on gof_tpu's binning and payload) and `render(backend="xla")`
  against gof_tpu's: within atol 1e-5, rtol 1e-4 (the repo's Pallas-vs-XLA
  tolerance); the xla backend's live and compact fields are zeros, as
  gof_tpu's are.
- The six cases of tests/test_oracle.py, on the port's oracle.
- The port's pallas path against its oracle on a scene whose gaussians
  cover the whole image (tests/test_binning.py's full-cover scene, so
  tile culling drops nothing): image and T within gof_tpu's tiled-vs-oracle
  tolerance (rtol 2e-4; atol 2e-5, 2e-6 for T); gradients of a weighted
  sum of channels 0-7 with respect to every model tensor and to the
  rasterizer's inputs (rgb, opacity, M, u0) within gof_tpu's Pallas-vs-XLA
  gradient bound, max |pallas - oracle| <= 1e-4 * max |oracle|
  (tests/test_rasterize.py:154-157). These are the tolerances the GPU
  smoke run holds the CUDA path to.
- The pallas and xla backends on culled scenes (see the test for the
  scales' and rotations' wider bound, which gof_tpu's backends share).
- An unknown backend raises ValueError, in render and in the train step.
- One train step on the xla backend against gof_tpu's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import cameras as jcam
from gof_tpu import config as jconfig
from gof_tpu import train as jtrain
from gof_tpu.constants import ALPHA_OFFSET, DEPTH_OFFSET, DISTORTION_OFFSET
from gof_tpu.model import gaussians as jgm
from gof_tpu.ops import binning as jb
from gof_tpu.ops import oracle as joracle
from gof_tpu.ops import quadrics as jq
from gof_tpu.ops import render as jrender
from gof_tpu.ops import tiled_ref as jtr
from gof_tpu.sh import rgb_to_sh_dc
from gof_tpu_torch import cameras as tcam
from gof_tpu_torch import config as tconfig
from gof_tpu_torch import train as ttrain
from gof_tpu_torch.model import gaussians as tgm
from gof_tpu_torch.ops import binning as tb
from gof_tpu_torch.ops import oracle as toracle
from gof_tpu_torch.ops import quadrics
from gof_tpu_torch.ops import render as trender
from gof_tpu_torch.ops import tiled_ref as ttr
from gof_tpu_torch.sh import rgb_to_sh_dc as t_rgb_to_sh_dc

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
ORACLE_RTOL, ORACLE_ATOL, ORACLE_T_ATOL = 2e-4, 2e-5, 2e-6
GRAD_BOUND = 1e-4
SCALE_ROT_BOUND = 2e-3
BG = np.array([0.2, 0.3, 0.4], np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def make_scene(seed, n=40, width=96, height=64, scale=0.15, z_span=(3.0, 8.0)):
    """tests/test_binning.py's make_scene as numpy arrays."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(*z_span, size=n)
    x = rng.uniform(-1.0, 1.0, size=n) * z * 0.2
    y = rng.uniform(-1.0, 1.0, size=n) * z * 0.2
    means = np.stack([x, y, z], -1)
    scales = rng.uniform(0.5, 1.5, size=(n, 3)) * scale
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, size=n)
    colors = rng.uniform(0.05, 0.95, size=(n, 3))
    shs = np.asarray(rgb_to_sh_dc(jnp.asarray(colors, jnp.float32)))[:, None, :]
    arrays = [np.asarray(a, np.float32) for a in (means, scales, q, opac, shs)]
    return arrays, dict(eye=(0, 0, 0), target=(0, 0, 5.0), width=width, height=height)


def full_cover_scene(seed=0):
    """Gaussians whose rects cover the whole image: the tiled renderers are
    then the oracle."""
    return make_scene(seed, n=12, scale=0.9, z_span=(4.0, 7.0))


# ---------------------------------------------------------------------------
# Against gof_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel_size", [0.0, 0.1])
def test_render_oracle_matches_gof_tpu(kernel_size):
    arrays, cam = make_scene(1, n=30, width=48, height=40)
    active = np.arange(30) < 27
    want = jax.device_get(joracle.render_oracle(
        *map(jnp.asarray, arrays[:4]), jnp.asarray(arrays[4]), 0, jcam.look_at_camera(**cam),
        kernel_size, jnp.asarray(BG), active_mask=jnp.asarray(active)))
    got = toracle.render_oracle(*map(t, arrays[:4]), t(arrays[4]), 0, tcam.look_at_camera(**cam),
                                kernel_size, t(BG), active_mask=t(active))
    for k in ("image", "transmittance", "depth_ndc_sum"):
        np.testing.assert_allclose(getattr(got, k).numpy(), getattr(want, k), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    assert got.image.shape == (9, 40, 48)


def test_render_tiles_xla_matches_gof_tpu():
    arrays, cam = make_scene(2, n=60)
    jc = jcam.look_at_camera(**cam)
    m, s, r, o, sh = map(jnp.asarray, arrays)
    pre = jq.preprocess(m, s, r, sh, 0, jc, 0.1)
    ntx, nty = jb.tile_grid(jc.width, jc.height)
    rects = jb.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty)
    b = jb.bin_gaussians(pre.depth, rects, ntx, nty, capacity=8192)
    op_eff = o * jnp.where(pre.valid, pre.coef, 0.0)
    payload = jtr.build_payload(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b)
    L = max(int(np.asarray(b.bounds[1:] - b.bounds[:-1]).max()), 1)
    want = np.asarray(jtr.render_tiles_xla(payload, b, ntx, nty, jc.width, jc.height,
                                           jc.focal_x, jc.focal_y, jnp.asarray(BG), L))
    bn = jax.device_get(b)
    port_b = tb.Binning(slot_to_gaussian=t(bn.slot_to_gaussian), bounds=t(bn.bounds),
                        num_keys=torch.tensor(int(bn.num_keys)), overflow=torch.tensor(False),
                        num_slots=torch.tensor(int(bn.num_slots)))
    tc = tcam.look_at_camera(**cam)
    pp = ttr.build_payload(t(pre.rgb), t(op_eff), t(pre.v2g_M), t(pre.v2g_u0), port_b)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(payload))
    got = ttr.render_tiles_xla(pp, port_b, ntx, nty, tc.width, tc.height, tc.focal_x,
                               tc.focal_y, t(BG), L)
    assert got.shape == want.shape == (ntx * nty, ttr.OUT_CH, 1024)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    rx, ry = ttr.tile_rays(ntx, nty, tc.width, tc.height, tc.focal_x, tc.focal_y)
    jrx, jry = jtr.tile_rays(ntx, nty, jc.width, jc.height, jc.focal_x, jc.focal_y)
    np.testing.assert_array_equal(rx.numpy(), np.asarray(jrx))
    np.testing.assert_array_equal(ry.numpy(), np.asarray(jry))


def test_render_xla_backend_matches_gof_tpu():
    arrays, cam = make_scene(3, n=80)
    active = np.arange(80) < 75
    m, s, r, o, sh = map(jnp.asarray, arrays)
    want = jax.device_get(jrender.render(jcam.look_at_camera(**cam), m, s, r, o, sh, 0, 0.1,
                                         jnp.asarray(BG), active_mask=jnp.asarray(active),
                                         capacity=8192, backend="xla"))
    got = trender.render(tcam.look_at_camera(**cam), *map(t, arrays[:4]), t(arrays[4]), 0, 0.1,
                         t(BG), active_mask=t(active), backend="xla")
    np.testing.assert_allclose(got.image.numpy(), want.image, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.transmittance.numpy(), want.transmittance, atol=ATOL,
                               rtol=RTOL)
    for k in ("radii", "visibility", "num_keys", "live_counts", "live_bad", "live_demand",
              "compact_demand"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), k)
    assert not got.live_counts.any() and int(got.compact_demand) == 0
    assert not bool(got.overflow) and not bool(got.compact_overflow)


# ---------------------------------------------------------------------------
# tests/test_oracle.py's cases on the port
# ---------------------------------------------------------------------------


def single_gaussian_scene(color=(1.0, 0.0, 0.0), z=4.0, scale=0.3):
    means = torch.tensor([[0.0, 0.0, z]])
    scales = torch.full((1, 3), scale)
    rots = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    opac = torch.tensor([0.9])
    shs = torch.zeros((1, 1, 3))
    shs[0, 0] = t_rgb_to_sh_dc(torch.tensor(color))
    cam = tcam.look_at_camera(eye=(0, 0, 0), target=(0, 0, z), width=32, height=32)
    return means, scales, rots, opac, shs, cam


def test_oracle_center_blob():
    means, scales, rots, opac, shs, cam = single_gaussian_scene()
    img = toracle.render_oracle(means, scales, rots, opac, shs, 0, cam, 0.0,
                                torch.zeros(3)).image.numpy()
    assert img[0, 16, 16] > 0.5
    assert img[1, 16, 16] < 1e-3
    assert img[0, 0, 0] < 1e-2
    assert img[ALPHA_OFFSET, 16, 16] > 0.8
    assert abs(img[DEPTH_OFFSET, 16, 16] - 4.0) < 1e-2


def test_oracle_background_blend():
    means, scales, rots, opac, shs, cam = single_gaussian_scene()
    out = toracle.render_oracle(means, scales, rots, opac, shs, 0, cam, 0.0,
                                torch.tensor([0.0, 0.0, 1.0]))
    img = out.image.numpy()
    assert img[2, 0, 0] > 0.99
    T = out.transmittance.numpy()[16, 16]
    assert abs(img[2, 16, 16] - T * 1.0) < 1e-5


def test_oracle_depth_ordering_occlusion():
    means = torch.tensor([[0.0, 0.0, 3.0], [0.0, 0.0, 6.0]])
    scales = torch.full((2, 3), 0.4)
    rots = torch.tensor([[1.0, 0, 0, 0]]).repeat(2, 1)
    opac = torch.tensor([0.99, 0.99])
    shs = torch.zeros((2, 1, 3))
    shs[0, 0] = t_rgb_to_sh_dc(torch.tensor([1.0, 0.0, 0.0]))
    shs[1, 0] = t_rgb_to_sh_dc(torch.tensor([0.0, 1.0, 0.0]))
    cam = tcam.look_at_camera(eye=(0, 0, 0), target=(0, 0, 1.0), width=16, height=16)
    img = toracle.render_oracle(means, scales, rots, opac, shs, 0, cam, 0.0,
                                torch.zeros(3)).image.numpy()
    assert img[0, 8, 8] > 5 * img[1, 8, 8]
    img2 = toracle.render_oracle(means.flip(0), scales, rots, opac, shs.flip(0), 0, cam, 0.0,
                                 torch.zeros(3)).image.numpy()
    np.testing.assert_allclose(img, img2, atol=1e-5)


def test_oracle_normals_face_camera():
    means, scales, rots, opac, shs, cam = single_gaussian_scene(scale=0.3)
    img = toracle.render_oracle(means, scales, rots, opac, shs, 0, cam, 0.0,
                                torch.zeros(3)).image.numpy()
    n = img[3:6, 16, 16] / max(img[ALPHA_OFFSET, 16, 16], 1e-6)
    assert n[2] < -0.9


def test_oracle_distortion_two_surfaces():
    rots = torch.tensor([[1.0, 0, 0, 0]])
    scales = torch.full((1, 3), 0.5)
    shs = torch.zeros((1, 1, 3))
    cam = tcam.look_at_camera(eye=(0, 0, 0), target=(0, 0, 1.0), width=16, height=16)
    one = toracle.render_oracle(torch.tensor([[0, 0, 4.0]]), scales, rots, torch.tensor([0.5]),
                                shs, 0, cam, 0.0, torch.zeros(3))
    two = toracle.render_oracle(torch.tensor([[0, 0, 4.0], [0, 0, 8.0]]), scales.repeat(2, 1),
                                rots.repeat(2, 1), torch.tensor([0.5, 0.5]), shs.repeat(2, 1, 1),
                                0, cam, 0.0, torch.zeros(3))
    d1 = float(one.image[DISTORTION_OFFSET, 8, 8])
    d2 = float(two.image[DISTORTION_OFFSET, 8, 8])
    assert d2 > d1 + 1e-5


def test_oracle_gradients_flow():
    leaves = [x.clone().requires_grad_(True) for x in single_gaussian_scene()[:5]]
    cam = single_gaussian_scene()[5]
    out = toracle.render_oracle(*leaves, 0, cam, 0.1, torch.zeros(3))
    ((out.image[:3] ** 2).sum() + out.image[8].sum()).backward()
    for name, x in zip(("m", "s", "r", "o", "sh"), leaves):
        assert torch.isfinite(x.grad).all(), name
    for i in (0, 1, 3):  # means, scales, opacities
        assert (leaves[i].grad != 0).any()


# ---------------------------------------------------------------------------
# The port's kernel path against its oracle
# ---------------------------------------------------------------------------


def weights(shape, seed=1):
    return t(np.random.default_rng(seed).normal(0, 0.1, shape).astype(np.float32))


def render_grads(arrays, cam, which: str, level: str, monkeypatch):
    """Image, T and the gradients of loss = sum(image[:8] * w) from the
    oracle or one render backend: with respect to the model tensors (level
    "model": means, scales, rotations, opacities, shs) or to the
    rasterizer's per-gaussian inputs (level "raster": rgb, opacities, M,
    u0; preprocess runs once and its outputs become leaves)."""
    c = tcam.look_at_camera(**cam)
    leaves = [t(a).requires_grad_(True) for a in arrays]
    if level == "raster":
        m, s, r, o, sh = map(t, arrays)
        pre = quadrics.preprocess(m, s, r, sh, 0, c, 0.1, opacities=o)
        raster = {k: getattr(pre, k).detach().clone().requires_grad_(True)
                  for k in ("rgb", "v2g_M", "v2g_u0")}
        pre = dataclasses.replace(pre, **raster)
        monkeypatch.setattr(quadrics, "preprocess", lambda *a, **k: pre)
    if which == "oracle":
        out = toracle.render_oracle(*leaves[:4], leaves[4], 0, c, 0.1, t(BG))
    else:
        out = trender.render(c, *leaves[:4], leaves[4], 0, 0.1, t(BG), backend=which)
    (out.image[:8] * weights(out.image[:8].shape)).sum().backward()
    monkeypatch.undo()
    grads = ([x.grad for x in leaves] if level == "model" else
             [raster["rgb"].grad, leaves[3].grad, raster["v2g_M"].grad, raster["v2g_u0"].grad])
    return out.image.detach(), out.transmittance.detach(), grads


MODEL = ("means", "scales", "rotations", "opacities", "shs")
RASTER = ("rgb", "opacities", "M", "u0")


def test_pallas_path_matches_its_oracle(monkeypatch):
    arrays, cam = full_cover_scene()
    for level, names in (("model", MODEL), ("raster", RASTER)):
        img_o, T_o, g_o = render_grads(arrays, cam, "oracle", level, monkeypatch)
        img_p, T_p, g_p = render_grads(arrays, cam, "pallas", level, monkeypatch)
        np.testing.assert_allclose(img_p.numpy(), img_o.numpy(), rtol=ORACLE_RTOL,
                                   atol=ORACLE_ATOL)
        np.testing.assert_allclose(T_p.numpy(), T_o.numpy(), rtol=ORACLE_RTOL,
                                   atol=ORACLE_T_ATOL)
        for name, a, b in zip(names, g_p, g_o):
            assert torch.isfinite(a).all() and float(b.abs().max()) > 0, name
            assert rel_err(a.numpy(), b.numpy()) <= GRAD_BOUND, (level, name,
                                                                 rel_err(a.numpy(), b.numpy()))


def test_xla_backend_matches_pallas_path(monkeypatch):
    """The two backends on an ordinary (culled) scene: images within the
    Pallas-vs-XLA tolerance; the rasterizer inputs' gradients, and the
    means', opacities' and shs', within its bound. The scales' and
    rotations' gradients reach the pallas path through the quadric
    invariants' chain (rasterize.quadric_chain) and differ by more: up to
    1.4e-3 of their largest magnitude at these scenes, where gof_tpu's own
    pallas and xla backends differ by 6.5e-4 (seed 0); they are held within
    SCALE_ROT_BOUND."""
    for seed in (0, 4):
        arrays, cam = make_scene(seed, n=60 if seed else 40, width=64, height=32)
        for level, names in (("model", MODEL), ("raster", RASTER)):
            img_p, _, g_p = render_grads(arrays, cam, "pallas", level, monkeypatch)
            img_x, _, g_x = render_grads(arrays, cam, "xla", level, monkeypatch)
            np.testing.assert_allclose(img_p.numpy(), img_x.numpy(), atol=ATOL, rtol=RTOL)
            for name, a, b in zip(names, g_p, g_x):
                bound = SCALE_ROT_BOUND if name in ("scales", "rotations") else GRAD_BOUND
                assert rel_err(a.numpy(), b.numpy()) <= bound, (seed, level, name)


def step_scene(seed, n=40):
    """A train step's inputs as numpy: gaussians at SH degree 1, their
    GaussianState, a 64x48 target and the camera's arguments."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(4, 7, n)
    xyz = np.stack([rng.uniform(-1, 1, n) * z * 0.2, rng.uniform(-1, 1, n) * z * 0.2, z], -1)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    params = jgm.GaussianParams(
        xyz=f32(xyz), features_dc=f32(rng.normal(0, 0.5, (n, 1, 3))),
        features_rest=f32(rng.normal(0, 0.1, (n, 3, 3))),
        scaling=f32(np.log(rng.uniform(0.2, 0.5, (n, 3)))), rotation=f32(q),
        opacity=f32(rng.uniform(-1, 1, n)))
    zf = np.zeros((n,), np.float32)
    state = jgm.GaussianState(active=np.ones(n, bool), filter_3d=zf + 1e-3, max_radii2d=zf,
                              grad_accum=zf, grad_abs_accum=zf, denom=zf)
    gt = rng.uniform(0, 1, (3, 48, 64)).astype(np.float32)
    cam = dict(eye=(0.1, -0.05, 0.0), target=(0, 0, 5.0), width=64, height=48)
    return params, state, gt, cam


def test_unknown_backend_raises():
    """render raises on an unknown backend, and so does a train step built
    for one (through its render); a liveness limit needs the pallas
    backend."""
    arrays, cam = make_scene(5, n=4)
    args = (tcam.look_at_camera(**cam), *map(t, arrays[:4]), t(arrays[4]), 0, 0.1, t(BG))
    with pytest.raises(ValueError, match="unknown backend"):
        trender.render(*args, backend="mosaic")
    with pytest.raises(ValueError, match="needs the pallas backend"):
        trender.render(*args, backend="xla", live_limit_chunks=torch.ones(6, dtype=torch.int32))
    params, state, gt, scam = step_scene(7, n=8)
    g, s = tgm.from_numpy(params, state)
    opt = tconfig.OptimizationParams()
    tx = ttrain.make_optimizer(opt, 5.0)
    tp = ttrain.TrainParams(gauss=g)
    step = ttrain.build_train_step(opt, tconfig.ModelParams(sh_degree=1, kernel_size=0.1),
                                   tconfig.PipelineParams(backend="mosaic"), tx)
    with pytest.raises(ValueError, match="unknown backend"):
        step(tp, tx.init(tp), s, t(gt), 100, tcam.look_at_camera(**scam), torch.zeros(3))


def test_train_step_xla_backend_matches_gof_tpu():
    """One step of both packages on the xla backend (statistics on, the
    regularizers on): losses within rtol 1e-5, gradients within the bound,
    and the densification statistics zero in both (the xla render gives
    the carrier no gradient)."""
    params, state, gt, cam = step_scene(6)
    opt_kw = dict(distortion_from_iter=0, depth_normal_from_iter=0)
    jopt = jconfig.OptimizationParams(**opt_kw)
    jtx = jtrain.make_optimizer(jopt, 5.0)
    jtp = jtrain.TrainParams(gauss=jax.tree.map(jnp.asarray, params), app_net=None, app_emb=None)
    js0 = jtx.init(jtp)
    jstep = jtrain.build_train_step(jopt, jconfig.ModelParams(sh_degree=1, kernel_size=0.1),
                                    jconfig.PipelineParams(backend="xla", key_capacity=4096),
                                    jtx)
    _, js, jgs, jm = jax.device_get(jstep(jtp, js0, jax.tree.map(jnp.asarray, state),
                                          jnp.asarray(gt), jnp.int32(100),
                                          jcam.look_at_camera(**cam), jnp.zeros(3)))
    topt = tconfig.OptimizationParams(**opt_kw)
    g, s = tgm.from_numpy(params, state)
    ttx = ttrain.make_optimizer(topt, 5.0)
    step = ttrain.build_train_step(topt, tconfig.ModelParams(sh_degree=1, kernel_size=0.1),
                                   tconfig.PipelineParams(backend="xla"), ttx)
    _, st, gs, m = step(ttrain.TrainParams(gauss=g), ttrain.from_numpy(jax.device_get(js0), g),
                        s, t(gt), 100, tcam.look_at_camera(**cam), torch.zeros(3))
    for k in ("loss", "l1", "ssim", "distortion", "depth_normal"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-7), k
    jmu = jtrain.unflatten_gauss_t(jnp.asarray(js.mu_flat), params)
    for f in ttrain.GAUSS_FIELDS:
        if f == "features_rest":  # SH degree 0 at step 100
            continue
        assert rel_err(getattr(st.mu, f).numpy(), np.asarray(getattr(jmu, f))) <= GRAD_BOUND, f
    for f in ("grad_accum", "grad_abs_accum"):
        assert not getattr(gs, f).any() and not np.asarray(getattr(jgs, f)).any(), f
    np.testing.assert_array_equal(gs.denom.numpy(), np.asarray(jgs.denom))
    assert gs.denom.numpy().sum() > 30
