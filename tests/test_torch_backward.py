"""The backward slice of gof_tpu_torch against gof_tpu.

- The backward blend's plain version (`rasterize_bwd_reference`) against the
  Pallas `_bwd_kernel` in interpret mode, each side on its own forward's
  fout, for the (with_stats, with_reg) combinations: gradient rows and
  statistics within max|port - jax| / max|jax| < 1e-4 (gof_tpu's own
  Pallas-vs-XLA gradient bound, tests/test_rasterize.py:154-157) over the
  compact demand prefix; the gaussian-id stream exactly.
- The reduction and quadric chain: gradients of `rasterize` against
  `jax.grad` of gof_tpu's `rasterize`, within the same bound.
- The whole `render` (padded pool with inactive rows at the origin, one
  gaussian behind the camera): gradients of means3d, scales, rotations,
  opacities, shs and the carrier against `jax.grad` of gof_tpu's render,
  within the bound and finite. This test fails if the dilation coef is left
  attached in the port's render (gof_tpu detaches it, ops/render.py:96-98).
- Counterparts of gof_tpu's quirk tests (tests/test_rasterize.py:161-259).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import cameras as jcam
from gof_tpu.ops import binning as jb
from gof_tpu.ops import quadrics as jq
from gof_tpu.ops import rasterize_pallas as rp
from gof_tpu.ops import render as jrender
from gof_tpu.ops import tiled_ref as jtr
from gof_tpu.sh import rgb_to_sh_dc
from gof_tpu_torch import cameras as tcam
from gof_tpu_torch.ops import binning as tb
from gof_tpu_torch.ops import rasterize as tr
from gof_tpu_torch.ops import render as trender
from gof_tpu_torch.ops import tiled_ref as ttr

torch.set_num_threads(2)

BOUND = 1e-4
W, H = 64, 32
BG = np.array([0.15, 0.1, 0.2], np.float32)
SCENES = {"small_16": 16, "multi_300": 300}
FLAGS = [(True, False), (False, True), (True, True)]  # (with_stats, with_reg)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def t(a):
    return torch.from_numpy(np.array(a))


def gaussians(n, seed=11):
    rng = np.random.default_rng(seed)
    z = rng.uniform(4, 7, n)
    means = np.stack([rng.uniform(-1, 1, n) * z * 0.2, rng.uniform(-1, 1, n) * z * 0.2, z], -1)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return (means.astype(np.float32), rng.uniform(0.3, 1.0, (n, 3)).astype(np.float32),
            q.astype(np.float32), rng.uniform(0.3, 0.9, n).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def jax_setup(n):
    """gof_tpu's preprocess and binning of an n-gaussian 64x32 view."""
    means, scales, q, op, rgb = gaussians(n)
    cam = jcam.look_at_camera(eye=(0, 0, 0), target=(0, 0, 5.0), width=W, height=H)
    shs = rgb_to_sh_dc(jnp.asarray(rgb))[:, None, :]
    pre = jq.preprocess(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(q), shs, 0, cam,
                        0.1, opacities=jnp.asarray(op))
    ntx, nty = jb.tile_grid(W, H)
    rects = jb.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty, radius_xy=pre.radius_xy)
    b = jb.bin_gaussians(pre.depth, rects, ntx, nty, capacity=8192, mean2d=pre.mean2d,
                         radius=pre.radius)
    op_eff = jnp.asarray(op) * jnp.where(pre.valid, jax.lax.stop_gradient(pre.coef), 0.0)
    return pre, b, op_eff, cam, ntx, nty


def torch_binning(b):
    b = jax.device_get(b)
    return tb.Binning(slot_to_gaussian=t(b.slot_to_gaussian), bounds=t(b.bounds),
                      num_keys=torch.tensor(int(b.num_keys)), overflow=torch.tensor(False),
                      num_slots=torch.tensor(int(b.num_slots)))


@pytest.fixture(scope="module", params=sorted(SCENES))
def bwd_scene(request):
    pre, b, op_eff, cam, ntx, nty = jax_setup(SCENES[request.param])
    ntiles = ntx * nty
    meta = rp._meta_vec(cam.focal_x, cam.focal_y, jnp.asarray(BG), W, H)
    gout = np.random.default_rng(7).normal(size=(ntiles, 16, 1024)).astype(np.float32) * 0.1
    refs = {}
    for ws, wr in FLAGS:
        payload = rp.build_payload16(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b,
                                     conic=pre.conic if ws else None,
                                     mean2d=pre.mean2d if ws else None)
        fout = rp.rasterize_fwd_pallas(payload, b, meta, ntx, ntiles, interpret=True,
                                       with_reg=wr)
        got = rp.rasterize_bwd_pallas(payload, fout, jnp.asarray(gout), b, meta, ntx, ntiles,
                                      W / 2.0, H / 2.0, interpret=True, with_stats=ws,
                                      with_reg=wr)
        refs[ws, wr] = (np.asarray(payload), np.asarray(fout), jax.device_get(got))
    return request.param, torch_binning(b), t(meta), ntx, ntiles, gout, refs


@pytest.mark.parametrize("flags", FLAGS, ids=["stats", "reg", "stats_reg"])
def test_backward_matches_pallas(bwd_scene, flags):
    name, b, meta, ntx, ntiles, gout, refs = bwd_scene
    ws, wr = flags
    payload, fout_j, (dslot_j, gid_j, stats_j) = refs[flags]
    fout = tr.rasterize_fwd(t(payload), b, meta, ntx, ntiles, with_reg=wr)
    for ch in (tr.CH_LIVEC, tr.CH_CSTART, tr.CH_MEDIDX):
        np.testing.assert_array_equal(fout[:, ch].numpy(), fout_j[:, ch])
    dslot, gid, stats = tr.rasterize_bwd(t(payload), fout, t(gout), b, meta, ntx, ntiles,
                                         W / 2.0, H / 2.0, with_stats=ws, with_reg=wr)
    assert tuple(dslot.shape) == dslot_j.shape and tuple(gid.shape) == gid_j.shape
    demand = int(fout_j[-1, tr.CH_CSTART, 0] + fout_j[-1, tr.CH_LIVEC, 0] * 128)
    assert demand > 0
    if name == "multi_300":
        assert demand > 2 * 128  # some tile walks more than one window
    np.testing.assert_array_equal(gid.numpy()[:demand], gid_j[:demand])
    assert rel_err(dslot.numpy()[:, :demand], dslot_j[:, :demand]) < BOUND
    assert np.abs(dslot_j[:, :demand]).max() > 0
    assert (dslot.numpy()[14:] == 0).all() and (dslot.numpy()[:, demand:] == 0).all()
    if ws:
        assert rel_err(stats.numpy()[:, :demand], stats_j[:, :demand]) < BOUND
        assert (stats.numpy()[3:] == 0).all()
    else:
        assert stats is None and stats_j is None


def test_backward_tile_blocks_agree(bwd_scene, monkeypatch):
    """The plain version's tile blocking does not change its result."""
    _, b, meta, ntx, ntiles, gout, refs = bwd_scene
    payload, _, _ = refs[True, True]
    fout = tr.rasterize_fwd(t(payload), b, meta, ntx, ntiles)
    args = (t(payload), fout, t(gout), b, meta, ntx, ntiles, W / 2.0, H / 2.0)
    whole = tr.rasterize_bwd_reference(*args)
    monkeypatch.setattr(tr, "BWD_TILE_BLOCK", 1)
    split = tr.rasterize_bwd_reference(*args)
    for x, y in zip(whole, split):
        assert torch.equal(x, y)


@pytest.mark.parametrize("flags", [(False, False), *FLAGS], ids=["plain", "stats", "reg",
                                                                  "stats_reg"])
def test_bwd_reference_views_hold_the_column_arrays(bwd_scene, flags):
    """The plain version's dslot [16, R] and stats [8, R] are views of one
    row-major buffer ([R, 16], or [R, 24] with the statistics), and hold
    bit for bit what the tile walk writes into separate column-major arrays
    (the layout before the buffer), in each (with_stats, with_reg)
    instance."""
    _, b, meta, ntx, ntiles, gout, refs = bwd_scene
    ws, wr = flags
    payload = t(refs[ws, True][0])
    fout = tr.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=wr)
    args = (payload, fout, t(gout), b, meta, ntx, ntiles, W / 2.0, H / 2.0)
    dslot, gid, stats = tr.rasterize_bwd_reference(*args, with_stats=ws, with_reg=wr)
    R, width = gid.shape[0], 24 if ws else 16
    assert dslot.stride() == (1, width) and dslot.T.is_contiguous() == (not ws)
    want_d = torch.zeros((16, R))
    want_g = torch.zeros((R,), dtype=torch.int32)
    want_s = torch.zeros((8, R)) if ws else None
    tr._bwd_tiles(*args[:6], torch.arange(ntiles), W / 2.0, H / 2.0, ws, wr, want_d, want_g,
                  want_s)
    assert torch.equal(dslot, want_d) and torch.equal(gid, want_g)
    assert float(want_d.abs().max()) > 0
    if ws:
        assert stats.stride() == (1, width)
        assert stats.data_ptr() == dslot.data_ptr() + 16 * dslot.element_size()
        assert torch.equal(stats, want_s)
    else:
        assert stats is None


@pytest.mark.parametrize("with_stats", [True, False])
def test_reduce_compact_rows_equals_the_two_array_reduce(bwd_scene, with_stats):
    """reduce_compact_rows reduces the backward's row buffer (bwd_rows) as
    it is; its sums equal the column-major reduce of gof_tpu's two arrays
    (rasterize_bwd's views of the same buffer)."""
    from gof_tpu_torch.ops import reduce as tred

    name, b, meta, ntx, ntiles, gout, refs = bwd_scene
    P = SCENES[name]
    payload = t(refs[with_stats, True][0])
    fout = tr.rasterize_fwd(payload, b, meta, ntx, ntiles)
    args = (payload, fout, t(gout), b, meta, ntx, ntiles, W / 2.0, H / 2.0)
    rows, gid = tr.bwd_rows(*args, with_stats=with_stats)
    assert tuple(rows.shape) == (gid.shape[0], 24 if with_stats else 16)
    per_g, per_s = tr.reduce_compact_rows(rows, gid, P)
    dslot, gid_v, stats = tr.rasterize_bwd(*args, with_stats=with_stats)
    assert torch.equal(gid_v, gid) and torch.equal(dslot, rows[:, :16].T)
    cols = [dslot.contiguous()] + ([stats.contiguous()] if with_stats else [])
    want = tred.reduce_row_blocks(cols, gid, P)
    assert tuple(per_g.shape) == (P, 16) and torch.equal(per_g, want[:, :16])
    assert float(per_g.abs().max()) > 0
    if with_stats:
        assert tuple(per_s.shape) == (P, 3) and torch.equal(per_s, want[:, 16:19])
    else:
        assert per_s is None


def test_backward_nonfinite_row_stays_in_its_tile():
    """A NaN payload row outside a tile's segment (in its first window) is
    skipped by select: that tile's gradient rows stay finite and unchanged,
    and the NaN row itself gets a zero gradient row."""
    pre, b, op_eff, cam, ntx, nty = jax_setup(300)
    ntiles = ntx * nty
    payload = t(rp.build_payload16(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b))
    tb_ = torch_binning(b)
    meta = t(rp._meta_vec(cam.focal_x, cam.focal_y, jnp.asarray(BG), W, H))
    bounds = tb_.bounds.numpy()
    assert bounds[1] % 128 and bounds[2] > bounds[1] > bounds[0]
    gout = torch.from_numpy(np.random.default_rng(1).normal(size=(ntiles, 16, 1024))
                            .astype(np.float32))
    bad = payload.clone()
    bad[:, bounds[1] - 1] = float("nan")
    res = []
    for p in (payload, bad):
        fout = tr.rasterize_fwd(p, tb_, meta, ntx, ntiles, with_reg=True)
        res.append(tr.rasterize_bwd(p, fout, gout, tb_, meta, ntx, ntiles, W / 2.0, H / 2.0,
                                    with_stats=False))
        cst = int(fout[1, tr.CH_CSTART, 0])
        live = int(fout[1, tr.CH_LIVEC, 0])
    cols = slice(cst, cst + live * 128)
    assert torch.isfinite(res[1][0][:, cols]).all()
    assert torch.equal(res[1][0][:, cols], res[0][0][:, cols])


def test_bwd_wrapper_refuses_non_cuda_devices():
    pre, b, op_eff, cam, ntx, nty = jax_setup(16)
    payload = t(rp.build_payload16(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b))
    tb_ = torch_binning(b)
    meta = t(rp._meta_vec(cam.focal_x, cam.focal_y, jnp.asarray(BG), W, H))
    fout = tr.rasterize_fwd(payload, tb_, meta, ntx, ntx * nty)
    before = tr.BWD.launches
    tr.rasterize_bwd(payload, fout, torch.zeros_like(fout), tb_, meta, ntx, ntx * nty,
                     W / 2.0, H / 2.0, with_stats=False)
    assert tr.BWD.launches == before
    mb = tb.Binning(slot_to_gaussian=tb_.slot_to_gaussian.to("meta"),
                    bounds=tb_.bounds.to("meta"), num_keys=tb_.num_keys,
                    overflow=tb_.overflow, num_slots=tb_.num_slots)
    with pytest.raises(ValueError):
        tr.rasterize_bwd(payload.to("meta"), fout.to("meta"), fout.to("meta"), mb,
                         meta.to("meta"), ntx, ntx * nty, W / 2.0, H / 2.0, with_stats=False)


# ---------------------------------------------------------------------------
# rasterize: reduction + quadric chain
# ---------------------------------------------------------------------------


def raster_loss_jax(pre, b, cam, ntx, nty, gw, with_stats, with_reg):
    meta = rp.RasterMeta(ntx=ntx, nty=nty, width=W, height=H, interpret=True,
                         with_stats=with_stats, with_reg=with_reg)

    def loss(rgb, op, M, u0, carrier):
        out = rp.rasterize(meta, rgb, op, M, u0, pre.conic, pre.mean2d, carrier,
                           cam.focal_x, cam.focal_y, jnp.asarray(BG), b)
        img = jtr.assemble_image(out, ntx, nty, W, H)
        return jnp.sum(img[:9] * gw)

    return loss


def raster_loss_torch(pre, b, cam, ntx, nty, gw, with_stats, with_reg):
    meta = tr.RasterMeta(ntx=ntx, nty=nty, width=W, height=H, with_stats=with_stats,
                         with_reg=with_reg)
    conic, mean2d = t(pre.conic), t(pre.mean2d)
    focal = (t(cam.focal_x), t(cam.focal_y))

    def loss(rgb, op, M, u0, carrier):
        out = tr.rasterize(meta, rgb, op, M, u0, conic, mean2d, carrier, *focal,
                           torch.from_numpy(BG), b)
        img = ttr.assemble_image(out, ntx, nty, W, H)
        return (img[:9] * gw).sum()

    return loss


@pytest.fixture(scope="module")
def raster_case():
    pre, b, op_eff, cam, ntx, nty = jax_setup(40)
    gw = np.random.default_rng(2).normal(size=(9, H, W)).astype(np.float32) * 0.1
    args = (pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, jnp.zeros((40, 3), jnp.float32))
    grads = {}
    for ws, wr in ((True, True), (False, True)):
        f = raster_loss_jax(pre, b, cam, ntx, nty, jnp.asarray(gw), ws, wr)
        grads[ws, wr] = jax.device_get(jax.grad(f, argnums=(0, 1, 2, 3, 4))(*args))
    # the distortion channel alone (gof_tpu's quirk test)
    meta = rp.RasterMeta(ntx=ntx, nty=nty, width=W, height=H, interpret=True)

    def dist_loss(M, u0):
        out = rp.rasterize(meta, pre.rgb, op_eff, M, u0, pre.conic, pre.mean2d, args[4],
                           cam.focal_x, cam.focal_y, jnp.asarray(BG), b)
        return jnp.sum(jtr.assemble_image(out, ntx, nty, W, H)[8])

    grads["dist"] = jax.device_get(jax.grad(dist_loss, argnums=(0, 1))(pre.v2g_M, pre.v2g_u0))
    return pre, b, cam, ntx, nty, gw, jax.device_get(args), grads


def torch_grads(loss, args):
    leaves = [t(a).requires_grad_(True) for a in args]
    loss(*leaves).backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("with_stats", [True, False])
def test_rasterize_grads_match_jax(raster_case, with_stats):
    pre, b, cam, ntx, nty, gw, args, grads = raster_case
    loss = raster_loss_torch(pre, torch_binning(b), cam, ntx, nty, t(gw), with_stats, True)
    got = torch_grads(loss, args)
    want = grads[with_stats, True]
    for name, g, w in zip(("rgb", "op", "M", "u0"), got, want):
        assert np.isfinite(g).all(), name
        assert rel_err(g, w) < BOUND, name
    if with_stats:
        assert rel_err(got[4], want[4]) < BOUND
        valid = np.asarray(pre.valid)
        # the abs channel sums |gx| + |gy| terms: nonnegative, positive where visible
        assert (got[4][:, 2] >= 0).all() and got[4][valid, 2].max() > 0
    else:
        assert (got[4] == 0).all()


def test_distortion_grad_flows_through_m_only(raster_case):
    """d(sum ch8)/d(M, u0) follows gof_tpu's rule (the reference's
    backward.cu:839-858: through the mapped depth m only)."""
    pre, b, cam, ntx, nty, _, args, grads = raster_case
    gw = np.zeros((9, H, W), np.float32)
    gw[8] = 1.0
    loss = raster_loss_torch(pre, torch_binning(b), cam, ntx, nty, t(gw), True, True)
    got = torch_grads(loss, args)
    assert np.abs(grads["dist"][0]).max() > 0
    for g, w in zip(got[2:4], grads["dist"]):
        assert rel_err(g, w) < BOUND
    assert (got[0] == 0).all()  # colour takes no distortion gradient


def test_median_depth_grad_routing():
    """The median-depth gradient reaches only the median contributor: two
    gaussians on one ray, the front one opaque."""
    means = torch.tensor([[0.0, 0.0, 4.0], [0.0, 0.0, 6.0]])
    scales = torch.full((2, 3), 0.5)
    rots = torch.tensor([[1.0, 0, 0, 0], [1.0, 0, 0, 0]])
    opac = torch.tensor([0.95, 0.95])
    from gof_tpu_torch.sh import rgb_to_sh_dc as t_rgb_to_sh_dc

    shs = t_rgb_to_sh_dc(torch.full((2, 3), 0.5))[:, None, :]
    cam = tcam.look_at_camera(eye=(0, 0, 0), target=(0, 0, 5.0), width=32, height=32)
    means.requires_grad_(True)
    out = trender.render(cam, means, scales, rots, opac, shs, 0, 0.1, torch.zeros(3))
    out.image[6, 16, 16].backward()
    g = means.grad.numpy()
    assert np.abs(g[0]).sum() > 1e-6
    assert np.abs(g[1]).sum() < 1e-8


# ---------------------------------------------------------------------------
# The whole render
# ---------------------------------------------------------------------------

N_POOL, N_LIVE = 48, 41


def pool_inputs():
    """A padded pool: 40 gaussians in view, one active gaussian behind the
    camera, and inactive slots at the origin with init's padding values."""
    rng = np.random.default_rng(21)
    n = N_POOL
    # gof_tpu's gradient-test layout (tests/test_rasterize.py:21-33) with
    # scales 0.5-1.0: smaller gaussians make d/dscales cancel in the quadric
    # chain, and both packages' f32 errors there approach the bound (against
    # a float64 run of the port, at scales 0.1-0.4, the port's error was
    # 2.5e-4 and gof_tpu's 3.1e-3)
    z = rng.uniform(4, 7, n)
    xyz = np.stack([rng.uniform(-1, 1, n) * z * 0.2, rng.uniform(-1, 1, n) * z * 0.2, z], -1)
    xyz[40] = (0.1, 0.2, -3.0)  # behind the camera
    xyz[N_LIVE:] = 0.0
    scales = rng.uniform(0.5, 1.0, (n, 3))
    scales[N_LIVE:] = np.sqrt(np.exp(-10.0) ** 2 + 1e-4 ** 2)
    q = rng.normal(size=(n, 4))
    q[N_LIVE:] = (1.0, 0.0, 0.0, 0.0)
    op = rng.uniform(0.3, 0.95, n)
    op[N_LIVE:] = 0.5 * 1e-3
    shs = rng.normal(0, 0.5, (n, 16, 3))
    shs[N_LIVE:] = 0.0
    active = np.arange(n) < N_LIVE
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return [f32(xyz), f32(scales), f32(q), f32(op), f32(shs)], active


CAM = dict(eye=(0.2, -0.1, -1.0), target=(0, 0, 5.0), width=W, height=H)


@pytest.fixture(scope="module")
def render_case():
    inputs, active = pool_inputs()
    gw = np.random.default_rng(4).normal(size=(9, H, W)).astype(np.float32) * 0.1
    cam = jcam.look_at_camera(**CAM)

    def loss(xyz, scales, rots, op, shs, carrier):
        out = jrender.render(cam, xyz, scales, rots, op, shs, 3, 0.1, jnp.asarray(BG),
                             carrier=carrier, active_mask=jnp.asarray(active),
                             capacity=1 << 13, backend="pallas", interpret=True)
        return jnp.sum(out.image * gw), out.visibility

    args = [jnp.asarray(a) for a in inputs] + [jnp.zeros((N_POOL, 3), jnp.float32)]
    (_, vis), grads = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(*args)
    return inputs, active, gw, jax.device_get(grads), np.asarray(vis)


def test_render_grads_match_jax(render_case):
    inputs, active, gw, want, vis = render_case
    leaves = [t(a).requires_grad_(True) for a in inputs]
    carrier = torch.zeros((N_POOL, 3), requires_grad=True)
    out = trender.render(tcam.look_at_camera(**CAM), *leaves, 3, 0.1, torch.from_numpy(BG),
                         carrier=carrier, active_mask=torch.from_numpy(active))
    (out.image * torch.from_numpy(gw)).sum().backward()
    np.testing.assert_array_equal(out.visibility.numpy(), vis)
    assert vis[:40].sum() > 30 and not vis[40:].any()
    names = ("means3d", "scales", "rotations", "opacities", "shs", "carrier")
    for name, x, w in zip(names, leaves + [carrier], want):
        g = x.grad.numpy()
        assert np.isfinite(g).all(), name
        assert rel_err(g, w) < BOUND, (name, rel_err(g, w))
    # nothing reaches the inactive slots or the gaussian behind the camera
    for x in leaves:
        assert (x.grad[40:] == 0).all()
