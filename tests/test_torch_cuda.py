"""gof_tpu_torch's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `cuda`: each test skips (from a fixture) where torch sees no CUDA
device. On a machine with an NVIDIA GPU and nvcc:
    python -m pytest tests/test_torch_cuda.py -q
The kernels are built with -fmad=false and follow their plain versions'
operation order, so most comparisons are exact; the blend's float channels
are held to atol 1e-5, rtol 1e-4 like the CPU parity tests.
"""

import numpy as np
import pytest
import torch

from gof_tpu_torch import cameras
from gof_tpu_torch.ops import class_gather, render
from gof_tpu_torch.ops import rasterize as rz

pytestmark = pytest.mark.cuda

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scene(n, width, height, seed=3, scale=(0.3, 1.0), op=(0.3, 0.95)):
    rng = np.random.default_rng(seed)
    z = rng.uniform(3, 9, n)
    xyz = np.stack([rng.uniform(-1, 1, n) * z * 0.35, rng.uniform(-1, 1, n) * z * 0.25, z], -1)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    args = (f(xyz), f(rng.uniform(*scale, (n, 3)) * 0.3), f(rng.normal(size=(n, 4))),
            f(rng.uniform(*op, n)), f(rng.normal(0, 0.5, (n, 16, 3))))
    cam = dict(eye=(0.1, 0.05, 0.0), target=(0, 0, 5.0), width=width, height=height)
    return args, cam


def render_on(device, args, cam, with_reg=True):
    c = cameras.look_at_camera(**cam, device=device)
    a = [x.to(device) for x in args]
    return render.render(c, *a, 3, 0.1, torch.tensor([0.1, 0.2, 0.3], device=device),
                         with_reg=with_reg)


@pytest.mark.parametrize("size", [(160, 96), (237, 131)])
@pytest.mark.parametrize("with_reg", [True, False])
def test_render_cuda_matches_cpu(dev, size, with_reg):
    args, cam = scene(2000, *size)
    before = (class_gather.EXPAND.launches, rz.FWD.launches)
    got = render_on(dev, args, cam, with_reg)
    assert (class_gather.EXPAND.launches, rz.FWD.launches) == (before[0] + 1, before[1] + 1)
    want = render_on("cpu", args, cam, with_reg)
    np.testing.assert_allclose(got.image.cpu().numpy(), want.image.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.transmittance.cpu().numpy(), want.transmittance.numpy(),
                               atol=ATOL, rtol=RTOL)
    # CPU and CUDA math libraries may differ in the last bit, which can move
    # a ceil'ed radius across an integer; exact wherever that did not happen
    diff = (got.radii.cpu() - want.radii).abs()
    assert diff.max() <= 1 and int((diff > 0).sum()) <= 2
    if not bool(diff.any()):
        assert int(got.num_keys) == int(want.num_keys)
        assert int(got.compact_demand) == int(want.compact_demand)


def test_render_cuda_empty_view(dev):
    """All gaussians behind the camera: every tile walks zero windows."""
    args, cam = scene(50, 100, 70)
    args = (args[0] * torch.tensor([1.0, 1.0, -1.0]),) + args[1:]
    out = render_on(dev, args, cam)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    assert bool((out.image[:3] == bg[:, None, None]).all())
    assert bool((out.transmittance == 1).all()) and int(out.num_keys) == 0


@pytest.mark.parametrize("cap,P,ncols", [(1, 1, 1), (1000, 37, 7), (300_001, 90_000, 23)])
def test_expand_bit_exact(dev, cap, P, ncols):
    g = torch.Generator().manual_seed(cap)
    tbl = torch.randint(-2**31, 2**31 - 1, (ncols, P), generator=g, dtype=torch.int64)
    tbl = tbl.to(torch.int32).to(dev)
    steps = (torch.rand(cap, generator=g) < P / max(cap, 1)).to(torch.int64)
    gidx = torch.clamp(torch.cumsum(steps, 0) - 1, 0, P - 1).to(torch.int32).to(dev)
    got = class_gather.expand_kernel_call(tbl, gidx)
    assert torch.equal(got, class_gather.expand_reference(tbl, gidx))


def blend_inputs(dev, n=3000, width=200, height=150, seed=4):
    args, cam = scene(n, width, height, seed=seed)
    c = cameras.look_at_camera(**cam, device=dev)
    a = [x.to(dev) for x in args]
    from gof_tpu_torch.ops import binning, quadrics

    pre = quadrics.preprocess(a[0], a[1], a[2], a[4], 3, c, 0.1, opacities=a[3])
    ntx, nty = binning.tile_grid(width, height)
    rects = binning.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty,
                                   radius_xy=pre.radius_xy)
    b = binning.bin_gaussians(pre.depth, rects, ntx, nty, mean2d=pre.mean2d, radius=pre.radius)
    op_eff = a[3] * torch.where(pre.valid, pre.coef, torch.zeros_like(pre.coef))
    payload = rz.build_payload16(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b)
    meta = rz._meta_vec(c.focal_x, c.focal_y, torch.tensor([0.1, 0.2, 0.3], device=dev),
                        width, height)
    return payload, b, meta, ntx, ntx * nty


@pytest.mark.parametrize("n", [3000, 40])
@pytest.mark.parametrize("with_reg", [True, False])
def test_blend_kernel_matches_plain(dev, with_reg, n):
    payload, b, meta, ntx, ntiles = blend_inputs(dev, n=n)
    got = rz.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=with_reg)
    want = rz.rasterize_fwd_reference(payload, b, meta, ntx, ntiles, with_reg=with_reg)
    chans = list(range(9)) + [rz.CH_TFINAL, rz.CH_DFINAL]
    torch.testing.assert_close(got[:, chans], want[:, chans], atol=ATOL, rtol=RTOL)
    for ch in (rz.CH_MEDIDX, rz.CH_LIVEC, rz.CH_CSTART):
        assert torch.equal(got[:, ch], want[:, ch]), ch


def test_blend_kernel_nan_row_stays_in_its_tile(dev):
    payload, b, meta, ntx, ntiles = blend_inputs(dev)
    bounds = b.bounds.cpu().numpy()
    t = next(t for t in range(1, ntiles)
             if bounds[t] % 128 and bounds[t + 1] > bounds[t] > bounds[t - 1])
    bad = payload.clone()
    bad[:, bounds[t] - 1] = float("nan")
    got = rz.rasterize_fwd(bad, b, meta, ntx, ntiles)
    clean = rz.rasterize_fwd(payload, b, meta, ntx, ntiles)
    assert bool(torch.isfinite(got[t]).all())
    assert torch.equal(got[t], clean[t])


def test_wrappers_check_inputs(dev):
    payload, b, meta, ntx, ntiles = blend_inputs(dev, n=200, width=64, height=64)
    with pytest.raises(ValueError):
        rz.rasterize_fwd(payload.double(), b, meta, ntx, ntiles)
    with pytest.raises(ValueError):
        rz.rasterize_fwd(payload[:, :-1].contiguous(), b, meta, ntx, ntiles)
    with pytest.raises(ValueError):
        class_gather.expand_kernel_call(torch.zeros((2, 5), dtype=torch.int64, device=dev),
                                        torch.zeros(3, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# K3 backward blend and K4 reduce
# ---------------------------------------------------------------------------

BWD_BOUND = 1e-4  # max |kernel - plain| / max |plain| per output group


def bwd_inputs(dev, width, height, with_stats, n=3000, seed=4):
    """The backward's inputs for one view: payload (with the statistics
    columns when with_stats), binning, meta, the forward's fout and a
    seeded cotangent that is zero outside the image, as assemble's is."""
    from gof_tpu_torch.ops import binning, quadrics, tiled_ref

    args, cam = scene(n, width, height, seed=seed)
    c = cameras.look_at_camera(**cam, device=dev)
    a = [x.to(dev) for x in args]
    pre = quadrics.preprocess(a[0], a[1], a[2], a[4], 3, c, 0.1, opacities=a[3])
    ntx, nty = binning.tile_grid(width, height)
    rects = binning.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty,
                                   radius_xy=pre.radius_xy)
    b = binning.bin_gaussians(pre.depth, rects, ntx, nty, mean2d=pre.mean2d, radius=pre.radius)
    op_eff = a[3] * torch.where(pre.valid, pre.coef, torch.zeros_like(pre.coef))
    payload = rz.build_payload16(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b,
                                 conic=pre.conic if with_stats else None,
                                 mean2d=pre.mean2d if with_stats else None)
    meta = rz._meta_vec(c.focal_x, c.focal_y, torch.tensor([0.1, 0.2, 0.3], device=dev),
                        width, height)
    ntiles = ntx * nty
    g = torch.Generator().manual_seed(seed)
    img = torch.randn((rz.OUT_CH, nty * 32, ntx * 32), generator=g) * 0.1
    img[:, height:] = 0.0
    img[:, :, width:] = 0.0
    gout = img.reshape(rz.OUT_CH, nty, 32, ntx, 32).permute(1, 3, 0, 2, 4)
    gout = gout.reshape(ntiles, rz.OUT_CH, rz.NPIX).contiguous().to(dev)
    return payload, b, meta, ntx, ntiles, gout, (width / 2.0, height / 2.0)


def bwd_pair(dev, width, height, with_stats, with_reg, **kw):
    payload, b, meta, ntx, ntiles, gout, half = bwd_inputs(dev, width, height, with_stats, **kw)
    fout = rz.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=with_reg)
    args = (payload, fout, gout, b, meta, ntx, ntiles, *half)
    return args, int(fout[-1, rz.CH_CSTART, 0] + fout[-1, rz.CH_LIVEC, 0] * 128)


def assert_bwd_close(got, want, demand):
    (dg, ig, sg), (dw, iw, sw) = got, want
    assert torch.equal(ig, iw)
    assert float((dg - dw).abs().max()) <= BWD_BOUND * float(dw.abs().max())
    assert float(dw[:, :demand].abs().max()) > 0
    if sw is None:
        assert sg is None
    else:
        assert float((sg - sw).abs().max()) <= BWD_BOUND * float(sw.abs().max())


@pytest.mark.parametrize("size", [(160, 96), (237, 131)])
@pytest.mark.parametrize("flags", [(True, False), (False, True), (True, True), (False, False)])
def test_bwd_kernel_matches_plain(dev, size, flags):
    ws, wr = flags
    args, demand = bwd_pair(dev, *size, ws, wr)
    before = rz.BWD.launches
    got = rz.rasterize_bwd(*args, with_stats=ws, with_reg=wr, compact_cap=demand)
    assert rz.BWD.launches == before + 1
    want = rz.rasterize_bwd_reference(*args, with_stats=ws, with_reg=wr, compact_cap=demand)
    assert_bwd_close(got, want, demand)
    again = rz.rasterize_bwd(*args, with_stats=ws, with_reg=wr, compact_cap=demand)
    for x, y in zip(got, again):  # deterministic: no atomics
        assert (x is None and y is None) or torch.equal(x, y)


def test_bwd_kernel_default_capacity_zero_tail(dev):
    args, demand = bwd_pair(dev, 160, 96, True, True)
    dslot, gid, stats = rz.rasterize_bwd(*args)
    assert dslot.shape[1] == rz.compact_capacity_for(args[0].shape[1], args[6])
    assert not dslot[:, demand:].any() and not gid[demand:].any() and not stats[:, demand:].any()


def test_bwd_kernel_nan_row_stays_in_its_tile(dev):
    args, demand = bwd_pair(dev, 200, 150, False, True)
    payload, fout, gout, b, meta, ntx, ntiles, hw, hh = args
    bounds = b.bounds.cpu().numpy()
    t = next(t for t in range(1, ntiles)
             if bounds[t] % 128 and bounds[t + 1] > bounds[t] > bounds[t - 1])
    bad = payload.clone()
    bad[:, bounds[t] - 1] = float("nan")
    fout_bad = rz.rasterize_fwd(bad, b, meta, ntx, ntiles)
    got = rz.rasterize_bwd(bad, fout_bad, gout, b, meta, ntx, ntiles, hw, hh, with_stats=False,
                           compact_cap=demand)
    clean = rz.rasterize_bwd(payload, fout, gout, b, meta, ntx, ntiles, hw, hh,
                             with_stats=False, compact_cap=demand)
    cst, live = int(fout[t, rz.CH_CSTART, 0]), int(fout[t, rz.CH_LIVEC, 0])
    cols = slice(cst, cst + live * 128)
    assert bool(torch.isfinite(got[0][:, cols]).all())
    assert torch.equal(got[0][:, cols], clean[0][:, cols])


@pytest.mark.parametrize("C,R,P", [(24, 300_000, 262_144), (16, 5000, 37), (16, 4096, 1)])
def test_reduce_kernel_matches_plain_and_is_deterministic(dev, C, R, P):
    from gof_tpu_torch.ops import reduce as red

    g = torch.Generator().manual_seed(R)
    rows = torch.randn((C, R), generator=g).to(dev)
    gid = torch.randint(0, P + 1, (R,), generator=g, dtype=torch.int32).to(dev)
    before = red.REDUCE.launches
    got = red.reduce_rows_by_gid(rows, gid, P)
    assert red.REDUCE.launches == before + 1
    want = red.reduce_rows_by_gid_reference(rows, gid, P)
    assert tuple(got.shape) == (P, C)
    assert float((got - want).abs().max()) <= BWD_BOUND * float(want.abs().max())
    assert torch.equal(got, red.reduce_rows_by_gid(rows, gid, P))
    sentinel = red.reduce_rows_by_gid(rows, torch.full_like(gid, P), P)
    assert not sentinel.any()


def test_bwd_and_reduce_wrappers_check_inputs(dev):
    from gof_tpu_torch.ops import reduce as red

    args, _ = bwd_pair(dev, 64, 64, True, True, n=200)
    payload, fout, gout = args[:3]
    with pytest.raises(ValueError):  # 16-row payload where stats need 24
        rz.rasterize_bwd(payload[:16].contiguous(), *args[1:])
    with pytest.raises(ValueError):
        rz.rasterize_bwd(payload, fout, gout.double(), *args[3:])
    with pytest.raises(ValueError):
        rz.rasterize_bwd(payload, fout, gout[:, :, :-1].contiguous(), *args[3:])
    rows = torch.zeros((16, 10), device=dev)
    with pytest.raises(ValueError):
        red.reduce_rows_by_gid(rows, torch.zeros(10, dtype=torch.int64, device=dev), 5)
    with pytest.raises(ValueError):
        red.reduce_rows_by_gid(rows, torch.zeros(9, dtype=torch.int32, device=dev), 5)
    with pytest.raises(ValueError):
        red.reduce_rows_by_gid(rows.T, torch.zeros(16, dtype=torch.int32, device=dev), 5)


def test_train_step_cuda_matches_cpu(dev):
    """One train step (both regularizers and the statistics on) on CUDA
    against the plain CPU path, 3000 gaussians at 160x96: gradients (the
    first Adam moment) and the carrier's statistics within the gradient
    bound, the loss within 1e-5, the visit counts exact, and each kernel
    launched once."""
    from gof_tpu_torch import config, train
    from gof_tpu_torch.model import gaussians as gm
    from gof_tpu_torch.ops import reduce as red

    # scales 0.3-0.6: at this file's default 0.09-0.3, d/dscales and d/dxyz
    # cancel in the quadric chain and each f32 path alone is up to 7.6e-5
    # from a float64 run of the same step (8e-6 or less here)
    (xyz, scales, rots, op, shs), cam = scene(3000, 160, 96, scale=(1.0, 2.0))
    g = torch.Generator().manual_seed(9)
    gt = torch.rand((3, 96, 160), generator=g)
    opt = config.OptimizationParams(distortion_from_iter=0, depth_normal_from_iter=0)
    runs = []
    for d in (dev, torch.device("cpu")):
        params = gm.GaussianParams(  # fresh leaves: the step updates them in place
            xyz=xyz.to(d, copy=True), features_dc=shs[:, :1].to(d, copy=True),
            features_rest=shs[:, 1:].to(d, copy=True), scaling=torch.log(scales).to(d),
            rotation=rots.to(d, copy=True), opacity=torch.logit(op).to(d))
        n = xyz.shape[0]
        z = torch.zeros(n, device=d)
        state = gm.GaussianState(active=torch.ones(n, dtype=torch.bool, device=d),
                                 filter_3d=z + 1e-4, max_radii2d=z.clone(), grad_accum=z.clone(),
                                 grad_abs_accum=z.clone(), denom=z.clone())
        tx = train.make_optimizer(opt, 5.0)
        tp = train.TrainParams(gauss=params)
        step = train.build_train_step(opt, config.ModelParams(sh_degree=3, kernel_size=0.1),
                                      config.PipelineParams(), tx)
        before = [k.launches for k in (class_gather.EXPAND, rz.FWD, rz.BWD, red.REDUCE)]
        out = step(tp, tx.init(tp), state, gt.to(d), 2500,
                   cameras.look_at_camera(**cam, device=d), torch.zeros(3, device=d))
        after = [k.launches for k in (class_gather.EXPAND, rz.FWD, rz.BWD, red.REDUCE)]
        assert [a - b for a, b in zip(after, before)] == ([1, 1, 1, 1] if d.type == "cuda"
                                                          else [0, 0, 0, 0])
        runs.append(out)
    (_, sg, gg, mg), (_, sw, gw, mw) = runs
    assert float(mg["loss"]) == pytest.approx(float(mw["loss"]), rel=1e-5)
    for f in train.GAUSS_FIELDS:
        a, b = getattr(sg.mu, f).cpu(), getattr(sw.mu, f)
        assert bool(torch.isfinite(a).all()), f
        assert float((a - b).abs().max()) <= BWD_BOUND * float(b.abs().max()), f
    for f in ("grad_accum", "grad_abs_accum"):
        a, b = getattr(gg, f).cpu(), getattr(gw, f)
        assert float((a - b).abs().max()) <= BWD_BOUND * float(b.abs().max()), f
    assert torch.equal(gg.denom.cpu(), gw.denom)


# ---------------------------------------------------------------------------
# K5 integrate and the mesh path
# ---------------------------------------------------------------------------


def field_inputs(dev, n=3000, n_points=40_000, width=200, height=150, seed=5):
    """The integrate kernel's inputs for one view (FieldEvaluator.view_inputs)
    and the field evaluator itself: random points in front of the camera,
    plus some behind it and some outside the image."""
    from gof_tpu_torch.mesh import extract
    from gof_tpu_torch.model import gaussians as gm

    (xyz, scales, rots, op, shs), cam = scene(n, width, height, seed=seed)
    z = torch.zeros(n)
    params = gm.GaussianParams(xyz=xyz.to(dev), features_dc=shs[:, :1].to(dev),
                               features_rest=shs[:, 1:].to(dev),
                               scaling=torch.log(scales).to(dev), rotation=rots.to(dev),
                               opacity=torch.logit(op).to(dev))
    state = gm.GaussianState(active=torch.ones(n, dtype=torch.bool, device=dev),
                             filter_3d=(z + 1e-4).to(dev), max_radii2d=z.to(dev),
                             grad_accum=z.to(dev), grad_abs_accum=z.to(dev), denom=z.to(dev))
    c = cameras.look_at_camera(**cam, device=dev)
    ev = extract.FieldEvaluator(params, state, [c], 3, 0.1)
    rng = np.random.default_rng(seed)
    zq = rng.uniform(2, 10, n_points)
    pts = np.stack([rng.uniform(-1, 1, n_points) * zq * 0.4, rng.uniform(-1, 1, n_points) * zq * 0.3,
                    zq], -1).astype(np.float32)
    pts[:50, 2] = -pts[:50, 2]  # behind the camera
    pts[50:100, 0] += 100.0  # outside the image
    p = torch.from_numpy(pts).to(dev)
    return ev, p, c, ev.view_inputs(p, c)


def test_integrate_kernel_matches_plain(dev):
    from gof_tpu_torch.ops import integrate as ti

    _, p, _, (payload, b, pb) = field_inputs(dev)
    n = p.shape[0]
    before = ti.INTEGRATE.launches
    got = ti.integrate_transmittance(payload, b, pb, n)
    assert ti.INTEGRATE.launches == before + 1
    again = ti.integrate_transmittance(payload, b, pb, n)
    want = ti.integrate_transmittance_reference(payload, b, pb, n)
    assert torch.equal(got, again)  # no atomics, serial per point
    assert float((got - want).abs().max()) <= 1e-6
    assert bool((got[:100] == 1).all())
    assert float(got.min()) < 0.5 and pb.n_blocks > b.bounds.shape[0] - 1


def test_integrate_kernel_nan_row_stays_in_its_tile(dev):
    from gof_tpu_torch.ops import integrate as ti

    _, p, _, (payload, b, pb) = field_inputs(dev)
    n = p.shape[0]
    bounds = b.bounds.cpu().numpy()
    blocks = pb.bins.tile_blocks.cpu().numpy()
    k = next(k for k in range(1, len(bounds) - 1)
             if bounds[k] % 128 and bounds[k + 1] > bounds[k] > bounds[k - 1] and blocks[k])
    bad = payload.clone()
    bad[:, bounds[k] - 1] = float("nan")
    got = ti.integrate_transmittance(bad, b, pb, n)
    clean = ti.integrate_transmittance(payload, b, pb, n)
    mine = pb.point_of_slot[pb.block_tile.repeat_interleave(ti.PBLOCK) == k]
    mine = mine[mine < n].long()
    assert len(mine) and bool(torch.isfinite(got[mine]).all())
    assert torch.equal(got[mine], clean[mine])


def test_integrate_wrapper_checks_inputs(dev):
    from gof_tpu_torch.ops import integrate as ti

    _, p, _, (payload, b, pb) = field_inputs(dev, n=200, n_points=3000, width=64, height=64)
    with pytest.raises(ValueError):
        ti.integrate_transmittance(payload.double(), b, pb, p.shape[0])
    with pytest.raises(ValueError):
        ti.integrate_transmittance(payload[:, :-1].contiguous(), b, pb, p.shape[0])


def test_marching_tets_cuda_matches_numpy(dev):
    from scipy.spatial import Delaunay

    from gof_tpu_torch.mesh import tetmesh

    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.5, 1.5, (20_000, 3)).astype(np.float32)
    tets = Delaunay(pts).simplices.astype(np.int32)
    sdf = (np.linalg.norm(pts - np.array([0.2, -0.1, 0.05]), axis=-1) - 0.9).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, len(pts)).astype(np.float32)
    want = tetmesh.marching_tetrahedra(pts, tets, sdf, scales)
    got = tetmesh.marching_tetrahedra(pts, tets, torch.from_numpy(sdf).to(dev), scales)
    for k in ("edge_verts", "edge_points", "edge_sdf", "edge_scale"):
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["faces"]) == len(want["faces"]) > 1000
    assert {tuple(f) for f in got["faces"].tolist()} == {tuple(f) for f in want["faces"].tolist()}
