"""gof_tpu_torch's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `cuda`: each test skips (from a fixture) where torch sees no CUDA
device. On a machine with an NVIDIA GPU and nvcc:
    python -m pytest tests/test_torch_cuda.py -q
The kernels but K1 and K3 are built with -fmad=false and follow their
plain versions' operation order, so most comparisons are exact; K1's T,
median depth and counts are bit-exact (its alpha/T chain never contracts),
its accumulated channels (on FMAs) held to atol 1e-5, rtol 1e-4 like the
CPU parity tests, and K3's gradient rows (contracted into FMAs) to 1e-4 x
max |plain|.
"""

import numpy as np
import pytest
import torch

from gof_tpu_torch import cameras
from gof_tpu_torch.ops import class_gather, render
from gof_tpu_torch.ops import rasterize as rz
from gof_tpu_torch.scripts.mxu_gather_probe import RLD_EDGE_CASES

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


# K1's channels from its exact chain (T, median depth and visit index) and
# its integer counts are bit-exact; its accumulations run on FMAs
FWD_EXACT = [rz.CH_TFINAL, 6, rz.CH_MEDIDX, rz.CH_LIVEC, rz.CH_CSTART]
FWD_TOL = [0, 1, 2, 3, 4, 5, 7, 8, rz.CH_DFINAL]


def assert_fwd_matches(got, want):
    torch.testing.assert_close(got[:, FWD_TOL], want[:, FWD_TOL], atol=ATOL, rtol=RTOL)
    for ch in FWD_EXACT:
        assert torch.equal(got[:, ch], want[:, ch]), ch


@pytest.mark.parametrize("n", [3000, 40])
@pytest.mark.parametrize("with_reg", [True, False])
def test_blend_kernel_matches_plain(dev, with_reg, n):
    payload, b, meta, ntx, ntiles = blend_inputs(dev, n=n)
    got = rz.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=with_reg)
    want = rz.rasterize_fwd_reference(payload, b, meta, ntx, ntiles, with_reg=with_reg)
    assert_fwd_matches(got, want)
    assert torch.equal(got, rz.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=with_reg))


def synthetic_rows(rng, n, rx_span, ry_span):
    """n payload rows ([16, n] f32) of isotropic gaussians seen along rays
    with slopes in the given spans: centre c = z (rx, ry, 1), scale s,
    M = R / s for a small rotation R, u0 = -M c, so the ray-gaussian
    maximum lies at c's depth and the footprint spans 1-10 pixels at a
    focal length of 100."""
    z = rng.uniform(2.0, 10.0, n)
    c = np.stack([rng.uniform(*rx_span, n) * z, rng.uniform(*ry_span, n) * z, z], -1)
    s = z * rng.uniform(0.005, 0.05, n)
    R = np.eye(3) + rng.normal(0, 0.05, (n, 3, 3))
    M = R / s[:, None, None]
    u0 = -np.einsum("nij,nj->ni", M, c)
    rows = np.concatenate([rng.uniform(0, 1, (n, 3)), rng.uniform(0.05, 0.95, (n, 1)),
                           M.reshape(n, 9), u0], 1)
    return rows.T.astype(np.float32)


# a row every pixel sees at alpha 0.99: d = (0, 0, 1), t = 5, v = 0
WALL_ROW = np.array([0.5, 0.5, 0.5, 0.99, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, -5], np.float32)


def synthetic_tiles(dev, segs=(0, 2000, 37, 1000, 600, 5), walls=((3, 150),), faint=(1,),
                    start=77, seed=6, width=96, height=64, focal=100.0):
    """The blend's inputs for hand-made tiles: tile t owns segs[t] random
    rows (synthetic_rows over its own pixels), the segments back to back
    from an unaligned start; (tile, row) in walls puts three WALL_ROWs at
    that row of the tile's segment, so every pixel of the tile saturates
    there, mid-window; the tiles in faint get a tenth of the opacity, so
    they walk all their windows. Returns payload, a binning with its bounds, meta,
    ntx, ntiles."""
    from types import SimpleNamespace

    from gof_tpu_torch.ops import binning

    rng = np.random.default_rng(seed)
    ntx, nty = binning.tile_grid(width, height)
    assert len(segs) == ntx * nty
    cols, bounds = [np.zeros((16, start), np.float32)], [start]
    for t, n in enumerate(segs):
        x0, y0 = (t % ntx) * 32 - width / 2, (t // ntx) * 32 - height / 2
        rows = synthetic_rows(rng, n, (x0 / focal - 0.05, (x0 + 32) / focal + 0.05),
                              (y0 / focal - 0.05, (y0 + 32) / focal + 0.05))
        if t in faint:
            rows[3] *= 0.1
        for tw, at in walls:
            if tw == t:
                rows[:, at:at + 3] = WALL_ROW[:, None]
        cols.append(rows)
        bounds.append(bounds[-1] + n)
    payload = np.concatenate(cols, 1)
    cap = -(-payload.shape[1] // 128) * 128 + 128
    payload = np.pad(payload, ((0, 0), (0, cap - payload.shape[1])))
    b = SimpleNamespace(bounds=torch.tensor(bounds, dtype=torch.int32, device=dev))
    meta = rz._meta_vec(torch.tensor(focal), torch.tensor(focal),
                        torch.tensor([0.1, 0.2, 0.3], device=dev), width, height).to(dev)
    return torch.from_numpy(payload).to(dev), b, meta, ntx, ntx * nty


@pytest.mark.parametrize("with_reg", [True, False])
def test_blend_kernel_long_tile_wall_and_empty_tiles(dev, with_reg):
    """One tile ten times longer than the others, one whose pixels all
    saturate mid-window (the exit vote at the next boundary, past a
    prefetched window), empty tiles: exact and close to the plain version,
    the same across launches."""
    from gof_tpu_torch.ops import windows

    payload, b, meta, ntx, ntiles = synthetic_tiles(dev)
    got = rz.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=with_reg)
    want = rz.rasterize_fwd_reference(payload, b, meta, ntx, ntiles, with_reg=with_reg)
    assert_fwd_matches(got, want)
    assert torch.equal(got, rz.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=with_reg))
    nc = windows.window_counts(b.bounds[:-1], b.bounds[1:]).cpu()
    live = got[:, rz.CH_LIVEC, 0].cpu().long()
    assert int(nc[1]) >= 10 * int(nc[[2, 5]].max()) and int(live[1]) == int(nc[1])
    assert int(live[3]) == 2 < int(nc[3]) and float(got[3, rz.CH_TFINAL].max()) < 1e-4
    assert int(nc[0]) == int(live[0]) == 0 and bool((got[0, rz.CH_TFINAL] == 1).all())


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


def bwd_inputs(dev, width, height, with_stats, n=3000, seed=4, crowd=0):
    """The backward's inputs for one view: payload (with the statistics
    columns when with_stats), binning, meta, the forward's fout and a
    seeded cotangent that is zero outside the image, as assemble's is.
    crowd: that many extra faint small gaussians (opacity 0.01) in front of
    the rest, at the view's centre, so that its tiles walk far more windows
    than the others."""
    from gof_tpu_torch.ops import binning, quadrics, tiled_ref

    args, cam = scene(n, width, height, seed=seed)
    if crowd:
        rng = np.random.default_rng(seed + 1)
        xyz = np.stack([rng.normal(0, 0.02, crowd), rng.normal(0, 0.02, crowd),
                        rng.uniform(1.5, 2.5, crowd)], -1)
        extra = (xyz, np.full((crowd, 3), 0.03), rng.normal(size=(crowd, 4)),
                 np.full(crowd, 0.01), rng.normal(0, 0.5, (crowd, 16, 3)))
        args = tuple(torch.cat([a, torch.tensor(e, dtype=torch.float32)])
                     for a, e in zip(args, extra))
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


def assert_row_buffer_views(dslot, stats, R):
    """dslot [16, R] and stats [8, R] are views of one row-major buffer."""
    width = 16 if stats is None else 24
    assert tuple(dslot.shape) == (16, R) and dslot.stride() == (1, width)
    if stats is not None:
        assert tuple(stats.shape) == (8, R) and stats.stride() == (1, width)
        assert stats.data_ptr() == dslot.data_ptr() + 16 * 4


@pytest.mark.parametrize("size", [(160, 96), (237, 131)])
@pytest.mark.parametrize("flags", [(True, False), (False, True), (True, True), (False, False)])
def test_bwd_kernel_matches_plain(dev, size, flags):
    ws, wr = flags
    args, demand = bwd_pair(dev, *size, ws, wr)
    before = rz.BWD.launches
    miss = torch.zeros(1, dtype=torch.int32, device=dev)
    got = rz.rasterize_bwd(*args, with_stats=ws, with_reg=wr, compact_cap=demand,
                           t_mismatch=miss)
    assert rz.BWD.launches == before + 1
    assert int(miss) == 0  # the transmittance chain keeps the forward's bits
    assert_row_buffer_views(got[0], got[2], demand)
    want = rz.rasterize_bwd_reference(*args, with_stats=ws, with_reg=wr, compact_cap=demand)
    assert_row_buffer_views(want[0], want[2], demand)
    assert_bwd_close(got, want, demand)
    again = rz.rasterize_bwd(*args, with_stats=ws, with_reg=wr, compact_cap=demand)
    for x, y in zip(got, again):  # deterministic: no atomics
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("flags", [(True, False), (False, True)])
def test_bwd_kernel_longest_tile_first(dev, flags):
    """A crowd of faint gaussians makes the centre tiles walk far more
    windows than the rest, so the kernel's tile order (by CH_LIVEC,
    descending) is not blockIdx order: the result is the plain version's,
    the same across launches, and T matches the forward's."""
    ws, wr = flags
    args, demand = bwd_pair(dev, 237, 131, ws, wr, crowd=4000)
    live = args[1][:, rz.CH_LIVEC, 0]
    top = int(live.argmax())
    assert float(live[top]) >= 3 * float(live[live > 0].median()) and top > 0
    miss = torch.zeros(1, dtype=torch.int32, device=dev)
    got = rz.rasterize_bwd(*args, with_stats=ws, with_reg=wr, compact_cap=demand,
                           t_mismatch=miss)
    assert int(miss) == 0
    want = rz.rasterize_bwd_reference(*args, with_stats=ws, with_reg=wr, compact_cap=demand)
    assert_bwd_close(got, want, demand)
    for _ in range(2):
        again = rz.rasterize_bwd(*args, with_stats=ws, with_reg=wr, compact_cap=demand)
        for x, y in zip(got, again):
            assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("with_stats", [True, False])
def test_reduce_compact_rows_reads_the_row_buffer(dev, with_stats):
    """The row-major entry on the backward's buffer equals the column-major
    entry on the two arrays, bit for bit, and the plain version."""
    from gof_tpu_torch.ops import reduce as red

    args, demand = bwd_pair(dev, 237, 131, with_stats, True)
    rows, gid = rz.bwd_rows(*args, with_stats=with_stats, compact_cap=demand)
    dslot, _, stats = rz._bwd_views(rows, gid, with_stats)
    P = int(gid.max()) + 5
    before = red.REDUCE.launches
    per_g, per_s = rz.reduce_compact_rows(rows, gid, P)
    assert red.REDUCE.launches == before + 1
    cols = [dslot.contiguous()] + ([stats.contiguous()] if with_stats else [])
    ref = red.reduce_row_blocks(cols, gid, P)
    assert torch.equal(per_g, ref[:, :16])
    plain = red.reduce_rows_by_gid_reference(torch.cat([c.cpu() for c in cols]), gid.cpu(), P)
    assert torch.equal(per_g.cpu(), plain[:, :16])
    if with_stats:
        assert torch.equal(per_s, ref[:, 16:19]) and torch.equal(per_s.cpu(), plain[:, 16:19])
    else:
        assert per_s is None


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
    # bit for bit: the kernel and the plain version on the CPU both sum each
    # id's rows in ascending row order from +0.0
    want = red.reduce_rows_by_gid_reference(rows.cpu(), gid.cpu(), P)
    assert tuple(got.shape) == (P, C)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, red.reduce_rows_by_gid(rows, gid, P))
    sentinel = red.reduce_rows_by_gid(rows, torch.full_like(gid, P), P)
    assert not sentinel.any()


@pytest.mark.parametrize("kind", ["one_id_5000_rows", "all_rows_on_one_id"])
def test_reduce_kernel_skewed_ids_bit_exact(dev, kind):
    """Ids far past a warp's bucket (the block path) and every row on one
    id, through the two-array entry the backward uses."""
    from gof_tpu_torch.ops import reduce as red

    R, P = 240_000, 100_000
    g = torch.Generator().manual_seed(5)
    rows = torch.randn((24, R), generator=g) * 10.0 ** torch.randint(-3, 4, (1, R), generator=g)
    gid = torch.randint(0, P + 1, (R,), generator=g, dtype=torch.int32)
    if kind == "one_id_5000_rows":
        gid[torch.randperm(R, generator=g)[:5000]] = 777
    else:
        gid[:] = 4242
    blocks = [rows[:16].contiguous().to(dev), rows[16:].contiguous().to(dev)]
    got = red.reduce_row_blocks(blocks, gid.to(dev), P)
    assert torch.equal(got.cpu(), red.reduce_rows_by_gid_reference(rows, gid, P))
    assert torch.equal(got, red.reduce_row_blocks(blocks, gid.to(dev), P))


@pytest.mark.parametrize("kind", ["uniform", "one_id_5000_rows", "all_rows_on_one_id",
                                  "all_sentinel"])
@pytest.mark.parametrize("cp,c", [(24, 19), (16, 16), (32, 32), (64, 37)])
def test_reduce_row_major_kernel_bit_exact(dev, kind, cp, c):
    """The row-major entry ([R, cp] rows, the first c columns summed)
    against its plain version on CPU copies, bit for bit, and across
    launches; ids past a warp's bucket, on one id and all on the
    sentinel."""
    from gof_tpu_torch.ops import reduce as red

    R, P = 240_000, 100_000
    g = torch.Generator().manual_seed(cp + c)
    vals = torch.randn((R, cp), generator=g) * 10.0 ** torch.randint(-3, 4, (R, 1), generator=g)
    gid = torch.randint(0, P + 1, (R,), generator=g, dtype=torch.int32)
    if kind == "one_id_5000_rows":
        gid[torch.randperm(R, generator=g)[:5000]] = 777
    elif kind == "all_rows_on_one_id":
        gid[:] = 4242
    elif kind == "all_sentinel":
        gid[:] = P
    before = red.REDUCE.launches
    got = red.reduce_row_major(vals.to(dev), gid.to(dev), P, c)
    assert red.REDUCE.launches == before + 1
    assert tuple(got.shape) == (P, c)
    assert torch.equal(got.cpu(), red.reduce_rows_by_gid_reference(vals[:, :c].T, gid, P))
    assert torch.equal(got, red.reduce_row_major(vals.to(dev), gid.to(dev), P, c))
    if kind == "all_sentinel":
        assert not got.any()


@pytest.mark.parametrize("C", [1, 7, 40])
def test_reduce_kernel_column_counts_bit_exact(dev, C):
    """Column counts off the 4-float row padding and past one warp's 32
    lanes, with short, warp-sized (40 rows) and block-sized (600 rows)
    buckets, split into two row arrays where C allows."""
    from gof_tpu_torch.ops import reduce as red

    R, P = 20_000, 3_000
    g = torch.Generator().manual_seed(C)
    rows = torch.randn((C, R), generator=g)
    gid = torch.randint(0, P + 1, (R,), generator=g, dtype=torch.int32)
    perm = torch.randperm(R, generator=g)
    gid[perm[:40]] = 11
    gid[perm[40:640]] = 12
    blocks = [rows.to(dev)] if C == 1 else [rows[:C // 2].contiguous().to(dev),
                                            rows[C // 2:].contiguous().to(dev)]
    got = red.reduce_row_blocks(blocks, gid.to(dev), P)
    assert tuple(got.shape) == (P, C)
    assert torch.equal(got.cpu(), red.reduce_rows_by_gid_reference(rows, gid, P))


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
    vals, ids = torch.zeros((10, 16), device=dev), torch.zeros(10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # rows of 6 floats: not whole float4s
        red.reduce_row_major(vals[:, :6].contiguous(), ids, 5)
    with pytest.raises(ValueError):  # more columns summed than the rows hold
        red.reduce_row_major(vals, ids, 5, 17)
    with pytest.raises(ValueError):  # CPU ids, CUDA rows
        red.reduce_row_major(vals, ids.cpu(), 5)
    with pytest.raises(ValueError):  # non-contiguous rows
        red.reduce_row_major(vals.T, torch.zeros(16, dtype=torch.int32, device=dev), 5)
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


def test_warm_liveness_limits_keep_the_step_on_cuda(dev):
    """Warm liveness limits (live_counts + 2) on the card: with a black
    background the image channels 0-7 are bit-equal to the unlimited
    render, T differs only where both are below 1e-4 (ROADMAP C21), and one
    step leaves a bit-equal state (C20); with limits of 0 chunks every
    non-empty tile is flagged and the step changes nothing."""
    from gof_tpu_torch import config, train
    from gof_tpu_torch.model import gaussians as gm
    from gof_tpu_torch.ops import binning

    (xyz, scales, rots, op, shs), cam = scene(6000, 200, 150, scale=(0.6, 1.5))
    c = cameras.look_at_camera(**cam, device=dev)
    gt = torch.rand((3, 150, 200), generator=torch.Generator().manual_seed(2)).to(dev)
    opt = config.OptimizationParams(distortion_from_iter=0, depth_normal_from_iter=0)

    def state():
        n = xyz.shape[0]
        z = torch.zeros(n, device=dev)
        g = gm.GaussianParams(xyz=xyz.to(dev, copy=True), features_dc=shs[:, :1].to(dev, copy=True),
                              features_rest=shs[:, 1:].to(dev, copy=True),
                              scaling=torch.log(scales).to(dev),
                              rotation=rots.to(dev, copy=True), opacity=torch.logit(op).to(dev))
        s = gm.GaussianState(active=torch.ones(n, dtype=torch.bool, device=dev),
                             filter_3d=z + 1e-4, max_radii2d=z.clone(), grad_accum=z.clone(),
                             grad_abs_accum=z.clone(), denom=z.clone())
        tx = train.make_optimizer(opt, 5.0)
        tp = train.TrainParams(gauss=g)
        return tx, (tp, tx.init(tp), s)

    tx, (tp, _, s) = state()
    bg = torch.zeros(3, device=dev)
    args = (c, tp.gauss.xyz, gm.filtered_scaling(tp.gauss, s.filter_3d), tp.gauss.rotation,
            gm.filtered_opacity(tp.gauss, s.filter_3d), train.masked_shs(tp.gauss, 0, 3), 3, 0.1,
            bg)
    with torch.no_grad():
        full = render.render(*args, with_stats=False)
        lim = full.live_counts + binning.LIVE_MARGIN_CHUNKS
        comp = render.render(*args, with_stats=False, live_limit_chunks=lim)
    assert int(comp.live_demand) < int(full.num_keys) and not comp.live_bad.any()
    assert torch.equal(comp.image[:8], full.image[:8])
    tf, tc = full.transmittance, comp.transmittance
    assert bool(((tf == tc) | ((tf < 1e-4) & (tc < 1e-4))).all())
    outs = []
    for row in (None, lim, torch.zeros_like(lim)):
        tx, st = state()
        step = train.build_train_step(opt, config.ModelParams(sh_degree=3, kernel_size=0.1),
                                      config.PipelineParams(), tx, with_stats=False)
        outs.append(step(*st, gt, 20000, c, bg, lim=row))
    (tp0, st0, s0, _), (tp1, st1, s1, m1), (tp2, st2, s2, m2) = outs
    for f in train.GAUSS_FIELDS:
        assert torch.equal(getattr(tp0.gauss, f), getattr(tp1.gauss, f)), f
        assert torch.equal(getattr(st0.mu, f), getattr(st1.mu, f)), f
        assert torch.equal(getattr(st0.nu, f), getattr(st1.nu, f)), f
        assert torch.equal(getattr(tp2.gauss, f), getattr(state()[1][0].gauss, f)), f
    assert st1.count == 1 and st2.count == 0 and bool(m2["packed"][9]) and not bool(m1["packed"][9])
    for f in ("max_radii2d", "denom"):
        assert torch.equal(getattr(s0, f), getattr(s1, f)), f


def test_xla_backend_and_oracle_on_cuda_match_the_kernels(dev):
    """The xla backend and the dense oracle on the card against the kernel
    path, with tests/test_torch_oracle.py's tolerances."""
    from gof_tpu_torch.ops import oracle

    args, cam = scene(12, 96, 64, scale=(2.0, 4.0))
    c = cameras.look_at_camera(**cam, device=dev)
    a = [x.to(dev) for x in args]
    bg = torch.tensor([0.2, 0.3, 0.4], device=dev)
    ker = render.render(c, *a, 3, 0.1, bg)
    xla = render.render(c, *a, 3, 0.1, bg, backend="xla")
    orc = oracle.render_oracle(*a, 3, c, 0.1, bg)
    torch.testing.assert_close(ker.image, xla.image, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(ker.image, orc.image, atol=2e-5, rtol=2e-4)
    torch.testing.assert_close(ker.transmittance, orc.transmittance, atol=2e-6, rtol=2e-4)


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


def test_integrate_kernel_uneven_blocks_bit_exact(dev):
    """Point blocks over segments of 1 to 3000 rows, an empty segment, full,
    partial and padding-only CUDA blocks (eighths of a point block): bit-equal to the plain
    version and across launches; points in no slot exactly 1."""
    from types import SimpleNamespace

    from gof_tpu_torch.ops import integrate as ti

    payload, b, meta, ntx, ntiles = synthetic_tiles(dev, segs=(1, 3000, 0, 600, 129, 40),
                                                    walls=(), faint=())
    rng = np.random.default_rng(7)
    focal, width, height = 100.0, 96, 64
    points = (3 * 1024 + 100, 10, 500, 1024, 700, 256)  # per tile: its point blocks' fill
    n_unproj = 7
    N = sum(points) + n_unproj
    ids = rng.permutation(N)
    slots, tiles, rxs, rys, zs, k = [], [], [], [], [], 0
    for t, n in enumerate(points):
        nb = -(-n // ti.PBLOCK)
        pid = np.full(nb * ti.PBLOCK, N, np.int32)
        pid[:n] = ids[k:k + n]
        k += n
        x0, y0 = (t % ntx) * 32 - width / 2, (t // ntx) * 32 - height / 2
        rx = np.where(pid < N, rng.uniform(x0, x0 + 32, pid.size) / focal, 0.0)
        ry = np.where(pid < N, rng.uniform(y0, y0 + 32, pid.size) / focal, 0.0)
        slots.append(pid)
        tiles += [t] * nb
        rxs.append(rx), rys.append(ry)
        zs.append(np.where(pid < N, rng.uniform(1, 12, pid.size), 0))
    f32 = lambda x: torch.tensor(np.concatenate(x), dtype=torch.float32, device=dev)  # noqa: E731
    pb = SimpleNamespace(n_blocks=len(tiles),
                         block_tile=torch.tensor(tiles, dtype=torch.int32, device=dev),
                         rx=f32(rxs), ry=f32(rys), depth=f32(zs),
                         point_of_slot=torch.tensor(np.concatenate(slots), device=dev))
    before = ti.INTEGRATE.launches
    got = ti.integrate_transmittance(payload, b, pb, N)
    assert ti.INTEGRATE.launches == before + 1
    want = ti.integrate_transmittance_reference(payload, b, pb, N)
    assert torch.equal(got, want)
    assert torch.equal(got, ti.integrate_transmittance(payload, b, pb, N))
    unproj = torch.tensor(ids[k:], device=dev).long()
    assert len(unproj) == n_unproj and bool((got[unproj] == 1).all())
    assert float(got.min()) < 0.5


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


# ---------------------------------------------------------------------------
# K6-K13, the gather/scatter probes
# ---------------------------------------------------------------------------

PROBE_SHAPES = {  # PAGE, W, CHUNK, NCHUNK, PAGE_B / CH, WG, C8, NCH, CV
    "small": (dict(page=256, w=32, chunk=128, nchunk=4, page_b=64),
              dict(ch=128, wg=256, c8=128, nch=4, cv=8)),
    "ragged": (dict(page=512, w=64, chunk=100, nchunk=3, page_b=128),
               dict(ch=72, wg=192, c8=64, nch=5, cv=4)),
    "script": (dict(page=16384, w=32, chunk=2048, nchunk=256, page_b=2048),
               dict(ch=1024, wg=2048, c8=128, nch=512, cv=8)),
}


def probe_idx(rng, shape, lo, hi, edges=()):
    idx = rng.integers(lo, hi, shape).astype(np.int32)
    idx.reshape(-1)[:len(edges)] = edges
    return torch.from_numpy(idx)


@pytest.mark.parametrize("view", ["as_drawn", "w30", "w1", "w129", "unaligned", "one_row"])
@pytest.mark.parametrize("shapes", list(PROBE_SHAPES))
def test_probe_gathers_match_plain(dev, shapes, view):
    """K6, K7 and K8 bit-equal to their plain versions on the edge indices.
    K6 and K7 share one kernel: 16-byte pieces where W % 4 == 0 and the
    table is 16-byte aligned, 4-byte pieces at any other width ("w30",
    "w1", "w129") or view ("unaligned": a table one float past an aligned
    buffer); "one_row" puts every index on one row. K8 takes the drawn
    table alone."""
    from gof_tpu_torch.ops import gather_probes as gp

    s, _ = PROBE_SHAPES[shapes]
    rng = np.random.default_rng(11)
    page = s["page"]
    w = {"w30": 30, "w1": 1, "w129": 129}.get(view, s["w"])
    table = torch.from_numpy(rng.normal(size=(page, w)).astype(np.float32)).to(dev)
    if view == "unaligned":
        table = torch.zeros(page * w + 1, device=dev)[1:].view(page, w).copy_(table)
        assert table.data_ptr() % 16 == 4
    edges = (-2**31, 2**31 - 1, -page - 1, -page, -1, 0, page - 1, page)
    idx = probe_idx(rng, (s["nchunk"], 1, s["chunk"]), -page - 8, page + 8, edges).to(dev)
    if view == "one_row":
        idx = torch.full_like(idx, page // 3)
    gathers = [(gp.take_gather, gp.take_gather_reference, {}, gp.TAKE),
               (gp.vidx_gather, gp.vidx_gather_reference, {}, gp.VIDX)]
    if view == "as_drawn":
        gathers.append((gp.onehot_gather, gp.onehot_gather_reference, {"page_b": s["page_b"]},
                        gp.ONEHOT))
    for fn, plain, kw, counter in gathers:
        before = counter.launches
        got = fn(idx, table, **kw)
        assert counter.launches == before + 1
        assert torch.equal(got, plain(idx, table, **kw)), fn.__name__
    # in-range indices: the library gather computes the same function
    ok = probe_idx(rng, (s["nchunk"], 1, s["chunk"]), 0, page).to(dev)
    flat = ok.reshape(-1)
    assert torch.equal(gp.take_gather(ok, table), torch.index_select(table, 0, flat))
    assert torch.equal(gp.vidx_gather(ok, table), torch.index_select(table, 0, flat))
    if view == "as_drawn":
        assert torch.equal(gp.onehot_gather(ok, table, s["page_b"]),
                           torch.index_select(table.bfloat16().float(), 0, flat))


@pytest.mark.parametrize("shapes", list(PROBE_SHAPES))
def test_probe_scatters_match_plain(dev, shapes):
    from gof_tpu_torch.ops import gather_probes as gp

    s, _ = PROBE_SHAPES[shapes]
    rng = np.random.default_rng(12)
    page = s["page"]
    n = s["nchunk"] * s["chunk"]
    rows = torch.from_numpy(rng.normal(size=(n, s["w"])).astype(np.float32)).to(dev)
    idx = probe_idx(rng, (s["nchunk"], 1, s["chunk"]), -page - 8, page + 8,
                    (-2**31, 2**31 - 1, -page - 1, -page, -1, page)).to(dev)
    got = gp.scat(idx, rows, page)
    want = gp.scat_reference(idx, rows, page)
    tol = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
    assert bool(((got - want).abs() <= tol).all())
    # K10 folds each id's rows in ascending input row, as its plain version
    # does on the CPU: equal bit for bit, and across launches
    before = gp.SCATMXU.launches
    got = gp.scatmxu(idx, rows, page)
    assert gp.SCATMXU.launches == before + 1
    assert torch.equal(got.cpu(), gp.scatmxu_reference(idx.cpu(), rows.cpu(), page))
    assert torch.equal(got, gp.scatmxu(idx, rows, page))


@pytest.mark.parametrize("kind", ["one_id_5000_rows", "all_rows_on_one_id", "all_sentinel"])
def test_probe_scatmxu_skewed_ids_bit_exact(dev, kind):
    """K10 at the script's shapes with one id owning 5000+ rows (the reduce's
    block path), every row on one id, every row on the sentinel."""
    from gof_tpu_torch.ops import gather_probes as gp

    s, _ = PROBE_SHAPES["script"]
    rng = np.random.default_rng(17)
    page, n = s["page"], s["nchunk"] * s["chunk"]
    rows = torch.from_numpy(rng.normal(size=(n, s["w"])).astype(np.float32))
    idx = rng.integers(0, page, n).astype(np.int32)
    if kind == "one_id_5000_rows":
        idx[rng.permutation(n)[:6000]] = 777
    else:
        idx[:] = 4242 if kind == "all_rows_on_one_id" else page
    idx = torch.from_numpy(idx.reshape(s["nchunk"], 1, s["chunk"]))
    got = gp.scatmxu(idx.to(dev), rows.to(dev), page)
    assert torch.equal(got.cpu(), gp.scatmxu_reference(idx, rows, page))
    assert torch.equal(got, gp.scatmxu(idx.to(dev), rows.to(dev), page))


PROBE_DISTS = ("uniform", "sorted", "one_index", "own_kstep", "outside")


def probe_dist_idx(kind: str, s: dict, seed: int) -> torch.Tensor:
    """K8's and K9's index distributions at a PROBE_SHAPES entry: the
    uniform draw, the same sorted, every row on one index, consecutive rows
    on distinct k-steps (cycling over all of them), every index outside
    [-PAGE, PAGE)."""
    rng = np.random.default_rng(seed)
    page, n = s["page"], s["nchunk"] * s["chunk"]
    r = np.arange(n)
    v = {"uniform": lambda: rng.integers(0, page, n),
         "sorted": lambda: np.sort(rng.integers(0, page, n)),
         "one_index": lambda: np.full(n, page // 3),
         "own_kstep": lambda: 16 * (r % (page // 16)) + (r // (page // 16) + 5 * r) % 16,
         "outside": lambda: rng.choice([-2**31, 2**31 - 1, -page - 1, -2 * page, page, page + 7],
                                       n)}[kind]()
    return torch.from_numpy(v.astype(np.int32).reshape(s["nchunk"], 1, s["chunk"]))


@pytest.mark.parametrize("dist", PROBE_DISTS)
@pytest.mark.parametrize("shapes", list(PROBE_SHAPES))
def test_probe_onehot_index_distributions_bit_exact(dev, shapes, dist):
    """K8 (sort by k-step, then a product per hit k-step) bit-equal to its
    plain version and to index_select of the bf16-rounded table."""
    from gof_tpu_torch.ops import gather_probes as gp

    s, _ = PROBE_SHAPES[shapes]
    rng = np.random.default_rng(18)
    table = torch.from_numpy(rng.normal(size=(s["page"], s["w"])).astype(np.float32)).to(dev)
    idx = probe_dist_idx(dist, s, 19).to(dev)
    got = gp.onehot_gather(idx, table, s["page_b"])
    assert torch.equal(got, gp.onehot_gather_reference(idx, table, s["page_b"]))
    if dist == "outside":
        assert not got.any()
    else:
        assert torch.equal(got, torch.index_select(table.bfloat16().float(), 0, idx.reshape(-1)))


@pytest.mark.parametrize("shapes", list(PROBE_SHAPES))
def test_probe_onehot_every_sorted_tile_on_64_ksteps(dev, shapes):
    """K8's slowest tiles: PAGE / 16 rows, each on a k-step of its own, so
    each 64 sorted rows hit 64 k-steps (the product's double buffer wraps
    32 times)."""
    from gof_tpu_torch.ops import gather_probes as gp

    s, _ = PROBE_SHAPES[shapes]
    rng = np.random.default_rng(20)
    page = s["page"]
    table = torch.from_numpy(rng.normal(size=(page, s["w"])).astype(np.float32)).to(dev)
    nk = page // 16
    ix = 16 * rng.permutation(nk) + rng.integers(0, 16, nk)
    idx = torch.from_numpy(ix.astype(np.int32).reshape(1, 1, nk)).to(dev)
    got = gp.onehot_gather(idx, table, s["page_b"])
    assert torch.equal(got, torch.index_select(table.bfloat16().float(), 0, idx.reshape(-1)))


@pytest.mark.parametrize("dist", PROBE_DISTS)
@pytest.mark.parametrize("shapes", list(PROBE_SHAPES))
def test_probe_scat_index_distributions(dev, shapes, dist):
    """K9 (16-byte vector reductions) within rtol 1e-5 / atol 1e-5 x max
    |plain| of its plain version and of index_add_. Every row on one index
    sums n rows into one address in any order: there the rows are integers
    in [-8, 8], so every partial sum is an integer below 2**24 and each f32
    add is exact in any order; the result must equal the float64 sum (and
    the plain version, and index_add_) exactly."""
    from gof_tpu_torch.ops import gather_probes as gp

    s, _ = PROBE_SHAPES[shapes]
    rng = np.random.default_rng(21)
    page, n, w = s["page"], s["nchunk"] * s["chunk"], s["w"]
    rows = (rng.integers(-8, 9, (n, w)) if dist == "one_index" else rng.normal(size=(n, w)))
    rows = torch.from_numpy(rows.astype(np.float32)).to(dev)
    idx = probe_dist_idx(dist, s, 22).to(dev)
    got = gp.scat(idx, rows, page)
    want = gp.scat_reference(idx, rows, page)
    if dist == "outside":
        assert not got.any() and not want.any()
        return
    lib = torch.zeros((page, w), device=dev).index_add_(0, idx.reshape(-1), rows)
    if dist == "one_index":
        exact = torch.zeros((page, w), dtype=torch.float64, device=dev)
        exact[page // 3] = rows.double().sum(0)
        assert torch.equal(got.double(), exact)
        assert torch.equal(got, want) and torch.equal(got, lib)
        return
    for ref in (want, lib):
        tol = 1e-5 * ref.abs() + 1e-5 * float(ref.abs().max())
        assert bool(((got - ref).abs() <= tol).all())


@pytest.mark.parametrize("shapes", list(PROBE_SHAPES))
def test_probe_int8_and_paged_match_plain(dev, shapes):
    from gof_tpu_torch.ops import gather_probes as gp

    _, s = PROBE_SHAPES[shapes]
    rng = np.random.default_rng(13)
    wg, c8 = s["wg"], s["c8"]
    tbl = torch.from_numpy(rng.integers(-128, 128, (wg, c8)).astype(np.int8)).to(dev)
    idx = probe_idx(rng, (s["nch"], 1, s["ch"]), -8, wg + 8,
                    (-2**31, 2**31 - 1, -1, 0, wg - 1, wg)).to(dev)
    got = gp.int8_gather(idx, tbl)
    assert torch.equal(got, gp.int8_gather_reference(idx, tbl))
    big = torch.from_numpy(rng.integers(-128, 128, (8 * wg, c8)).astype(np.int8)).to(dev)
    pages = rng.integers(-1, 9, s["nch"]).astype(np.int32)  # two pages outside the table
    pages[:2] = (3, 7)
    pidx = np.empty((s["nch"], 1, s["ch"]), np.int32)
    for i, p in enumerate(pages):
        pidx[i, 0] = rng.integers(p * wg - wg // 4, (p + 1) * wg + wg // 4, s["ch"])
    pages_t, pidx_t = torch.from_numpy(pages).to(dev), torch.from_numpy(pidx).to(dev)
    got = gp.paged_gather(pages_t, pidx_t, big, wg)
    assert torch.equal(got, gp.paged_gather_reference(pages_t, pidx_t, big, wg))
    assert bool(got[:s["ch"]].any())


@pytest.mark.parametrize("case", ["single_page", "few_chunks"])
@pytest.mark.parametrize("shapes", list(PROBE_SHAPES))
def test_probe_int8_and_paged_single_page_and_few_chunks(dev, shapes, case):
    """Every chunk on one page, and 3 chunks: fewer than the product's
    persistent blocks, so blocks split a chunk's m-tiles."""
    from gof_tpu_torch.ops import gather_probes as gp

    _, s = PROBE_SHAPES[shapes]
    rng = np.random.default_rng(15)
    wg, c8, ch = s["wg"], s["c8"], s["ch"]
    nch = s["nch"] if case == "single_page" else 3
    pages = np.full(nch, 5, np.int32) if case == "single_page" else np.array([6, -1, 0], np.int32)
    big = torch.from_numpy(rng.integers(-128, 128, (8 * wg, c8)).astype(np.int8)).to(dev)
    pidx = np.stack([rng.integers(p * wg - 8, (p + 1) * wg + 8, ch) for p in pages])[:, None]
    pages_t, pidx_t = torch.from_numpy(pages).to(dev), torch.from_numpy(pidx.astype(np.int32)).to(dev)
    got = gp.paged_gather(pages_t, pidx_t, big, wg)
    assert torch.equal(got, gp.paged_gather_reference(pages_t, pidx_t, big, wg))
    assert bool(got[:ch].any())
    tbl = big[:wg].contiguous()
    idx = torch.from_numpy(rng.integers(-8, wg + 8, (nch, 1, ch)).astype(np.int32)).to(dev)
    assert torch.equal(gp.int8_gather(idx, tbl), gp.int8_gather_reference(idx, tbl))


@pytest.mark.parametrize("shapes", list(PROBE_SHAPES))
def test_probe_int8_helpers_match_plain(dev, shapes):
    """K13's grouping pass and the B-layout pass against their plain twins."""
    from gof_tpu_torch.ops import gather_probes as gp

    _, s = PROBE_SHAPES[shapes]
    rng = np.random.default_rng(16)
    pages = torch.from_numpy(rng.integers(-2, 10, s["nch"]).astype(np.int32))
    order, starts = gp.group_chunks_by_page(pages.to(dev), 8)
    want = gp.group_chunks_by_page_reference(pages, 8)
    assert torch.equal(order.cpu(), want[0]) and torch.equal(starts.cpu(), want[1])
    big = torch.from_numpy(rng.integers(-128, 128, (8 * s["wg"], s["c8"])).astype(np.int8))
    got = gp.s8_operand_layout(big.to(dev), s["wg"])
    assert torch.equal(got.cpu(), gp.s8_operand_layout_reference(big, s["wg"]))


@pytest.mark.parametrize("case", ["as_drawn", *RLD_EDGE_CASES])
@pytest.mark.parametrize("shapes", list(PROBE_SHAPES))
def test_probe_rld_matches_plain(dev, shapes, case):
    """K12 bit-equal to its plain version, values over the whole int32
    range: on sorted draws with a chunk whose rows start uncovered, and on
    mxu_gather_probe.rld_edge_offsets' cases (every offset 0, a dense chunk,
    k across 2^30 and across the int32 wrap, uncovered rows, WG = 65,536)."""
    from gof_tpu_torch.ops import gather_probes as gp
    from gof_tpu_torch.scripts.mxu_gather_probe import rld_edge_offsets

    _, s = PROBE_SHAPES[shapes]
    rng = np.random.default_rng(14)
    nch, ch, wg = s["nch"], s["ch"], s["wg"]
    if case == "as_drawn":
        off = np.sort(rng.integers(0, nch * ch, (nch, 1, wg)), axis=-1)
        off[0, 0] = np.sort(rng.integers(ch + 7, nch * ch + ch, wg))  # uncovered rows in chunk 0
        base = np.zeros((nch, 1, 8), np.int64)
        base[:, 0, 0] = np.arange(nch) * ch
    else:
        off, base = rld_edge_offsets(case, nch, ch, wg, rng)
    val = rng.integers(-2**31, 2**31 - 1, (off.shape[-1], s["cv"]))  # exact past 2^24
    args = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in (off, val, base)]
    before = gp.RLD.launches
    got = gp.rld(*args, ch)
    assert gp.RLD.launches == before + 1
    assert torch.equal(got, gp.rld_reference(*args, ch)), case
    if case == "as_drawn":
        assert not got[:7].any() and bool(got[ch:].any())
    elif case == "uncovered":
        assert not got[:ch // 2].any() and bool(got[ch // 2:ch].any())


def test_probe_wrappers_refuse_bad_inputs(dev):
    from gof_tpu_torch.ops import gather_probes as gp

    table = torch.zeros((256, 32), device=dev)
    idx = torch.zeros((4, 1, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # mixed devices
        gp.take_gather(idx.cpu(), table)
    with pytest.raises(ValueError):  # non-contiguous table
        gp.vidx_gather(idx, torch.zeros((32, 256), device=dev).T)
    with pytest.raises(ValueError):  # the kernel's width is a multiple of 32 (the wgmma N)
        gp.onehot_gather(idx, torch.zeros((256, 40), device=dev), 64)
    with pytest.raises(ValueError):  # the table is whole k-steps of 16 rows
        gp.onehot_gather(idx, torch.zeros((264, 32), device=dev), 8)
    with pytest.raises(ValueError):  # the sort's histogram fits in shared memory
        gp.onehot_gather(idx, torch.zeros((16 * 60000, 32), device=dev), 16)
    with pytest.raises(ValueError):  # the rows are whole float4s
        gp.scat(idx, torch.zeros((512, 30), device=dev), 256)
    with pytest.raises(ValueError):  # 16-byte aligned rows
        gp.scat(idx, torch.zeros(512 * 32 + 1, device=dev)[1:].view(512, 32), 256)
    with pytest.raises(ValueError):  # non-contiguous rows
        gp.scatmxu(idx, torch.zeros((32, 512), device=dev).T, 256)
    with pytest.raises(ValueError):  # the rows are whole float4s
        gp.scatmxu(idx, torch.zeros((512, 30), device=dev), 256)
    with pytest.raises(ValueError):  # int8 slab of 64 columns
        gp.int8_gather(idx, torch.zeros((256, 32), dtype=torch.int8, device=dev))
    with pytest.raises(ValueError):  # CV a multiple of 4
        gp.rld(idx, torch.zeros((128, 6), dtype=torch.int32, device=dev),
               torch.zeros((4, 1, 8), dtype=torch.int32, device=dev), 64)
    with pytest.raises(ValueError):  # val rows read as 16-byte pieces
        gp.rld(idx, torch.zeros(128 * 8 + 1, dtype=torch.int32, device=dev)[1:].view(128, 8),
               torch.zeros((4, 1, 8), dtype=torch.int32, device=dev), 64)


def test_probe_entry_points_on_the_card(dev):
    from gof_tpu_torch.scripts import mxu_gather_probe, pallas_gather_probe

    out = pallas_gather_probe.main(["--page", "1024", "--chunk", "256", "--nchunk", "8",
                                    "--page_b", "256"])
    k = out["kernels"]
    assert out["device"] == torch.cuda.get_device_name(0)
    assert all(k[n]["exact"] and k[n]["library_exact"]
               for n in ("take_gather", "vidx_gather", "onehot_gather"))
    assert k["scat"]["within_tol"] and k["scatmxu"]["within_tol"] and k["scatmxu"]["deterministic"]
    out = mxu_gather_probe.main(["--ch", "256", "--wg", "512", "--nch", "16", "--cap", "100000",
                                 "--presort", "50000"])
    assert all(r["exact"] for r in out["kernels"].values()) and out["sort_ordered"]
