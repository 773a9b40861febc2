"""gof_tpu_torch's point binning and integrate path (K5's plain version)
against gof_tpu.

The index fields of the aligned point binning are exact; ray slopes and
depths agree within 1e-6. Transmittance is held to gof_tpu's Pallas kernel
in interpret mode at atol 1e-5 / rtol 1e-4 (gof_tpu's own Pallas-vs-dense
tolerance, tests/test_mesh.py): gof_tpu multiplies a log-doubling cumprod
per chunk and forms d with a matmul, the port a serial product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import cameras as jcam
from gof_tpu.ops import binning as jb
from gof_tpu.ops import integrate as ji
from gof_tpu.ops import quadrics as jq
from gof_tpu.ops import rasterize_pallas as jrp
from gof_tpu_torch import cameras as tcam
from gof_tpu_torch.ops import binning as tb
from gof_tpu_torch.ops import integrate as ti
from gof_tpu_torch.ops import quadrics as tq
from gof_tpu_torch.ops import rasterize as trz

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
CAM = dict(eye=(0, 0, 0), target=(0, 0, 5.0), width=64, height=64)


def t(x):
    return torch.from_numpy(np.array(x))


def gauss_scene(rng, n=10):
    """tests/test_mesh.py's scene as numpy arrays: means, scales, rots, op."""
    z = rng.uniform(4, 6, n)
    x = rng.uniform(-0.8, 0.8, n)
    y = rng.uniform(-0.8, 0.8, n)
    means = np.stack([x, y, z], -1).astype(np.float32)
    scales = rng.uniform(0.4, 0.9, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return means, scales, q.astype(np.float32), rng.uniform(0.5, 0.95, n).astype(np.float32)


def query_points(rng, n=200):
    return (rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, 5.0])).astype(np.float32)


def jax_view(scene, pts, cam_kw=CAM):
    """gof_tpu's FieldEvaluator view body up to the kernel's inputs (one
    jitted program: eager dispatch would compile each op on its own)."""
    cam = jcam.look_at_camera(**cam_kw)
    return (cam,) + _jax_view(*(jnp.asarray(a) for a in scene), jnp.asarray(pts), cam)


@jax.jit
def _jax_view(means, scales, rots, op, pts, cam):
    pre = jq.preprocess(means, scales, rots, jnp.zeros((len(op), 1, 3)), 0, cam, 0.1)
    ntx, nty = jb.tile_grid(cam.width, cam.height)
    rects = jb.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty, radius_xy=pre.radius_xy)
    b = jb.bin_gaussians(pre.depth, rects, ntx, nty, 2048, mean2d=pre.mean2d, radius=pre.radius)
    op_eff = op * jnp.where(pre.valid, pre.coef, 0.0)
    payload = jrp.build_payload16(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b)
    pcap = max(1 << int(np.ceil(np.log2(max(len(pts), ji.PBLOCK)))), ji.PBLOCK)  # as gof_tpu's
    pb = ji.bin_points(pts, cam, ntx, nty, pcap)
    return pre, op_eff, payload, b, pb


def torch_view(scene, pts, cam_kw=CAM):
    """The port's counterpart (mesh.extract.FieldEvaluator.view_inputs)."""
    means, scales, rots, op = (t(a) for a in scene)
    cam = tcam.look_at_camera(**cam_kw)
    pre = tq.preprocess(means, scales, rots, torch.zeros((len(op), 1, 3)), 0, cam, 0.1)
    ntx, nty = tb.tile_grid(cam.width, cam.height)
    rects = tb.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty, radius_xy=pre.radius_xy)
    b = tb.bin_gaussians(pre.depth, rects, ntx, nty, mean2d=pre.mean2d, radius=pre.radius)
    op_eff = op * torch.where(pre.valid, pre.coef, torch.zeros_like(pre.coef))
    payload = trz.build_payload16(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b)
    pb = ti.bin_points(t(pts), cam, ntx, nty)
    return cam, pre, op_eff, payload, b, pb


@pytest.mark.parametrize("n,ntiles,block,seed", [(50, 7, 8, 0), (300, 5, 16, 1), (40, 3, 8, 2)])
def test_bin_items_aligned_matches(n, ntiles, block, seed):
    rng = np.random.default_rng(seed)
    tile = rng.integers(0, ntiles + 1, n).astype(np.int32)  # ntiles = invalid
    if seed == 2:
        tile[tile == 1] = ntiles  # an empty tile between full ones
    want = jax.device_get(jax.jit(jb.bin_items_aligned, static_argnums=(1, 2, 3))(
        jnp.asarray(tile), ntiles, n, block))
    got = tb.bin_items_aligned(t(tile), ntiles, block)
    np.testing.assert_array_equal(got.tile_start.numpy(), want.tile_start)
    np.testing.assert_array_equal(got.tile_blocks.numpy(), want.tile_blocks)
    assert int(got.num_keys) == int(want.num_keys) == int((tile < ntiles).sum())
    real = int(want.tile_blocks.sum()) * block
    assert got.slot_to_item.shape == (real,)
    np.testing.assert_array_equal(got.slot_to_item.numpy(), want.slot_to_item[:real])
    assert (want.slot_to_item[real:] == n).all()
    assert real <= tb.aligned_capacity(n, ntiles, block) == jb.aligned_capacity(n, ntiles, block)
    assert not bool(got.overflow)


def test_bin_points_matches():
    rng = np.random.default_rng(3)
    scene = gauss_scene(rng)
    pts = query_points(rng, 2500)
    pts[1000:, :2] = pts[1000:, :2] * 0.05 + 0.3  # 1500 points in one tile: two blocks
    pts[:20, 2] = -3.0  # behind the camera
    pts[20:40, 0] = 50.0  # outside the image
    *_, jpb = jax_view(scene, pts)
    *_, tpb = torch_view(scene, pts)
    jpb = jax.device_get(jpb)
    B = tpb.n_blocks
    assert B == int(jpb.block_real.sum()) and B > 4
    assert np.diff(tpb.bins.tile_blocks.numpy()).any()
    np.testing.assert_array_equal(tpb.bins.tile_start.numpy(), jpb.bins.tile_start)
    np.testing.assert_array_equal(tpb.bins.tile_blocks.numpy(), jpb.bins.tile_blocks)
    assert int(tpb.bins.num_keys) == int(jpb.bins.num_keys) == 2500 - 40
    np.testing.assert_array_equal(tpb.block_tile.numpy(), jpb.block_tile[:B])
    np.testing.assert_array_equal(jpb.block_ofs[:B], np.arange(B))  # block b: slots b * PBLOCK on
    S = B * ti.PBLOCK
    np.testing.assert_array_equal(tpb.point_of_slot.numpy(), jpb.point_of_slot[:S])
    for name in ("rx", "ry", "depth"):
        np.testing.assert_allclose(getattr(tpb, name).numpy(), getattr(jpb, name)[:S],
                                   atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def pallas_scene():
    """test_mesh.py's gauss_scene (10 gaussians, 64x64, 200 points) through
    gof_tpu's integrate kernel in interpret mode, the one Pallas call here."""
    rng = np.random.default_rng(0)
    scene = gauss_scene(rng)
    pts = query_points(rng)
    _, _, _, payload, b, pb = jax_view(scene, pts)
    T = ji.integrate_transmittance_pallas(payload, b, pb, len(pts), interpret=True)
    return scene, pts, np.asarray(T)


def test_plain_matches_pallas_interpret(pallas_scene):
    scene, pts, want = pallas_scene
    _, _, _, payload, b, pb = torch_view(scene, pts)
    before = ti.INTEGRATE.launches
    got = ti.integrate_transmittance(payload, b, pb, len(pts))
    assert ti.INTEGRATE.launches == before  # CPU tensors never launch
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert (want < 0.9).mean() > 0.3  # the points do see gaussians
    torch.testing.assert_close(got, ti.integrate_transmittance_reference(payload, b, pb, len(pts)),
                               atol=0, rtol=0)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_and_dense_match_gof_tpu_dense(seed):
    rng = np.random.default_rng(seed)
    scene = gauss_scene(rng, n=30)
    pts = query_points(rng, 400)
    cam, pre, op_eff, *_ = jax_view(scene, pts)
    want = np.asarray(ji.integrate_transmittance_dense(jnp.asarray(pts), cam, op_eff, pre.v2g_M,
                                                       pre.v2g_u0, pre.valid))
    tcam_, tpre, top, payload, b, pb = torch_view(scene, pts)
    dense = ti.integrate_transmittance_dense(t(pts), tcam_, top, tpre.v2g_M, tpre.v2g_u0,
                                             tpre.valid)
    np.testing.assert_allclose(dense.numpy(), want, atol=ATOL, rtol=RTOL)
    plain = ti.integrate_transmittance(payload, b, pb, len(pts))
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=RTOL)


def test_unprojected_points_get_T1():
    rng = np.random.default_rng(4)
    scene = gauss_scene(rng)
    pts = np.array([[0, 0, -5.0], [100, 100, 5.0], [0, 0, 1e-5]], np.float32)
    cam, pre, op, payload, b, pb = torch_view(scene, pts)
    assert pb.n_blocks == 0
    assert torch.equal(ti.integrate_transmittance(payload, b, pb, 3), torch.ones(3))
    dense = ti.integrate_transmittance_dense(t(pts), cam, op, pre.v2g_M, pre.v2g_u0, pre.valid)
    assert torch.equal(dense, torch.ones(3))


def test_transmittance_monotone_along_ray():
    """T falls as the query point moves deeper along one ray."""
    rng = np.random.default_rng(0)
    scene = gauss_scene(rng)
    depths = np.linspace(1.0, 9.0, 30, dtype=np.float32)
    pts = np.stack([0 * depths, 0 * depths, depths], -1)
    *_, payload, b, pb = torch_view(scene, pts)
    T = ti.integrate_transmittance(payload, b, pb, len(pts)).numpy()
    assert np.all(np.diff(T) <= 1e-6) and T[0] > 0.99 and T[-1] < 0.5


def test_nonfinite_row_stays_in_its_tile():
    """A NaN payload row of the previous tile's part of a shared 128-row
    window leaves this tile's points finite and unchanged (ROADMAP C1: the
    TPU kernel multiplies masked rows by zero)."""
    rng = np.random.default_rng(5)
    scene = gauss_scene(rng, n=40)
    pts = query_points(rng, 2000)
    _, _, _, payload, b, pb = torch_view(scene, pts)
    bounds = b.bounds.numpy()
    tiles = [k for k in range(1, len(bounds) - 1)
             if bounds[k] % 128 and bounds[k + 1] > bounds[k] > bounds[k - 1]
             and int(pb.bins.tile_blocks[k]) > 0]
    assert tiles
    k = tiles[0]
    bad = payload.clone()
    bad[:, bounds[k] - 1] = float("nan")
    clean = ti.integrate_transmittance(payload, b, pb, len(pts))
    got = ti.integrate_transmittance(bad, b, pb, len(pts))
    mine = pb.point_of_slot[pb.block_tile.repeat_interleave(ti.PBLOCK) == k]
    mine = mine[mine < len(pts)].long()
    assert len(mine) and bool(torch.isfinite(got[mine]).all())
    assert torch.equal(got[mine], clean[mine])
    assert (clean[mine] < 1).any()


def test_wrapper_refuses_other_devices():
    rng = np.random.default_rng(6)
    scene = gauss_scene(rng)
    _, _, _, payload, b, pb = torch_view(scene, query_points(rng, 50))
    with pytest.raises(ValueError):
        ti.integrate_transmittance(payload.to("meta"), b, pb, 50)
