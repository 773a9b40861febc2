"""gof_tpu_torch binning and class-expansion gather against gof_tpu.

Both must be exact: the expand plain version is compared bit for bit with
gof_tpu's Pallas kernel (interpret mode) and its XLA gather, and
bin_gaussians' slot order, tile bounds, key count and slot demand with
gof_tpu's bin_gaussians on the same preprocess outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import cameras as jcam
from gof_tpu.ops import binning as jb
from gof_tpu.ops import class_gather as jcg
from gof_tpu.ops import quadrics as jq
from gof_tpu_torch.ops import binning as tb
from gof_tpu_torch.ops import class_gather as tcg

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("cap,P", [(4096, 700), (2500, 3000)])
def test_expand_matches_kernel_and_gather(rng, cap, P):
    """Monotone step-0/1 indices, int32 columns with float bits and negatives."""
    steps = (rng.uniform(size=cap) < 0.4).astype(np.int32)
    gidx = np.clip(np.cumsum(steps) - 3, 0, None).astype(np.int32)  # may exceed P-1
    cols_np = [rng.integers(-2**31, 2**31 - 1, P, dtype=np.int64).astype(np.int32),
               rng.normal(size=P).astype(np.float32).view(np.int32),
               rng.integers(0, 1000, P).astype(np.int32),
               np.arange(P, dtype=np.int32)]
    nbytes = [4, 4, 2, 2]
    ref = {}
    for force in ("interpret", "xla"):
        ref[force] = [np.asarray(a) for a in jcg.expand(
            [(jnp.asarray(c), n) for c, n in zip(cols_np, nbytes)], jnp.asarray(gidx), P,
            force=force)]
    got = tcg.expand([t(c) for c in cols_np], t(gidx), P)
    for i in range(len(cols_np)):
        np.testing.assert_array_equal(got[i].numpy(), ref["interpret"][i])
        np.testing.assert_array_equal(got[i].numpy(), ref["xla"][i])


def test_expand_wrapper_dispatch():
    """CPU tensors run the plain version and count no launch; tensors on a
    device that is neither CPU nor CUDA are refused, never sent to it."""
    tbl = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    gidx = torch.tensor([0, 0, 1, 3], dtype=torch.int32)
    before = tcg.EXPAND.launches
    out = tcg.expand_kernel_call(tbl, gidx)
    assert tcg.EXPAND.launches == before
    assert torch.equal(out, tcg.expand_reference(tbl, gidx))
    with pytest.raises(ValueError):
        tcg.expand_kernel_call(tbl.to("meta"), gidx.to("meta"))


def scene_many(rng):
    """400 gaussians on a 64x64 image: tiles hold more than 128 keys."""
    n = 400
    z = rng.uniform(3, 8, n)
    x = rng.uniform(-1, 1, n) * z * 0.25
    y = rng.uniform(-1, 1, n) * z * 0.25
    means = np.stack([x, y, z], -1)
    scales = rng.uniform(0.1, 0.5, (n, 3))
    return means, scales, 64, 64


def scene_giant(rng):
    """One near-camera gaussian spanning the whole tile grid."""
    n = 60
    z = rng.uniform(3, 8, n)
    means = np.stack([rng.uniform(-1, 1, n) * z * 0.2, rng.uniform(-1, 1, n) * z * 0.2, z], -1)
    scales = rng.uniform(0.05, 0.2, (n, 3))
    means[7] = [0.0, 0.0, 0.6]
    scales[7] = [2.0, 2.0, 2.0]
    return means, scales, 160, 96


def scene_ties(rng):
    """Pairs of gaussians with bit-equal depths in the same tiles, where the
    lower id has the larger rect (a later size class in slot order)."""
    n = 40
    z = rng.uniform(3, 8, n)
    means = np.stack([rng.uniform(-1, 1, n) * z * 0.2, rng.uniform(-1, 1, n) * z * 0.2, z], -1)
    scales = rng.uniform(0.05, 0.2, (n, 3))
    for big, small in ((0, 1), (10, 3), (20, 21)):
        means[small] = means[big]
        scales[big] = [0.6, 0.6, 0.6]
        scales[small] = [0.05, 0.05, 0.05]
    return means, scales, 128, 96


SCENES = {"many": scene_many, "giant": scene_giant, "ties": scene_ties}


@pytest.fixture(scope="module", params=sorted(SCENES))
def binned(request):
    rng = np.random.default_rng(7)
    means, scales, W, H = SCENES[request.param](rng)
    n = len(means)
    q = rng.normal(size=(n, 4))
    op = rng.uniform(0.3, 0.95, n)
    shs = np.zeros((n, 1, 3))
    arrs = [np.asarray(a, np.float32) for a in (means, scales, q, shs, op)]
    cam = jcam.look_at_camera(eye=(0, 0, 0), target=(0, 0, 5.0), width=W, height=H)
    pre = jq.preprocess(*(jnp.asarray(a) for a in arrs[:4]), 0, cam, 0.1,
                        opacities=jnp.asarray(arrs[4]))
    ntx, nty = jb.tile_grid(W, H)
    rects = jb.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty, radius_xy=pre.radius_xy)
    b = jb.bin_gaussians(pre.depth, rects, ntx, nty, capacity=1 << 15,
                         mean2d=pre.mean2d, radius=pre.radius)
    pre_np = jax.device_get(pre)
    return request.param, pre_np, jax.device_get(rects), jax.device_get(b), ntx, nty


def test_gaussian_rects_match(binned):
    _, pre, rects, _, ntx, nty = binned
    tr = tb.gaussian_rects(t(pre.mean2d), t(pre.radius), t(pre.valid), ntx, nty,
                           radius_xy=t(pre.radius_xy))
    for name in ("x0", "y0", "w", "h"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(), getattr(rects, name))


def test_bin_gaussians_exact(binned):
    name, pre, rects, b, ntx, nty = binned
    rt = tb.TileRect(*(t(getattr(rects, f)) for f in ("x0", "y0", "w", "h")))
    got = tb.bin_gaussians(t(pre.depth), rt, ntx, nty, mean2d=t(pre.mean2d), radius=t(pre.radius))
    nk = int(b.num_keys)
    assert not bool(b.overflow)
    assert int(got.num_keys) == nk and int(got.num_slots) == int(b.num_slots)
    np.testing.assert_array_equal(got.bounds.numpy(), b.bounds)
    np.testing.assert_array_equal(got.slot_to_gaussian.numpy()[:nk], b.slot_to_gaussian[:nk])
    assert got.slot_to_gaussian.shape[0] % tb.CHUNK_SIZE == 0
    assert got.slot_to_gaussian.shape[0] >= int(got.num_slots)
    assert not bool(got.overflow)

    seg = np.diff(b.bounds)
    counts = rects.w * rects.h
    if name == "many":
        assert seg.max() > tb.CHUNK_SIZE
    elif name == "giant":
        assert counts.max() == ntx * nty
    else:
        # equal depths: lower id first inside every tile it shares
        s2g = got.slot_to_gaussian.numpy()
        for big, small in ((0, 1), (10, 3), (20, 21)):
            assert pre.depth[big] == pre.depth[small]
            for tile in range(ntx * nty):
                ids = list(s2g[b.bounds[tile]:b.bounds[tile + 1]])
                if big in ids and small in ids:
                    assert ids.index(min(big, small)) < ids.index(max(big, small))


def test_class_sizes_and_grid():
    for m in (1, 32, 33, 1014, 5000):
        assert tb.class_sizes(m) == jb.class_sizes(m)
    assert tb.tile_grid(1237, 822) == jb.tile_grid(1237, 822) == (39, 26)
