"""The forward blend's plain version against gof_tpu's Pallas `_fwd_kernel`.

Both run on the same payload and binning (built by gof_tpu, then copied).
The JAX side runs the Pallas kernel in interpret mode, as gof_tpu's own
tests do. Channels 0-8, CH_TFINAL and CH_DFINAL agree within atol 1e-5,
rtol 1e-4 (the repo's Pallas-vs-XLA tolerance, tests/test_rasterize.py:84;
the two sum and multiply in different orders). CH_MEDIDX, CH_LIVEC and
CH_CSTART, the conventions the backward relies on, must match exactly.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import cameras as jcam
from gof_tpu.ops import binning as jb
from gof_tpu.ops import quadrics as jq
from gof_tpu.ops import rasterize_pallas as rp
from gof_tpu.sh import rgb_to_sh_dc
from gof_tpu_torch.ops import binning as tb
from gof_tpu_torch.ops import rasterize as tr
from gof_tpu_torch.ops import windows as tw
from test_torch_cuda import synthetic_tiles

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
TOL_CHANNELS = list(range(9)) + [tr.CH_TFINAL, tr.CH_DFINAL]
EXACT_CHANNELS = [tr.CH_MEDIDX, tr.CH_LIVEC, tr.CH_CSTART]


def gaussians(rng, n, z_span, scale_span, op_span, spread=0.2):
    z = rng.uniform(*z_span, n)
    means = np.stack([rng.uniform(-1, 1, n) * z * spread, rng.uniform(-1, 1, n) * z * spread, z], -1)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rgb = rng.uniform(0, 1, (n, 3))
    return (np.asarray(means, np.float32), rng.uniform(*scale_span, (n, 3)).astype(np.float32),
            q.astype(np.float32), rng.uniform(*op_span, n).astype(np.float32), rgb.astype(np.float32))


SCENES = {
    # (n, width, height, z, scales, opacities)
    "small_96x64": (24, 96, 64, (4, 7), (0.3, 1.0), (0.3, 0.9)),
    "multi_chunk_64x32": (300, 64, 32, (4, 7), (0.3, 1.0), (0.3, 0.9)),
    # opaque wide gaussians: every pixel saturates within the first windows
    "opaque_stack": (700, 64, 32, (4, 8), (1.5, 2.5), (0.97, 0.99)),
}


def jax_inputs(name):
    n, W, H, zs, ss, os_ = SCENES[name]
    rng = np.random.default_rng(11)
    means, scales, q, op, rgb = gaussians(rng, n, zs, ss, os_)
    cam = jcam.look_at_camera(eye=(0, 0, 0), target=(0, 0, 5.0), width=W, height=H)
    shs = rgb_to_sh_dc(jnp.asarray(rgb))[:, None, :]
    pre = jq.preprocess(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(q), shs, 0, cam, 0.1,
                        opacities=jnp.asarray(op))
    ntx, nty = jb.tile_grid(W, H)
    rects = jb.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty, radius_xy=pre.radius_xy)
    b = jb.bin_gaussians(pre.depth, rects, ntx, nty, capacity=8192,
                         mean2d=pre.mean2d, radius=pre.radius)
    op_eff = jnp.asarray(op) * jnp.where(pre.valid, pre.coef, 0.0)
    payload = rp.build_payload16(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b)
    bg = jnp.array([0.15, 0.1, 0.2])
    meta = rp._meta_vec(cam.focal_x, cam.focal_y, bg, W, H)
    return payload, b, meta, ntx, ntx * nty


def to_torch(payload, b, meta, ntx, ntiles):
    b_np = jax.device_get(b)
    tb_ = tb.Binning(slot_to_gaussian=torch.from_numpy(np.array(b_np.slot_to_gaussian)),
                     bounds=torch.from_numpy(np.array(b_np.bounds)),
                     num_keys=torch.tensor(int(b_np.num_keys)), overflow=torch.tensor(False),
                     num_slots=torch.tensor(int(b_np.num_slots)))
    return (torch.from_numpy(np.array(payload)), tb_, torch.from_numpy(np.array(meta)),
            ntx, ntiles)


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    payload, b, meta, ntx, ntiles = jax_inputs(request.param)
    out = rp.rasterize_fwd_pallas(payload, b, meta, ntx, ntiles, interpret=True, with_reg=True)
    return request.param, to_torch(payload, b, meta, ntx, ntiles), np.asarray(out)


def check(got, want):
    np.testing.assert_allclose(got[:, TOL_CHANNELS], want[:, TOL_CHANNELS], atol=ATOL, rtol=RTOL)
    for ch in EXACT_CHANNELS:
        np.testing.assert_array_equal(got[:, ch], want[:, ch], err_msg=f"channel {ch}")


def test_forward_matches_pallas(scene):
    name, inputs, want = scene
    got = tr.rasterize_fwd(*inputs).numpy()
    assert got.shape == want.shape == (inputs[4], tr.OUT_CH, tr.NPIX)
    check(got, want)
    bounds = inputs[1].bounds.numpy()
    nc = np.where(bounds[1:] > bounds[:-1],
                  (bounds[1:] - (bounds[:-1] // 128) * 128 + 127) // 128, 0)
    livec = got[:, tr.CH_LIVEC, 0]
    # median indices count from the aligned window base, not the segment
    head = bounds[:-1] % 128
    med = got[:, tr.CH_MEDIDX]
    assert ((med < 0) | (med >= head[:, None])).all()
    if name == "multi_chunk_64x32":
        assert nc.max() > 1 and livec.max() > 1 and head.max() > 0
    if name == "opaque_stack":
        # the early exit cut every tile short of its windows
        assert (livec < nc).all() and got[:, tr.CH_TFINAL].max() < 1e-4


@pytest.fixture(scope="module")
def multi():
    """The multi-window scene's JAX inputs and their torch copies."""
    payload, b, meta, ntx, ntiles = jax_inputs("multi_chunk_64x32")
    return to_torch(payload, b, meta, ntx, ntiles), (payload, b, meta)


def test_forward_without_reg_channels(multi):
    inputs, (payload, b, meta) = multi
    want = np.asarray(rp.rasterize_fwd_pallas(payload, b, meta, inputs[3], inputs[4],
                                              interpret=True, with_reg=False))
    got = tr.rasterize_fwd(*inputs, with_reg=False).numpy()
    check(got, want)
    assert (got[:, 3:7] == 0).all() and (got[:, tr.CH_MEDIDX] == -1).all()


def test_nonfinite_row_stays_in_its_tile(multi):
    """A NaN payload row is masked by select, not by multiplying with zero:
    a tile whose first window reads it (but whose segment excludes it)
    stays finite and unchanged. gof_tpu's kernel multiplies it by zero
    instead (rasterize_pallas.py:415) and poisons that tile."""
    (payload, b, meta, ntx, ntiles), _ = multi
    bounds = b.bounds.numpy()
    t = 1  # second tile: its segment starts mid-window, after tile 0's rows
    assert bounds[t] % 128 and bounds[t + 1] > bounds[t] > bounds[t - 1]
    bad = payload.clone()
    bad[:, bounds[t] - 1] = float("nan")
    got = tr.rasterize_fwd(bad, b, meta, ntx, ntiles).numpy()
    assert np.isfinite(got[t]).all()
    np.testing.assert_array_equal(got[t], tr.rasterize_fwd(payload, b, meta, ntx, ntiles).numpy()[t])


def test_wrapper_refuses_non_cuda_devices(multi):
    """Only CPU tensors take the plain version; other devices are refused."""
    (payload, b, meta, ntx, ntiles), _ = multi
    before = tr.FWD.launches
    tr.rasterize_fwd(payload, b, meta, ntx, ntiles)
    assert tr.FWD.launches == before
    mb = tb.Binning(slot_to_gaussian=b.slot_to_gaussian.to("meta"), bounds=b.bounds.to("meta"),
                    num_keys=b.num_keys, overflow=b.overflow, num_slots=b.num_slots)
    with pytest.raises(ValueError):
        tr.rasterize_fwd(payload.to("meta"), mb, meta.to("meta"), ntx, ntiles)


def test_window_counts_are_the_windows_walked(scene):
    """Where no tile exits early, each tile walks window_counts(bounds)
    windows (gof_tpu's CH_LIVEC); the early exit only ever cuts it short."""
    _, inputs, want = scene
    bounds = inputs[1].bounds
    nc = tw.window_counts(bounds[:-1], bounds[1:]).numpy()
    livec = want[:, tr.CH_LIVEC, 0]
    assert (livec <= nc).all()
    walked = want[:, tr.CH_TFINAL].max(axis=1) >= 1e-4
    np.testing.assert_array_equal(livec[walked], nc[walked])


@pytest.mark.parametrize("with_reg", [True, False])
def test_forward_matches_pallas_on_synthetic_tiles(with_reg):
    """Hand-made tiles (test_torch_cuda.synthetic_tiles): empty ones, one
    seventeen windows long, one whose every pixel saturates mid-window, on
    segments that start off the window grid."""
    payload, b, meta, ntx, ntiles = synthetic_tiles("cpu", segs=(0, 1200, 37, 700, 300, 5))
    want = np.asarray(rp.rasterize_fwd_pallas(
        jnp.asarray(payload.numpy()), SimpleNamespace(bounds=jnp.asarray(b.bounds.numpy())),
        jnp.asarray(meta.numpy()), ntx, ntiles, interpret=True, with_reg=with_reg))
    got = tr.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=with_reg).numpy()
    check(got, want)
    livec, nc = got[:, tr.CH_LIVEC, 0], tw.window_counts(b.bounds[:-1], b.bounds[1:]).numpy()
    assert livec[0] == nc[0] == 0 and livec[1] == nc[1] >= 10
    assert livec[3] == 2 < nc[3] and got[3, tr.CH_TFINAL].max() < 1e-4


@pytest.mark.parametrize("seed", [1, 3])
def test_window_counts_match_the_aligned_windows(seed):
    """window_counts against a plain loop: empty segments, one segment of
    300k rows, starts off the window grid."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([[0, 300_000, 1], rng.integers(0, 2000, 200)])
    ends = np.cumsum(lens) + 33
    seg_s = torch.tensor(ends - lens, dtype=torch.int32)
    seg_e = torch.tensor(ends, dtype=torch.int32)
    nc = [(e - s // 128 * 128 + 127) // 128 if e > s else 0 for s, e in zip(ends - lens, ends)]
    np.testing.assert_array_equal(tw.window_counts(seg_s, seg_e).numpy(), nc)
