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
