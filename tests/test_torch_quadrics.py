"""gof_tpu_torch.ops.quadrics.preprocess against gof_tpu, field by field.

`valid` matches exactly; float fields within atol 1e-5, rtol 1e-5. `radius`
and `radius_xy` are ceil'ed floats and must match exactly, except where the
port's un-ceiled value (quadrics.screen_extent) lies within 1e-5 (relative)
of an integer: there the two packages' last-bit differences may round to
neighbouring integers, so a difference of exactly 1 is accepted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import cameras as jcam
from gof_tpu.ops import quadrics as jq
from gof_tpu_torch import cameras as tcam
from gof_tpu_torch.ops import quadrics as tq

torch.set_num_threads(2)

FIELDS = ("depth", "mean2d", "conic", "coef", "rgb", "v2g_M", "v2g_u0")


def make_inputs(rng, n, degree, near=False):
    z = rng.uniform(0.1 if near else 2.0, 9.0, n)
    x = rng.uniform(-1, 1, n) * z * 0.5
    y = rng.uniform(-1, 1, n) * z * 0.4
    means = np.stack([x, y, z], -1).astype(np.float32)
    scales = np.exp(rng.normal(-1.5, 0.8, (n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    shs = (rng.normal(size=(n, (degree + 1) ** 2, 3)) * 0.4).astype(np.float32)
    op = rng.uniform(0.02, 0.99, n).astype(np.float32)
    active = rng.uniform(size=n) > 0.1
    return means, scales, q, shs, op, active


CASES = {
    "deg0": dict(n=200, degree=0, opacities=False, mask=False),
    "deg3_opacity_mask": dict(n=300, degree=3, opacities=True, mask=True),
    "near_plane": dict(n=300, degree=2, opacities=True, mask=False, near=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_matches(rng, case):
    c = CASES[case]
    means, scales, q, shs, op, active = make_inputs(rng, c["n"], c["degree"], c.get("near", False))
    kw = dict(eye=(0.2, 0.1, -0.3), target=(0, 0, 5.0), width=160, height=96)
    cj, ct = jcam.look_at_camera(**kw), tcam.look_at_camera(**kw)
    oj = jq.preprocess(*(jnp.asarray(a) for a in (means, scales, q, shs)), c["degree"], cj, 0.1,
                       jnp.asarray(active) if c["mask"] else None,
                       opacities=jnp.asarray(op) if c["opacities"] else None)
    t = [torch.from_numpy(a) for a in (means, scales, q, shs)]
    ot = tq.preprocess(*t, c["degree"], ct, 0.1,
                       torch.from_numpy(active) if c["mask"] else None,
                       opacities=torch.from_numpy(op) if c["opacities"] else None)

    np.testing.assert_array_equal(np.asarray(oj.valid), ot.valid.numpy())
    v = ot.valid.numpy()
    assert v.sum() > 0.5 * c["n"] * (0.8 if c["mask"] else 1.0) or case == "near_plane"
    for name in FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(oj, name))[v], getattr(ot, name).numpy()[v],
                                   atol=1e-5, rtol=1e-5, err_msg=name)

    # radius fields: exact off ceil boundaries
    cov3d = tq.cov3d_from_scaling_rotation(t[1], t[2])
    cov2d, coef = tq.cov2d_ewa(t[0], cov3d, ct.world_view, ct.focal_x, ct.focal_y,
                               ct.tan_fovx, ct.tan_fovy, 0.1)
    raw, raw_xy = tq.screen_extent(cov2d, coef, torch.from_numpy(op) if c["opacities"] else None)
    for name, pre_ceil in (("radius", raw.numpy()), ("radius_xy", raw_xy.numpy())):
        rj, rt = np.asarray(getattr(oj, name)), getattr(ot, name).numpy()
        np.testing.assert_array_equal(rt, np.ceil(pre_ceil))
        on_edge = np.abs(pre_ceil - np.round(pre_ceil)) <= 1e-5 * np.maximum(1.0, pre_ceil)
        diff = np.abs(rj - rt)
        assert np.all((diff == 0) | (on_edge & (diff == 1))), name
        assert diff.sum() <= 2, name


def test_view_to_gaussian_and_cov3d(rng):
    means, scales, q, _, _, _ = make_inputs(rng, 64, 0)
    wv = jcam.look_at_camera(eye=(0, 0, 0), target=(0, 0, 5.0)).world_view
    vj = jq.view_to_gaussian(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(q), wv)
    vt = tq.view_to_gaussian(torch.from_numpy(means), torch.from_numpy(scales),
                             torch.from_numpy(q), torch.from_numpy(np.array(wv)))
    np.testing.assert_allclose(np.asarray(vj.M), vt.M.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(vj.u0), vt.u0.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(jq.cov3d_from_scaling_rotation(jnp.asarray(scales), jnp.asarray(q))),
        tq.cov3d_from_scaling_rotation(torch.from_numpy(scales), torch.from_numpy(q)).numpy(),
        atol=1e-6, rtol=1e-5)
