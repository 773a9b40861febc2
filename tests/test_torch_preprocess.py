"""The view preprocess's entry (gof_tpu_torch/ops/preprocess.py) on the CPU.

Its plain version against the composition the render and the field ran
before it (the 3D filter, the SH table's concatenation, quadrics.preprocess,
the tile rects, the effective opacity), bit for bit; the rule that picks
the kernel (CUDA tensors that autograd would not record) and that the CPU
paths never launch it; the kernel wrapper's input checks. The kernel itself
is held to the plain version on the card (tests/test_torch_cuda.py). This
file imports no JAX.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gof_tpu_torch import cameras, config, render_cli, train
from gof_tpu_torch.model import gaussians as gm
from gof_tpu_torch.ops import binning, quadrics
from gof_tpu_torch.ops import preprocess as pp

W, H = 96, 64


def model(n=200, seed=7):
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 9, n)
    xyz = np.stack([rng.uniform(-1, 1, n) * z * 0.5, rng.uniform(-1, 1, n) * z * 0.3, z], -1)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    params = gm.GaussianParams(
        xyz=t(xyz), features_dc=t(rng.normal(0, 0.5, (n, 1, 3))),
        features_rest=t(rng.normal(0, 0.5, (n, 15, 3))),
        scaling=t(np.log(rng.uniform(0.05, 0.5, (n, 3)))), rotation=t(rng.normal(size=(n, 4))),
        opacity=t(np.log(1 / rng.uniform(0.1, 0.95, n) - 1) * -1))
    zero = torch.zeros(n)
    state = gm.GaussianState(active=torch.tensor(rng.random(n) > 0.2),
                             filter_3d=t(rng.uniform(1e-4, 0.05, n)), max_radii2d=zero,
                             grad_accum=zero, grad_abs_accum=zero, denom=zero)
    cam = cameras.look_at_camera(eye=(0.1, 0.05, 0.0), target=(0, 0, 5.0), width=W, height=H)
    return params, state, cam


def assert_same(got: pp.ViewPre, want: pp.ViewPre):
    for name in ("valid", "depth", "mean2d", "conic", "coef", "radius", "radius_xy", "rgb",
                 "v2g_M", "v2g_u0"):
        assert torch.equal(getattr(got.pre, name), getattr(want.pre, name)), name
    for name in ("x0", "y0", "w", "h"):
        assert torch.equal(getattr(got.rects, name), getattr(want.rects, name)), name
    assert torch.equal(got.op_eff, want.op_eff)


def composed(cam, params, state, degree, kernel_size=0.1):
    """The render's preprocess as render_eval and render ran it before the
    entry: filters, torch.cat of the SH tables, quadrics.preprocess, the
    rects, op_eff."""
    scales = gm.filtered_scaling(params, state.filter_3d)
    op = gm.filtered_opacity(params, state.filter_3d)
    shs = gm.get_features(params)
    pre = quadrics.preprocess(params.xyz, scales, params.rotation, shs, degree, cam, kernel_size,
                              state.active, opacities=op)
    ntx, nty = binning.tile_grid(cam.width, cam.height)
    rects = binning.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty,
                                   radius_xy=pre.radius_xy)
    op_eff = op * torch.where(pre.valid, pre.coef, torch.zeros_like(pre.coef))
    return pp.ViewPre(pre=pre, rects=rects, op_eff=op_eff)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_leaf_entry_equals_filters_features_and_preprocess(degree):
    """The model's leaves (the 3D filter folded in, the two SH tables)
    give what the filters, the concatenated table and quadrics.preprocess
    gave, bit for bit; so do filtered scales and opacities with one
    table."""
    params, state, cam = model()
    want = composed(cam, params, state, degree)
    got = pp.preprocess_view(cam, params.xyz, None, params.rotation, None, None, degree, 0.1,
                             state.active, leaves=pp.Leaves.of(params, state))
    assert_same(got, want)
    got = pp.preprocess_view(cam, params.xyz, gm.filtered_scaling(params, state.filter_3d),
                             params.rotation, gm.filtered_opacity(params, state.filter_3d),
                             gm.get_features(params), degree, 0.1, state.active)
    assert_same(got, want)


def test_field_form_equals_the_field_s_composition():
    """The field's call (no SH table, the radius at 3 sigma) against what
    FieldEvaluator.view_inputs composed: a zero table at degree 0, no
    opacities in quadrics.preprocess, op_eff from the filtered opacity."""
    params, state, cam = model()
    scales = gm.filtered_scaling(params, state.filter_3d)
    op = gm.filtered_opacity(params, state.filter_3d)
    pre = quadrics.preprocess(params.xyz, scales, params.rotation,
                              params.xyz.new_zeros((params.xyz.shape[0], 1, 3)), 0, cam, 0.1,
                              state.active)
    ntx, nty = binning.tile_grid(cam.width, cam.height)
    want = pp.ViewPre(pre=pre, rects=binning.gaussian_rects(pre.mean2d, pre.radius, pre.valid,
                                                            ntx, nty, radius_xy=pre.radius_xy),
                      op_eff=op * torch.where(pre.valid, pre.coef, torch.zeros_like(pre.coef)))
    got = pp.preprocess_view(cam, params.xyz, scales, params.rotation, op, None, 0, 0.1,
                             state.active, tight_radius=False)
    assert_same(got, want)


def fake(cuda, grad):
    return SimpleNamespace(is_cuda=cuda, requires_grad=grad)


@pytest.mark.parametrize("case,grad_mode,want", [
    ("cpu", True, False), ("cpu", False, False),
    ("cuda", True, True), ("cuda", False, True),
    ("cuda_requires_grad", True, False), ("cuda_requires_grad", False, True),
])
def test_kernel_rule(case, grad_mode, want):
    """The kernel runs on CUDA tensors unless autograd would record: grad
    mode on and some input requiring grad."""
    ts = {"cpu": [fake(False, False)] * 3, "cuda": [fake(True, False)] * 3,
          "cuda_requires_grad": [fake(True, False), None, fake(True, True)]}[case]
    with torch.set_grad_enabled(grad_mode):
        assert pp.uses_kernel(*ts) is want


def test_cpu_paths_never_launch_the_kernel():
    """A CPU render_eval, a CPU render under autograd and a CPU train step
    run the plain version: the launch counter stays where it was."""
    params, state, cam = model(80)
    before = pp.PREPROCESS.launches
    out = render_cli.render_eval(params, state, cam, config.ModelParams(sh_degree=3,
                                                                        kernel_size=0.1),
                                 torch.zeros(3))
    assert out.image.shape == (9, H, W)
    xyz, log_s = [t.clone().requires_grad_(True) for t in (params.xyz, params.scaling)]
    from gof_tpu_torch.ops import render
    out = render.render(cam, xyz, None, params.rotation, None, None, 3, 0.1, torch.zeros(3),
                        active_mask=state.active,
                        leaves=pp.Leaves(log_s, params.opacity, state.filter_3d,
                                         params.features_dc, params.features_rest))
    out.image.sum().backward()
    assert log_s.grad is not None and bool(log_s.grad.abs().sum() > 0)
    opt = config.OptimizationParams(distortion_from_iter=0, depth_normal_from_iter=0)
    tx = train.make_optimizer(opt, 5.0)
    tp = train.TrainParams(gauss=params)
    step = train.build_train_step(opt, config.ModelParams(sh_degree=3, kernel_size=0.1),
                                  config.PipelineParams(), tx, with_stats=False)
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(1))
    step(tp, tx.init(tp), state, gt, 20000, cam, torch.zeros(3))
    assert pp.PREPROCESS.launches == before


def check_case(case):
    """Valid CPU inputs for preprocess_view_cuda, in the leaves' form or
    (cases marked "filtered") with filtered scales and opacities and one
    table, with one thing the kernel does not take; returns the kwargs."""
    params, state, cam = model(20)
    leaves = pp.Leaves.of(params, state)
    a = dict(camera=cam, means3d=params.xyz, scales=None, rotations=params.rotation,
             opacities=None, shs=None, sh_degree=3, kernel_size=0.1, active_mask=state.active,
             leaves=leaves)
    table = gm.get_features(params)
    filtered = dict(scales=gm.filtered_scaling(params, state.filter_3d),
                    opacities=gm.filtered_opacity(params, state.filter_3d), shs=table,
                    leaves=None)

    def leaf(**kw):
        return dict(leaves=dataclasses.replace(leaves, **kw))

    edit = {
        "cpu": {},
        "means3d_dtype": dict(means3d=params.xyz.double()),
        "means3d_shape": dict(means3d=params.xyz[:, :2].contiguous()),
        "scales_shape": dict(filtered, scales=filtered["scales"][:-1]),
        "rotations_not_contiguous": dict(rotations=params.rotation.T.contiguous().T),
        "opacities_shape": dict(filtered, opacities=filtered["opacities"][:, None]),
        "opacities_missing": dict(filtered, opacities=None),
        "filter_dtype": leaf(filter_3d=state.filter_3d.double()),
        "active_dtype": dict(active_mask=state.active.float()),
        "degree_4": dict(sh_degree=4),
        "too_few_coefficients": dict(filtered, shs=table[:, :4].contiguous()),
        "too_many_coefficients": dict(filtered, shs=torch.cat([table, table[:, :1]], 1)),
        "sh_rest_shape": leaf(sh_rest=params.features_rest[:, :, :2].contiguous()),
        "sh_rest_columns_apart": leaf(sh_rest=params.features_rest.transpose(1, 2)
                                      .contiguous().transpose(1, 2)),
        "table_without_degree_0": dict(filtered, shs=None),
        "world_view_shape": dict(camera=cameras.Camera(
            cam.width, cam.height, cam.world_view[:3].contiguous(), cam.full_proj,
            cam.cam_center, cam.tan_fovx, cam.tan_fovy)),
        "tan_dtype": dict(camera=cameras.Camera(
            cam.width, cam.height, cam.world_view, cam.full_proj, cam.cam_center,
            cam.tan_fovx.double(), cam.tan_fovy)),
        "leaves_and_scales": dict(scales=filtered["scales"]),
        "leaves_and_table": dict(shs=table),
        "log_scales_not_contiguous": leaf(log_scales=params.scaling.T.contiguous().T),
        "opacity_logits_shape": leaf(opacity_logits=params.opacity[:-1]),
        "sh_dc_shape": leaf(sh_dc=params.features_dc[:, :, :2].contiguous()),
    }[case]
    a.update(edit)
    return a


@pytest.mark.parametrize("case,match", [
    ("cpu", "one CUDA device"),
    ("means3d_dtype", "means3d is torch.float64"),
    ("means3d_shape", r"means3d \(20, 2\)"),
    ("scales_shape", r"scales \(19, 3\)"),
    ("rotations_not_contiguous", "rotations is not contiguous"),
    ("opacities_shape", r"opacities \(20, 1\)"),
    ("opacities_missing", "scales and opacities are needed without leaves"),
    ("filter_dtype", "filter_3d is torch.float64"),
    ("active_dtype", "active_mask is torch.float32"),
    ("degree_4", "SH degree 4"),
    ("too_few_coefficients", "4 SH coefficients for degree 3"),
    ("too_many_coefficients", "17 SH coefficients"),
    ("sh_rest_shape", r"sh_rest \(20, 15, 2\)"),
    ("sh_rest_columns_apart", "sh_rest strides"),
    ("table_without_degree_0", "no SH table needs degree 0"),
    ("world_view_shape", r"world_view \(3, 4\)"),
    ("tan_dtype", "tan_fovx is torch.float64"),
    ("leaves_and_scales", "with leaves, scales, opacities and shs must be None"),
    ("leaves_and_table", "with leaves, scales, opacities and shs must be None"),
    ("log_scales_not_contiguous", "log_scales is not contiguous"),
    ("opacity_logits_shape", r"opacity_logits \(19,\)"),
    ("sh_dc_shape", r"sh_dc \(20, 1, 2\)"),
])
def test_kernel_wrapper_checks_inputs(case, match):
    """preprocess_view_cuda raises ValueError on what the kernel does not
    take, before it loads the library."""
    with pytest.raises(ValueError, match=match):
        pp.preprocess_view_cuda(**check_case(case))


@pytest.mark.parametrize("given", ["scales", "opacities", "shs"])
def test_render_takes_leaves_or_filtered_values_not_both(given):
    """A filtered value beside the model's leaves is refused (it would be
    filtered again, or its table ignored) on the plain path too, and so is
    a render with neither."""
    from gof_tpu_torch.ops import render

    params, state, cam = model(20)
    vals = dict(scales=gm.filtered_scaling(params, state.filter_3d),
                opacities=gm.filtered_opacity(params, state.filter_3d),
                shs=gm.get_features(params))
    kw = dict(scales=None, opacities=None, shs=None)
    kw[given] = vals[given]
    with pytest.raises(ValueError, match="with leaves"):
        render.render(cam, params.xyz, kw["scales"], params.rotation, kw["opacities"],
                      kw["shs"], 3, 0.1, torch.zeros(3), active_mask=state.active,
                      leaves=pp.Leaves.of(params, state))
    kw = dict(vals)
    kw[given] = None
    if given != "shs":  # no table is the field's form; no scales or opacities is none
        with pytest.raises(ValueError, match="needed without leaves"):
            pp.preprocess_view_reference(cam, params.xyz, kw["scales"], params.rotation,
                                         kw["opacities"], kw["shs"], 3, 0.1, state.active)
