"""The view preprocess of the render and the field in one call: the 3D
filter, SH colour, the quadrics (ops/quadrics.py::preprocess), the tile
rects (binning.gaussian_rects) and the blend's effective opacity.

`preprocess_view` launches kernel csrc/preprocess.cu where the tensors are
on CUDA and autograd would record nothing (grad mode off, or no input
requires grad): eval renders, the field, the viewers. It takes filtered
scales and opacities with one SH table (or none), or the model's own
leaves (`Leaves`: log-scales, opacity logits, the 3D filter and the two SH
tables), which the kernel filters and reads where they lie. Everywhere else (CPU
tensors, the training step under autograd) it runs the plain version,
`preprocess_view_reference`, which is the filters, quadrics.preprocess,
gaussian_rects and the op_eff product as the render has always called
them. The kernel follows the plain version's operation order under
-fmad=false, so its integer outputs (valid, the rects) equal the plain
version's on the same CUDA tensors and its floats agree to a few ulps (the
math library's expf/logf and the reductions' order are the only places
they can part).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
import torch

from ..model import gaussians as gm
from . import binning, cuda_lib, quadrics

PREPROCESS = cuda_lib.LaunchCounter("preprocess")
MAX_SH_COEFFS = 16  # degree 3


@dataclass
class ViewPre:
    """One view's preprocess: what binning, the payload and the blend read."""

    pre: quadrics.PreprocessOut
    rects: binning.TileRect
    op_eff: torch.Tensor  # [P] opacity * (valid ? coef : 0), coef detached


@dataclass
class Leaves:
    """A model's leaves as it stores them, for the preprocess to filter and
    read where they lie: no filtered copy, no concatenated SH table."""

    log_scales: torch.Tensor  # [P, 3] GaussianParams.scaling
    opacity_logits: torch.Tensor  # [P] GaussianParams.opacity
    filter_3d: torch.Tensor  # [P] GaussianState.filter_3d
    sh_dc: torch.Tensor  # [P, 1, 3] GaussianParams.features_dc
    sh_rest: torch.Tensor  # [P, K-1, 3] GaussianParams.features_rest

    @classmethod
    def of(cls, params, state) -> "Leaves":
        return cls(params.scaling, params.opacity, state.filter_3d, params.features_dc,
                   params.features_rest)


def preprocess_view(camera, means3d, scales, rotations, opacities, shs, sh_degree: int,
                    kernel_size: float, active_mask=None, leaves: Leaves | None = None,
                    tight_radius: bool = True) -> ViewPre:
    """The view's preprocess, on the kernel where it applies (see the module
    docstring), else the plain version.

    scales, opacities: 3D-filtered. shs: [P, K, 3] SH coefficients, or None:
      no colour table (degree 0, every coefficient 0: the field).
    leaves: the model's own leaves in place of scales, opacities and shs,
      which must then be None.
    tight_radius: cut the screen radius where alpha falls below 1/255 (the
      render); False keeps 3 sigma (the field, whose points are no pixels).
    """
    _check_forms(scales, opacities, shs, leaves)
    args = (camera, means3d, scales, rotations, opacities, shs, sh_degree, kernel_size,
            active_mask, leaves, tight_radius)
    raw = () if leaves is None else (leaves.log_scales, leaves.opacity_logits,
                                     leaves.filter_3d, leaves.sh_dc, leaves.sh_rest)
    if uses_kernel(means3d, scales, rotations, opacities, shs, *raw, camera.world_view,
                   camera.full_proj, camera.cam_center):
        return preprocess_view_cuda(*args)
    return preprocess_view_reference(*args)


def _check_forms(scales, opacities, shs, leaves) -> None:
    """Filtered values or the model's leaves, never both: a filtered scale
    read as a log-scale would be filtered twice without a trace."""
    if leaves is None:
        cuda_lib.require(scales is not None and opacities is not None,
                         "preprocess: scales and opacities are needed without leaves")
    else:
        cuda_lib.require(scales is None and opacities is None and shs is None,
                         "preprocess: with leaves, scales, opacities and shs must be None")


def uses_kernel(*tensors) -> bool:
    """The kernel runs on CUDA tensors that autograd would not record."""
    ts = [t for t in tensors if t is not None]
    if not ts[0].is_cuda:
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in ts))


def preprocess_view_reference(camera, means3d, scales, rotations, opacities, shs,
                              sh_degree: int, kernel_size: float, active_mask=None,
                              leaves: Leaves | None = None,
                              tight_radius: bool = True) -> ViewPre:
    """Plain version of the kernel (differentiable; any device)."""
    _check_forms(scales, opacities, shs, leaves)
    if leaves is not None:
        scales = gm.filtered_scaling_of(leaves.log_scales, leaves.filter_3d)
        opacities = gm.filtered_opacity_of(leaves.opacity_logits, leaves.log_scales,
                                           leaves.filter_3d)
        shs = torch.cat([leaves.sh_dc, leaves.sh_rest], dim=1)
    if shs is None:
        shs = means3d.new_zeros((means3d.shape[0], 1, 3))
    pre = quadrics.preprocess(means3d, scales, rotations, shs, sh_degree, camera, kernel_size,
                              active_mask, opacities=opacities if tight_radius else None)
    ntx, nty = binning.tile_grid(camera.width, camera.height)
    rects = binning.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty,
                                   radius_xy=pre.radius_xy)
    # The 2D-dilation compensation is detached, as in gof_tpu (its cov2D
    # backward is disabled in the reference, backward.cu:991-1007).
    coef = pre.coef.detach()
    op_eff = opacities * torch.where(pre.valid, coef, torch.zeros_like(coef))
    return ViewPre(pre=pre, rects=rects, op_eff=op_eff)


_P = ctypes.c_void_p


class _Args(ctypes.Structure):
    """csrc/preprocess.cu's Args, field for field."""

    _fields_ = [
        ("P", ctypes.c_longlong),
        ("xyz", _P), ("rot", _P), ("scale", _P), ("opac", _P), ("filter3d", _P),
        ("active", _P), ("dc", _P), ("rest", _P),
        ("sh_stride0", ctypes.c_longlong), ("sh_stride1", ctypes.c_longlong),
        ("degree", ctypes.c_int), ("tight", ctypes.c_int),
        ("wv", _P), ("fp", _P), ("campos", _P), ("tanfx", _P), ("tanfy", _P),
        ("width", ctypes.c_int), ("height", ctypes.c_int), ("ntx", ctypes.c_int),
        ("nty", ctypes.c_int), ("kernel_size", ctypes.c_float),
        ("valid", _P), ("depth", _P), ("mean2d", _P), ("conic", _P), ("coef", _P),
        ("radius", _P), ("radius_xy", _P), ("rgb", _P), ("M", _P), ("u0", _P),
        ("x0", _P), ("y0", _P), ("w", _P), ("h", _P), ("op_eff", _P),
    ]


def _check_inputs(camera, means3d, rotations, sh_degree, active_mask, values, sh) -> None:
    """What the kernel takes: f32 (active: bool) tensors of the documented
    shapes on one CUDA device, contiguous but for the SH tables, whose rows
    may lie apart (a view of a wider table) but hold their coefficients
    densely. `values`: the per-gaussian scales and opacities of the form
    called ({name: tensor}); `sh`: its SH tables, a one-table form's
    {"shs": table} (or {} for none) or the leaves' {"sh_dc", "sh_rest"}.
    Raises ValueError otherwise."""
    req = cuda_lib.require
    req(0 <= sh_degree <= 3, f"preprocess: SH degree {sh_degree} (need 0..3)")
    req(means3d.dim() == 2 and means3d.shape[1] == 3,
        f"preprocess: means3d {tuple(means3d.shape)} (need [P, 3])")
    P = means3d.shape[0]
    shapes = {"scales": (P, 3), "opacities": (P,), "log_scales": (P, 3),
              "opacity_logits": (P,), "filter_3d": (P,)}
    tensors = {"means3d": (means3d, (P, 3)), "rotations": (rotations, (P, 4)),
               **{name: (t, shapes[name]) for name, t in values.items()},
               "active_mask": (active_mask, (P,)),
               "world_view": (camera.world_view, (4, 4)), "full_proj": (camera.full_proj, (4, 4)),
               "cam_center": (camera.cam_center, (3,)), "tan_fovx": (camera.tan_fovx, ()),
               "tan_fovy": (camera.tan_fovy, ())}
    if not sh:
        req(sh_degree == 0, "preprocess: no SH table needs degree 0")
    else:
        first = next(iter(sh))
        t = sh[first]
        req(t.dim() == 3 and t.shape[0] == P and t.shape[2] == 3,
            f"preprocess: {first} {tuple(t.shape)} (need [P, K, 3])")
        rest = sh.get("sh_rest")
        k = t.shape[1] if rest is None else 1 + (rest.shape[1] if rest.dim() == 3 else -1)
        req((sh_degree + 1) ** 2 <= k <= MAX_SH_COEFFS,
            f"preprocess: {k} SH coefficients for degree {sh_degree} (need (degree+1)^2..16)")
        tensors[first] = (t, tuple(t.shape) if rest is None else (P, 1, 3))
        if rest is not None:
            tensors["sh_rest"] = (rest, (P, k - 1, 3))
    for name, (t, shape) in tensors.items():
        if t is None:
            continue
        want = torch.bool if name == "active_mask" else torch.float32
        req(t.dtype == want, f"preprocess: {name} is {t.dtype} (need {want})")
        req(tuple(t.shape) == shape, f"preprocess: {name} {tuple(t.shape)} (need {shape})")
        if name in sh:
            req(t.stride(2) == 1 and (t.shape[1] == 1 or t.stride(1) == 3)
                and 3 * t.shape[1] <= t.stride(0) <= 3 * MAX_SH_COEFFS,
                f"preprocess: {name} strides {t.stride()} (need dense rows of at most 48 floats)")
        else:
            req(t.is_contiguous(), f"preprocess: {name} is not contiguous")
    dev = means3d.device
    req(dev.type == "cuda" and all(t.device == dev for t, _ in tensors.values() if t is not None),
        "preprocess: every tensor must lie on one CUDA device")


def preprocess_view_cuda(camera, means3d, scales, rotations, opacities, shs, sh_degree: int,
                         kernel_size: float, active_mask=None, leaves: Leaves | None = None,
                         tight_radius: bool = True) -> ViewPre:
    """preprocess_view on kernel csrc/preprocess.cu (no autograd graph)."""
    _check_forms(scales, opacities, shs, leaves)
    if leaves is None:
        values = {"scales": scales, "opacities": opacities}
        sh = {} if shs is None else {"shs": shs}
        scale_in, opac_in, filter_3d = scales, opacities, None
    else:
        values = {"log_scales": leaves.log_scales, "opacity_logits": leaves.opacity_logits,
                  "filter_3d": leaves.filter_3d}
        sh = {"sh_dc": leaves.sh_dc, "sh_rest": leaves.sh_rest}
        scale_in, opac_in, filter_3d = leaves.log_scales, leaves.opacity_logits, leaves.filter_3d
    _check_inputs(camera, means3d, rotations, sh_degree, active_mask, values, sh)
    dev = means3d.device
    P = means3d.shape[0]
    f = torch.empty(26 * P, dtype=torch.float32, device=dev)
    depth, mean2d, conic, coef, radius, radius_xy, rgb, M, u0, op_eff = f.split(
        [P, 2 * P, 3 * P, P, P, 2 * P, 3 * P, 9 * P, 3 * P, P])
    rect = torch.empty((4, P), dtype=torch.int32, device=dev)
    valid = torch.empty(P, dtype=torch.bool, device=dev)
    pre = quadrics.PreprocessOut(
        valid=valid, depth=depth, mean2d=mean2d.view(P, 2), conic=conic.view(P, 3), coef=coef,
        radius=radius, radius_xy=radius_xy.view(P, 2), rgb=rgb.view(P, 3),
        v2g_M=M.view(P, 3, 3), v2g_u0=u0.view(P, 3))
    out = ViewPre(pre=pre, rects=binning.TileRect(*rect), op_eff=op_eff)
    if P == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    if leaves is not None:
        dc, rest = leaves.sh_dc.data_ptr(), leaves.sh_rest.data_ptr()
        s0, s1 = leaves.sh_dc.stride(0), leaves.sh_rest.stride(0)
    elif shs is None:
        dc = rest = None
        s0 = s1 = 0
    else:  # one table: the rest starts 3 floats into each row
        dc, rest = shs.data_ptr(), shs.data_ptr() + 3 * shs.element_size()
        s0 = s1 = shs.stride(0)
    ntx, nty = binning.tile_grid(camera.width, camera.height)
    a = _Args(
        P, means3d.data_ptr(), rotations.data_ptr(), scale_in.data_ptr(), opac_in.data_ptr(),
        ptr(filter_3d), ptr(active_mask), dc, rest, s0, s1, sh_degree, int(tight_radius),
        camera.world_view.data_ptr(), camera.full_proj.data_ptr(), camera.cam_center.data_ptr(),
        camera.tan_fovx.data_ptr(), camera.tan_fovy.data_ptr(), camera.width, camera.height,
        ntx, nty, kernel_size, valid.data_ptr(), depth.data_ptr(), mean2d.data_ptr(),
        conic.data_ptr(), coef.data_ptr(), radius.data_ptr(), radius_xy.data_ptr(),
        rgb.data_ptr(), M.data_ptr(), u0.data_ptr(), *(r.data_ptr() for r in rect),
        op_eff.data_ptr())
    rc = cuda_lib.library().gof_preprocess(dev.index, ctypes.addressof(a),
                                           cuda_lib.stream_ptr(means3d))
    cuda_lib.check(rc, "preprocess")
    PREPROCESS.launches += 1
    return out
