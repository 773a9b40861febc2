"""Gaussian model parameters and state (counterpart of gof_tpu/model/gaussians.py).

Parameters live in padded arrays with an `active` mask, as in gof_tpu, so a
model carried across with `from_numpy` keeps its slot layout, and
`init_from_points` pads the pool to gof_tpu's capacity with the same values.
Ported for training: init, the Mip 3D filter, the densification statistics,
densify_and_prune and the opacity reset.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import NamedTuple

import numpy as np
import torch

from .. import sh as sh_lib
from ..ops import knn
from ..transforms import quat_to_rot
from ..utils import trace

FRUSTUM_NEAR = 0.2
FILTER_SCALE = 0.2**0.5


@dataclass
class GaussianParams:
    """Trainable leaves, all [CAP, ...] f32."""

    xyz: torch.Tensor  # [C, 3]
    features_dc: torch.Tensor  # [C, 1, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    scaling: torch.Tensor  # [C, 3] log-scale
    rotation: torch.Tensor  # [C, 4] unnormalized quat (w,x,y,z)
    opacity: torch.Tensor  # [C] logit


@dataclass
class GaussianState:
    """Non-trainable per-Gaussian state, all [CAP, ...]."""

    active: torch.Tensor  # [C] bool
    filter_3d: torch.Tensor  # [C] mip 3D filter stddev
    max_radii2d: torch.Tensor  # [C]
    grad_accum: torch.Tensor  # [C]
    grad_abs_accum: torch.Tensor  # [C]
    denom: torch.Tensor  # [C]


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def num_active(state: GaussianState) -> torch.Tensor:
    return torch.sum(state.active)


def get_scaling(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.scaling)


def get_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity)


def get_features(params: GaussianParams) -> torch.Tensor:
    return torch.cat([params.features_dc, params.features_rest], dim=1)


def filtered_scaling(params: GaussianParams, filter_3d: torch.Tensor) -> torch.Tensor:
    """sqrt(s^2 + f^2) (gaussian_model.py:156-162)."""
    return filtered_scaling_of(params.scaling, filter_3d)


def filtered_opacity(params: GaussianParams, filter_3d: torch.Tensor) -> torch.Tensor:
    """opacity * sqrt(det(s^2) / det(s^2 + f^2)) (gaussian_model.py:183-194)."""
    return filtered_opacity_of(params.opacity, params.scaling, filter_3d)


def filtered_scaling_of(log_scaling: torch.Tensor, filter_3d: torch.Tensor) -> torch.Tensor:
    """filtered_scaling of the leaf itself."""
    s2 = torch.exp(log_scaling) ** 2
    return torch.sqrt(s2 + filter_3d[:, None] ** 2)


def filtered_opacity_of(opacity_logit: torch.Tensor, log_scaling: torch.Tensor,
                        filter_3d: torch.Tensor) -> torch.Tensor:
    """filtered_opacity of the leaves themselves."""
    s2 = torch.exp(log_scaling) ** 2
    det1 = torch.prod(s2, dim=-1)
    det2 = torch.prod(s2 + filter_3d[:, None] ** 2, dim=-1)
    trace.read_in_backward("prod_zeros", det1, det2)
    return torch.sigmoid(opacity_logit) * torch.sqrt(det1 / det2)


def from_numpy(params, state, device: torch.device | str = "cpu"):
    """Carry a model across from gof_tpu: `params` and `state` are any objects
    with gof_tpu's GaussianParams / GaussianState field names holding numpy
    arrays (e.g. `jax.device_get` of the JAX NamedTuples). Returns the port's
    (GaussianParams, GaussianState) on `device`."""

    def conv(obj, cls):
        out = {}
        for f in fields(cls):
            a = np.asarray(getattr(obj, f.name))
            a = a.astype(bool) if f.name == "active" else a.astype(np.float32)
            out[f.name] = torch.as_tensor(np.ascontiguousarray(a), device=device)
        return cls(**out)

    return conv(params, GaussianParams), conv(state, GaussianState)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_from_points(points: np.ndarray, colors: np.ndarray, sh_degree: int, capacity: int,
                     device: torch.device | str = "cpu"):
    """create_from_pcd (gaussian_model.py:317-340) into a padded pool of
    `capacity` slots, as gof_tpu: SH-DC from RGB, log sqrt(3-NN mean squared
    distance) scales, opacity 0.1; padding slots are inactive, at the origin,
    with scaling -10, identity rotation and opacity logit 0."""
    P = points.shape[0]
    if capacity < P:
        raise ValueError(f"capacity {capacity} < {P} points")
    K = sh_lib.num_sh_coeffs(sh_degree)
    dist2 = torch.clamp_min(torch.from_numpy(knn.mean_sq_dist_3nn_exact(points)), 1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def pad(x, fill=0.0):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill, dtype=torch.float32)
        out[:P] = x
        return out.to(device)

    dc = sh_lib.rgb_to_sh_dc(torch.as_tensor(np.asarray(colors, np.float32)))[:, None, :]
    rot = torch.zeros((P, 4), dtype=torch.float32)
    rot[:, 0] = 1.0
    rot = pad(rot)
    rot[P:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(torch.as_tensor(np.asarray(points, np.float32))),
        features_dc=pad(dc),
        features_rest=pad(torch.zeros((P, K - 1, 3))),
        scaling=pad(scales, fill=-10.0),
        rotation=rot,
        opacity=pad(torch.full((P,), float(inverse_sigmoid(torch.tensor(0.1))))),
    )
    z = torch.zeros((capacity,), dtype=torch.float32, device=device)
    state = GaussianState(
        active=torch.arange(capacity, device=device) < P,
        filter_3d=z + 1e-4, max_radii2d=z.clone(), grad_accum=z.clone(),
        grad_abs_accum=z.clone(), denom=z.clone(),
    )
    return params, state


# ---------------------------------------------------------------------------
# Mip-Splatting 3D filter
# ---------------------------------------------------------------------------


def compute_3d_filter(xyz: torch.Tensor, active: torch.Tensor, world_views: torch.Tensor,
                      focals_x: torch.Tensor, focals_y: torch.Tensor, widths: torch.Tensor,
                      heights: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian 3D filter stddev over all training cameras
    (compute_3D_filter, gaussian_model.py:262-311); camera arrays [N, ...]."""
    pv = torch.einsum("nij,pj->npi", world_views[:, :3, :3], xyz) + world_views[:, None, :3, 3]
    z = pv[..., 2]
    in_front = z > FRUSTUM_NEAR
    zc = torch.clamp_min(z, 0.001)
    x_pix = pv[..., 0] / zc * focals_x[:, None] + widths[:, None] / 2.0
    y_pix = pv[..., 1] / zc * focals_y[:, None] + heights[:, None] / 2.0
    in_screen = ((x_pix >= -0.15 * widths[:, None]) & (x_pix <= 1.15 * widths[:, None])
                 & (y_pix >= -0.15 * heights[:, None]) & (y_pix <= 1.15 * heights[:, None]))
    visible = in_front & in_screen  # [N, P]
    inf = torch.full_like(zc, float("inf"))
    dist = torch.amin(torch.where(visible, zc, inf), dim=0)  # [P]
    any_vis = torch.any(visible, dim=0)
    max_seen = torch.amax(torch.where(any_vis & active, dist, -inf[0]))
    max_seen = torch.where(torch.isfinite(max_seen), max_seen, torch.ones_like(max_seen))
    dist = torch.where(any_vis, dist, max_seen)
    return dist / torch.amax(focals_x) * FILTER_SCALE


# ---------------------------------------------------------------------------
# Densification statistics, densify and prune, opacity reset
# ---------------------------------------------------------------------------


def add_densification_stats(state: GaussianState, carrier_grad: torch.Tensor,
                            radii: torch.Tensor, visible: torch.Tensor) -> GaussianState:
    """Accumulate per-step stats (add_densification_stats,
    gaussian_model.py:709-714, and the max_radii2D update, train.py:253-254)."""
    gxy = torch.linalg.norm(carrier_grad[:, :2], dim=-1)
    gabs = torch.abs(carrier_grad[:, 2])
    vis = visible & state.active
    zero = torch.zeros_like(gxy)
    return GaussianState(
        active=state.active, filter_3d=state.filter_3d,
        max_radii2d=torch.where(vis, torch.maximum(state.max_radii2d, radii), state.max_radii2d),
        grad_accum=state.grad_accum + torch.where(vis, gxy, zero),
        grad_abs_accum=state.grad_abs_accum + torch.where(vis, gabs, zero),
        denom=state.denom + vis.to(torch.float32),
    )


def _masked_quantile(x: torch.Tensor, mask: torch.Tensor, q) -> torch.Tensor:
    """torch.quantile-compatible linear-interpolation quantile over mask
    (gof_tpu gaussians.py:206-217), in f32 and in gof_tpu's order: a shifted
    quantile changes which gaussians densify selects."""
    f32 = torch.float32
    xs = torch.sort(torch.where(mask, x, torch.tensor(3.4e38, dtype=f32, device=x.device))).values
    n = torch.sum(mask)
    q = torch.as_tensor(q, dtype=f32, device=x.device)
    pos = torch.clamp(q, 0.0, 1.0) * torch.clamp_min(n - 1, 0).to(f32)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo.to(f32)
    lo = torch.clamp(lo, 0, x.shape[0] - 1)
    hi = torch.clamp(hi, 0, x.shape[0] - 1)
    return xs[lo] * (1 - frac) + xs[hi] * frac


class DensifyReport(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    pool_overflow: torch.Tensor  # bool: ran out of capacity, the host should grow


class Densified(NamedTuple):
    """What densify_and_prune returns."""

    params: GaussianParams
    state: GaussianState
    moments: object  # the AdamState given, its placed rows zeroed; or None
    report: DensifyReport


def _assign_free_slots(active: torch.Tensor, want: torch.Tensor):
    """For each source i with want[i], a distinct inactive slot: the k-th
    wanting source gets the k-th free slot. Returns (target [C] int64,
    ok [C] bool); ok is False where the free slots ran out. Reads nothing to
    the host."""
    C = active.shape[0]
    dev = active.device
    free = ~active
    # free_idx[k] = the k-th free slot, C - 1 past the last (jnp.nonzero's fill)
    free_idx = torch.full((C + 1,), C - 1, dtype=torch.int64, device=dev)
    free_idx.scatter_(0, torch.where(free, torch.cumsum(free, 0) - 1, C),
                      torch.arange(C, device=dev))
    rank = torch.cumsum(want, 0) - 1
    ok = want & (rank < torch.sum(free))
    return free_idx[:C][torch.clamp(rank, 0, C - 1)], ok


def _placed_rows(targets: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Per slot, the source row that dst[targets[i]] = src[i] where ok[i]
    writes there (unique targets by construction), -1 where none does."""
    C = targets.shape[0]
    row = torch.full((C + 1,), -1, dtype=torch.int64, device=targets.device)
    row.scatter_(0, torch.where(ok, targets, C), torch.arange(C, device=targets.device))
    return row[:C]


def _scatter_rows(dst: torch.Tensor, src: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """gof_tpu's _scatter_rows (gaussians.py:243) with the slots' source rows
    from _placed_rows, as a new tensor."""
    hit = (row >= 0).view((-1,) + (1,) * (dst.dim() - 1))
    return torch.where(hit, src[torch.clamp_min(row, 0)], dst)


@torch.no_grad()
def densify_and_prune(params: GaussianParams, state: GaussianState, opt_moments, noise,
                      max_grad: float, min_opacity: float, extent, percent_dense: float,
                      use_size_prune):
    """Functional densify_and_prune (gaussian_model.py:683-707), as gof_tpu
    (gaussians.py:249-389). Returns Densified(params, state, moments,
    report), all new tensors; reads nothing to the host.

    noise: three [C, 3] f32 standard-normal tensors, the position offsets of
    the clones, the first and the second split children (gof_tpu draws them
    from its key; torch cannot reproduce that stream, ROADMAP C13).
    opt_moments: the train loop's AdamState or None. Every field of its mu
    and nu is zeroed at exactly the rows a placement wrote; count and every
    other row (pruned slots, removed split originals) are kept.

    Clones, then first children, then second children take free slots in
    that order, each seeing the slots the one before took; a full pool drops
    the excess and sets pool_overflow (ROADMAP C12). Split originals are
    removed after all placements; the prune then covers the new slots too:
    opacity below min_opacity, world size above 0.1 * extent when
    use_size_prune, and any non-finite gaussian. There is no screen-size
    prune (ROADMAP C11). The statistics reset to 0; filter_3d is left for
    the caller to recompute.
    """
    f32 = torch.float32
    active = state.active
    zero = torch.zeros_like(state.denom)
    denom = torch.clamp_min(state.denom, 1e-12)
    grads = torch.where(state.denom > 0, state.grad_accum / denom, zero)
    grads_abs = torch.where(state.denom > 0, state.grad_abs_accum / denom, zero)

    n_act = torch.clamp_min(torch.sum(active), 1)
    classic = (grads >= max_grad) & active
    ratio = torch.sum(classic) / n_act.to(f32)
    Q = _masked_quantile(grads_abs, active, 1.0 - ratio)
    selected = classic | ((grads_abs >= Q) & active)

    scaling = torch.exp(params.scaling)
    maxscale = torch.amax(scaling, dim=-1)
    clone_mask = selected & (maxscale <= percent_dense * extent)
    split_mask = selected & (maxscale > percent_dense * extent)
    R = quat_to_rot(params.rotation)

    def sampled(eps, new_scaling):
        """Sources at xyz + R (eps * s), otherwise copies (new_scaling aside)."""
        return GaussianParams(
            xyz=params.xyz + torch.einsum("pij,pj->pi", R, eps * scaling),
            features_dc=params.features_dc, features_rest=params.features_rest,
            scaling=new_scaling, rotation=params.rotation, opacity=params.opacity)

    def place(new_params, new_active, moments, src, mask):
        targets, ok = _assign_free_slots(new_active, mask)
        row = _placed_rows(targets, ok)
        p2 = GaussianParams(*[_scatter_rows(getattr(new_params, f.name), getattr(src, f.name), row)
                              for f in fields(GaussianParams)])
        hit = row >= 0
        if moments is not None:
            def zeroed(m):
                return GaussianParams(*[
                    x.masked_fill(hit.view((-1,) + (1,) * (x.dim() - 1)), 0)
                    for x in (getattr(m, f.name) for f in fields(GaussianParams))])

            moments = replace(moments, mu=zeroed(moments.mu), nu=zeroed(moments.nu))
        return p2, new_active | hit, moments, torch.sum(mask) - torch.sum(ok)

    # clones (gaussian_model.py:659-681), then N=2 split children at
    # scale / (0.8 * N) (gaussian_model.py:631-657)
    new_params, new_active, moments, drop1 = place(
        params, active, opt_moments, sampled(noise[0], params.scaling), clone_mask)
    # divided by a tensor: CUDA rounds a division by a Python number as a
    # product with its reciprocal, and the card's children then part from
    # the CPU's in the last bit (ROADMAP C16)
    split_scaling = torch.log(scaling / scaling.new_tensor(1.6))
    new_params, new_active, moments, drop2 = place(
        new_params, new_active, moments, sampled(noise[1], split_scaling), split_mask)
    new_params, new_active, moments, drop3 = place(
        new_params, new_active, moments, sampled(noise[2], split_scaling), split_mask)
    new_active = new_active & ~split_mask

    prune = torch.sigmoid(new_params.opacity) < min_opacity
    ws = torch.amax(torch.exp(new_params.scaling), dim=-1) > 0.1 * extent
    prune = torch.where(torch.as_tensor(use_size_prune, device=prune.device), prune | ws, prune)
    # NaN compares False against every threshold, so a non-finite gaussian
    # would otherwise hold its slot forever
    finite = (torch.isfinite(new_params.xyz).all(dim=-1)
              & torch.isfinite(new_params.scaling).all(dim=-1)
              & torch.isfinite(new_params.rotation).all(dim=-1)
              & torch.isfinite(new_params.opacity))
    prune = prune | ~finite
    n_before_prune = torch.sum(new_active)
    new_active = new_active & ~prune

    new_state = GaussianState(active=new_active, filter_3d=state.filter_3d,
                              max_radii2d=zero.clone(), grad_accum=zero.clone(),
                              grad_abs_accum=zero.clone(), denom=zero.clone())
    report = DensifyReport(n_cloned=torch.sum(clone_mask) - drop1, n_split=torch.sum(split_mask),
                           n_pruned=n_before_prune - torch.sum(new_active),
                           pool_overflow=(drop1 + drop2 + drop3) > 0)
    return Densified(new_params, new_state, moments, report)


def reset_opacity(params: GaussianParams, filter_3d: torch.Tensor) -> GaussianParams:
    """reset_opacity (gaussian_model.py:465-483): clamp the filtered opacity
    to <= 0.01, undo the filter compensation, store the logit."""
    op_f = filtered_opacity(params, filter_3d)
    s2 = torch.exp(params.scaling) ** 2
    coef = torch.sqrt(torch.prod(s2, dim=-1) / torch.prod(s2 + filter_3d[:, None] ** 2, dim=-1))
    new = torch.clamp_max(op_f, 0.01) / torch.clamp_min(coef, 1e-12)
    new = torch.clamp(new, 1e-6, 1.0 - 1e-6)
    return GaussianParams(xyz=params.xyz, features_dc=params.features_dc,
                          features_rest=params.features_rest, scaling=params.scaling,
                          rotation=params.rotation, opacity=inverse_sigmoid(new))
