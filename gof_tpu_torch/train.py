"""Training loop (python -m gof_tpu_torch.train -s <data> -m <out>;
counterpart of gof_tpu/train.py).

One optimization step is render -> losses -> backward -> Adam ->
densification statistics (`build_train_step`, gof_tpu's `step_body`), run
eagerly, one step per iteration; the CUDA kernels carry the render's forward
and backward on CUDA tensors, their plain versions on CPU tensors (`--cpu`).
The host loop (`training`) keeps gof_tpu's seeds, camera order (a shuffled
stack plus the 30% high-resolution oversampling), phase flips of the
statistics and regularizer channels, SH warm-up, opacity-reset cadence,
3D-filter refresh, `train_log.jsonl` records, eval and PLY snapshots.

Loss (gof_tpu train.py:355-383):
  rgb:        (1 - lambda_dssim) * L1 + lambda_dssim * (1 - SSIM); with
              --use_decoupled_appearance the L1 is appearance_l1's, on the
              render times the appearance network's multiplier for the
              camera's embedding row (model/appearance.py)
  distortion: mean of channel 8, weight lambda_distortion from
              distortion_from_iter
  normal:     mean of 1 - dot(rendered normal in world, normal from depth),
              weight lambda_depth_normal from depth_normal_from_iter

Densification (gof_tpu train.py:921-936): every densification_interval
steps past densify_from_iter and before densify_until_iter, densify_and_prune with
three noise draws from one torch.Generator seeded 0 (gof_tpu's PRNGKey(0),
also re-seeded on resume), one host read of pool_overflow, which doubles the
pool (grow_capacity), then the 3D filter is recomputed. Checkpoints
(chkpnt{iter}.pkl, plain dicts of numpy arrays; load_checkpoint also reads
gof_tpu's), --start_checkpoint, --debug's fail-time npz dump,
--debug_image_interval grids (utils/vis.py), --profile_dir (a torch.profiler
trace of the first PROFILE_STEPS iterations, with the program's spans) and
the TensorBoard scalars follow gof_tpu.

Temporal liveness culling (gof_tpu train.py:833-850): from the first step
past densify_until_iter on the pallas backend, each training camera's row
of a device-resident cache bounds the keys each tile walks (its previous
visit's walked chunks plus a margin); a step whose bound proved stale
skips its update and grows the row (`build_train_step`).

Camera-batch data parallelism (--dp N, gof_tpu train.py:224-287,
603-615): N ranks, one process each over torch.distributed
(parallel/sharding.py), each rendering its own view of every optimizer
step; the gradients are averaged over the ranks and every replica takes the
same Adam step. There are no capacity re-jits or overflow gates: the port
sizes its render buffers from each view's demand.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import random
import time
import warnings
from collections import namedtuple
from dataclasses import dataclass, fields, replace
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cameras as cameras_lib
from . import config as config_lib
from .data import scene as scene_lib
from .model import appearance as app_lib
from .model import gaussians as gm
from .ops import binning as binning_lib
from .ops import render as render_lib
from .ops.blend import pixel_rays
from .utils import hostio, losses, schedules, trace

GAUSS_FIELDS = tuple(f.name for f in fields(gm.GaussianParams))
STATE_FIELDS = tuple(f.name for f in fields(gm.GaussianState))
PROFILE_STEPS = 20  # iterations --profile_dir traces

# gof_tpu's optimizer state on the host: count and the [NCOL, CAP] moment
# buffers whose row blocks follow GaussianParams' field order (each leaf
# flattened per slot); mu_app / nu_app hold the appearance network's moments
FusedAdamState = namedtuple("FusedAdamState", "count mu_flat nu_flat mu_app nu_app",
                            defaults=(None, None))


@dataclass
class TrainParams:
    """Trainable state: the gaussians and, with the decoupled appearance
    network, the network and its [2048, 64] per-view embeddings (None
    without: a run without --use_decoupled_appearance builds no network)."""

    gauss: gm.GaussianParams
    app_net: app_lib.AppearanceNetwork | None = None
    app_emb: torch.Tensor | None = None


def app_leaves(tp: TrainParams) -> dict:
    """The appearance parameters by name ("net.<parameter>", then "emb");
    empty without the network."""
    if tp.app_net is None:
        return {}
    return {**{f"net.{n}": p for n, p in tp.app_net.named_parameters()}, "emb": tp.app_emb}


@dataclass
class AdamState:
    """Adam moments per gaussian field, shaped like the field (gof_tpu keeps
    them as lanes-major [59, CAP] buffers, a TPU layout choice), and per
    appearance leaf, keyed as app_leaves (None without the network)."""

    count: int
    mu: gm.GaussianParams
    nu: gm.GaussianParams
    mu_app: dict | None = None
    nu_app: dict | None = None


class Adam:
    """Per-group Adam of training_setup (gaussian_model.py:342-364), with
    gof_tpu's arithmetic (train.py:139-150): b1 0.9, b2 0.999, eps 1e-15,
    the position lr on gof_tpu's exponential schedule scaled by the scene
    extent and evaluated at the update count, fixed lrs for the other
    groups (features_rest at feature_lr / 20); the appearance leaves per
    leaf at appearance_network_lr and appearance_embeddings_lr, with the
    same count and bias corrections (train.py:165-180)."""

    b1, b2, eps = 0.9, 0.999, 1e-15

    def __init__(self, opt: config_lib.OptimizationParams, spatial_lr_scale: float):
        self.opt = opt
        self.spatial_lr_scale = spatial_lr_scale

    def xyz_lr(self, step) -> torch.Tensor:
        o = self.opt
        return schedules.expon_lr(step, o.position_lr_init * self.spatial_lr_scale,
                                  o.position_lr_final * self.spatial_lr_scale,
                                  o.position_lr_max_steps, lr_delay_mult=o.position_lr_delay_mult,
                                  lr_delay_steps=0)

    def group_lrs(self, count: int) -> dict:
        o = self.opt
        return {"xyz": self.xyz_lr(count), "features_dc": o.feature_lr,
                "features_rest": o.feature_lr / 20.0, "scaling": o.scaling_lr,
                "rotation": o.rotation_lr, "opacity": o.opacity_lr}

    def init(self, tp: TrainParams) -> AdamState:
        def zeros():
            return gm.GaussianParams(*[torch.zeros_like(getattr(tp.gauss, f).detach())
                                       for f in GAUSS_FIELDS])

        mu_app, nu_app = zero_app_moments(tp)
        return AdamState(count=0, mu=zeros(), nu=zeros(), mu_app=mu_app, nu_app=nu_app)

    def _leaf(self, g, m, v, lr, bc1, bc2):
        m2 = self.b1 * m + (1.0 - self.b1) * g
        v2 = self.b2 * v + (1.0 - self.b2) * g * g
        return (-lr) * (m2 / bc1) / (torch.sqrt(v2 / bc2) + self.eps), m2, v2

    def _bias_corrections(self, count: int, dev):
        with trace.copy("adam_count"):
            cf = torch.tensor(float(count), dtype=torch.float32, device=dev)
        return 1.0 - torch.pow(self.b1, cf), 1.0 - torch.pow(self.b2, cf)

    def update(self, grads: gm.GaussianParams, state: AdamState):
        """Returns (updates, new state); updates are added to the params.
        The appearance moments pass through unchanged (update_app)."""
        dev = grads.xyz.device
        count_inc = state.count + 1
        bc1, bc2 = self._bias_corrections(count_inc, dev)
        lrs = self.group_lrs(state.count)
        with trace.copy("adam_lr"):
            lrs = {f: torch.as_tensor(lrs[f], dtype=torch.float32).to(dev) for f in GAUSS_FIELDS}
        upd, mu, nu = {}, {}, {}
        for f in GAUSS_FIELDS:
            upd[f], mu[f], nu[f] = self._leaf(getattr(grads, f), getattr(state.mu, f),
                                              getattr(state.nu, f), lrs[f], bc1, bc2)
        return (gm.GaussianParams(**upd),
                replace(state, count=count_inc, mu=gm.GaussianParams(**mu),
                        nu=gm.GaussianParams(**nu)))

    def update_app(self, grads: dict, state: AdamState):
        """The appearance leaves' step, keyed as app_leaves; called after
        update() of the same step, whose count (state.count) gives the bias
        corrections, as gof_tpu's one update does. Returns (updates, new
        state)."""
        dev = grads["emb"].device
        bc1, bc2 = self._bias_corrections(state.count, dev)
        with trace.copy("adam_lr"):
            lr_net = torch.tensor(self.opt.appearance_network_lr, dtype=torch.float32,
                                  device=dev)
            lr_emb = torch.tensor(self.opt.appearance_embeddings_lr, dtype=torch.float32,
                                  device=dev)
        upd, mu, nu = {}, {}, {}
        for k, g in grads.items():
            upd[k], mu[k], nu[k] = self._leaf(g, state.mu_app[k], state.nu_app[k],
                                              lr_emb if k == "emb" else lr_net, bc1, bc2)
        return upd, replace(state, mu_app=mu, nu_app=nu)


def make_optimizer(opt: config_lib.OptimizationParams, spatial_lr_scale: float) -> Adam:
    return Adam(opt, spatial_lr_scale)


def zero_app_moments(tp: TrainParams):
    """(mu_app, nu_app) zeros for tp's appearance leaves, or (None, None)."""
    if tp.app_net is None:
        return None, None
    return tuple({k: torch.zeros_like(p.detach()) for k, p in app_leaves(tp).items()}
                 for _ in range(2))


def init_appearance(tp: TrainParams, opt_state: AdamState, device) -> tuple:
    """Give tp the appearance network and embeddings gof_tpu's loop starts
    from (train.py:629-631), drawn from a CPU generator seeded 0, with zero
    moments. Returns (tp, opt_state)."""
    net, emb = app_lib.init_appearance(torch.Generator().manual_seed(0), device)
    tp = replace(tp, app_net=net, app_emb=emb)
    mu_app, nu_app = zero_app_moments(tp)
    return tp, replace(opt_state, mu_app=mu_app, nu_app=nu_app)


def from_numpy(opt_state, like: gm.GaussianParams, device: torch.device | str = "cpu") -> AdamState:
    """Carry gof_tpu's optimizer state across: `opt_state` has the fields of
    its FusedAdamState (count, and mu_flat / nu_flat as [NCOL, CAP] numpy
    arrays whose row blocks follow GaussianParams' field order, each leaf
    flattened per slot); `like` gives the port's field shapes."""
    cols = [int(np.prod(getattr(like, f).shape[1:])) for f in GAUSS_FIELDS]
    edges = np.cumsum([0] + cols)

    def split(flat):
        flat = np.asarray(flat, np.float32)
        return gm.GaussianParams(*[
            torch.tensor(flat[a:b].T.reshape(getattr(like, f).shape), device=device)
            for f, a, b in zip(GAUSS_FIELDS, edges[:-1], edges[1:])])

    return AdamState(count=int(np.asarray(opt_state.count)), mu=split(opt_state.mu_flat),
                     nu=split(opt_state.nu_flat),
                     mu_app=app_moments_from_numpy(opt_state.mu_app, device),
                     nu_app=app_moments_from_numpy(opt_state.nu_app, device))


def app_moments_from_numpy(moments, device: torch.device | str = "cpu"):
    """gof_tpu's appearance moments, (flax tree, embeddings' moment), ->
    a dict keyed as app_leaves; None stays None."""
    if moments is None:
        return None
    net, emb = moments
    out = {f"net.{k}": v.to(device) for k, v in app_lib.net_state_from_flax(net).items()}
    out["emb"] = torch.tensor(np.asarray(emb, np.float32), device=device)
    return out


def app_moments_to_numpy(moments: dict | None):
    """The inverse of app_moments_from_numpy."""
    if moments is None:
        return None
    net = app_lib.net_state_to_flax({k[4:]: v for k, v in moments.items() if k != "emb"})
    return net, moments["emb"].detach().cpu().numpy()


def adam_to_numpy(state: AdamState) -> FusedAdamState:
    """The inverse of from_numpy: count and the moments in gof_tpu's
    [NCOL, CAP] layout, and the appearance moments in its trees, as numpy
    arrays."""
    def flat(g: gm.GaussianParams) -> np.ndarray:
        cap = g.xyz.shape[0]
        return np.concatenate([getattr(g, f).detach().cpu().numpy().reshape(cap, -1).T
                               for f in GAUSS_FIELDS], axis=0)

    return FusedAdamState(count=int(state.count), mu_flat=flat(state.mu), nu_flat=flat(state.nu),
                          mu_app=app_moments_to_numpy(state.mu_app),
                          nu_app=app_moments_to_numpy(state.nu_app))


def as_float64(tp: TrainParams, opt_state: AdamState, gstate: gm.GaussianState,
               camera: cameras_lib.Camera):
    """Float64 copies of a step's gaussian state and camera, for the plain
    CPU path in float64: the witness that a float32 step (on the CPU or the
    card) is held against where the step test's bounds do not apply
    (ROADMAP C29, C30). The appearance network is not carried."""
    def dbl(g):
        return gm.GaussianParams(*[getattr(g, f).detach().double() for f in GAUSS_FIELDS])

    gstate = gm.GaussianState(*[x.double() if x.is_floating_point() else x
                                for x in (getattr(gstate, f) for f in STATE_FIELDS)])
    camera = replace(camera, **{f: getattr(camera, f).double()
                                for f in cameras_lib.TENSOR_FIELDS})
    return (TrainParams(gauss=dbl(tp.gauss)),
            AdamState(count=opt_state.count, mu=dbl(opt_state.mu), nu=dbl(opt_state.nu)),
            gstate, camera)


@torch.no_grad()
def grow_capacity(tp: TrainParams, gstate: gm.GaussianState, opt_state: AdamState,
                  old_cap: int, new_cap: int):
    """Pool growth after an overflowing densify step (gof_tpu
    train.py:569-596): every per-slot tensor (params, GaussianState and the
    moments) padded from old_cap to new_cap slots with zeros, except
    rotation[:, 0] = 1 in the new slots, as gof_tpu pads (init_from_points
    pads scaling with -10 instead). Adam's count and the appearance state
    are unchanged. Returns new (tp, gstate, opt_state)."""
    def pad(x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros((new_cap,) + tuple(x.shape[1:]))
        out[:old_cap] = x.detach()
        return out

    def pad_all(g: gm.GaussianParams) -> gm.GaussianParams:
        return gm.GaussianParams(*[pad(getattr(g, f)) for f in GAUSS_FIELDS])

    gauss = pad_all(tp.gauss)
    gauss.rotation[old_cap:, 0] = 1.0
    gstate = gm.GaussianState(*[pad(getattr(gstate, f)) for f in STATE_FIELDS])
    opt_state = replace(opt_state, mu=pad_all(opt_state.mu), nu=pad_all(opt_state.nu))
    return replace(tp, gauss=gauss), gstate, opt_state


def pool_capacity(n_points: int) -> int:
    """gof_tpu's pool size for an n-point init (train.py:625): the power of
    two at or above 2n, at least 1024."""
    return 1 << max(int(np.ceil(np.log2(max(n_points * 2, 1024)))), 10)


def depth_to_normal(camera: cameras_lib.Camera, depth: torch.Tensor) -> torch.Tensor:
    """World-space normals from the median-depth map by central differences
    (utils/depth_utils.py:6-35). Returns [3, H, W] with a zero border."""
    H, W = camera.height, camera.width
    rx, ry = pixel_rays(W, H, camera.focal_x, camera.focal_y)
    dirs_view = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1).to(depth.dtype)  # [H, W, 3]
    R_c2w = camera.world_view[:3, :3].T
    rays_world = dirs_view @ R_c2w.T
    points = depth[..., None] * rays_world + camera.cam_center  # [H, W, 3]
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    # rsqrt(sum + eps): background pixels give zero normals
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    return F.pad(n, (0, 0, 1, 1, 1, 1)).permute(2, 0, 1)


def masked_shs(params: gm.GaussianParams, active_degree: int, max_degree: int) -> torch.Tensor:
    """Zero the SH coefficients beyond the warm-up degree (oneupSHdegree,
    train.py:131-132)."""
    shs = gm.get_features(params)
    keep = torch.arange(shs.shape[1], device=shs.device) < (active_degree + 1) ** 2
    return shs * keep[None, :, None]


def train_loss(image: torch.Tensor, gt: torch.Tensor, camera: cameras_lib.Camera,
               opt: config_lib.OptimizationParams, step: int, with_reg: bool, app=None):
    """The step's loss from the rendered [9, H, W] image (train.py:355-383).
    Returns (loss, l1, ssim, distortion, depth_normal); without with_reg the
    regularizer channels are not rendered and their terms are zero. `app`,
    (network, embeddings) or None, selects appearance_l1 at the camera's
    uid for the L1."""
    rgb = image[:3]
    if app is None:
        l1 = losses.l1_loss(rgb, gt)
    else:
        l1 = app_lib.appearance_l1(rgb, gt, *app, camera.uid)
    ssim_val = losses.ssim(rgb, gt)
    loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1.0 - ssim_val)
    zero = torch.zeros((), device=image.device)
    if not with_reg:
        return loss, l1, ssim_val, zero, zero
    distortion = torch.mean(image[8])
    d2n = depth_to_normal(camera, image[6])
    rn = image[3:6]
    rn = rn * torch.rsqrt(torch.sum(rn * rn, dim=0, keepdim=True) + 1e-12)
    rn_world = torch.einsum("ij,jhw->ihw", camera.world_view[:3, :3].T, rn)
    depth_normal = torch.mean(1.0 - torch.sum(rn_world * d2n, dim=0))
    lam_dist = opt.lambda_distortion if step >= opt.distortion_from_iter else 0.0
    lam_dn = opt.lambda_depth_normal if step >= opt.depth_normal_from_iter else 0.0
    loss = loss + lam_dist * distortion + lam_dn * depth_normal
    return loss, l1, ssim_val, distortion, depth_normal


class ViewGrad(NamedTuple):
    """One view's render, loss terms and gradients (view_grad)."""

    out: render_lib.RenderOut
    terms: torch.Tensor  # [6]: loss, l1, ssim, distortion, depth_normal, psnr (detached)
    grads: list | None  # per GAUSS_FIELDS; None when live_inv
    app_grads: dict  # per stepped appearance leaf (app_leaves' keys)
    carrier_grad: torch.Tensor | None
    live_inv: bool


def view_grad(tp: TrainParams, gstate: gm.GaussianState, gt: torch.Tensor, step: int,
              camera: cameras_lib.Camera, bg: torch.Tensor, opt: config_lib.OptimizationParams,
              model_cfg: config_lib.ModelParams, backend: str, with_stats: bool, with_reg: bool,
              lim: torch.Tensor | None = None) -> ViewGrad:
    """The per-view half of gof_tpu's step (view_loss and its
    value_and_grad, train.py:343-397): render, loss and backward on one
    view; the gradients are read off the leaves, which keep them until the
    step clears them. With a liveness limit `lim` (this camera's row, cut to
    its tiles) whose bound proved stale (`live_bad`, one host read) no
    backward runs."""
    g = tp.gauss
    sh_degree = model_cfg.sh_degree
    leaves = [getattr(g, f).requires_grad_(True) for f in GAUSS_FIELDS]
    app = app_leaves(tp) if model_cfg.use_decoupled_appearance else {}
    for x in app.values():
        x.requires_grad_(True)
    active_degree = min(int(step) // 1000, sh_degree)
    carrier = torch.zeros((g.xyz.shape[0], 3), device=g.xyz.device, requires_grad=True)
    with trace.span("preprocess"):
        scales_f = gm.filtered_scaling(g, gstate.filter_3d)
        opac_f = gm.filtered_opacity(g, gstate.filter_3d)
        shs = masked_shs(g, active_degree, sh_degree)
    out = render_lib.render(camera, g.xyz, scales_f, g.rotation, opac_f, shs, sh_degree,
                            model_cfg.kernel_size, bg, carrier=carrier,
                            active_mask=gstate.active, with_stats=with_stats, with_reg=with_reg,
                            backend=backend, live_limit_chunks=lim)
    with trace.span("loss"):
        loss, l1, ssim_val, distortion_loss, depth_normal_loss = train_loss(
            out.image, gt, camera, opt, step, with_reg,
            (tp.app_net, tp.app_emb) if app else None)
        psnr = losses.psnr(out.image[:3].detach(), gt)
        terms = torch.stack([loss, l1, ssim_val, distortion_loss, depth_normal_loss,
                             psnr]).detach()
    # a stale liveness bound cut an unsaturated tile: skip the update
    live_inv = False
    if lim is not None:
        with trace.read("live_bad"):
            live_inv = bool(out.live_bad.any())  # the one host read
    if live_inv:
        return ViewGrad(out, terms, None, {}, None, True)
    with trace.span("backward"):
        loss.backward()
    cgrad = carrier.grad if carrier.grad is not None else torch.zeros_like(carrier)
    return ViewGrad(out, terms, [x.grad for x in leaves], {k: x.grad for k, x in app.items()},
                    cgrad, False)


def build_train_step(opt: config_lib.OptimizationParams, model_cfg: config_lib.ModelParams,
                     pipe: config_lib.PipelineParams, tx: Adam, with_stats: bool = True,
                     with_reg: bool = True, dp: int = 1, group=None):
    """One training step for one camera: gof_tpu's `step_body`
    (train.py:328-481). Returns step(tp, opt_state, gstate, gt, step, camera,
    bg, lim=None) -> (tp, opt_state, gstate, metrics), with gof_tpu's
    metrics dict.

    The params are updated in place (they stay autograd leaves); the
    optimizer and densification states are returned anew. `key_overflow` and
    `compact_overflow` are always False: there is no overflow gate. With
    --use_decoupled_appearance the L1 goes through tp's appearance network,
    which Adam steps with the gaussians. Without the flag, an appearance
    state that tp carries (a gof_tpu checkpoint always holds one) feeds
    nothing and is stepped with zero gradients, as gof_tpu does
    (train.py:409-415): its momentum alone moves it.

    pipe.backend picks the render path ("pallas": the kernels; "xla": the
    tiled reference, whose render gives the densification carrier no
    gradient, as in gof_tpu). lim: this camera's row of the liveness cache
    ([>= NTILES] int32 chunk bounds, binning.LIM_INF = none), pallas
    backend only. With it the render walks the compacted list; if any tile
    was cut by a stale bound (`live_bad`, read on the host once after the
    forward), the step runs no backward and no update: params, Adam's
    moments and count, the GaussianState and the appearance leaves stay as
    they were (gof_tpu's gate, train.py:421-439). Either way
    metrics["live_new_lim"] is the row's next value (train.py:460-480),
    padded with LIM_INF to lim's width.

    group (a parallel.sharding.Group of dp ranks): gof_tpu's camera-batch
    data parallelism (train.py:224-287, 397-407). Each rank passes its own
    gt and camera, computes its view's loss and gradients as above, and
    _dp_grad_step reduces them over the group; every rank then takes the
    same Adam step on the same averaged gradients, so the replicas stay
    bit-identical. Liveness culling needs dp == 1 (gof_tpu train.py:840).
    """
    if (1 if group is None else group.world) != dp:
        raise ValueError(f"dp={dp} needs a group of {dp} ranks (parallel.sharding.launch)")
    use_app = model_cfg.use_decoupled_appearance

    def step_fn(tp: TrainParams, opt_state: AdamState, gstate: gm.GaussianState,
                gt: torch.Tensor, step: int, camera: cameras_lib.Camera, bg: torch.Tensor,
                lim: torch.Tensor | None = None):
        with trace.unit("step", int(step), gt):
            return one_step(tp, opt_state, gstate, gt, step, camera, bg, lim)

    def one_step(tp, opt_state, gstate, gt, step, camera, bg, lim):
        if lim is not None and group is not None:
            raise ValueError("liveness culling needs dp == 1")
        ntx, nty = binning_lib.tile_grid(camera.width, camera.height)
        lim_cam = None if lim is None else lim[:ntx * nty]
        v = view_grad(tp, gstate, gt, step, camera, bg, opt, model_cfg, pipe.backend,
                      with_stats, with_reg, lim_cam)
        out, terms, grads, app_grads = v.out, v.terms, v.grads, v.app_grads
        counts = {"num_keys": out.num_keys, "compact_demand": out.compact_demand,
                  "live_demand": out.live_demand, "key_overflow": out.overflow,
                  "compact_overflow": out.compact_overflow, "live_overflow": out.live_overflow}
        with torch.no_grad():
            if v.live_inv:
                stat_new = gstate
            elif group is None:
                with trace.span("stats"):
                    stat_new = gm.add_densification_stats(gstate, v.carrier_grad, out.radii,
                                                          out.visibility)
            else:
                grads, app_grads, terms, counts, stat_new = _dp_grad_step(
                    group, grads, app_grads, terms, counts, v.carrier_grad, out, gstate)
            if not v.live_inv:
                with trace.span("adam"):
                    updates, opt_state = tx.update(gm.GaussianParams(*grads), opt_state)
                    for f in GAUSS_FIELDS:
                        x = getattr(tp.gauss, f)
                        x.add_(getattr(updates, f))
                        x.grad = None
                    carried = app_leaves(tp)
                    if carried:
                        app_upd, opt_state = tx.update_app(
                            {k: app_grads[k] if use_app else torch.zeros_like(x)
                             for k, x in carried.items()}, opt_state)
                        for k, x in carried.items():
                            x.add_(app_upd[k])
                            x.grad = None
            loss, l1, ssim_val, distortion_loss, depth_normal_loss, psnr = terms.unbind()
            metrics = {"l1": l1, "ssim": ssim_val, "distortion": distortion_loss,
                       "depth_normal": depth_normal_loss, "num_keys": counts["num_keys"],
                       "key_overflow": counts["key_overflow"], "psnr": psnr,
                       "compact_demand": counts["compact_demand"],
                       "compact_overflow": counts["compact_overflow"], "loss": loss,
                       "step_next": int(step) + 1}
            fl = torch.float32
            with trace.copy("skip_flag"):
                skipped = psnr.new_tensor(float(v.live_inv))
            metrics["packed"] = torch.stack([
                loss, psnr, counts["num_keys"].to(fl), counts["key_overflow"].to(fl),
                counts["compact_demand"].to(fl), counts["compact_overflow"].to(fl),
                gm.num_active(stat_new).to(fl), counts["live_demand"].to(fl),
                counts["live_overflow"].to(fl), skipped])
            if lim is not None:
                # the next visit's bounds: the walked prefix plus margin;
                # exponential growth where the bound proved stale
                lim_c = torch.clamp_max(lim_cam.to(torch.int32), binning_lib.LIM_INF)
                measured = out.live_counts + binning_lib.LIVE_MARGIN_CHUNKS
                new_lim = torch.where(out.live_bad, lim_c * 2 + 4, measured)
                if lim.shape[0] > new_lim.shape[0]:
                    new_lim = torch.cat([new_lim, new_lim.new_full(
                        (lim.shape[0] - new_lim.shape[0],), binning_lib.LIM_INF)])
                metrics["live_new_lim"] = new_lim
        return tp, opt_state, stat_new, metrics

    return step_fn


def _dp_grad_step(group, grads: list, app_grads: dict, terms: torch.Tensor, counts: dict,
                  carrier_grad: torch.Tensor, out, gstate: gm.GaussianState):
    """gof_tpu's per-device reductions (train.py:224-287) over `group`, in
    two collectives (each a host synchronisation):

    - one float32 SUM buffer: the gradients of the six gaussian fields and
      of the stepped appearance leaves and the loss terms (loss, l1, ssim,
      distortion, depth_normal, psnr), then divided by the world size
      (pmean), and the statistics rows [|carrier_grad[:, :2]|,
      |carrier_grad[:, 2]|, visibility] over vis = visibility & active,
      which stay summed (psum: each view counts as one reference
      iteration). The divisor is a device tensor: CUDA rounds a division by
      a Python number as a product with its reciprocal (ROADMAP C16);
    - one float64 MAX buffer (exact for every count): the radii over vis,
      num_keys, compact_demand, live_demand (pmax) and the overflow flags
      (any).

    Returns the reduced (grads, app_grads, terms, counts) and the new
    GaussianState (train.py:274-282)."""
    vis = out.visibility & gstate.active
    zero = torch.zeros((), device=carrier_grad.device)
    rows = torch.stack([torch.where(vis, torch.linalg.norm(carrier_grad[:, :2], dim=-1), zero),
                        torch.where(vis, torch.abs(carrier_grad[:, 2]), zero),
                        vis.to(torch.float32)])
    means = list(grads) + list(app_grads.values()) + [terms]
    buf = group.all_reduce(torch.cat([x.reshape(-1) for x in means] + [rows.reshape(-1)]),
                           "sum")
    n_mean = buf.numel() - rows.numel()
    world = torch.tensor(float(group.world), device=buf.device)
    parts = iter((buf[:n_mean] / world).split([x.numel() for x in means]))
    grads = [next(parts).view_as(x) for x in grads]
    app_grads = {k: next(parts).view_as(x) for k, x in app_grads.items()}
    terms = next(parts)
    stat = buf[n_mean:].view(3, -1)

    f64 = torch.float64
    mx = group.all_reduce(torch.cat([torch.where(vis, out.radii, zero).to(f64),
                                     torch.stack([c.to(f64).reshape(()) for c in counts.values()])]),
                          "max")
    P = vis.shape[0]
    radii = mx[:P].to(gstate.max_radii2d.dtype)
    counts = {k: mx[P + i].to(c.dtype) for i, (k, c) in enumerate(counts.items())}
    vis_any = stat[2] > 0
    return grads, app_grads, terms, counts, gm.GaussianState(
        active=gstate.active, filter_3d=gstate.filter_3d,
        max_radii2d=torch.where(vis_any, torch.maximum(gstate.max_radii2d, radii),
                                gstate.max_radii2d),
        grad_accum=gstate.grad_accum + stat[0], grad_abs_accum=gstate.grad_abs_accum + stat[1],
        denom=gstate.denom + stat[2])


@torch.no_grad()
def evaluate(sc, tp: TrainParams, gstate, model_cfg, bg, device, backend: str = "pallas"):
    """PSNR over the test split (or the first 4 training views), as gof_tpu's
    evaluate (train.py:1147-1158), building no autograd graph, through the
    render backend `backend`."""
    from .render_cli import render_eval

    cams = sc.test_cameras or sc.train_cameras[:4]
    psnrs = []
    for info in cams:
        camera, gt = sc.camera(info, device=device)
        img = render_eval(tp.gauss, gstate, camera, model_cfg, bg, backend).image
        psnrs.append(float(losses.psnr(img[:3], torch.as_tensor(gt, device=device))))
    return {"psnr": round(float(np.mean(psnrs)), 3), "views": len(psnrs)}


def training(model_cfg: config_lib.ModelParams, opt: config_lib.OptimizationParams,
             pipe: config_lib.PipelineParams, test_iterations, save_iterations,
             checkpoint_iterations, start_checkpoint: str = "", quiet: bool = False,
             device: torch.device | str = "cuda", profile_dir: str = "",
             debug_image_interval: int = 0, dp: int = 1, devices=None):
    """gof_tpu's host loop (train.py:599-1104) with one step per iteration.
    Returns (TrainParams, GaussianState).

    dp > 1: camera-batch data parallelism (train.py:603-615, 868-877) over
    dp ranks, rank r on devices[r] (default parallel.sharding.make_mesh:
    the first dp CUDA devices, or dp CPU ranks where `device` is the CPU),
    started by parallel.sharding.launch. Every rank runs this loop with the
    same seeds, so each optimizer step draws the same dp views everywhere
    and rank r renders the r-th; every rank densifies and grows its pool
    alike, so the replicas stay bit-identical, which a sha256 of each field
    across the ranks checks at the end (a difference raises). Rank 0 alone
    writes the config, the log, TensorBoard scalars, evals, PLYs,
    checkpoints (dp == 1's format: either resumes the other), debug images
    and the profile, and prints; the other ranks wait at a barrier. Returns
    rank 0's state on devices[0]."""
    if dp == 1:
        tp, _, gstate = _train_loop(None, torch.device(device), model_cfg, opt, pipe,
                                    test_iterations, save_iterations, checkpoint_iterations,
                                    start_checkpoint, quiet, profile_dir, debug_image_interval)
        return tp, gstate
    from .parallel import sharding

    if devices is None:
        devices = sharding.make_mesh(dp, torch.device(device).type, f"--dp {dp}")
    results = sharding.launch(_training_rank, dp, devices, (
        model_cfg, opt, pipe, test_iterations, save_iterations, checkpoint_iterations,
        start_checkpoint, quiet, profile_dir, debug_image_interval))
    digests = [r["digests"] for r in results]
    diverged = sorted(k for k, v in digests[0].items() if any(d[k] != v for d in digests[1:]))
    if diverged:
        raise RuntimeError(f"the {dp} replicas diverged in {diverged}")
    if not quiet:
        print(f"replicas: sha256 of {len(digests[0])} fields equal on all {dp} ranks")
    tp, _, gstate, _ = state_from_blob(results[0]["state"], devices[0])
    return tp, gstate


def replica_digests(blob: dict) -> dict:
    """sha256 of each array of a checkpoint_blob, by its path in the blob."""
    def leaves(obj, name):
        if isinstance(obj, dict):
            for k in sorted(obj):
                yield from leaves(obj[k], f"{name}.{k}" if name else str(k))
        elif isinstance(obj, (tuple, list)):
            for i, x in enumerate(obj):
                yield from leaves(x, f"{name}.{i}")
        elif obj is not None:
            yield name, hashlib.sha256(np.ascontiguousarray(obj).tobytes()).hexdigest()

    return dict(leaves(blob, ""))


def _training_rank(group, *loop_args) -> dict:
    """One rank of training(dp > 1): the digests of its final state and, on
    rank 0, the state itself (checkpoint_blob)."""
    tp, opt_state, gstate = _train_loop(group, group.device, *loop_args)
    blob = checkpoint_blob(tp, opt_state, gstate, 0)
    return {"digests": replica_digests(blob), "state": blob if group.rank == 0 else None}


def _train_loop(group, device: torch.device, model_cfg, opt, pipe, test_iterations,
                save_iterations, checkpoint_iterations, start_checkpoint, quiet, profile_dir,
                debug_image_interval):
    """training's loop on one rank (group None: dp == 1). Returns (tp,
    opt_state, gstate)."""
    dp = 1 if group is None else group.world
    rank0 = group is None or group.rank == 0
    quiet = quiet or not rank0
    random.seed(0)
    np.random.seed(0)

    sc = scene_lib.Scene(model_cfg.source_path, model_cfg.model_path if rank0 else "",
                         images=model_cfg.images, resolution=model_cfg.resolution,
                         white_background=model_cfg.white_background, eval_split=model_cfg.eval,
                         load_allres=model_cfg.load_allres)
    if rank0:
        config_lib.save_cfg(model_cfg.model_path, model_cfg, pipe, opt)

    tx = make_optimizer(opt, sc.cameras_extent)
    first_iter = 0
    if start_checkpoint:
        tp, opt_state, gstate, first_iter = load_checkpoint(start_checkpoint, device)
        if not quiet:
            print(f"resumed from {start_checkpoint} at iteration {first_iter}")
    else:
        cap = pool_capacity(sc.info.point_cloud_xyz.shape[0])
        gauss, gstate = gm.init_from_points(sc.info.point_cloud_xyz, sc.info.point_cloud_rgb,
                                            model_cfg.sh_degree, cap, device=device)
        tp = TrainParams(gauss=gauss)
        opt_state = tx.init(tp)
    if model_cfg.use_decoupled_appearance and tp.app_net is None:
        tp, opt_state = init_appearance(tp, opt_state, device)
    if group is not None:  # every rank starts from rank 0's state
        from .parallel import sharding

        with torch.no_grad():
            sharding.replicate(state_tensors(tp, opt_state, gstate), group)

    cam_meta = sc.all_cameras_meta(sc.train_cameras, device=device)
    gstate.filter_3d = gm.compute_3d_filter(tp.gauss.xyz, gstate.active, *cam_meta)

    bg = torch.tensor([1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0],
                      device=device)
    reg_start = min(opt.distortion_from_iter, opt.depth_normal_from_iter)
    with_stats = first_iter + 1 <= opt.densify_until_iter
    with_reg = first_iter + 1 >= reg_start

    # temporal liveness culling (binning.compact_live): a [n_cameras,
    # ntiles_max] cache of per-tile live-prefix bounds in chunks, made at
    # the first step past densify_until_iter on the pallas backend and
    # indexed by the camera's index among the training cameras (a resume
    # starts a fresh one, as gof_tpu's does)
    ntiles_max = max(int(np.prod(binning_lib.tile_grid(*sc._scaled_size(c))))
                     for c in sc.train_cameras)
    live_cache = None

    def rebuild_step():
        return build_train_step(opt, model_cfg, pipe, tx, with_stats=with_stats,
                                with_reg=with_reg, dp=dp, group=group)

    train_step = rebuild_step()
    cam_cache = {}

    def get_cam(info):
        if info.uid not in cam_cache:
            cam, gt = sc.camera(info, device=device)
            cam_cache[info.uid] = (cam, torch.as_tensor(gt, device=device))
        return cam_cache[info.uid]

    # >= 800px-wide cameras for the 30% high-res oversampling
    # (reference train.py:112-116,139-141)
    highres_ids = [i for i, c in enumerate(sc.train_cameras) if sc._scaled_size(c)[0] >= 800]
    stack = []

    def next_id():
        nonlocal stack
        if not stack:
            stack = list(range(len(sc.train_cameras)))
            random.shuffle(stack)
        j = stack.pop()
        # the pop above still consumes a stack entry, as in the reference
        if model_cfg.sample_more_highres and highres_ids and random.random() < 0.3:
            j = highres_ids[random.randint(0, len(highres_ids) - 1)]
        return j

    # the densify offsets' stream (gof_tpu's PRNGKey(0), train.py:789)
    noise_gen = torch.Generator(device=device)
    noise_gen.manual_seed(0)
    log_path = os.path.join(model_cfg.model_path, "train_log.jsonl")
    tb = _make_tb_writer(model_cfg.model_path) if rank0 else None
    ema_loss = None
    pending = []  # unread packed metrics, read every 10 iterations
    prof = contextlib.nullcontext()
    if profile_dir and rank0:
        prof = profiler(profile_dir, device)
    t_start = time.time()
    iteration = first_iter
    with open(log_path if rank0 else os.devnull, "a") as logf, prof, \
            tb or contextlib.nullcontext():
        while iteration < opt.iterations:
            iteration += 1
            # the statistics leave the backward after densification; the
            # regularizer channels join at the first step that weighs them
            if with_stats and iteration > opt.densify_until_iter:
                with_stats = False
                train_step = rebuild_step()
            if not with_reg and iteration >= reg_start:
                with_reg = True
                train_step = rebuild_step()
            if (live_cache is None and dp == 1 and pipe.backend == "pallas"
                    and iteration > opt.densify_until_iter):
                live_cache = torch.full((len(sc.train_cameras), ntiles_max), binning_lib.LIM_INF,
                                        dtype=torch.int32, device=device)
                if not quiet:
                    print(f"[{iteration}] liveness culling on")

            # one optimizer step draws dp views; rank r renders the r-th
            cam_id = [next_id() for _ in range(dp)][0 if group is None else group.rank]
            camera, gt = get_cam(sc.train_cameras[cam_id])
            tp, opt_state, gstate, metrics = train_step(
                tp, opt_state, gstate, gt, iteration, camera, bg,
                lim=None if live_cache is None else live_cache[cam_id])
            if live_cache is not None:
                live_cache[cam_id] = metrics["live_new_lim"]

            # --- host control flow (train.py:921-943) ---
            if iteration < opt.densify_until_iter:
                if (iteration > opt.densify_from_iter
                        and iteration % opt.densification_interval == 0):
                    cap = tp.gauss.xyz.shape[0]
                    noise = tuple(torch.randn((cap, 3), generator=noise_gen, device=device)
                                  for _ in range(3))
                    gauss, gstate, opt_state, rep = gm.densify_and_prune(
                        tp.gauss, gstate, opt_state, noise, opt.densify_grad_threshold,
                        0.05, sc.cameras_extent, opt.percent_dense,
                        iteration > opt.opacity_reset_interval)
                    tp = replace(tp, gauss=gauss)
                    if bool(rep.pool_overflow):  # the densify step's one host read
                        tp, gstate, opt_state = grow_capacity(tp, gstate, opt_state, cap,
                                                              2 * cap)
                        if not quiet:
                            print(f"[{iteration}] grew capacity to {2 * cap}")
                    gstate.filter_3d = gm.compute_3d_filter(tp.gauss.xyz, gstate.active,
                                                            *cam_meta)
                if iteration % opt.opacity_reset_interval == 0 or (
                        model_cfg.white_background and iteration == opt.densify_from_iter):
                    with torch.no_grad():
                        new = gm.reset_opacity(tp.gauss, gstate.filter_3d)
                        tp.gauss.opacity.copy_(new.opacity)
            elif iteration % 100 == 0:
                gstate.filter_3d = gm.compute_3d_filter(tp.gauss.xyz.detach(),
                                                        gstate.active, *cam_meta)

            pending.append(metrics["packed"])
            if iteration % 10 == 0 or iteration == first_iter + 1:
                mp = torch.stack(pending).cpu().numpy()  # one host read
                pending.clear()
                if pipe.debug and not np.all(np.isfinite(mp[:, 0])):
                    fn = (_debug_dump(model_cfg.model_path, iteration, tp, gstate, opt_state,
                                      {"packed_metrics": mp}) if rank0 else "rank 0's debug/")
                    raise FloatingPointError(
                        f"non-finite loss in the steps ending at iteration {iteration}; "
                        f"render inputs dumped to {fn}")
                loss = float(mp[-1, 0])
                ema_loss = loss if ema_loss is None else 0.6 * loss + 0.4 * ema_loss
                rec = {"iter": iteration, "loss": round(loss, 5),
                       "ema": round(ema_loss, 5), "psnr": round(float(mp[-1, 1]), 3),
                       "points": int(mp[-1, 6]), "keys": int(mp[:, 2].max()),
                       "elapsed": round(time.time() - t_start, 1)}
                logf.write(json.dumps(rec) + "\n")
                logf.flush()
                if tb is not None:
                    tb.add_scalar("train_loss_patches/total_loss", loss, iteration)
                    tb.add_scalar("train/psnr", rec["psnr"], iteration)
                    tb.add_scalar("total_points", rec["points"], iteration)
                    tb.add_scalar("iter_time", (time.time() - t_start) / iteration,
                                  iteration)
                if not quiet and iteration % 100 == 0:
                    print(rec)

            debug_image = bool(debug_image_interval) and iteration % debug_image_interval == 0
            rank0_writes = (debug_image or iteration in test_iterations
                            or iteration in save_iterations or iteration in checkpoint_iterations)
            if rank0 and debug_image:
                from .render_cli import render_eval
                from .utils import vis

                img = render_eval(tp.gauss, gstate, camera, model_cfg, bg, pipe.backend).image
                vis.save_debug_grid(os.path.join(model_cfg.model_path, "debug",
                                                 f"iter_{iteration:06d}.png"),
                                    img.cpu().numpy(), gt.cpu().numpy())

            if rank0 and iteration in test_iterations:
                report = evaluate(sc, tp, gstate, model_cfg, bg, device, pipe.backend)
                if not quiet:
                    print(f"[{iteration}] eval: {report}")
                logf.write(json.dumps({"iter": iteration, "eval": report}) + "\n")
                logf.flush()

            if rank0 and iteration in save_iterations:
                path = os.path.join(model_cfg.model_path, "point_cloud",
                                    f"iteration_{iteration}", "point_cloud.ply")
                scene_lib.save_gaussians_ply(path, tp.gauss, gstate, model_cfg.sh_degree)

            if rank0 and iteration in checkpoint_iterations:
                save_checkpoint(model_cfg.model_path, iteration, tp, opt_state, gstate)
            if group is not None and rank0_writes:
                group.barrier()
            if profile_dir and rank0:
                prof.step()
    return tp, opt_state, gstate


def profiler(profile_dir: str, device: torch.device):
    """--profile_dir's torch.profiler: the first PROFILE_STEPS iterations
    from the start or resume point (a late window: resume from a
    checkpoint), their spans included (utils/trace.py). When the window
    closes, or the run ends inside it, it writes trace.json (the profiler's
    chrome trace) and spans.jsonl (trace.export) to profile_dir."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def ready(prof):
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        trace.export(os.path.join(profile_dir, "spans.jsonl"))

    with warnings.catch_warnings():  # every step of the window counts: no warm-up step
        warnings.filterwarnings("ignore", "Profiler won't be using warmup")
        sched = torch.profiler.schedule(wait=0, warmup=0, active=PROFILE_STEPS, repeat=1)
    return torch.profiler.profile(activities=acts, schedule=sched, on_trace_ready=ready)


def _make_tb_writer(model_path: str):
    """gof_tpu's TensorBoard writer (train.py:1107-1113), or None where
    torch.utils.tensorboard does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(model_path)
    except Exception:
        return None


def _debug_dump(model_path: str, iteration: int, tp: TrainParams, gstate: gm.GaussianState,
                opt_state: AdamState, extra: dict) -> str:
    """--debug's fail-time snapshot (gof_tpu train.py:1116-1140):
    debug/snapshot_iter{iteration:06d}.npz with the gaussians (gauss_*), the
    GaussianState (gstate_*), Adam's count and moments in gof_tpu's [NCOL, CAP]
    layout (adam_count, adam_mu_flat, adam_nu_flat) and `extra`
    (packed_metrics). gof_tpu's key_capacity, compact_capacity and n_inner
    are TPU capacities the port does not have, so they are left out.
    Returns the file's path."""
    path = os.path.join(model_path, "debug")
    os.makedirs(path, exist_ok=True)
    fn = os.path.join(path, f"snapshot_iter{int(iteration):06d}.npz")
    arrs = {f"gauss_{f}": hostio.device_get(getattr(tp.gauss, f)) for f in GAUSS_FIELDS}
    arrs.update({f"gstate_{f}": hostio.device_get(getattr(gstate, f)) for f in STATE_FIELDS})
    adam = adam_to_numpy(opt_state)
    arrs.update(adam_count=np.asarray(adam.count, np.int32), adam_mu_flat=adam.mu_flat,
                adam_nu_flat=adam.nu_flat, **extra)
    np.savez_compressed(fn, **arrs)
    return fn


def checkpoint_blob(tp: TrainParams, opt_state: AdamState, gstate: gm.GaussianState,
                    iteration: int) -> dict:
    """The state as a checkpoint holds it: plain dicts of numpy arrays and
    ints, {"gauss": {field: array}, "gstate": {field: array}, "adam":
    {"count", "mu_flat", "nu_flat"} in adam_to_numpy's layout, "iter":
    iteration}; with the appearance network also "app_net" (gof_tpu's flax
    tree), "app_emb" and, in "adam", "mu_app" / "nu_app" as gof_tpu's
    (tree, embeddings) pairs."""
    adam = adam_to_numpy(opt_state)
    blob = {"gauss": {f: hostio.device_get(getattr(tp.gauss, f)) for f in GAUSS_FIELDS},
            "gstate": {f: hostio.device_get(getattr(gstate, f)) for f in STATE_FIELDS},
            "adam": {"count": adam.count, "mu_flat": adam.mu_flat, "nu_flat": adam.nu_flat},
            "iter": int(iteration)}
    if tp.app_net is not None:
        blob["app_net"], blob["app_emb"] = app_lib.app_to_numpy(tp.app_net, tp.app_emb)
        blob["adam"].update(mu_app=adam.mu_app, nu_app=adam.nu_app)
    return blob


def state_tensors(tp: TrainParams, opt_state: AdamState, gstate: gm.GaussianState) -> list:
    """Every tensor of the training state: the params, the GaussianState,
    Adam's moments and the appearance leaves and their moments."""
    out = [getattr(tp.gauss, f) for f in GAUSS_FIELDS]
    out += [getattr(gstate, f) for f in STATE_FIELDS]
    out += [getattr(m, f) for m in (opt_state.mu, opt_state.nu) for f in GAUSS_FIELDS]
    out += list(app_leaves(tp).values())
    for m in (opt_state.mu_app, opt_state.nu_app):
        out += list((m or {}).values())
    return out


def save_checkpoint(model_path: str, iteration: int, tp: TrainParams, opt_state: AdamState,
                    gstate: gm.GaussianState) -> str:
    """Write chkpnt{iteration}.pkl into model_path (gof_tpu
    train.py:1203-1213): a pickle of checkpoint_blob. Returns the path."""
    path = os.path.join(model_path, f"chkpnt{iteration}.pkl")
    with open(path, "wb") as f:
        pickle.dump(checkpoint_blob(tp, opt_state, gstate, iteration), f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    return path


# stand-ins, with the same positional fields, for the classes a checkpoint
# written by gof_tpu.train.save_checkpoint names
_GOF_CLASSES = {
    ("gof_tpu.train", "TrainParams"): namedtuple("TrainParams", "gauss app_net app_emb"),
    ("gof_tpu.train", "FusedAdamState"): FusedAdamState,
    ("gof_tpu.model.gaussians", "GaussianParams"): namedtuple("GaussianParams", GAUSS_FIELDS),
    ("gof_tpu.model.gaussians", "GaussianState"): namedtuple("GaussianState", STATE_FIELDS),
}
_GOF_MAIN = {name: cls for (_, name), cls in _GOF_CLASSES.items()}
_BUILTINS = {"tuple", "list", "dict", "set", "frozenset", "int", "float", "complex", "bool",
             "str", "bytes", "bytearray", "slice", "range"}
# what a pickle of numpy arrays and scalars names (protocols 3-5, numpy 1
# and 2); numpy's other functions stay out, numpy.load among them
_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype")} | {
    (f"numpy.{core}.{mod}", name) for core in ("core", "_core")
    for mod, name in (("multiarray", "_reconstruct"), ("multiarray", "scalar"),
                      ("numeric", "_frombuffer"))}


class _CheckpointUnpickler(pickle.Unpickler):
    """Loads the port's checkpoints and gof_tpu's without importing gof_tpu:
    gof_tpu's four state classes (also as pickled by `python -m
    gof_tpu.train`, under __main__) map to stand-ins; numpy arrays and
    scalars and builtin types load; any other global is refused."""

    def find_class(self, module, name):
        cls = _GOF_MAIN.get(name) if module == "__main__" else _GOF_CLASSES.get((module, name))
        if cls is not None:
            return cls
        if (module, name) in _NUMPY or (module == "builtins" and name in _BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a checkpoint may not name {module}.{name}")


def _migrate_legacy_adam(adam) -> FusedAdamState:
    """gof_tpu's legacy checkpoint migration (train.py:1231-1244): an older
    gof_tpu stored Adam's moments as TrainParams trees in a 3-field
    FusedAdamState. Their gaussian fields flatten into the [NCOL, CAP]
    layout (flatten_gauss_t); the appearance moments, where either tree
    holds them, become the (app_net, app_emb) pairs."""
    def flat(gauss) -> np.ndarray:
        cap = np.shape(gauss.xyz)[0]
        return np.concatenate([np.asarray(getattr(gauss, f)).reshape(cap, -1).T
                               for f in GAUSS_FIELDS], axis=0)

    mu, nu = adam.mu_flat, adam.nu_flat
    has_app = mu.app_net is not None or mu.app_emb is not None
    return FusedAdamState(count=adam.count, mu_flat=flat(mu.gauss), nu_flat=flat(nu.gauss),
                          mu_app=(mu.app_net, mu.app_emb) if has_app else None,
                          nu_app=(nu.app_net, nu.app_emb) if has_app else None)


def load_checkpoint(path: str, device: torch.device | str = "cpu"):
    """Read a checkpoint written by save_checkpoint or by gof_tpu's
    (train.py:1216-1245), an older gof_tpu's legacy layout included.
    Returns (TrainParams, AdamState, GaussianState, iteration) on `device`,
    with the appearance network, its embeddings and their moments where the
    checkpoint holds them (gof_tpu's always do)."""
    with open(path, "rb") as f:
        blob = _CheckpointUnpickler(f).load()
    return state_from_blob(blob, device)


def state_from_blob(blob: dict, device: torch.device | str = "cpu"):
    """load_checkpoint from an unpickled checkpoint: checkpoint_blob's dict
    or gof_tpu's {"tp", "opt_state", "gstate", "iter"}."""
    if "tp" in blob:
        tp, gstate, adam = blob["tp"], blob["gstate"], blob["opt_state"]
        gauss, app_net, app_emb = tp.gauss, tp.app_net, tp.app_emb
        if isinstance(adam.mu_flat, _GOF_CLASSES[("gof_tpu.train", "TrainParams")]):
            adam = _migrate_legacy_adam(adam)
    else:
        gauss = _GOF_CLASSES[("gof_tpu.model.gaussians", "GaussianParams")](**blob["gauss"])
        gstate = _GOF_CLASSES[("gof_tpu.model.gaussians", "GaussianState")](**blob["gstate"])
        adam = FusedAdamState(**blob["adam"])
        app_net, app_emb = blob.get("app_net"), blob.get("app_emb")
    g, s = gm.from_numpy(gauss, gstate, device)
    tp = TrainParams(gauss=g)
    if app_net is not None:
        tp.app_net, tp.app_emb = app_lib.app_from_numpy(app_net, app_emb, device)
    return tp, from_numpy(adam, g, device), s, int(blob["iter"])


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="gof_tpu_torch training")
    config_lib.add_group(parser, config_lib.ModelParams)
    config_lib.add_group(parser, config_lib.PipelineParams)
    config_lib.add_group(parser, config_lib.OptimizationParams)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[30_000])
    parser.add_argument("--start_checkpoint", type=str, default="")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    parser.add_argument("--profile_dir", type=str, default="")
    parser.add_argument("--debug_image_interval", type=int, default=0)
    parser.add_argument("--dp", type=int, default=1,
                        help="camera-batch data parallelism over dp ranks, one per device "
                             "(each optimizer step consumes dp views; gradients averaged)")
    ns = parser.parse_args(argv)
    if ns.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --cpu for the CPU path")
        device = torch.device("cuda")
    devices = None
    if ns.dp > 1:
        from .parallel import sharding

        devices = sharding.make_mesh(ns.dp, device.type, f"--dp {ns.dp}")
    model_cfg = config_lib.extract(config_lib.ModelParams, ns)
    pipe = config_lib.extract(config_lib.PipelineParams, ns)
    opt = config_lib.extract(config_lib.OptimizationParams, ns)
    save_iters = sorted(set(ns.save_iterations + [opt.iterations]))
    out = training(model_cfg, opt, pipe, set(ns.test_iterations), set(save_iters),
                   set(ns.checkpoint_iterations), ns.start_checkpoint, ns.quiet, device=device,
                   profile_dir=ns.profile_dir, debug_image_interval=ns.debug_image_interval,
                   dp=ns.dp, devices=devices)
    print("Training complete.")
    return out


if __name__ == "__main__":
    main()
