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
trace) and the TensorBoard scalars follow gof_tpu.

Temporal liveness culling (gof_tpu train.py:833-850): from the first step
past densify_until_iter on the pallas backend, each training camera's row
of a device-resident cache bounds the keys each tile walks (its previous
visit's walked chunks plus a margin); a step whose bound proved stale
skips its update and grows the row (`build_train_step`).

Not ported yet: --dp > 1 (A.18) raises NotImplementedError naming its
ROADMAP item rather than being skipped. There are no capacity re-jits or
overflow gates: the port sizes its render buffers from each view's demand.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import random
import time
from collections import namedtuple
from dataclasses import dataclass, fields, replace

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
from .utils import hostio, losses, schedules

GAUSS_FIELDS = tuple(f.name for f in fields(gm.GaussianParams))
STATE_FIELDS = tuple(f.name for f in fields(gm.GaussianState))

# gof_tpu's optimizer state on the host: count and the [NCOL, CAP] moment
# buffers whose row blocks follow GaussianParams' field order (each leaf
# flattened per slot); mu_app / nu_app hold the appearance network's moments
FusedAdamState = namedtuple("FusedAdamState", "count mu_flat nu_flat mu_app nu_app",
                            defaults=(None, None))


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to gof_tpu_torch yet (ROADMAP {item})")


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
        cf = torch.tensor(float(count), dtype=torch.float32, device=dev)
        return 1.0 - torch.pow(self.b1, cf), 1.0 - torch.pow(self.b2, cf)

    def update(self, grads: gm.GaussianParams, state: AdamState):
        """Returns (updates, new state); updates are added to the params.
        The appearance moments pass through unchanged (update_app)."""
        dev = grads.xyz.device
        count_inc = state.count + 1
        bc1, bc2 = self._bias_corrections(count_inc, dev)
        lrs = self.group_lrs(state.count)
        upd, mu, nu = {}, {}, {}
        for f in GAUSS_FIELDS:
            lr = torch.as_tensor(lrs[f], dtype=torch.float32).to(dev)
            upd[f], mu[f], nu[f] = self._leaf(getattr(grads, f), getattr(state.mu, f),
                                              getattr(state.nu, f), lr, bc1, bc2)
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
        lr_net = torch.tensor(self.opt.appearance_network_lr, dtype=torch.float32, device=dev)
        lr_emb = torch.tensor(self.opt.appearance_embeddings_lr, dtype=torch.float32, device=dev)
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
    dirs_view = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)  # [H, W, 3]
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


def build_train_step(opt: config_lib.OptimizationParams, model_cfg: config_lib.ModelParams,
                     pipe: config_lib.PipelineParams, tx: Adam, with_stats: bool = True,
                     with_reg: bool = True, dp: int = 1):
    """One training step for one camera: gof_tpu's `step_body` for dp == 1
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
    """
    if dp != 1:
        raise _not_ported(f"--dp {dp} (camera-batch data parallelism)", "A.18")
    backend = pipe.backend
    use_app = model_cfg.use_decoupled_appearance
    sh_degree = model_cfg.sh_degree
    kernel_size = model_cfg.kernel_size

    def step_fn(tp: TrainParams, opt_state: AdamState, gstate: gm.GaussianState,
                gt: torch.Tensor, step: int, camera: cameras_lib.Camera, bg: torch.Tensor,
                lim: torch.Tensor | None = None):
        g = tp.gauss
        use_live = lim is not None
        ntx, nty = binning_lib.tile_grid(camera.width, camera.height)
        lim_cam = lim[:ntx * nty] if use_live else None
        leaves = [getattr(g, f).requires_grad_(True) for f in GAUSS_FIELDS]
        app = app_leaves(tp) if use_app else {}
        for x in app.values():
            x.requires_grad_(True)
        active_degree = min(int(step) // 1000, sh_degree)
        carrier = torch.zeros((g.xyz.shape[0], 3), device=g.xyz.device, requires_grad=True)
        scales_f = gm.filtered_scaling(g, gstate.filter_3d)
        opac_f = gm.filtered_opacity(g, gstate.filter_3d)
        shs = masked_shs(g, active_degree, sh_degree)
        out = render_lib.render(camera, g.xyz, scales_f, g.rotation, opac_f, shs, sh_degree,
                                kernel_size, bg, carrier=carrier, active_mask=gstate.active,
                                with_stats=with_stats, with_reg=with_reg, backend=backend,
                                live_limit_chunks=lim_cam)
        loss, l1, ssim_val, distortion_loss, depth_normal_loss = train_loss(
            out.image, gt, camera, opt, step, with_reg,
            (tp.app_net, tp.app_emb) if use_app else None)
        image = out.image[:3]
        # a stale liveness bound cut an unsaturated tile: skip the update
        live_inv = use_live and bool(out.live_bad.any())  # the one host read
        if live_inv:
            stat_new = gstate
        else:
            loss.backward()
            grads = gm.GaussianParams(*[x.grad for x in leaves])
            cgrad = carrier.grad if carrier.grad is not None else torch.zeros_like(carrier)
            stat_new = gm.add_densification_stats(gstate, cgrad, out.radii, out.visibility)
        with torch.no_grad():
            if not live_inv:
                updates, opt_state = tx.update(grads, opt_state)
                for x, f in zip(leaves, GAUSS_FIELDS):
                    x.add_(getattr(updates, f))
                    x.grad = None
                carried = app if use_app else app_leaves(tp)
                if carried:
                    app_upd, opt_state = tx.update_app(
                        {k: x.grad if use_app else torch.zeros_like(x)
                         for k, x in carried.items()}, opt_state)
                    for k, x in carried.items():
                        x.add_(app_upd[k])
                        x.grad = None
            psnr = losses.psnr(image, gt)
            metrics = {"l1": l1.detach(), "ssim": ssim_val.detach(),
                       "distortion": distortion_loss.detach(),
                       "depth_normal": depth_normal_loss.detach(), "num_keys": out.num_keys,
                       "key_overflow": out.overflow, "psnr": psnr,
                       "compact_demand": out.compact_demand,
                       "compact_overflow": out.compact_overflow, "loss": loss.detach(),
                       "step_next": int(step) + 1}
            fl = torch.float32
            metrics["packed"] = torch.stack([
                loss.detach(), psnr, out.num_keys.to(fl), out.overflow.to(fl),
                out.compact_demand.to(fl), out.compact_overflow.to(fl),
                gm.num_active(stat_new).to(fl), out.live_demand.to(fl),
                out.live_overflow.to(fl), psnr.new_tensor(float(live_inv))])
            if use_live:
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
             debug_image_interval: int = 0, dp: int = 1):
    """gof_tpu's host loop (train.py:599-1104) with one step per iteration.
    Returns (TrainParams, GaussianState)."""
    random.seed(0)
    np.random.seed(0)
    device = torch.device(device)

    sc = scene_lib.Scene(model_cfg.source_path, model_cfg.model_path, images=model_cfg.images,
                         resolution=model_cfg.resolution,
                         white_background=model_cfg.white_background, eval_split=model_cfg.eval,
                         load_allres=model_cfg.load_allres)
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
                                with_reg=with_reg, dp=dp)

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
    tb = _make_tb_writer(model_cfg.model_path)
    ema_loss = None
    pending = []  # unread packed metrics, read every 10 iterations
    prof = contextlib.nullcontext()
    if profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    t_start = time.time()
    iteration = first_iter
    with open(log_path, "a") as logf, prof, tb or contextlib.nullcontext():
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
            if (live_cache is None and pipe.backend == "pallas"
                    and iteration > opt.densify_until_iter):
                live_cache = torch.full((len(sc.train_cameras), ntiles_max), binning_lib.LIM_INF,
                                        dtype=torch.int32, device=device)
                if not quiet:
                    print(f"[{iteration}] liveness culling on")

            cam_id = next_id()
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
                    fn = _debug_dump(model_cfg.model_path, iteration, tp, gstate, opt_state,
                                     {"packed_metrics": mp})
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

            if debug_image_interval and iteration % debug_image_interval == 0:
                from .render_cli import render_eval
                from .utils import vis

                img = render_eval(tp.gauss, gstate, camera, model_cfg, bg, pipe.backend).image
                vis.save_debug_grid(os.path.join(model_cfg.model_path, "debug",
                                                 f"iter_{iteration:06d}.png"),
                                    img.cpu().numpy(), gt.cpu().numpy())

            if iteration in test_iterations:
                report = evaluate(sc, tp, gstate, model_cfg, bg, device, pipe.backend)
                if not quiet:
                    print(f"[{iteration}] eval: {report}")
                logf.write(json.dumps({"iter": iteration, "eval": report}) + "\n")
                logf.flush()

            if iteration in save_iterations:
                path = os.path.join(model_cfg.model_path, "point_cloud",
                                    f"iteration_{iteration}", "point_cloud.ply")
                scene_lib.save_gaussians_ply(path, tp.gauss, gstate, model_cfg.sh_degree)

            if iteration in checkpoint_iterations:
                save_checkpoint(model_cfg.model_path, iteration, tp, opt_state, gstate)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return tp, gstate


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


def save_checkpoint(model_path: str, iteration: int, tp: TrainParams, opt_state: AdamState,
                    gstate: gm.GaussianState) -> str:
    """Write chkpnt{iteration}.pkl into model_path (gof_tpu
    train.py:1203-1213): a pickle of plain dicts of numpy arrays and ints,
    {"gauss": {field: array}, "gstate": {field: array}, "adam": {"count",
    "mu_flat", "nu_flat"} in adam_to_numpy's layout, "iter": iteration};
    with the appearance network also "app_net" (gof_tpu's flax tree),
    "app_emb" and, in "adam", "mu_app" / "nu_app" as gof_tpu's (tree,
    embeddings) pairs. Returns the path."""
    adam = adam_to_numpy(opt_state)
    blob = {"gauss": {f: hostio.device_get(getattr(tp.gauss, f)) for f in GAUSS_FIELDS},
            "gstate": {f: hostio.device_get(getattr(gstate, f)) for f in STATE_FIELDS},
            "adam": {"count": adam.count, "mu_flat": adam.mu_flat, "nu_flat": adam.nu_flat},
            "iter": int(iteration)}
    if tp.app_net is not None:
        blob["app_net"], blob["app_emb"] = app_lib.app_to_numpy(tp.app_net, tp.app_emb)
        blob["adam"].update(mu_app=adam.mu_app, nu_app=adam.nu_app)
    path = os.path.join(model_path, f"chkpnt{iteration}.pkl")
    with open(path, "wb") as f:
        pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
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


def load_checkpoint(path: str, device: torch.device | str = "cpu"):
    """Read a checkpoint written by save_checkpoint or by gof_tpu's
    (train.py:1216-1245). Returns (TrainParams, AdamState, GaussianState,
    iteration) on `device`, with the appearance network, its embeddings and
    their moments where the checkpoint holds them (gof_tpu's always do).
    gof_tpu's legacy migration is not ported."""
    with open(path, "rb") as f:
        blob = _CheckpointUnpickler(f).load()
    if "tp" in blob:  # gof_tpu's {"tp", "opt_state", "gstate", "iter"}
        tp, gstate, adam = blob["tp"], blob["gstate"], blob["opt_state"]
        gauss, app_net, app_emb = tp.gauss, tp.app_net, tp.app_emb
        if not isinstance(adam.mu_flat, np.ndarray):
            raise ValueError(f"{path}: a legacy gof_tpu checkpoint (moments stored as "
                             "TrainParams trees); gof_tpu.train.load_checkpoint migrates it, "
                             "gof_tpu_torch does not")
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
    parser.add_argument("--dp", type=int, default=1)
    ns = parser.parse_args(argv)
    if ns.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --cpu for the CPU path")
        device = torch.device("cuda")
    model_cfg = config_lib.extract(config_lib.ModelParams, ns)
    pipe = config_lib.extract(config_lib.PipelineParams, ns)
    opt = config_lib.extract(config_lib.OptimizationParams, ns)
    save_iters = sorted(set(ns.save_iterations + [opt.iterations]))
    out = training(model_cfg, opt, pipe, set(ns.test_iterations), set(save_iters),
                   set(ns.checkpoint_iterations), ns.start_checkpoint, ns.quiet, device=device,
                   profile_dir=ns.profile_dir, debug_image_interval=ns.debug_image_interval,
                   dp=ns.dp)
    print("Training complete.")
    return out


if __name__ == "__main__":
    main()
