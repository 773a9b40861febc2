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
  rgb:        (1 - lambda_dssim) * L1 + lambda_dssim * (1 - SSIM)
  distortion: mean of channel 8, weight lambda_distortion from
              distortion_from_iter
  normal:     mean of 1 - dot(rendered normal in world, normal from depth),
              weight lambda_depth_normal from depth_normal_from_iter

Not ported yet; each raises NotImplementedError naming its ROADMAP item
rather than being skipped: densify_and_prune (at the first iteration where
gof_tpu would densify), checkpoints (--start_checkpoint, reaching a
--checkpoint_iterations entry), the decoupled appearance network, --dp > 1,
--debug_image_interval, --debug's fail-time dump and --profile_dir.
Tensorboard scalars are not written. There are no capacity re-jits or
overflow gates: the port sizes its buffers from each view's demand.
"""

from __future__ import annotations

import json
import os
import random
import time
from dataclasses import dataclass, fields

import numpy as np
import torch
import torch.nn.functional as F

from . import cameras as cameras_lib
from . import config as config_lib
from .data import scene as scene_lib
from .model import gaussians as gm
from .ops import render as render_lib
from .ops.blend import pixel_rays
from .utils import losses, schedules

GAUSS_FIELDS = tuple(f.name for f in fields(gm.GaussianParams))


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to gof_tpu_torch yet (ROADMAP {item})")


@dataclass
class TrainParams:
    """Trainable state: the gaussians (the appearance network waits,
    ROADMAP A.10)."""

    gauss: gm.GaussianParams


@dataclass
class AdamState:
    """Adam moments per gaussian field, shaped like the field (gof_tpu keeps
    them as lanes-major [59, CAP] buffers, a TPU layout choice)."""

    count: int
    mu: gm.GaussianParams
    nu: gm.GaussianParams


class Adam:
    """Per-group Adam of training_setup (gaussian_model.py:342-364), with
    gof_tpu's arithmetic (train.py:139-150): b1 0.9, b2 0.999, eps 1e-15,
    the position lr on gof_tpu's exponential schedule scaled by the scene
    extent and evaluated at the update count, fixed lrs for the other
    groups (features_rest at feature_lr / 20)."""

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

        return AdamState(count=0, mu=zeros(), nu=zeros())

    def update(self, grads: gm.GaussianParams, state: AdamState):
        """Returns (updates, new state); updates are added to the params."""
        b1, b2 = self.b1, self.b2
        dev = grads.xyz.device
        count_inc = state.count + 1
        cf = torch.tensor(float(count_inc), dtype=torch.float32, device=dev)
        bc1 = 1.0 - torch.pow(b1, cf)
        bc2 = 1.0 - torch.pow(b2, cf)
        lrs = self.group_lrs(state.count)
        upd, mu, nu = {}, {}, {}
        for f in GAUSS_FIELDS:
            g, m, v = getattr(grads, f), getattr(state.mu, f), getattr(state.nu, f)
            lr = torch.as_tensor(lrs[f], dtype=torch.float32).to(dev)
            m2 = b1 * m + (1.0 - b1) * g
            v2 = b2 * v + (1.0 - b2) * g * g
            upd[f] = (-lr) * (m2 / bc1) / (torch.sqrt(v2 / bc2) + self.eps)
            mu[f], nu[f] = m2, v2
        return (gm.GaussianParams(**upd),
                AdamState(count=count_inc, mu=gm.GaussianParams(**mu), nu=gm.GaussianParams(**nu)))


def make_optimizer(opt: config_lib.OptimizationParams, spatial_lr_scale: float) -> Adam:
    return Adam(opt, spatial_lr_scale)


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
                     nu=split(opt_state.nu_flat))


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
               opt: config_lib.OptimizationParams, step: int, with_reg: bool):
    """The step's loss from the rendered [9, H, W] image (train.py:355-383).
    Returns (loss, l1, ssim, distortion, depth_normal); without with_reg the
    regularizer channels are not rendered and their terms are zero."""
    rgb = image[:3]
    l1 = losses.l1_loss(rgb, gt)
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
    bg) -> (tp, opt_state, gstate, metrics), with gof_tpu's metrics dict.

    The params are updated in place (they stay autograd leaves); the
    optimizer and densification states are returned anew. `key_overflow` and
    `compact_overflow` are always False: there is no overflow gate.
    """
    del pipe  # gof_tpu's capacities and backend; the port needs neither
    if dp != 1:
        raise _not_ported(f"--dp {dp} (camera-batch data parallelism)", "A.18")
    if model_cfg.use_decoupled_appearance:
        raise _not_ported("--use_decoupled_appearance", "A.10")
    sh_degree = model_cfg.sh_degree
    kernel_size = model_cfg.kernel_size

    def step_fn(tp: TrainParams, opt_state: AdamState, gstate: gm.GaussianState,
                gt: torch.Tensor, step: int, camera: cameras_lib.Camera, bg: torch.Tensor):
        g = tp.gauss
        leaves = [getattr(g, f).requires_grad_(True) for f in GAUSS_FIELDS]
        active_degree = min(int(step) // 1000, sh_degree)
        carrier = torch.zeros((g.xyz.shape[0], 3), device=g.xyz.device, requires_grad=True)
        scales_f = gm.filtered_scaling(g, gstate.filter_3d)
        opac_f = gm.filtered_opacity(g, gstate.filter_3d)
        shs = masked_shs(g, active_degree, sh_degree)
        out = render_lib.render(camera, g.xyz, scales_f, g.rotation, opac_f, shs, sh_degree,
                                kernel_size, bg, carrier=carrier, active_mask=gstate.active,
                                with_stats=with_stats, with_reg=with_reg)
        loss, l1, ssim_val, distortion_loss, depth_normal_loss = train_loss(
            out.image, gt, camera, opt, step, with_reg)
        image = out.image[:3]
        loss.backward()
        grads = gm.GaussianParams(*[x.grad for x in leaves])
        stat_new = gm.add_densification_stats(gstate, carrier.grad, out.radii, out.visibility)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state)
            for x, f in zip(leaves, GAUSS_FIELDS):
                x.add_(getattr(updates, f))
                x.grad = None
            psnr = losses.psnr(image, gt)
            false = torch.zeros((), dtype=torch.bool, device=image.device)
            metrics = {"l1": l1.detach(), "ssim": ssim_val.detach(),
                       "distortion": distortion_loss.detach(),
                       "depth_normal": depth_normal_loss.detach(), "num_keys": out.num_keys,
                       "key_overflow": out.overflow, "psnr": psnr,
                       "compact_demand": out.compact_demand,
                       "compact_overflow": out.compact_overflow, "loss": loss.detach(),
                       "step_next": int(step) + 1}
            fl = torch.float32
            zero = torch.zeros((), dtype=fl, device=image.device)
            metrics["packed"] = torch.stack([
                loss.detach(), psnr, out.num_keys.to(fl), out.overflow.to(fl),
                out.compact_demand.to(fl), out.compact_overflow.to(fl),
                gm.num_active(stat_new).to(fl), zero, zero, false.to(fl)])
        return tp, opt_state, stat_new, metrics

    return step_fn


@torch.no_grad()
def evaluate(sc, tp: TrainParams, gstate, model_cfg, bg, device):
    """PSNR over the test split (or the first 4 training views), as gof_tpu's
    evaluate (train.py:1147-1158), building no autograd graph."""
    from .render_cli import render_eval

    cams = sc.test_cameras or sc.train_cameras[:4]
    psnrs = []
    for info in cams:
        camera, gt = sc.camera(info, device=device)
        img = render_eval(tp.gauss, gstate, camera, model_cfg, bg).image
        psnrs.append(float(losses.psnr(img[:3], torch.as_tensor(gt, device=device))))
    return {"psnr": round(float(np.mean(psnrs)), 3), "views": len(psnrs)}


def training(model_cfg: config_lib.ModelParams, opt: config_lib.OptimizationParams,
             pipe: config_lib.PipelineParams, test_iterations, save_iterations,
             checkpoint_iterations, start_checkpoint: str = "", quiet: bool = False,
             device: torch.device | str = "cuda", profile_dir: str = "",
             debug_image_interval: int = 0, dp: int = 1):
    """gof_tpu's host loop (train.py:599-1104) with one step per iteration.
    Returns (TrainParams, GaussianState)."""
    if start_checkpoint:
        raise _not_ported("--start_checkpoint (checkpoint load and resume)", "A.11")
    if debug_image_interval:
        raise _not_ported("--debug_image_interval", "A.11")
    if profile_dir:
        raise _not_ported("--profile_dir", "A.11")
    if pipe.debug:
        raise _not_ported("--debug (the fail-time snapshot dump)", "A.11")
    random.seed(0)
    np.random.seed(0)
    device = torch.device(device)

    sc = scene_lib.Scene(model_cfg.source_path, model_cfg.model_path, images=model_cfg.images,
                         resolution=model_cfg.resolution,
                         white_background=model_cfg.white_background, eval_split=model_cfg.eval,
                         load_allres=model_cfg.load_allres)
    config_lib.save_cfg(model_cfg.model_path, model_cfg, pipe, opt)

    cap = pool_capacity(sc.info.point_cloud_xyz.shape[0])
    gauss, gstate = gm.init_from_points(sc.info.point_cloud_xyz, sc.info.point_cloud_rgb,
                                        model_cfg.sh_degree, cap, device=device)
    tp = TrainParams(gauss=gauss)
    tx = make_optimizer(opt, sc.cameras_extent)
    opt_state = tx.init(tp)

    cam_meta = sc.all_cameras_meta(sc.train_cameras, device=device)
    gstate.filter_3d = gm.compute_3d_filter(tp.gauss.xyz, gstate.active, *cam_meta)

    bg = torch.tensor([1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0],
                      device=device)
    reg_start = min(opt.distortion_from_iter, opt.depth_normal_from_iter)
    first_iter = 0
    with_stats = first_iter + 1 <= opt.densify_until_iter
    with_reg = first_iter + 1 >= reg_start

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

    log_path = os.path.join(model_cfg.model_path, "train_log.jsonl")
    ema_loss = None
    pending = []  # unread packed metrics, read every 10 iterations
    t_start = time.time()
    iteration = first_iter
    with open(log_path, "a") as logf:
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

            camera, gt = get_cam(sc.train_cameras[next_id()])
            tp, opt_state, gstate, metrics = train_step(tp, opt_state, gstate, gt, iteration,
                                                        camera, bg)

            # --- host control flow (train.py:921-943) ---
            if iteration < opt.densify_until_iter:
                if (iteration > opt.densify_from_iter
                        and iteration % opt.densification_interval == 0):
                    raise _not_ported(f"densify_and_prune (due at iteration {iteration})",
                                      "A.8")
                if iteration % opt.opacity_reset_interval == 0 or (
                        model_cfg.white_background and iteration == opt.densify_from_iter):
                    with torch.no_grad():
                        new = gm.reset_opacity(tp.gauss, gstate.filter_3d)
                        tp.gauss.opacity.copy_(new.opacity)
            elif iteration % 100 == 0:
                gstate.filter_3d = gm.compute_3d_filter(tp.gauss.xyz.detach(), gstate.active,
                                                        *cam_meta)

            pending.append(metrics["packed"])
            if iteration % 10 == 0 or iteration == first_iter + 1:
                mp = torch.stack(pending).cpu().numpy()  # one host read
                pending.clear()
                loss = float(mp[-1, 0])
                ema_loss = loss if ema_loss is None else 0.6 * loss + 0.4 * ema_loss
                rec = {"iter": iteration, "loss": round(loss, 5), "ema": round(ema_loss, 5),
                       "psnr": round(float(mp[-1, 1]), 3), "points": int(mp[-1, 6]),
                       "keys": int(mp[:, 2].max()), "elapsed": round(time.time() - t_start, 1)}
                logf.write(json.dumps(rec) + "\n")
                logf.flush()
                if not quiet and iteration % 100 == 0:
                    print(rec)

            if iteration in test_iterations:
                report = evaluate(sc, tp, gstate, model_cfg, bg, device)
                if not quiet:
                    print(f"[{iteration}] eval: {report}")
                logf.write(json.dumps({"iter": iteration, "eval": report}) + "\n")
                logf.flush()

            if iteration in save_iterations:
                path = os.path.join(model_cfg.model_path, "point_cloud",
                                    f"iteration_{iteration}", "point_cloud.ply")
                scene_lib.save_gaussians_ply(path, tp.gauss, gstate, model_cfg.sh_degree)

            if iteration in checkpoint_iterations:
                raise _not_ported(f"checkpoint save (due at iteration {iteration})", "A.11")
    return tp, gstate


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
