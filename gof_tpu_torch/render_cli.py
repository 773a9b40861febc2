"""Render train/test sets from a trained model
(python -m gof_tpu_torch.render_cli; counterpart of gof_tpu/render_cli.py).

Writes {model}/{split}/ours_{iter}/renders/NNNNN.png and gt/NNNNN.png pairs.
Runs on CUDA (raises when CUDA is absent); `--cpu` selects the plain
PyTorch path on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def save_png(path: str, img_chw: np.ndarray) -> None:
    from PIL import Image

    arr = np.clip(np.asarray(img_chw), 0, 1)
    Image.fromarray((arr.transpose(1, 2, 0) * 255 + 0.5).astype(np.uint8)).save(path)


@torch.no_grad()
def render_eval(gauss, gstate, camera, model_cfg, bg, backend: str = "pallas"):
    """Full-degree eval render of one view (gof_tpu train.py:1164-1200),
    building no autograd graph, through the render backend `backend`
    (the model directory's pipeline setting in the CLIs). Buffers are sized
    to each view's demand, so there is no overflow to retry. The
    densification statistics feed only the backward, so their payload
    columns are left out. Returns the RenderOut. One `view` unit of the
    program's spans (utils/trace.py), id the camera's uid. The model's
    leaves go to the render as they are: its preprocess applies the 3D
    filter and reads the two SH tables where they lie."""
    from .ops import preprocess
    from .ops import render as render_lib
    from .utils import trace

    with trace.unit("view", camera.uid, gauss.xyz):
        return render_lib.render(
            camera, gauss.xyz, None, gauss.rotation, None, None, model_cfg.sh_degree,
            model_cfg.kernel_size, bg, active_mask=gstate.active, with_stats=False,
            backend=backend, leaves=preprocess.Leaves.of(gauss, gstate),
        )


def render_set(scene, gauss, gstate, model_cfg, bg, split: str, cams, iteration: int, device,
               backend: str = "pallas"):
    """Render one split; returns per-view stats [{"num_keys", "ms"}]."""
    base = os.path.join(model_cfg.model_path, split, f"ours_{iteration}")
    rdir = os.path.join(base, "renders")
    gdir = os.path.join(base, "gt")
    os.makedirs(rdir, exist_ok=True)
    os.makedirs(gdir, exist_ok=True)
    stats = []
    for idx, info in enumerate(cams):
        camera, gt = scene.camera(info, device=device)
        t0 = time.perf_counter()
        out = render_eval(gauss, gstate, camera, model_cfg, bg, backend)
        rgb = out.image[:3].cpu().numpy()  # waits for the device
        ms = (time.perf_counter() - t0) * 1e3
        stats.append({"num_keys": int(out.num_keys), "ms": ms})
        save_png(os.path.join(rdir, f"{idx:05d}.png"), rgb)
        save_png(os.path.join(gdir, f"{idx:05d}.png"), gt)
        print(f"{split} {idx + 1}/{len(cams)}: {stats[-1]['num_keys']} key slots, {ms:.1f} ms")
    return stats


def main(argv=None):
    from . import config as config_lib
    from .data import scene as scene_lib

    parser = argparse.ArgumentParser(description="gof_tpu_torch render")
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    ns = parser.parse_args(argv)
    if ns.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --cpu for the CPU path")
        device = torch.device("cuda")

    model_cfg, pipe, _opt = config_lib.load_cfg(ns.model_path)
    model_cfg.model_path = ns.model_path
    iteration = ns.iteration if ns.iteration > 0 else _latest_iteration(ns.model_path)

    sc = scene_lib.Scene(
        model_cfg.source_path, "", images=model_cfg.images,
        resolution=model_cfg.resolution, white_background=model_cfg.white_background,
        eval_split=model_cfg.eval, shuffle=False,
    )
    ply_path = os.path.join(ns.model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply")
    gauss, gstate = scene_lib.load_gaussians_ply(ply_path, model_cfg.sh_degree, device=device)
    bg = torch.tensor([1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0],
                      device=device)
    stats = {}
    if not ns.skip_train:
        stats["train"] = render_set(sc, gauss, gstate, model_cfg, bg, "train", sc.train_cameras,
                                    iteration, device, pipe.backend)
    if not ns.skip_test and sc.test_cameras:
        stats["test"] = render_set(sc, gauss, gstate, model_cfg, bg, "test", sc.test_cameras,
                                   iteration, device, pipe.backend)
    print("Rendering complete.")
    return stats


def _latest_iteration(model_path: str) -> int:
    pc = os.path.join(model_path, "point_cloud")
    iters = [int(d.split("_")[1]) for d in os.listdir(pc) if d.startswith("iteration_")]
    return max(iters)


if __name__ == "__main__":
    main()
