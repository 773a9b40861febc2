"""Image metrics over rendered sets (python -m gof_tpu_torch.metrics -m
<model>; counterpart of gof_tpu/metrics.py).

Walks {model}/test/ours_*/renders against gt, computes PSNR / SSIM (and
LPIPS-VGG when converted weights are given; without them LPIPS is null with
its reason), and writes results.json + per_view.json in gof_tpu's format.
Runs on CUDA (raises when CUDA is absent); `--cpu` selects the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _load(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32).transpose(2, 0, 1) / 255.0


@torch.no_grad()
def evaluate_dir(base: str, lpips_weights: str = "", device: torch.device | str = "cpu"):
    """PSNR, SSIM and LPIPS of base/renders/* against base/gt/*: the means
    and "per_view"."""
    from .utils import losses
    from .utils.lpips import lpips_fn

    rdir = os.path.join(base, "renders")
    gdir = os.path.join(base, "gt")
    names = sorted(os.listdir(rdir))
    psnrs, ssims, lpipss, per_view = [], [], [], {}
    # weights resolve: explicit flag > GOF_LPIPS_WEIGHTS env; when absent the
    # output is self-describing (LPIPS null + reason) rather than silently
    # incomplete
    lpips_weights = lpips_weights or os.environ.get("GOF_LPIPS_WEIGHTS", "")
    lp = lpips_fn(lpips_weights, device)
    for name in names:
        r = torch.as_tensor(_load(os.path.join(rdir, name)), device=device)
        g = torch.as_tensor(_load(os.path.join(gdir, name)), device=device)
        p = float(losses.psnr(r, g))
        s = float(losses.ssim(r, g))
        l = float(lp(r, g)) if lp is not None else None
        psnrs.append(p)
        ssims.append(s)
        if l is not None:
            lpipss.append(l)
        per_view[name] = {"PSNR": p, "SSIM": s, "LPIPS": l}
    out = {
        "PSNR": float(np.mean(psnrs)),
        "SSIM": float(np.mean(ssims)),
        "LPIPS": float(np.mean(lpipss)) if lpipss else None,
        "per_view": per_view,
    }
    if not lpipss:
        out["LPIPS_reason"] = (
            "weights unavailable: convert with scripts/convert_lpips_weights"
            ".py and pass --lpips_weights or set GOF_LPIPS_WEIGHTS")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="gof_tpu_torch metrics")
    parser.add_argument("-m", "--model_paths", nargs="+", required=True)
    parser.add_argument("--lpips_weights", default="", help="converted VGG16+LPIPS .npz")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    ns = parser.parse_args(argv)
    if ns.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --cpu for the CPU path")
        device = torch.device("cuda")

    for mp in ns.model_paths:
        full = {}
        per_view_all = {}
        test_dir = os.path.join(mp, "test")
        if not os.path.isdir(test_dir):
            print(f"{mp}: no test renders")
            continue
        for method in sorted(os.listdir(test_dir)):
            res = evaluate_dir(os.path.join(test_dir, method), ns.lpips_weights, device)
            pv = res.pop("per_view")
            full[method] = res
            per_view_all[method] = pv
            print(f"{mp} {method}: PSNR {res['PSNR']:.3f}  SSIM {res['SSIM']:.4f}")
        with open(os.path.join(mp, "results.json"), "w") as f:
            json.dump(full, f, indent=2)
        with open(os.path.join(mp, "per_view.json"), "w") as f:
            json.dump(per_view_all, f, indent=2)


if __name__ == "__main__":
    main()
