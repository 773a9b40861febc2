"""Export a Mip-Splatting-compatible PLY with the 3D filter fused in
(python -m gof_tpu_torch.create_fused_ply -m <model> --output_ply
fused/point_cloud.ply; counterpart of gof_tpu/create_fused_ply.py).

save_fused_ply (gaussian_model.py:410-430): scale' = log sqrt(s^2 + f^2),
opacity' = logit(sigmoid(o) * sqrt(det(s^2) / det(s^2 + f^2))); the
filter_3D attribute is dropped. Runs on CUDA (raises when CUDA is absent);
`--cpu` selects the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description="gof_tpu_torch fused PLY export")
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=30_000)
    parser.add_argument("--output_ply", type=str, default="fused/point_cloud.ply")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    ns = parser.parse_args(argv)
    if ns.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --cpu for the CPU path")
        device = torch.device("cuda")

    from . import config as config_lib
    from .data import scene as scene_lib
    from .model import gaussians as gm
    from .utils import ply

    model_cfg, _pipe, _opt = config_lib.load_cfg(ns.model_path)
    pc_dir = os.path.join(ns.model_path, "point_cloud")
    iteration = ns.iteration
    if not os.path.isdir(os.path.join(pc_dir, f"iteration_{iteration}")):
        iteration = max(int(d.split("_")[1]) for d in os.listdir(pc_dir))
    params, state = scene_lib.load_gaussians_ply(
        os.path.join(pc_dir, f"iteration_{iteration}", "point_cloud.ply"),
        model_cfg.sh_degree, device=device,
    )
    idx = torch.nonzero(state.active).squeeze(1)

    def host(x):
        return x[idx].detach().cpu().numpy()

    n = len(idx)
    scales_f = host(gm.filtered_scaling(params, state.filter_3d))
    opac_f = np.clip(host(gm.filtered_opacity(params, state.filter_3d)), 1e-6, 1 - 1e-6)
    xyz = host(params.xyz)
    f_dc = host(params.features_dc).reshape(n, -1)
    f_rest = host(params.features_rest).transpose(0, 2, 1).reshape(n, -1)
    rot = host(params.rotation)

    props = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
             "nx": np.zeros(n), "ny": np.zeros(n), "nz": np.zeros(n)}
    for i in range(f_dc.shape[1]):
        props[f"f_dc_{i}"] = f_dc[:, i]
    for i in range(f_rest.shape[1]):
        props[f"f_rest_{i}"] = f_rest[:, i]
    props["opacity"] = np.log(opac_f / (1 - opac_f))
    for i in range(3):
        props[f"scale_{i}"] = np.log(scales_f[:, i])
    for i in range(4):
        props[f"rot_{i}"] = rot[:, i]

    out = os.path.join(ns.model_path, ns.output_ply)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    ply.write_ply(out, props)
    print(f"fused PLY with {n} gaussians -> {out}")
    return out


if __name__ == "__main__":
    main()
