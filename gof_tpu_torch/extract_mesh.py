"""Level-set mesh extraction CLI
(python -m gof_tpu_torch.extract_mesh -m <model>; counterpart of
gof_tpu/extract_mesh.py).

Loads the trained model and its training cameras, runs marching tetrahedra
with binary-search refinement over the opacity field, and writes
{model}/test/ours_{iter}/fusion/mesh_binary_search_7.ply. Runs on CUDA
(raises when CUDA is absent); `--cpu` selects the plain PyTorch path on the
CPU. Returns the counts and stage seconds of
mesh.extract.extract_level_set_mesh.
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description="gof_tpu_torch mesh extraction")
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=30_000)
    parser.add_argument("--filter_mesh", action="store_true", default=True)
    parser.add_argument("--no_filter_mesh", dest="filter_mesh", action="store_false")
    parser.add_argument("--near", type=float, default=0.02)  # extract_mesh.py:151
    parser.add_argument("--far", type=float, default=1e6)
    parser.add_argument("--binary_steps", type=int, default=8)
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    parser.add_argument("--shard", type=int, default=0,
                        help="shard field evaluation points across N devices (not ported)")
    parser.add_argument("--texture_mesh", action="store_true",
                        help="write vertex colors from the integrated color "
                             "field (reference extract_mesh.py:106-111)")
    ns = parser.parse_args(argv)
    if ns.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --cpu for the CPU path")
        device = torch.device("cuda")

    from . import config as config_lib
    from .data import scene as scene_lib
    from .mesh import extract

    model_cfg, _pipe, _opt = config_lib.load_cfg(ns.model_path)
    model_cfg.model_path = ns.model_path
    pc_dir = os.path.join(ns.model_path, "point_cloud")
    iteration = ns.iteration
    if not os.path.isdir(os.path.join(pc_dir, f"iteration_{iteration}")):
        iteration = max(int(d.split("_")[1]) for d in os.listdir(pc_dir))
        print(f"iteration {ns.iteration} not found; using {iteration}")

    sc = scene_lib.Scene(
        model_cfg.source_path, "", images=model_cfg.images,
        resolution=model_cfg.resolution, white_background=model_cfg.white_background,
        eval_split=model_cfg.eval, shuffle=False,
    )
    gauss, gstate = scene_lib.load_gaussians_ply(
        os.path.join(pc_dir, f"iteration_{iteration}", "point_cloud.ply"),
        model_cfg.sh_degree, device=device,
    )
    cams = [sc.camera(info, device=device)[0] for info in sc.train_cameras]
    cam_meta = sc.all_cameras_meta(sc.train_cameras, device=device)

    out_dir = os.path.join(ns.model_path, "test", f"ours_{iteration}", "fusion")
    result = extract.extract_level_set_mesh(
        gauss, gstate, cams, cam_meta, out_dir,
        sh_degree=model_cfg.sh_degree, kernel_size=model_cfg.kernel_size,
        n_binary_steps=ns.binary_steps, filter_faces=ns.filter_mesh, near=ns.near,
        far=ns.far, shard=ns.shard, texture_mesh=ns.texture_mesh,
        bg=[1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0],
    )
    print(f"mesh written to {result['path']}")
    return result


if __name__ == "__main__":
    main()
