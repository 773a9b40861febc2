"""gof_tpu_torch — Gaussian Opacity Fields in PyTorch, with CUDA kernels for Hopper.

The PyTorch counterpart of `gof_tpu`, module for module: the same module
paths, public names, shapes and channel layouts, so the same inputs can be fed
to both packages and compared. Plain tensor code is PyTorch; every kernel that
`gof_tpu` writes in Pallas is hand-written CUDA C++ here (`csrc/`), built with
nvcc for sm_90a on first use and bound through ctypes. On CPU tensors each
kernel wrapper runs the kernel's plain PyTorch version instead.

Ported so far: the serving path (constants, transforms, sh, cameras,
config, model.gaussians, utils.ply, data.{colmap,readers,scene},
ops.{quadrics,class_gather,binning,rasterize,tiled_ref,render}, render_cli)
one training step with its host loop (ops.{rasterize backward, reduce,
blend, knn}, utils.{losses,schedules}, train, with model.appearance),
opacity-field mesh extraction (ops.integrate, mesh.{tetmesh,extract},
extract_mesh) and the DTU/TNT chain after it (mesh.tsdf,
extract_mesh_tsdf, metrics, utils.lpips, create_fused_ply,
eval.{geometry,dtu,tnt}, scripts.{make_procedural_scene,
eval_procedural_geometry}) and the parallel paths (parallel.{sharding,
steps}: camera-batch data parallelism over torch.distributed, scene
parallelism, point-sharded field evaluation; scripts.run_benchmarks). This
package never imports jax or gof_tpu.
"""

__version__ = "0.1.0"

import torch as _torch

# gof_tpu pins "highest" f32 matmul precision; the counterpart here is to
# forbid TF32 in matmuls and cuDNN convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
# Convolutions (the appearance network, SSIM's blur, LPIPS) run on torch's
# own CUDA path (im2col and cuBLAS GEMMs; depthwise kernels), not cuDNN,
# which picks its algorithm by heuristics and process state, some of them
# summing by atomics: the same inputs then give other bits from run to run.
_torch.backends.cudnn.enabled = False
