"""Configuration (counterpart of gof_tpu/config.py).

Reads and writes the `cfg_args.json` that gof_tpu persists in a model
directory, and turns the dataclasses into argparse flags with gof_tpu's names
and defaults (`add_group`, `extract`). The pipeline's `backend` picks the
render path, as in gof_tpu: "pallas" (the default) runs the CUDA kernels on
CUDA tensors and their plain versions on CPU tensors, "xla" the tiled
reference renderer (ops/tiled_ref.py) on either device. The port accepts
and ignores `key_capacity`, `compact_capacity` and `live_capacity`: it sizes
its buffers from each view's real demand.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass


@dataclass
class ModelParams:
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False
    sh_degree: int = 3
    # Mip-Splatting 2D dilation added to the screen-space covariance diagonal
    kernel_size: float = 0.0
    load_allres: bool = False
    sample_more_highres: bool = False
    use_decoupled_appearance: bool = False


@dataclass
class PipelineParams:
    # the render path: "pallas" (the kernels) | "xla" (ops/tiled_ref.py)
    backend: str = "pallas"
    # the capacities below are read for compatibility with gof_tpu's
    # cfg_args.json; the port sizes its buffers from the demand
    debug: bool = False
    key_capacity: int = 1 << 21
    compact_capacity: int = 0
    capacity_headroom: float = 1.3
    live_capacity: int = 0


@dataclass
class OptimizationParams:
    iterations: int = 30_000
    position_lr_init: float = 0.000_16
    position_lr_final: float = 0.000_001_6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    appearance_embeddings_lr: float = 0.001
    appearance_network_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_distortion: float = 100.0
    lambda_depth_normal: float = 0.05
    distortion_from_iter: int = 15_000
    depth_normal_from_iter: int = 15_000
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002


def add_group(parser: argparse.ArgumentParser, cls) -> None:
    """Register a dataclass's fields as CLI flags (gof_tpu's ParamGroup-style
    reflection: a bool becomes a store_true flag), with the short aliases
    -s, -m and -r."""
    for f in dataclasses.fields(cls):
        name = f"--{f.name}"
        if f.type in ("bool", bool):
            parser.add_argument(name, action="store_true", default=f.default)
        else:
            typ = {"int": int, "float": float, "str": str}.get(str(f.type), type(f.default))
            parser.add_argument(name, type=typ, default=f.default)
    for short, long in (("-s", "--source_path"), ("-m", "--model_path"), ("-r", "--resolution")):
        for a in parser._actions:
            if a.option_strings == [long]:
                a.option_strings.insert(0, short)
                parser._option_string_actions[short] = a


def extract(cls, ns: argparse.Namespace):
    return cls(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)})


def save_cfg(model_path: str, model: ModelParams, pipe: PipelineParams, opt: OptimizationParams) -> None:
    os.makedirs(model_path, exist_ok=True)
    cfg = {
        "model": dataclasses.asdict(model),
        "pipeline": dataclasses.asdict(pipe),
        "optimization": dataclasses.asdict(opt),
    }
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(cfg, f, indent=2)


def load_cfg(model_path: str):
    """Load a persisted config as (ModelParams, PipelineParams,
    OptimizationParams). Keys this package does not know are skipped."""
    with open(os.path.join(model_path, "cfg_args.json")) as f:
        cfg = json.load(f)

    def build(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    return (
        build(ModelParams, cfg["model"]),
        build(PipelineParams, cfg["pipeline"]),
        build(OptimizationParams, cfg["optimization"]),
    )
