"""What every entry hands the program: its types, built from the
benchmark's plain inputs (benchmark/generate.py), and the order in which a
closed loop visits the views."""

from __future__ import annotations

import torch

from .. import generate
from ..reference.render import LEAVES


def model_state(model: dict):
    """The program's (GaussianParams, GaussianState) over the model's own
    tensors (the training step updates them in place)."""
    from gof_tpu_torch.model import gaussians as gm

    zeros = torch.zeros_like(model["filter_3d"])
    return (gm.GaussianParams(**{k: model[k] for k in LEAVES}),
            gm.GaussianState(active=model["active"], filter_3d=model["filter_3d"],
                             max_radii2d=zeros, grad_accum=zeros.clone(),
                             grad_abs_accum=zeros.clone(), denom=zeros.clone()))


def cameras(views: list) -> list:
    """The program's cameras, uid = index."""
    from gof_tpu_torch import cameras as cameras_lib

    return [cameras_lib.Camera(v.width, v.height, v.world_view, v.full_proj, v.cam_center,
                               v.tan_fovx, v.tan_fovy, uid=i) for i, v in enumerate(views)]


class EpochWalk:
    """The views epoch after epoch, each epoch in a fresh seeded order."""

    def __init__(self, seed: int, n_views: int):
        self.seed, self.n, self.epoch, self.order = seed, n_views, 0, []

    def peek(self) -> int:
        """The view that next() will give."""
        if not self.order:
            self.order = generate.epoch_order(self.seed, self.epoch, self.n)
            self.epoch += 1
        return self.order[0]

    def next(self) -> int:
        self.peek()
        return self.order.pop(0)
