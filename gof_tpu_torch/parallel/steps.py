"""Rank entry points for `sharding.launch` over host arrays: data-parallel
and scene-parallel train steps run from a `case` of numpy inputs, each
rank's state returned as train.checkpoint_blob. A spawned rank imports its
entry function by module path, so these live in the package; the tests
(against gof_tpu) and chip_smoke.py (on the card) drive them.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .. import train
from ..model import gaussians as gm
from ..ops import class_gather, rasterize, reduce
from . import sharding

# the train step's kernels: K2, K1, K3, K4
COUNTERS = (class_gather.EXPAND, rasterize.FWD, rasterize.BWD, reduce.REDUCE)


def train_case(params, state, gts, cams, ids, opt, model_cfg, pipe, spatial_lr_scale: float,
               step: int, with_stats: bool = True, with_reg: bool = True, adam=None) -> dict:
    """A case: a model as numpy fields (gm.from_numpy's layout), the views'
    ground truths [V, 3, H, W] and cameras (each Camera.numpy()), ids
    [n_steps, world] (at step k rank r renders view ids[k, r]), the configs,
    the scene extent Adam scales the position lr by, the first step's index
    (each later one counts on), the phase flags and Adam's state (train.
    from_numpy's layout; zero moments when None)."""
    return dict(params=params, state=state, gts=np.asarray(gts, np.float32), cams=list(cams),
                ids=np.asarray(ids, np.int64).reshape(len(ids), -1), opt=opt,
                model_cfg=model_cfg, pipe=pipe, spatial_lr_scale=spatial_lr_scale, step=step,
                with_stats=with_stats, with_reg=with_reg, adam=adam)


def build(case: dict, device, group=None) -> SimpleNamespace:
    """The case on `device`: its step (build_train_step with dp =
    group.world; dp == 1 without a group), the state (tp, opt_state,
    gstate), the views (gts, cams) and the background."""
    g, s = gm.from_numpy(case["params"], case["state"], device)
    tp = train.TrainParams(gauss=g)
    tx = train.make_optimizer(case["opt"], case["spatial_lr_scale"])
    opt_state = tx.init(tp) if case["adam"] is None else train.from_numpy(case["adam"], g, device)
    step = train.build_train_step(case["opt"], case["model_cfg"], case["pipe"], tx,
                                  with_stats=case["with_stats"], with_reg=case["with_reg"],
                                  dp=1 if group is None else group.world, group=group)
    return SimpleNamespace(
        step=step, tp=tp, opt_state=opt_state, gstate=s,
        gts=torch.as_tensor(case["gts"], device=device), cams=[c.to(device) for c in case["cams"]],
        bg=torch.zeros(3, device=device))


def run(case: dict, device, group=None) -> dict:
    """The case's steps on one rank (rank 0 without a group): its final
    state (checkpoint_blob), the last step's metrics as host numbers and
    the kernels' launches over the steps."""
    b = build(case, device, group)
    rank = 0 if group is None else group.rank
    for c in COUNTERS:
        c.launches = 0
    for i, row in enumerate(case["ids"]):
        b.tp, b.opt_state, b.gstate, m = b.step(b.tp, b.opt_state, b.gstate, b.gts[row[rank]],
                                               case["step"] + i, b.cams[row[rank]], b.bg)
    return {"state": train.checkpoint_blob(b.tp, b.opt_state, b.gstate, case["step"] + i),
            "metrics": {k: float(v) for k, v in m.items() if k not in ("packed", "step_next")},
            "launches": {c.name: c.launches for c in COUNTERS}}


def dp_steps(group, cases: list) -> list:
    """launch entry: each case's data-parallel steps on this rank, each from
    its own state."""
    return [run(case, group.device, group) for case in cases]


def scene_steps(group, cases: list) -> dict:
    """launch entry: rank r steps its own scene, cases[r] (its ids[k, 0] at
    step k), through sharding.build_scene_parallel_step; its final state
    and every rank's loss of each step [n_steps, world]."""
    case = cases[group.rank]
    b = build(case, group.device)

    def single_scene_step(tp, opt_state, gstate, gt, camera, step):
        tp, opt_state, gstate, m = b.step(tp, opt_state, gstate, gt, step, camera, b.bg)
        return tp, opt_state, gstate, m["loss"]

    par = sharding.build_scene_parallel_step(single_scene_step, group)
    losses = []
    for i, row in enumerate(case["ids"]):
        b.tp, b.opt_state, b.gstate, lk = par(b.tp, b.opt_state, b.gstate, b.gts[row[0]],
                                              b.cams[row[0]], case["step"] + i)
        losses.append(lk.cpu().numpy())
    return {"state": train.checkpoint_blob(b.tp, b.opt_state, b.gstate, case["step"] + i),
            "losses": np.stack(losses)}
