"""Entry "train": the program's training step, `train.build_train_step`, as
train.py runs it late in training (regularizers on, statistics off), one
camera a step, with temporal liveness culling.

Set-up builds one training state (the model from the seed, a fresh Adam
state, the liveness cache at "no bound" for every view) and drives it
through the traffic's warm epochs with the window's own call and feed (each epoch visits every
view once in a seeded random order, as train.py draws its cameras), then
through `check_steps` more steps, the first to revisit views with the bound
of their previous visit in force, and hands that same state to the window.

Two stretches are recorded for the check. The first three steps (first
visits, no bound in force): each step's loss, the gradient of each leaf at
the first step (from Adam's first moment, m = (1 - b1) g), and each leaf's
change after the third. The bounded steps: the state they start from (on
the host), each step's view, the bound in force, the program's skip flag,
its next bound and its loss, and each leaf's change after the last.
"""

from __future__ import annotations

import math
import statistics

import torch

from .. import generate
from ..counts import blend as blend_counts
from ..counts import step as step_counts
from ..reference import gof
from ..reference import render as ref
from . import program
from .program import LEAVES

B1 = 0.9
SKIP = 9  # the skip flag's column of the program's packed step counters
LOSS = 0


class Runner:
    unit_name = "step"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from gof_tpu_torch import config as config_lib, train
        from gof_tpu_torch.ops import binning

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.train_cfg = {**cfg["train"], "step": traffic["step"]}
        self.views = generate.views(cfg["cameras"], device, traffic["views"])
        n = len(self.views)
        W, H = self.views[0].width, self.views[0].height
        self.gts = generate.targets(seed, n, W, H, device)
        self.bg = torch.zeros(3, device=device)
        model = generate.gaussians(cfg, seed, device)
        opt = config_lib.OptimizationParams(**cfg["optimization"])
        model_cfg = config_lib.ModelParams(sh_degree=cfg["train"]["sh_degree"],
                                           kernel_size=cfg["train"]["kernel_size"])
        self.tx = train.make_optimizer(opt, cfg["train"]["spatial_lr_scale"])
        self.step_fn = train.build_train_step(opt, model_cfg, config_lib.PipelineParams(),
                                              self.tx, with_stats=False, with_reg=True)
        gauss, self.gstate = program.model_state(model)
        self.tp = train.TrainParams(gauss=gauss)
        self.opt_state = self.tx.init(self.tp)
        self.cams = program.cameras(self.views)
        ntx, nty = binning.tile_grid(W, H)
        self.chunk = binning.CHUNK_SIZE  # rows per unit of a liveness bound
        self.cache = torch.full((n, ntx * nty), binning.LIM_INF, dtype=torch.int32,
                                device=device)
        self.step_i = int(traffic["step"])
        self.units_done = 0
        self.phase = "warm"
        self.packed = {"warm": [], "window": [], "trace": []}
        self.visits = {"warm": [], "window": [], "trace": []}
        self.traced_model = None
        self.walk = program.EpochWalk(seed, n)
        self.first = self._first_steps()
        for _ in range(int(traffic["warm_epochs"]) * n - 3):
            self.unit()
        self.bounded = self._bounded_steps(int(traffic["check_steps"]))

    def unit(self):
        v = self.walk.next()
        self.tp, self.opt_state, self.gstate, m = self.step_fn(
            self.tp, self.opt_state, self.gstate, self.gts[v], self.step_i, self.cams[v],
            self.bg, lim=self.cache[v])
        self.cache[v] = m["live_new_lim"]
        self.step_i = m["step_next"]
        self.packed[self.phase].append(m["packed"])
        self.visits[self.phase].append(v)
        self.units_done += 1
        return None

    def _first_steps(self) -> dict:
        """Steps 1-3, recorded for the check (norms in float64)."""
        losses = []
        for i in range(3):
            self.unit()
            losses.append(self.packed["warm"][-1][LOSS])
            if i == 0:
                grad = {k: torch.linalg.norm(getattr(self.opt_state.mu, k).double() / (1 - B1))
                        for k in LEAVES}
        start = generate.gaussians(self.cfg, self.seed, self.device)
        change = {k: torch.linalg.norm((getattr(self.tp.gauss, k).detach() - start[k]).double())
                  for k in LEAVES}
        return {"views": list(self.visits["warm"][:3]), "loss": [float(x) for x in losses],
                "grad": {k: float(x) for k, x in grad.items()},
                "change": {k: float(x) for k, x in change.items()}}

    def _bounded_steps(self, k: int) -> dict:
        """The next k steps, each with its view's bound in force, recorded
        for the check: the state they start from (on the host), per step
        the view, the bound in force and the program's next bound (in rows
        kept per tile), its skip flag and loss, and each leaf's change after
        the k (norms in float64)."""
        g, st = self.tp.gauss, self.opt_state

        def host(x):
            return x.detach().to("cpu", copy=True)

        start = {"params": {f: host(getattr(g, f)) for f in LEAVES},
                 "mu": {f: host(getattr(st.mu, f)) for f in LEAVES},
                 "nu": {f: host(getattr(st.nu, f)) for f in LEAVES},
                 "count": int(st.count), "step": int(self.step_i)}
        before = {f: getattr(g, f).detach().clone() for f in LEAVES}
        steps = []
        for _ in range(k):
            v = self.walk.peek()
            bound = self.bound_rows(self.cache[v])
            self.unit()
            steps.append({"view": v, "bound": bound.cpu(),
                          "next": self.bound_rows(self.cache[v]).cpu(),
                          "skip": bool(self.packed["warm"][-1][SKIP]),
                          "loss": float(self.packed["warm"][-1][LOSS])})
        g = self.tp.gauss
        change = {f: float(torch.linalg.norm((getattr(g, f).detach() - before[f]).double()))
                  for f in LEAVES}
        return {"start": start, "steps": steps, "change": change}

    def bound_rows(self, lim: torch.Tensor) -> torch.Tensor:
        """A cache row (per tile, in the program's chunks; LIM_INF = none)
        as the rows it keeps at the head of each tile's list."""
        return torch.clamp(lim.to(torch.int64), max=1 << 22) * self.chunk

    def end_to_end(self, win) -> dict:
        return {"train_iters_per_s": win.units / win.seconds}

    def counters(self, phase: str) -> torch.Tensor:
        """The program's packed step counters of a phase, [steps, 10]: loss,
        psnr, num_keys, key_overflow, compact_demand, compact_overflow,
        active, live_demand, live_overflow, skipped."""
        return torch.stack(self.packed[phase]).double().cpu()

    def before_trace(self):
        """Keep the state the traced steps start from: work() counts their
        pairs on it."""
        g = self.tp.gauss
        self.traced_model = {**{f: getattr(g, f).detach().clone() for f in LEAVES},
                             "filter_3d": self.gstate.filter_3d, "active": self.gstate.active}

    def work(self) -> dict:
        """The traced steps' operations and bytes by the benchmark's counts,
        each step's pairs counted on the benchmark's binning of its view at
        the state the traced steps start from."""
        model = self.traced_model
        tc = self.train_cfg
        per_view = {v: view_pairs(model, self.views[v], self.bg, tc)
                    for v in set(self.visits["trace"])}
        tot = {"k1": {"ops": 0, "bytes": 0}, "k3": {"ops": 0, "bytes": 0},
               "k4": {"ops": 0, "bytes": 0}, "step_ops": 0.0, "steps": 0}
        P = model["xyz"].shape[0]
        # which traced steps ran their backward: the program's skip flag
        # says which work happened; what the work costs is the benchmark's
        ran = (self.counters("trace")[:, SKIP] == 0).tolist()
        for v, backward in zip(self.visits["trace"], ran):
            c = per_view[v]
            parts = {"k1": blend_counts.k1(c["visited"], c["active"], c["rows"], c["pixels"],
                                           c["tiles"], True),
                     "k3": blend_counts.k3(c["visited"], c["active"], c["rows"], c["pixels"],
                                           True, False),
                     "k4": blend_counts.k4(c["rows"], c["gaussians"])}
            if not backward:
                parts["k3"] = parts["k4"] = {"ops": 0, "bytes": 0}
            for k, d in parts.items():
                tot[k]["ops"] += d["ops"]
                tot[k]["bytes"] += d["bytes"]
            tot["step_ops"] += step_counts.ops(P, c["pixels"], parts["k1"]["ops"],
                                               parts["k3"]["ops"], parts["k4"]["ops"], backward)
            tot["steps"] += 1
        return tot

    def release(self):
        for k in ("tp", "opt_state", "gstate", "cache", "step_fn", "packed", "traced_model"):
            setattr(self, k, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Both stretches against the plain reference's steps from the same
        inputs (see compare_first and compare_bounded). The first three start
        from the seed's model; the bounded steps from the program's state
        before them, with the program's bounds in force: the reference
        judges the skip decision and the next bound of each, and follows
        the steps that run."""
        first, bounded = self.first, self.bounded
        self.release()
        model = generate.gaussians(self.cfg, self.seed, self.device)
        out = compare_first(first, self.reference_first(model, first["views"], torch.float32))
        out.update(compare_bounded(self.program_bounded(bounded),
                                   self.reference_bounded(model, bounded, torch.float32)))
        return out

    def reference_first(self, model: dict, vs: list, dtype) -> dict:
        start = ref.fresh_start(model, self.traffic["step"])
        return ref.train_steps(start, model, [self.views[v] for v in vs],
                               [self.gts[v] for v in vs], [None] * len(vs), self.bg,
                               self.cfg["optimization"], self.train_cfg, dtype)

    def reference_bounded(self, model: dict, bounded: dict, dtype) -> dict:
        steps = bounded["steps"]
        return ref.train_steps(bounded["start"], model, [self.views[s["view"]] for s in steps],
                               [self.gts[s["view"]] for s in steps],
                               [s["bound"] for s in steps], self.bg, self.cfg["optimization"],
                               self.train_cfg, dtype, follow=[s["skip"] for s in steps])

    @staticmethod
    def program_bounded(bounded: dict) -> dict:
        return {"steps": bounded["steps"], "change": bounded["change"]}


def _gap(got: float, want: float, floor: float) -> float:
    return abs(got - want) / max(want, floor, 1e-30)


def _moved(grad: dict) -> list:
    """The leaves the reference moves: those whose first gradient is at
    least a thousandth of the median leaf's (the others move by Adam's
    round-off alone)."""
    med = statistics.median(grad.values())
    return [k for k in LEAVES if grad[k] >= 1e-3 * med]


def compare_first(got: dict, want: dict) -> dict:
    """The first three steps: the largest relative gap of a step's loss,
    of a leaf's first gradient norm and of a leaf's change norm (the gap
    between the two norms over the larger of the reference's norm of that
    leaf and of the median leaf), over the leaves the reference moves."""
    loss = max(abs(g - w["loss"]) / max(abs(w["loss"]), 1e-12)
               for g, w in zip(got["loss"], want["steps"]))
    med_g = statistics.median(want["grad"].values())
    grad = max(_gap(got["grad"][k], want["grad"][k], med_g) for k in LEAVES)
    moved = _moved(want["grad"])
    med_c = statistics.median(want["change"][k] for k in moved)
    change = max(_gap(got["change"][k], want["change"][k], med_c) for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def compare_bounded(got: dict, want: dict) -> dict:
    """The bounded steps (the reference follows the program's skip flags):

    - skip_margin: the largest distance from its tie, -ln(T / 1e-4) with T
      the reference's margin (read TIE_ROWS rows short of the bound; floored
      at 1e-30), of a step that the program skipped and the reference
      decides to run, 0 where there is none: a skip taken at a tie lies
      near it, a skip of a step that needs none far from it. A step that
      the program ran against the reference's decision is judged by what it
      renders: the reference runs it over the whole list, so the loss and
      change gaps read the rows that the bound left out;
    - skip_flips (not compared): the steps whose flag differs from the
      reference's decision, either way;
    - bound_short: the share of the tiles (of every step, leaving out the
      tiles the reference finds cut short, whose bound grows by the
      program's own rule) whose next bound keeps fewer rows than the
      reference finds the tile needs, among the tiles that need any;
    - win_loss_gap: the largest relative loss gap of a step that both ran
      (every step the program ran);
    - win_change_gap: each moved leaf's change after the steps, as in
      compare_first (0 where no step ran on either side)."""
    steps = list(zip(got["steps"], want["steps"]))
    floor = 1e-30 / gof.TRANSMITTANCE_EPS
    skip_margin = max((max(0.0, -math.log(max(w["margin"], floor)))
                       for g, w in steps if g["skip"] and not w["skip"]), default=0.0)
    short = counted = 0
    for g, w in steps:
        cut = (w["length"] > g["bound"]) & (w["need"] > g["bound"])
        kept = ~cut & (w["need"] > 0)
        short += int(((g["next"] < w["need"]) & kept).sum())
        counted += int(kept.sum())
    loss = [abs(g["loss"] - w["loss"]) / max(abs(w["loss"]), 1e-12)
            for g, w in steps if not g["skip"] and w["loss"] is not None]
    change = 0.0
    if want["grad"]:
        moved = _moved(want["grad"])
        med_c = statistics.median(want["change"][k] for k in moved)
        change = max(_gap(got["change"][k], want["change"][k], med_c) for k in moved)
    return {"skip_margin": skip_margin,
            "skip_flips": sum(g["skip"] != w["skip"] for g, w in steps),
            "bound_short": short / max(counted, 1),
            "win_loss_gap": max(loss, default=0.0), "win_change_gap": change}


@torch.no_grad()
def view_pairs(model: dict, view: gof.View, bg, tc: dict) -> dict:
    """The pairs one view's step needs, on the benchmark's binning: visited
    and active (pixel, row) pairs, walked rows (per tile, up to the last row
    a pixel needs), the gaussians among them, pixels and tiles."""
    degree = min(int(tc["step"]) // 1000, int(tc["sh_degree"]))
    rows, bins = ref.view_rows(model, view, int(tc["sh_degree"]), degree, float(tc["kernel_size"]))
    _, tiles, vis, act = ref.render(rows, bins, view, bg)
    real = ref.in_image(tiles, view)
    vis, act = vis * real, act * real
    walked = vis.amax(dim=1)
    k = torch.arange(int(walked.max()) if len(walked) else 0, device=rows.device)
    touched = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    for t0 in range(0, len(tiles), 64):
        t, w = tiles[t0:t0 + 64], walked[t0:t0 + 64]
        kk = k[: int(w.max())] if len(w) else k[:0]
        inside = kk[None, :] < w[:, None]
        touched[bins.gid[torch.where(inside, bins.start[t][:, None] + kk, 0)][inside]] = True
    return {"visited": int(vis.sum()), "active": int(act.sum()), "rows": int(walked.sum()),
            "gaussians": int(touched.sum()), "pixels": view.width * view.height,
            "tiles": len(tiles)}


def half_batch_loss(img, gt, view, opt: dict, step: int):
    """A planted fault: the step's loss over the top half of the image's
    rows only, each mean taken over the rest."""
    h = img.shape[1] // 2
    rgb, g = img[:3, :h], gt[:, :h]
    loss = ((1.0 - opt["lambda_dssim"]) * torch.mean(torch.abs(rgb - g))
            + opt["lambda_dssim"] * (1.0 - gof.ssim(rgb, g)))
    d2n = gof.depth_to_normal(view, img[6])[:, :h]
    rn = img[3:6, :h]
    rn = rn * torch.rsqrt(torch.sum(rn * rn, dim=0, keepdim=True) + 1e-12)
    rn_world = torch.einsum("ij,jhw->ihw", view.world_view[:3, :3].T, rn)
    return (loss + opt["lambda_distortion"] * torch.mean(img[8, :h])
            + opt["lambda_depth_normal"] * torch.mean(1.0 - torch.sum(rn_world * d2n, dim=0)))


def as_program(want: dict, bounded: dict, skip=None, keep: int = 1) -> dict:
    """A reference's bounded steps as the program's record, the reference
    put in the program's place: its next bound is its own need, its skip
    its own decision, or `skip` for every step, or its decision where the
    compaction keeps only 1 / `keep` of the rows the bound allows."""
    steps = []
    for g, w in zip(bounded["steps"], want["steps"]):
        b = g["bound"] // keep
        s = skip if skip is not None else bool(((w["length"] > b) & (w["need"] > b)).any())
        steps.append({"bound": g["bound"], "next": w["need"], "skip": s,
                      "loss": w["loss"] if w["loss"] is not None else float("nan")})
    change = ({k: 0.0 for k in LEAVES} if skip else want["change"])
    return {"steps": steps, "change": change}


def controls(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The numbers compared when the reference stands in the program's
    place: computed in bfloat16 (the precision below the configuration's
    float32), with the half-batch fault, with every bounded step skipped,
    and with a compaction that keeps a quarter of the rows the bound
    allows.
    The bounded steps start from the state of a run's set-up."""
    r = Runner(cfg, traffic, seed, device)
    first, bounded = r.first, r.bounded
    r.release()
    model = generate.gaussians(cfg, seed, device)
    want_first = r.reference_first(model, first["views"], torch.float32)
    want = r.reference_bounded(model, bounded, torch.float32)

    def as_first(got):
        return {"loss": [s["loss"] for s in got["steps"]], "grad": got["grad"],
                "change": got["change"]}

    low_first = r.reference_first(model, first["views"], torch.bfloat16)
    low = r.reference_bounded(model, bounded, torch.bfloat16)
    out = {"bf16": {**compare_first(as_first(low_first), want_first),
                    **compare_bounded(as_program(low, bounded), want)}}
    saved = gof.train_loss
    gof.train_loss = half_batch_loss
    try:
        half = r.reference_first(model, first["views"], torch.float32)
        half_bounded = r.reference_bounded(model, bounded, torch.float32)
    finally:
        gof.train_loss = saved
    out["half_batch"] = {**compare_first(as_first(half), want_first),
                         **compare_bounded(as_program(half_bounded, bounded), want)}
    out["skip_all"] = compare_bounded(as_program(want, bounded, skip=True), want)
    out["compaction_short"] = compare_bounded(as_program(want, bounded, keep=4), want)
    return out
