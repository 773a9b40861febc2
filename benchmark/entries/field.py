"""Entry "field": the opacity-field stage of mesh extraction,
`mesh.extract.FieldEvaluator.alpha`, over all of a configuration's views
at the tetra points of its model, one call after another (closed loop), as
extract_mesh evaluates the field before marching the tetrahedra.

Set-up builds the model from the seed, its tetra points (the benchmark's
own: GOF's get_tetra_points, frustum-filtered over the views), the
evaluator, and makes one warm call. For the check, the last call's alpha
at a sample of the points drawn from the seed is kept.
"""

from __future__ import annotations

import torch

from .. import generate
from ..counts import integrate as integrate_counts
from ..counts import step as step_counts
from ..reference import gof
from ..reference import render as ref
from . import program


class Runner:
    unit_name = "call"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from gof_tpu_torch.mesh import extract

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.views = generate.views(cfg["cameras"], device, traffic["views"])
        self.views_per_unit = len(self.views)
        model = generate.gaussians(cfg, seed, device)
        self.points = generate.tetra_points(model, self.views).cpu().numpy()
        gauss, gstate = program.model_state(model)
        self.evaluator = extract.FieldEvaluator(gauss, gstate, program.cameras(self.views),
                                                cfg["train"]["sh_degree"],
                                                cfg["train"]["kernel_size"])
        self.sample = generate.sample(seed, 5, len(self.points), int(traffic["check_points"]))
        self.kept = None
        self.units_done = 0
        self.phase = "warm"
        for _ in range(int(traffic["warm_calls"])):
            self.unit()

    def unit(self):
        alpha = self.evaluator.alpha(self.points)
        self.kept = alpha[self.sample]
        self.units_done += 1
        return None

    def end_to_end(self, win) -> dict:
        evals = win.units * len(self.points) * len(self.views)
        return {"field_evals_per_s": evals / win.seconds / 1e6}

    def work(self) -> dict:
        """K5's operations and bytes for the traced calls, by the benchmark's
        counts on its own binning of the model and the points in each view."""
        model = generate.gaussians(self.cfg, self.seed, self.device)
        pts = torch.as_tensor(self.points, device=self.device)
        tot = {"ops": 0, "bytes": 0}
        with torch.no_grad():
            for view in self.views:
                d = view_pairs(model, view, pts, float(self.cfg["train"]["kernel_size"]))
                tot["ops"] += d["ops"]
                tot["bytes"] += d["bytes"]
        n = int(self.traffic["trace_units"])
        call = step_counts.field_ops(model["xyz"].shape[0], len(self.views), tot["ops"])
        return {"k5": {"ops": tot["ops"] * n, "bytes": tot["bytes"] * n}, "call_ops": call * n}

    def check(self) -> dict:
        """The kept alphas against the reference's at the same points: the
        largest absolute gap."""
        got = torch.as_tensor(self.kept, dtype=torch.float64)
        self.evaluator = None
        model = generate.gaussians(self.cfg, self.seed, self.device)
        pts = torch.as_tensor(self.points[self.sample], device=self.device)
        want = ref.field_alpha(model, self.views, pts, float(self.cfg["train"]["kernel_size"]),
                               torch.float32)
        return {"alpha_gap": float((got - want.double().cpu()).abs().max())}


def view_pairs(model: dict, view: gof.View, points, kernel_size: float) -> dict:
    """One view's (point, row) pairs: over tiles, the points projecting into
    the tile times the rows binned to it; with the rows, points and tiles
    that the count's bytes read."""
    _, bins = ref.field_bins(model, view, kernel_size)
    tile = ref.point_tiles(points, view)[0]
    nt = bins.length.shape[0]
    per_tile = torch.bincount(tile, minlength=nt + 1)[:nt]
    pairs = int((per_tile * bins.length).sum())
    return integrate_counts.k5(pairs, int(bins.length.sum()), int(per_tile.sum()), nt)


def controls(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The numbers compared when the reference computed in bfloat16 stands
    in the program's place, at the points a run keeps."""
    views = generate.views(cfg["cameras"], device, traffic["views"])
    model = generate.gaussians(cfg, seed, device)
    pts = generate.tetra_points(model, views)
    pts = pts[torch.as_tensor(generate.sample(seed, 5, len(pts), int(traffic["check_points"])),
                              device=device)]
    ks = float(cfg["train"]["kernel_size"])
    want = ref.field_alpha(model, views, pts, ks, torch.float32).double()
    got = ref.field_alpha(model, views, pts, ks, torch.bfloat16).double()
    return {"bf16": {"alpha_gap": float((got - want).abs().max())}}
