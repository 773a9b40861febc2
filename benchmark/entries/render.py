"""Entry "render": the program's eval render, `render_cli.render_eval`, as
render_cli and the viewer call it: one client, one view after another
(closed loop), each timed from the call to the RGB image in host memory
(render_set's clock).

Set-up builds the model from the seed and renders every view of the ring
once. The window walks the ring in a seeded random order, epoch after
epoch. For the check, the last image of each of a few views drawn from the
seed is kept (all 9 channels, on the device).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import generate
from ..counts import blend as blend_counts
from ..counts import step as step_counts
from ..reference import gof
from ..reference import render as ref
from . import program

CHANNELS = {"rgb": slice(0, 3), "normal": slice(3, 6), "depth": slice(6, 7),
            "alpha": slice(7, 8)}


class Runner:
    unit_name = "view"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from gof_tpu_torch import config as config_lib, render_cli

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.render_eval = render_cli.render_eval
        self.views = generate.views(cfg["cameras"], device, traffic["views"])
        self.views_per_unit = 1
        model = generate.gaussians(cfg, seed, device)
        self.gauss, self.gstate = program.model_state(model)
        self.model_cfg = config_lib.ModelParams(sh_degree=cfg["train"]["sh_degree"],
                                                kernel_size=cfg["train"]["kernel_size"])
        self.cams = program.cameras(self.views)
        self.bg = torch.zeros(3, device=device)
        self.sampled = [int(i) for i in generate.sample(seed, 4, len(self.views),
                                                        int(traffic["check_views"]))]
        self.kept: dict = {}
        self.units_done = 0
        self.phase = "warm"
        self.visits = {"warm": [], "window": [], "trace": []}
        self.walk = program.EpochWalk(seed, len(self.views))
        for _ in range(len(self.views) * int(traffic["warm_epochs"])):
            self.unit()

    def unit(self) -> float:
        v = self.walk.next()
        t0 = time.perf_counter()
        out = self.render_eval(self.gauss, self.gstate, self.cams[v], self.model_cfg, self.bg)
        rgb = out.image[:3].cpu().numpy()  # waits for the device
        ms = (time.perf_counter() - t0) * 1e3
        del rgb
        if v in self.sampled:
            self.kept[v] = out.image
        self.visits[self.phase].append(v)
        self.units_done += 1
        return ms

    def end_to_end(self, win) -> dict:
        return {"render_p95_ms": float(np.percentile(win.latencies_ms, 95))}

    def work(self) -> dict:
        """The traced views' K1 operations and bytes by the benchmark's
        counts on its own binning of each view (render_eval renders the
        regularizer channels too)."""
        from .train import view_pairs

        model = generate.gaussians(self.cfg, self.seed, self.device)
        tc = {**self.cfg["train"], "step": 10 ** 9}  # full SH degree, as render_eval
        per_view = {v: view_pairs(model, self.views[v], self.bg, tc)
                    for v in set(self.visits["trace"])}
        tot = {"k1": {"ops": 0, "bytes": 0}, "view_ops": 0.0}
        P = model["xyz"].shape[0]
        for v in self.visits["trace"]:
            c = per_view[v]
            d = blend_counts.k1(c["visited"], c["active"], c["rows"], c["pixels"], c["tiles"],
                                True)
            tot["k1"]["ops"] += d["ops"]
            tot["k1"]["bytes"] += d["bytes"]
            tot["view_ops"] += step_counts.render_ops(P, d["ops"])
        return tot

    def check(self) -> dict:
        """Each kept image against the reference's render of its view, per
        channel group: the mean absolute gap over the mean absolute value of
        the reference, the worst view."""
        kept = {v: img for v, img in self.kept.items()}
        self.gauss = self.gstate = self.kept = None
        model = generate.gaussians(self.cfg, self.seed, self.device)
        want = {v: reference_image(model, self.views[v], self.bg, self.cfg["train"],
                                   torch.float32) for v in kept}
        return compare_images(kept, want)


def reference_image(model: dict, view: gof.View, bg, train: dict, dtype):
    m = ref.cast_model(model, dtype)
    view = view.cast(dtype)
    rows, bins = ref.view_rows(m, view, int(train["sh_degree"]), int(train["sh_degree"]),
                               float(train["kernel_size"]))
    return ref.render(rows.detach(), bins, view, bg.to(dtype))[0]


def compare_images(got: dict, want: dict) -> dict:
    out = {}
    for name, sl in CHANNELS.items():
        gaps = []
        for v, w in want.items():
            g, w = got[v][sl].double(), w[sl].double()
            gaps.append(float((g - w).abs().mean() / w.abs().mean().clamp_min(1e-30)))
        out[f"{name}_gap"] = max(gaps)
    return out


def controls(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The numbers compared when the reference computed in bfloat16 stands
    in the program's place, on the views a run keeps."""
    views = generate.views(cfg["cameras"], device, traffic["views"])
    model = generate.gaussians(cfg, seed, device)
    bg = torch.zeros(3, device=device)
    picked = [int(i) for i in generate.sample(seed, 4, len(views), int(traffic["check_views"]))]
    want = {v: reference_image(model, views[v], bg, cfg["train"], torch.float32) for v in picked}
    got = {v: reference_image(model, views[v], bg, cfg["train"], torch.bfloat16).float()
           for v in picked}
    return {"bf16": compare_images(got, want)}
