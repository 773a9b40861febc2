"""The port's spans and counters (gof_tpu_torch/utils/trace.py) on the CPU,
and one test of the host syncs on the card (marked `cuda`).

Spans record only under a torch.profiler: off, a step makes no
record_function call, leaves no record and computes what it computes on;
on, the train step, the eval render and the field call give the span tree
their docstrings name, on the profiler's clock, and `summary` sums it.
Every host read and every tensor made from host data on those paths sits
in a `read.*` or `copy.*` span (on the card: each one a host sync). This
file imports no JAX, so the card runs it without the conftest:
    python -m pytest tests/test_torch_trace.py -q --noconftest
"""

from __future__ import annotations

import contextlib
import json
import traceback

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from gof_tpu_torch import cameras, config, render_cli, train
from gof_tpu_torch.mesh import extract
from gof_tpu_torch.model import gaussians as gm
from gof_tpu_torch.ops import binning, cuda_lib
from gof_tpu_torch.utils import trace

W, H = 64, 32  # two tiles
STEP = 20000


def scene(n=80, seed=3, device="cpu", width=W, height=H):
    """A model in front of a look-at camera and a target image."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(3, 9, n)
    xyz = np.stack([rng.uniform(-1, 1, n) * z * 0.4, rng.uniform(-1, 1, n) * z * 0.2, z], -1)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

    shs = t(rng.normal(0, 0.5, (n, 16, 3)))
    params = gm.GaussianParams(xyz=t(xyz), features_dc=shs[:, :1].clone(),
                               features_rest=shs[:, 1:].clone(),
                               scaling=torch.log(t(rng.uniform(0.2, 0.5, (n, 3)))),
                               rotation=t(rng.normal(size=(n, 4))),
                               opacity=torch.logit(t(rng.uniform(0.3, 0.95, n))))
    zero = torch.zeros(n, device=device)
    state = gm.GaussianState(active=torch.ones(n, dtype=torch.bool, device=device),
                             filter_3d=zero + 1e-4, max_radii2d=zero.clone(),
                             grad_accum=zero.clone(), grad_abs_accum=zero.clone(),
                             denom=zero.clone())
    cam = cameras.look_at_camera(eye=(0.1, 0.05, 0.0), target=(0, 0, 5.0), width=width,
                                 height=height, device=device)
    gt = torch.rand((3, height, width), generator=torch.Generator().manual_seed(seed)).to(device)
    return params, state, cam, gt


class Trainer:
    """The late train step (regularizers on, statistics off) on one model."""

    def __init__(self, n=80, device="cpu", width=W, height=H):
        params, self.state, self.cam, self.gt = scene(n, device=device, width=width,
                                                      height=height)
        opt = config.OptimizationParams(distortion_from_iter=0, depth_normal_from_iter=0)
        self.tx = train.make_optimizer(opt, 5.0)
        self.tp = train.TrainParams(gauss=params)
        self.st = self.tx.init(self.tp)
        self.bg = torch.zeros(3, device=device)
        self.fn = train.build_train_step(opt, config.ModelParams(sh_degree=3, kernel_size=0.1),
                                         config.PipelineParams(), self.tx, with_stats=False)
        self.i = STEP

    def step(self, lim=None):
        self.tp, self.st, self.state, m = self.fn(self.tp, self.st, self.state, self.gt, self.i,
                                                  self.cam, self.bg, lim=lim)
        self.i += 1
        return m


def lims(device="cpu", width=W, height=H):
    """A row that bounds nothing (the step runs) and one of zero chunks
    (every non-empty tile is cut unsaturated: the step is skipped)."""
    ntiles = int(np.prod(binning.tile_grid(width, height)))
    return {"run": torch.full((ntiles,), binning.LIM_INF, dtype=torch.int32, device=device),
            "skip": torch.zeros((ntiles,), dtype=torch.int32, device=device)}


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def new_spans(before: int) -> list:
    """The spans recorded after `before` had been."""
    return trace.spans()[before - trace._count["spans"]:] if trace._count["spans"] > before else []


def tree(spans: list) -> dict:
    """parent name -> its children's names in order, copies left out."""
    out: dict = {}
    for s in sorted(spans, key=lambda s: s.t0):
        if s.parent is not None and not s.name.startswith("copy."):
            out.setdefault(s.parent.name, []).append(s.name)
    return out


RENDER = ["preprocess", "binning", "compact", "payload", "k1", "assemble"]
STEP_TREE = {
    "run": {"step": ["preprocess", *RENDER, "loss", "read.live_bad", "backward", "stats", "adam"],
            "binning": ["read.slot_demand"], "compact": ["read.live_demand"],
            "backward": ["read.compact_demand", "k3", "k4", "chain", "read.prod_zeros",
                         "read.prod_zeros"]},
    "skip": {"step": ["preprocess", *RENDER, "loss", "read.live_bad"],
             "binning": ["read.slot_demand"], "compact": ["read.live_demand"]},
}


def test_spans_off_call_nothing_and_leave_the_step_as_it_is(monkeypatch):
    """With no profiler a liveness step makes no profiler record (neither
    trace's own nor record_function) and records nothing; its params and
    packed counters are bit-identical to the same step's under the
    profiler."""
    runs = {}
    for on in (False, True):
        t = Trainer()
        lim = lims()["run"]
        t.step(lim)
        with monkeypatch.context() as mp:
            if not on:
                def refuse(*a, **k):
                    raise AssertionError("record_function called with the profiler off")

                mp.setattr(torch.autograd.profiler, "record_function", refuse)
                mp.setattr(trace, "_record", refuse)
            before = trace._count["spans"]
            with cpu_profile() if on else contextlib.nullcontext():
                m = t.step(lim)
            recorded = trace._count["spans"] - before
        assert (recorded > 0) == on
        runs[on] = (t.tp.gauss, m["packed"])
    (g0, p0), (g1, p1) = runs[False], runs[True]
    assert torch.equal(p0, p1)
    for f in train.GAUSS_FIELDS:
        assert torch.equal(getattr(g0, f), getattr(g1, f)), f


@pytest.mark.parametrize("case", ["run", "skip"])
def test_span_tree_of_a_train_step(case):
    """Under a CPU profiler the step's spans nest as build_train_step's
    docstring says: the backward's spans (opened where autograd runs it)
    take `backward` as their parent; a skipped step stops after
    read.live_bad. Every span belongs to the step's unit."""
    t = Trainer()
    with cpu_profile():
        before = trace._count["spans"]
        t.step(lims()[case])
    spans = new_spans(before)
    assert tree(spans) == STEP_TREE[case]
    assert {(s.kind, s.uid) for s in spans} == {("step", STEP)}
    assert all(s.dev_ms is None for s in spans)  # no device events on the CPU
    copies = {s.name for s in spans if s.name.startswith("copy.")}
    assert {"copy.focal", "copy.class_sizes", "copy.meta", "copy.ssim_window"} <= copies
    assert ("copy.adam_lr" in copies) == (case == "run")


def test_span_clock_is_the_profilers():
    """After a warm step, every span's host start and end lie within 2 ms
    of the profiler's event of its name (trace start + the event's offset):
    the spans stand on the profiler's clock."""
    t = Trainer()
    with cpu_profile() as prof:
        t.step(lims()["run"])
        before = trace._count["spans"]
        t.step(lims()["run"])
    spans = new_spans(before)
    start = prof.profiler.kineto_results.trace_start_ns()
    for name in {s.name for s in spans}:
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.t0)
        evs = sorted((e for e in prof.events() if e.name == name),
                     key=lambda e: e.time_range.start)[-len(mine):]
        assert len(evs) == len(mine), name
        for s, e in zip(mine, evs):
            assert abs(start + e.time_range.start * 1000 - s.t0) <= 2e6, name
            assert abs(start + e.time_range.end * 1000 - s.t1) <= 2e6, name


def made(name, kind, uid, serial, dev_ms, t0, t1, parent=None):
    s = trace.Span(name, kind, uid, None, None)
    s.serial, s.t0, s.t1, s._dev_ms, s.parent = serial, t0, t1, dev_ms, parent
    if parent is not None:
        s.kind, s.uid = parent.kind, parent.uid
        parent.children.append(s)
    return s


def test_summary_self_time_on_made_records(monkeypatch):
    """summary()'s sums by name over a kind's last units: device ms are the
    intervals, self ms the intervals less the children's; a unit's
    children plus its self time give its interval; other kinds and older
    units are left out."""
    monkeypatch.setattr(trace, "_spans", __import__("collections").deque(maxlen=64))
    recs = []
    for serial, (uid, total) in enumerate([(7, 99.0), (8, 10.0), (9, 12.0)], start=1):
        u = made("step", "step", uid, serial, total, 0, 5_000_000)
        a = made("binning", None, None, serial, 4.0, 0, 2_000_000, u)
        r = made("read.slot_demand", None, None, serial, 1.0, 500_000, 1_500_000, a)
        b = made("k1", None, None, serial, 3.0, 2_000_000, 3_000_000, u)
        recs += [r, a, b, u]
    other = made("view", "view", 0, 4, 5.0, 0, 1_000_000)
    recs.append(other)
    for s in recs:
        trace._spans.append(s)
    got = trace.summary("step", 2)
    assert got["units"] == 2 and got["ids"] == [8, 9]
    sp = got["spans"]
    assert sp["step"] == {"host_ms": 10.0, "device_ms": 22.0,
                          "self_device_ms": pytest.approx(22.0 - 14.0), "count": 2}
    assert sp["binning"]["device_ms"] == 8.0 and sp["binning"]["self_device_ms"] == 6.0
    assert sp["read.slot_demand"] == {"host_ms": 2.0, "device_ms": 2.0,
                                      "self_device_ms": 2.0, "count": 2}
    assert sp["k1"]["self_device_ms"] == 6.0 and "view" not in sp
    for d in got["per_unit"]:
        kids = d["binning"]["device_ms"] + d["k1"]["device_ms"]
        assert kids + d["step"]["self_device_ms"] == pytest.approx(d["step"]["device_ms"])
    assert trace.summary("step", 0)["units"] == 0
    assert trace.summary("view")["spans"]["view"]["self_device_ms"] == 5.0


@pytest.mark.parametrize("case,reads", [("run", 6), ("skip", 3)])
def test_host_reads_per_step(case, reads):
    """The liveness step reads the slot demand, the live demand and
    live_bad, and, when it runs the backward, the compact demand and, in
    torch.prod's backward of the filtered opacity's two determinants, their
    zero counts: 3 reads on a skipped step, 6 on a run step, by HOST_READS
    with spans off and by the read spans with them on."""
    t = Trainer()
    n0 = trace.HOST_READS.launches
    m = t.step(lims()[case])
    assert trace.HOST_READS.launches - n0 == reads
    assert bool(m["packed"][9]) == (case == "skip")
    with cpu_profile():
        t.step(lims()[case])
    got = trace.summary("step", 1)["spans"]
    assert sum(v["count"] for k, v in got.items() if k.startswith("read.")) == reads


def test_field_call_has_a_view_span_per_camera(tmp_path):
    """FieldEvaluator.alpha is one field_call unit: the points' copy, one
    field_view span per camera (tagged with its index) and the result's
    read; each view runs preprocess, binning, payload, point_bins (with its
    read) and K5."""
    params, state, cam, _ = scene(40)
    cams = [cam, cameras.look_at_camera(eye=(0.3, 0.0, 0.0), target=(0, 0, 5.0), width=W,
                                        height=H), cam]
    ev = extract.FieldEvaluator(params, state, cams, 3, 0.1)
    pts = params.xyz.detach().numpy()
    ev.alpha(pts)
    with cpu_profile():
        before = trace._count["spans"]
        ev.alpha(pts)
    spans = new_spans(before)
    units = [s for s in spans if s.name == "field_call"]
    assert len(units) == 1 and units[0].uid == 1 and units[0].parent is None
    views = [s for s in spans if s.name == "field_view"]
    assert [s.tag for s in sorted(views, key=lambda s: s.t0)] == [0, 1, 2]
    t = tree(spans)
    assert t["field_call"] == ["field_view"] * 3 + ["read.result"]
    assert t["field_view"] == ["preprocess", "binning", "payload", "point_bins", "k5"] * 3
    assert t["point_bins"] == ["read.point_bins"] * 3
    assert sum(s.name == "copy.points" and s.parent is units[0] for s in spans) == 1
    s = trace.summary("field_call", 1)
    assert s["spans"]["field_view"]["count"] == 3 and s["spans"]["k5"]["count"] == 3


def test_render_eval_is_a_view_unit(tmp_path):
    """render_cli.render_eval is one view unit (id the camera's uid): the
    render's spans without compaction, its preprocess holding the 3D filter
    and the SH colour of the model's leaves; export writes them as JSON
    lines."""
    params, state, cam, _ = scene(40)
    with cpu_profile():
        before = trace._count["spans"]
        render_cli.render_eval(params, state, cam, config.ModelParams(sh_degree=3),
                               torch.zeros(3))
    spans = new_spans(before)
    t = tree(spans)
    assert t["view"] == ["preprocess", "binning", "payload", "k1", "assemble"]
    assert [s.uid for s in spans if s.name == "view"] == [cam.uid]
    path = tmp_path / "spans.jsonl"
    n = trace.export(str(path))
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(recs) == n == len(trace.spans())
    last = recs[-1]
    assert last["name"] == "view" and last["kind"] == "view" and last["dev_ms"] is None
    assert last["t1_ns"] >= last["t0_ns"] and recs[-2]["parent"] == "view"


class HostData(TorchDispatchMode):
    """Every host read (`_local_scalar_dense`: int(), bool(), .item()) and
    every tensor made from host data (`lift_fresh`: on the card, a copy to
    the device), with the innermost open span and the program's line."""

    def __init__(self):
        super().__init__()
        self.sites = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if "lift_fresh" in name or "_local_scalar_dense" in name:
            stack = [f for f in traceback.extract_stack() if "gof_tpu_torch" in f.filename]
            where = stack[-1] if stack else None
            # the plain CPU versions of the kernels, and the lr schedule's
            # host tensors (copied to the device in copy.adam_lr), stay on
            # the host on the card too
            host_side = any(f.name.endswith("_reference") or f.filename.endswith("schedules.py")
                            for f in stack)
            if not host_side:
                self.sites.append((trace._stack[-1].name if trace._stack else None,
                                   f"{where.filename.split('gof_tpu_torch')[-1]}:{where.lineno}"
                                   if where else "?"))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("path", ["step run", "step skip", "render", "field"])
def test_host_syncs_sit_in_read_and_copy_spans(path):
    """Each host read and each tensor made from host data on the step's,
    the render's and the field's path happens inside a read.* or copy.*
    span, so every host sync that the card makes there is named (the CPU's
    picture of the `cuda` test below)."""
    params, state, cam, gt = scene(40)
    mode = HostData()
    with cpu_profile():
        if path.startswith("step"):
            t = Trainer(40)
            with mode:
                t.step(lims()[path.split()[1]])
        elif path == "render":
            with mode:
                render_cli.render_eval(params, state, cam, config.ModelParams(sh_degree=3),
                                       torch.zeros(3))
        else:
            ev = extract.FieldEvaluator(params, state, [cam, cam], 3, 0.1)
            with mode:
                ev.alpha(params.xyz.detach().numpy())
    assert mode.sites
    bad = [(span, where) for span, where in mode.sites
           if not (span or "").startswith(("read.", "copy."))]
    assert not bad, bad


def test_launch_counter_lives_in_trace():
    """cuda_lib.LaunchCounter is trace's counter, which the wrappers and
    HOST_READS share."""
    assert cuda_lib.LaunchCounter is trace.LaunchCounter
    assert isinstance(trace.HOST_READS, cuda_lib.LaunchCounter)
    assert cuda_lib.LOAD.keys() == {"seconds", "built"}


@pytest.mark.cuda
def test_host_syncs_on_the_card_sit_in_read_and_copy_spans(monkeypatch):
    """On the card, with torch's sync debug mode raising on every host sync
    outside read.* and copy.* spans: a liveness train step at 100k
    gaussians and 640x480 (run, then skipped) and a field call over 3
    views raise nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    size = dict(width=640, height=480)
    depth = [0]

    def allow(make):
        @contextlib.contextmanager
        def ctx(what):
            depth[0] += 1
            torch.cuda.set_sync_debug_mode(0)
            try:
                with make(what):
                    yield
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    torch.cuda.set_sync_debug_mode("error")
        return ctx

    t = Trainer(100_000, dev, **size)
    params, state, cam, _ = scene(20_000, device=dev, **size)
    ev = extract.FieldEvaluator(params, state, [cam] * 3, 3, 0.1)
    pts = params.xyz.detach().cpu().numpy()
    row = lims(dev, **size)
    t.step(row["run"])  # warm: builds the kernels, makes the lazy state
    ev.alpha(pts)
    torch.cuda.synchronize()
    monkeypatch.setattr(trace, "read", allow(trace.read))
    monkeypatch.setattr(trace, "copy", allow(trace.copy))
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = t.step(row["run"])
        m2 = t.step(row["skip"])
        ev.alpha(pts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not bool(m["packed"][9]) and bool(m2["packed"][9])
