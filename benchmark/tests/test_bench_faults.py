"""The check fails where it must: a run, shrunk to the CPU, with the timed
path broken underneath reads `correct` false, once for each fault a cell can
have; and the precision control (the reference one precision lower in the
program's place) fails the cell's limits."""

from __future__ import annotations

import importlib
import math

import pytest
import torch

from benchmark import harness, run

from conftest import CELLS, tiny_cell


def run_tiny(name, seed=3000000021):
    return run.main(["--workload", name, "--seed", str(seed), "--seconds", "0.05"],
                    device="cpu", cell=tiny_cell(name))


def test_fault_step_returns_state_unchanged(monkeypatch):
    from gof_tpu_torch import train

    build = train.build_train_step

    def frozen(*a, **k):
        step = build(*a, **k)

        def fn(tp, st, s, *rest, **kw):
            saved = {f: getattr(tp.gauss, f).detach().clone() for f in train.GAUSS_FIELDS}
            _, _, _, m = step(tp, st, s, *rest, **kw)
            for f, x in saved.items():
                getattr(tp.gauss, f).data.copy_(x)
            return tp, st, s, m

        return fn

    monkeypatch.setattr(train, "build_train_step", frozen)
    out = run_tiny("bicycle-train-late")
    assert not out["correct"]
    assert out["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_fault_half_the_batch(monkeypatch):
    """The step's colour loss over half the image's rows, each mean over the
    rest."""
    from gof_tpu_torch.utils import losses

    for name in ("l1_loss", "ssim"):
        fn = getattr(losses, name)
        monkeypatch.setattr(losses, name,
                            lambda a, b, fn=fn: fn(a[:, :a.shape[1] // 2], b[:, :b.shape[1] // 2]))
    out = run_tiny("bicycle-train-late")
    assert not out["correct"]


def test_fault_skip_forced(monkeypatch):
    """Every step with a liveness bound in force reports its bound stale,
    stale or not, and skips its update."""
    import dataclasses

    from gof_tpu_torch.ops import render as render_lib

    render = render_lib.render

    def stale(*a, **k):
        out = render(*a, **k)
        if k.get("live_limit_chunks") is None:
            return out
        return dataclasses.replace(out, live_bad=torch.ones_like(out.live_bad))

    monkeypatch.setattr(render_lib, "render", stale)
    out = run_tiny("bicycle-train-late")
    assert not out["correct"]
    assert out["compared"]["skip_margin"]["value"] > 0


@pytest.mark.parametrize("reported", [True, False])
def test_fault_compaction_drops_rows(monkeypatch, reported):
    """Liveness compaction keeps a quarter of the rows the bound allows:
    the cut tiles are flagged and the steps skip, or (not reported) they
    render without the rows they need."""
    from gof_tpu_torch.ops import binning

    compact = binning.compact_live

    def short(b, lim_chunks, num_gaussians):
        bc, truncated, overflow, demand = compact(b, lim_chunks // 4, num_gaussians)
        return bc, truncated if reported else torch.zeros_like(truncated), overflow, demand

    monkeypatch.setattr(binning, "compact_live", short)
    out = run_tiny("bicycle-train-late")
    assert not out["correct"]
    failed = "skip_margin" if reported else "win_loss_gap"
    assert out["compared"][failed]["value"] > out["compared"][failed]["limit"]


def test_fault_render_altered(monkeypatch):
    from gof_tpu_torch import render_cli

    render_eval = render_cli.render_eval

    def altered(*a, **k):
        out = render_eval(*a, **k)
        out.image[:3] *= 1.01
        return out

    monkeypatch.setattr(render_cli, "render_eval", altered)
    assert not run_tiny("bicycle-render")["correct"]


def test_fault_field_altered(monkeypatch):
    from gof_tpu_torch.mesh import extract

    alpha = extract.FieldEvaluator.alpha
    monkeypatch.setattr(extract.FieldEvaluator, "alpha",
                        lambda self, pts, cameras=None: alpha(self, pts, cameras) * 0.99)
    assert not run_tiny("dtu-field")["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_precision_control_fails(name):
    cell = tiny_cell(name)
    entry = importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    readings = entry.controls(cell.config, cell.traffic, 3000000031, torch.device("cpu"))
    for kind, r in readings.items():
        assert not harness.judge(r, cell.limits)[0], (kind, r)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_on_the_card(cuda_device, name):
    out = run.main(["--workload", name, "--seed", "3000000041", "--seconds", "0.5"],
                   device=cuda_device, cell=tiny_cell(name))
    assert out["correct"] and out["device"]["platform"] == "gpu"



def test_skip_decision_judged_by_its_tie():
    """Rows of alpha 1/2 at every pixel: T after b rows is 2^-b, so the
    reference's T after a bound lies above 1e-4 exactly where the bound cuts
    a tile short of its need (14 rows); a step that the program skips and
    the reference runs reads its distance from that tie, TIE_ROWS rows short
    of the bound; a step run against the reference's decision reads none."""
    from benchmark import generate
    from benchmark.entries import train
    from benchmark.reference import gof
    from benchmark.reference import render as ref

    cell = tiny_cell("bicycle-train-late")
    view = generate.views(cell.config["cameras"], torch.device("cpu"), "all")[0]
    ntx, nty = gof.tile_grid(view.width, view.height)
    L = 30
    rows = torch.zeros(L, 16)
    rows[:, 3] = 0.5  # opacity: alpha 1/2 where the ray meets the row's peak
    rows[:, 12] = 1.0  # M = diag(0, 0, 1): every pixel's ray direction (0, 0, 1)
    rows[:, 15] = -1.0  # u0 = (0, 0, -1): the peak at t = 1, on every ray
    n = ntx * nty
    bins = gof.Bins(gid=torch.arange(L).repeat(n), start=torch.arange(n) * L,
                    length=torch.full((n,), L))
    _, tiles, vis, _ = ref.render(rows, bins, view, torch.zeros(3))
    need = torch.zeros_like(bins.length)
    need[tiles] = (vis * ref.in_image(tiles, view)).amax(dim=1)
    assert need.tolist() == [14] * n
    for b in range(10, 18):
        bound = torch.full((n,), b)
        margin = ref.transmittance_at(rows, bins, view, bound) / gof.TRANSMITTANCE_EPS
        assert margin == pytest.approx(0.5 ** b / 1e-4, rel=1e-5)
        assert (margin > 1) == bool(((bins.length > bound) & (need > bound)).any())
    assert ref.transmittance_at(rows, bins, view, torch.full((n,), L)) == 0.0
    fresh = {"margin": 0.8, "skip": False, "need": need, "length": bins.length, "loss": 1.0}
    step = {"bound": need, "next": need, "skip": True, "loss": float("nan")}
    for w, read in ((fresh, -math.log(0.8)), ({**fresh, "margin": 0.01}, -math.log(0.01))):
        got = train.compare_bounded({"steps": [step], "change": {}}, {"steps": [w], "grad": {}})
        assert got["skip_margin"] == pytest.approx(read) and got["skip_flips"] == 1
    stale = {**fresh, "margin": 5.0, "skip": True}
    got = train.compare_bounded({"steps": [{**step, "skip": False, "loss": 1.0}], "change": {}},
                                {"steps": [stale], "grad": {}})
    assert got["skip_margin"] == 0.0 and got["skip_flips"] == 1 and got["win_loss_gap"] == 0.0
