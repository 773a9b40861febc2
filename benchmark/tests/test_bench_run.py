"""A whole run of each cell, shrunk, on the CPU (the program's plain path
against the reference), the result line's keys, and the import guard."""

from __future__ import annotations

import json
import sys

import pytest

from benchmark import harness, run

from conftest import CELLS, tiny_cell

# what the program's CPU path may differ from the reference by at the tiny
# size: the blend's sums in another order (f32), the quadric chain in f64,
# and, in a train step's change, Adam's sign on elements whose gradient is
# a rounding residue
TINY = {"loss_gap": 1e-4, "grad_gap": 5e-3, "change_gap": 5e-2, "skip_margin": 0.0,
        "bound_short": 0.0, "win_loss_gap": 1e-4, "win_change_gap": 5e-2, "rgb_gap": 1e-5,
        "normal_gap": 1e-5, "depth_gap": 1e-5, "alpha_gap": 1e-5}


def run_tiny(name, trace=0, seconds=0.05):
    cell = tiny_cell(name)
    return run.main(["--workload", name, "--seed", "3000000011", "--seconds", str(seconds),
                     "--trace", str(trace)], device="cpu", cell=cell)


@pytest.mark.parametrize("name", CELLS)
def test_run_keys_and_reference_agreement(name):
    out = run_tiny(name)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert out["attempted"] >= 1
    cell = harness.cell(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(out["compared"]) == set(cell.limits)
    for k, c in out["compared"].items():
        assert c["value"] <= TINY[k], (k, c)
    json.dumps(out)


def test_cli_refuses_without_a_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("mod,bad", [("jax", True), ("jaxlib.xla", True), ("flax", True),
                                     ("gof_tpu", True), ("gof_tpu.ops.render", True),
                                     ("gof_tpu_torch", False), ("gof_tpu_torch.ops", False),
                                     ("jaxtyping", False)])
def test_import_guard_by_top_level_name(monkeypatch, mod, bad):
    for name in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, mod, object())
    assert bool(harness.forbidden_modules()) == bad


def test_judge():
    ok, lines = harness.judge({"a": 1.0, "b": float("nan")}, {"a": 2.0, "b": 1.0})
    assert not ok and lines["a"] == {"value": 1.0, "limit": 2.0}
    assert harness.judge({"a": 1.0}, {"a": 1.0})[0]
    assert not harness.judge({}, {"a": 1.0})[0]
