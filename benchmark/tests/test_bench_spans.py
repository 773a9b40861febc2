"""The per-layer readers of the program's spans and counters
(benchmark/spans.py, the metrics whose source is program_span or
program_counter) on the shrunk CPU cells with --trace 1, and on a program
without spans."""

from __future__ import annotations

import sys
import time

import pytest

from benchmark import harness, run

from conftest import CELLS, tiny_cell

MAN = harness.manifest()
SPAN_READERS = [m for m in MAN["per_layer"] if m["source"] == "program_span"
                or m["name"] in ("host_reads_per_step.train", "lib_load_s")]
# readers of host clocks and counts, which the CPU run gives; the others
# read device intervals, which it does not
HOST = ("host_wait_ms", "host_reads_per_step", "view_host_ms")


def cpu_traced(runner, units, sync):
    """harness.traced on the CPU, which has no device operations to read:
    the units under a CPU torch.profiler, an empty device trace."""
    from torch.profiler import ProfilerActivity, profile

    before = getattr(runner, "before_trace", None)
    if before is not None:
        before()
    runner.phase = "trace"
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        for _ in range(units):
            runner.unit()
        wall = time.perf_counter() - t0
    return harness.Trace(units=units, window_s=wall, busy_s=0.0, ops={}, gaps=[])


def traced_run(name, monkeypatch):
    monkeypatch.setattr(harness, "traced", cpu_traced)
    cell = tiny_cell(name)
    cell.traffic["trace_units"] = 2
    return run.main(["--workload", name, "--seed", "3000000019", "--seconds", "0.05",
                     "--trace", "1"], device="cpu", cell=cell)


def test_manifest_lists_the_span_readers():
    names = {m["name"] for m in SPAN_READERS}
    assert {"preprocess_ms.train", "preprocess_ms.render", "binning_ms.train",
            "payload_ms.train", "payload_ms.render", "loss_ms.train", "backward_self_ms.train",
            "chain_ms.train", "adam_ms.train", "host_wait_ms.train", "host_wait_ms.render",
            "host_wait_ms.field", "host_reads_per_step.train", "view_setup_ms.field",
            "point_bins_ms.field", "view_host_ms.field", "lib_load_s"} == names
    for m in SPAN_READERS:
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_span_readers_on_the_cpu(name, monkeypatch):
    """A traced CPU run: the host-clock and count readers give numbers (a
    step reads 3 to 6 times), the device-ms readers and the library's load
    (no CUDA library is loaded on the CPU) give None, so the line leaves
    them out."""
    out = traced_run(name, monkeypatch)
    assert out["correct"]
    mine = [m["name"] for m in SPAN_READERS if name in m["workloads"]]
    got = {k: v["value"] for k, v in out["metrics"].items() if k in mine}
    want = {k for k in mine if k.startswith(HOST)}
    assert set(got) == want, (got, mine)
    assert all(v > 0 for v in got.values())
    if name == "bicycle-train-late":
        assert 3 <= got["host_reads_per_step.train"] <= 6


@pytest.mark.parametrize("name", CELLS)
def test_span_readers_without_spans(name, monkeypatch):
    """A program without the span module (the parent of the change that
    brought it): every such reader returns None and none raises."""
    import gof_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "gof_tpu_torch.utils.trace", None)
    monkeypatch.delattr(gof_tpu_torch.utils, "trace", raising=False)
    cell = harness.cell(name)

    class Run:
        runner = type("R", (), {"unit_name": {"bicycle-train-late": "step",
                                              "bicycle-render": "view",
                                              "dtu-field": "call"}[name],
                                "views_per_unit": 1})()
        trace = harness.Trace(units=2, window_s=1.0, busy_s=0.5, ops={}, gaps=[])

    for m in cell.per_layer:
        if m in SPAN_READERS and m["name"] != "lib_load_s":
            assert harness.reader(m["name"]).read(Run()) is None, m["name"]
