"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
MAN = harness.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert len(MAN["command"]) <= 32 and all(not w.startswith("/") and ".." not in w
                                             for w in MAN["command"])


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_keys_and_names(section, keys):
    for e in MAN[section]:
        assert set(e) == keys, e["name"]
        assert NAME.match(e["name"])
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics(section):
    base = {"name", "unit", "better", "source"}
    extra = {"bound"} if section == "end_to_end" else {"layer", "moves"}
    for m in MAN[section]:
        assert set(m) - {"workloads"} == base | extra, m["name"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert 1 <= len(m["layer"]) <= 200


def test_names_unique():
    for section in ("configs", "workloads"):
        names = [e["name"] for e in MAN[section]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_setup_metric_and_bound():
    setup = [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(name):
    """Each cell's configuration, traffic mix, limits and per-layer readers
    load by the names the manifest gives; it reports setup_s, another
    end-to-end metric and a per-layer metric."""
    cell = harness.cell(name)
    assert cell.chips in (1, 4)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.reader(m["name"]).read)
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    __import__(f"benchmark.entries.{cell.traffic['entry']}")


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    """The file lies under paths, is no other configuration's, and states
    what the manifest says of it."""
    assert any(cfg["file"].startswith(p + "/") for p in MAN["paths"])
    assert sum(c["file"] == cfg["file"] for c in MAN["configs"]) == 1
    data = harness.load_json("configs", cfg["name"])
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    # each key cut is a top-level key of the file, with its reason, and no width
    assert set(data["reduced"]) <= set(data) and set(data["reduced"]) == set(data["reduced_why"])
    assert not any(k.endswith(("_dim", "_rank", "_size")) for k in data["reduced"])
    assert data["precision"] == "float32"


def test_every_config_used_and_four_chip_share():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_check_time_fits():
    """A full check: 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a
    cell to compile, 1200 s spare, within 43,200 s with 24 cells."""
    per_run = MAN["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 180 + 1200 <= 43200
