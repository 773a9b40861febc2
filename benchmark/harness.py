"""What every cell shares: the manifest and the files it names, the window
loop, the profiler's reading, the import guard and the result line.

Nothing here knows a cell. A configuration, a traffic mix, a per-layer
metric and a cell's limits are files found by the names BENCHMARK.json
gives (README.md says where).
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that may not be loaded in a run: JAX and the JAX package, by the
# top-level name of each module, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "gof_tpu")


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    """benchmark/<kind>/<name>.json"""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of a per-layer metric: benchmark/metrics/<name>.py, or,
    where there is none, the reader of the quantity that the name's suffix
    splits by the end-to-end metric it moves (<name up to its first
    dot>.py); its read(run) returns a number or None."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path, "benchmark_metric_" + metric)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the manifest's end-to-end metrics this cell reports
    per_layer: list  # the manifest's per-layer metrics this cell reports


def cell(name: str, man: dict | None = None) -> Cell:
    man = man or manifest()
    wl = {w["name"]: w for w in man["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(wl)}")
    w = wl[name]

    def reports(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in man["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in e2e_names else [])]
    return Cell(name=name, chips=int(w["chips"]), config=load_json("configs", w["config"]),
                traffic=load_json("traffic", w["traffic"]), limits=load_json("limits", name),
                end_to_end=e2e, per_layer=layer)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# the measured window
# --------------------------------------------------------------------------

@dataclass
class Window:
    units: int
    seconds: float
    latencies_ms: list = field(default_factory=list)
    peak_bytes: int = 0  # the most allocated during the window
    run_peak_bytes: int = 0  # the most allocated from the process's start to the window's end


def run_window(runner, seconds: float, sync, on_gpu: bool = True) -> Window:
    """Units of work back to back (closed loop) until `seconds` have passed;
    the window ends when the device has finished the last one."""
    import torch

    sync()
    setup_peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    before = runner.units_done
    runner.phase = "window"
    lat = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ms = runner.unit()
        if ms is not None:
            lat.append(ms)
    sync()
    el = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    return Window(units=runner.units_done - before, seconds=el, latencies_ms=lat,
                  peak_bytes=peak, run_peak_bytes=max(peak, setup_peak))


# --------------------------------------------------------------------------
# the traced window
# --------------------------------------------------------------------------

@dataclass
class Trace:
    units: int
    window_s: float
    busy_s: float
    ops: dict  # device op name -> [seconds, count]
    gaps: list  # [[what the host was doing, idle seconds], ...]

    @property
    def launches(self) -> int:
        return sum(c for _, c in self.ops.values())

    def kernel_s(self, names) -> float | None:
        """Device seconds of the program's kernels named (the port's CUDA
        kernels live in anonymous namespaces); None if none ran."""
        pat = re.compile(r"^(void )?\(anonymous namespace\)::(" + "|".join(names) + r")[<(]")
        hits = [s for k, (s, _) in self.ops.items() if pat.match(k)]
        return sum(hits) if hits else None


def _union(intervals):
    total, out = 0.0, []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    for s, e in out:
        total += e - s
    return total, out


def traced(runner, units: int, sync) -> Trace:
    """`units` units of work under torch.profiler (host and device), after
    the runner's before_trace(), where it has one: the
    device's busy time (the union of its operations' intervals), each
    device operation's time and count, and the idle gaps between device
    operations, each named by the innermost host operation running at its
    middle."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = getattr(runner, "before_trace", None)
    if before is not None:
        before()
    sync()
    runner.phase = "trace"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            runner.unit()
        sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    ops: dict = {}
    for e in dev:
        s = ops.setdefault(e.name, [0.0, 0])
        s[0] += (e.time_range.end - e.time_range.start) * 1e-6
        s[1] += 1
    busy, merged = _union([(e.time_range.start, e.time_range.end) for e in dev])
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:400]
    hs = np.array([e.time_range.start for e in host], np.float64)
    he = np.array([e.time_range.end for e in host], np.float64)
    names = [e.name for e in host]
    by_host: dict = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        cover = np.nonzero((hs <= mid) & (he >= mid))[0]
        what = names[cover[np.argmin(he[cover] - hs[cover])]] if len(cover) else "(no host op)"
        by_host[what] = by_host.get(what, 0.0) + (e - s) * 1e-6
    return Trace(units=units, window_s=wall, busy_s=busy * 1e-6, ops=ops,
                 gaps=sorted(([k, v] for k, v in by_host.items()), key=lambda x: -x[1]))


@dataclass
class TraceRun:
    """What a per-layer reader reads: the runner (its program counters and
    the benchmark's own count of the traced work), the untraced window and
    the traced one."""

    runner: object
    window: Window
    trace: Trace
    _work: dict | None = None

    @property
    def work(self) -> dict:
        """runner.work(): the operations and bytes the traced units need, by
        the benchmark's counts (benchmark/counts/) on its own binning."""
        if self._work is None:
            self._work = self.runner.work()
        return self._work


def breakdown(tr: Trace) -> dict:
    top = sorted(tr.ops.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[k[:160], v[0]] for k, v in top], "idle_gaps": tr.gaps[:10]}


# --------------------------------------------------------------------------
# the result
# --------------------------------------------------------------------------

def judge(readings: dict, limits: dict) -> tuple:
    """Each number compared beside its limit (a number passes at or under
    its limit; a missing or non-finite one fails) -> (correct, lines)."""
    import math

    ok, lines = True, {}
    for name, lim in limits.items():
        v = readings.get(name)
        good = v is not None and math.isfinite(v) and v <= lim
        ok &= good
        lines[name] = {"value": v, "limit": lim}
    return ok, lines


def device_info(count: int, peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}
