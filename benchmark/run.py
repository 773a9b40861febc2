"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA GPUs.
Set-up makes the cell's inputs from the seed on the device, builds the
program's state and warms every shape the traffic uses; then the window
runs the traffic for `--seconds`. With --trace 0 the last line of stdout
holds the cell's end-to-end metrics; with --trace 1 the window runs as well
(the host-clock per-layer metrics come from it), then a short window under
torch.profiler, and the line holds the per-layer metrics. Either way the
program's output is then held to the plain reference, and each number
compared is printed beside its limit, last on stderr and last in the line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, cell=None) -> dict:
    """One run; returns the result line's object. `device` and `cell` (a
    harness.Cell) are for the benchmark's own tests, which drive a run of a
    shrunken cell on the CPU: a run of the benchmark proper reads its cell
    from the manifest and stops without the cell's GPUs."""
    args = parse(argv)
    cell = cell or harness.cell(args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise SystemExit(f"{args.workload} needs {cell.chips} CUDA device(s); this machine "
                             f"has {n}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_gpu = device.type == "cuda"

    def sync():
        if on_gpu:
            torch.cuda.synchronize(device)

    entry = importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    runner = entry.Runner(cell.config, cell.traffic, args.seed, device)
    sync()
    setup_s = time.perf_counter() - T_START
    harness.log(f"{args.workload}: set-up {setup_s:.3f} s")

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    win = harness.run_window(runner, args.seconds, sync, on_gpu)
    harness.log(f"window: {win.units} {runner.unit_name}s in {win.seconds:.3f} s")
    result["attempted"] = win.units
    if args.trace:
        tr = harness.traced(runner, int(cell.traffic["trace_units"]), sync)
        run = harness.TraceRun(runner=runner, window=win, trace=tr)
        t0 = time.perf_counter()
        run.work  # the benchmark's own count of the traced work, timed apart
        harness.log(f"traced {tr.units} {runner.unit_name}s: window {tr.window_s:.3f} s, busy "
                    f"{tr.busy_s:.3f} s; work counted in {time.perf_counter() - t0:.3f} s")
        for m in cell.per_layer:
            v = harness.reader(m["name"]).read(run)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = harness.breakdown(tr)
        device_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        values = runner.end_to_end(win)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        device_extra = {}
    result["device"] = {**(harness.device_info(cell.chips, win.run_peak_bytes) if on_gpu else
                           {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}), **device_extra}

    t0 = time.perf_counter()
    readings = runner.check()
    harness.log(f"check: {time.perf_counter() - t0:.3f} s")
    correct, compared = harness.judge(readings, cell.limits)
    result["correct"] = correct
    result["failed"] = 0 if correct else win.units
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}", file=sys.stderr, flush=True)
        raise SystemExit(3)
    for name, c in compared.items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    result["compared"] = compared
    return result


if __name__ == "__main__":
    out = main()
    print(json.dumps(out), flush=True)
