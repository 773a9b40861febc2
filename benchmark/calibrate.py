"""Readings that a cell's limits are set from, in one process.

    python3 -m benchmark.calibrate --workload <name> --seeds S... \
        [--control-seeds C...] [--seconds s] --out FILE

For each of --seeds, a run's set-up, a window of --seconds and its check:
the program's numbers (the lower readings). For each of --control-seeds, the
entry's controls at the cell's own size: the reference computed one
precision lower in the program's place, and each planted fault the entry
defines (the upper readings; the training entry's start from a run's
set-up). One JSON line per reading goes to FILE and
to stdout. Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time

import torch

from benchmark import harness


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cell = harness.cell(args.workload)
    entry = importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    device = torch.device("cuda", 0)

    def sync():
        torch.cuda.synchronize(device)

    with open(args.out, "a") as out:
        def emit(rec):
            line = json.dumps({"workload": args.workload, **rec})
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()

        for seed in args.seeds:
            t0 = time.perf_counter()
            runner = entry.Runner(cell.config, cell.traffic, seed, device)
            harness.run_window(runner, args.seconds, sync)
            readings = runner.check()
            del runner
            torch.cuda.empty_cache()
            emit({"kind": "program", "seed": seed, "readings": readings,
                  "seconds": time.perf_counter() - t0})
        for seed in args.control_seeds:
            t0 = time.perf_counter()
            for kind, readings in entry.controls(cell.config, cell.traffic, seed, device).items():
                emit({"kind": kind, "seed": seed, "readings": readings,
                      "seconds": time.perf_counter() - t0})
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
