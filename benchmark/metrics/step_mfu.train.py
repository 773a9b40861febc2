"""The whole training step's share of the card's f32 peak: the benchmark's
own operation count of the traced steps (benchmark/counts/step.py on its
binning of each step's view) over the traced window's seconds and 67
TFLOP/s."""

from benchmark.counts import peaks


def read(run):
    w = run.work
    if not w.get("steps") or run.trace.window_s <= 0:
        return None
    return 100.0 * w["step_ops"] / (run.trace.window_s * peaks.F32_FLOPS)
