"""The whole field call's share of the card's f32 peak: the benchmark's own
operation count of the traced calls (benchmark/counts/step.py: each view's
preprocess and K5 on its binning of the points) over the traced window's
seconds and 67 TFLOP/s."""

from benchmark.counts import peaks


def read(run):
    ops = run.work.get("call_ops")
    return 100.0 * ops / (run.trace.window_s * peaks.F32_FLOPS) if ops else None
