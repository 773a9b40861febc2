"""The whole eval render's share of the card's f32 peak: the benchmark's
own operation count of the traced renders (benchmark/counts/step.py: the
preprocess and K1 on its binning of each view) over the traced window's
seconds and 67 TFLOP/s."""

from benchmark.counts import peaks


def read(run):
    ops = run.work.get("view_ops")
    return 100.0 * ops / (run.trace.window_s * peaks.F32_FLOPS) if ops else None
