"""K4's share of its roofline in the traced steps (its count, scan, fill
and reduce passes): the per-row gradients read once and the per-gaussian
sums written once."""

from benchmark.counts import blend, peaks


def read(run):
    w = run.work.get("k4")
    return peaks.share(w["ops"], w["bytes"], run.trace.kernel_s(blend.K4)) if w else None
