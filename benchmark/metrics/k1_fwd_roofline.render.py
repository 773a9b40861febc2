"""K1's share of its roofline in the traced renders: the bound of the
benchmark's K1 count (benchmark/counts/blend.py) over K1's device time by
kernel name."""

from benchmark.counts import blend, peaks


def read(run):
    w = run.work.get("k1")
    return peaks.share(w["ops"], w["bytes"], run.trace.kernel_s(blend.K1)) if w else None
