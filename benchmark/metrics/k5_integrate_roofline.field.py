"""K5's share of its roofline in the traced field calls: the bound of the
benchmark's K5 count (benchmark/counts/integrate.py) over K5's device
time by kernel name."""

from benchmark.counts import integrate, peaks


def read(run):
    w = run.work.get("k5")
    return peaks.share(w["ops"], w["bytes"], run.trace.kernel_s(integrate.K5)) if w else None
