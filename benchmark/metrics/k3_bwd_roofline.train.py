"""K3's share of its roofline in the traced steps (its tile-order pass and
its blend)."""

from benchmark.counts import blend, peaks


def read(run):
    w = run.work.get("k3")
    return peaks.share(w["ops"], w["bytes"], run.trace.kernel_s(blend.K3)) if w else None
