"""Binning's device ms a step: the `binning` span (class layout, K2's
expansion, the sorts, the slot-demand read) and the `compact` span
(liveness compaction and its live-demand read)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ["binning", "compact"])
