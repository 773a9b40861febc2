"""The program's own spans and counters (gof_tpu_torch/utils/trace.py),
as the per-layer readers take them: the spans of the traced units, summed
by name (`trace.summary` over the last `run.trace.units` units of the
cell's kind), divided per step or per view.

A program without the module, or whose units recorded no span, gives
None, and so does a device number of units that ran off CUDA: the reader
returns None and the metric is left out of the line.
"""

from __future__ import annotations

KIND = {"step": "step", "view": "view", "call": "field_call"}  # runner.unit_name -> unit kind


def summary(run):
    """trace.summary of the traced units, kept on the run; None without
    spans."""
    if not hasattr(run, "_span_summary"):
        try:
            from gof_tpu_torch.utils import trace
        except ImportError:
            s = None
        else:
            s = trace.summary(KIND[run.runner.unit_name], run.trace.units)
            s = s if s["units"] else None
        run._span_summary = s
    return run._span_summary


def per(run, s) -> int:
    """The divisor: steps (train), or views (render; field: every view of
    each call)."""
    return s["units"] * getattr(run.runner, "views_per_unit", 1)


def device_ms(run, names, field: str = "device_ms"):
    """Device ms of the spans named (their intervals, children included; or
    `field`, e.g. "self_device_ms"), per step or view; None without spans
    or off CUDA. A name no traced unit opened counts 0."""
    s = summary(run)
    if s is None or s["spans"][s["kind"]]["device_ms"] is None:
        return None
    return sum(s["spans"][n][field] for n in names if n in s["spans"]) / per(run, s)


def host_ms(run, pick):
    """Host ms of the spans whose name `pick` accepts, per step or view."""
    s = summary(run)
    if s is None:
        return None
    return sum(v["host_ms"] for n, v in s["spans"].items() if pick(n)) / per(run, s)


def count(run, pick):
    """Spans whose name `pick` accepts, per step or view."""
    s = summary(run)
    if s is None:
        return None
    return sum(v["count"] for n, v in s["spans"].items() if pick(n)) / per(run, s)
