"""Spans and counters inside the port: which layer of the train step, the
eval render and the field evaluation the host and the device spend their
time in.

A span is a named stretch of the program (`span`), opened with `with`. A
unit span (`unit`) opens one unit of work, a training step, a view or a
field call, and the spans inside it belong to that unit. `read` and `copy`
name the device-to-host reads and host-to-device copies the path makes;
`HOST_READS` counts the reads.

Spans record only while a torch.profiler is recording
(`torch.autograd._profiler_enabled()`, true also on autograd's device
thread): there is no other switch. Off, `span` returns a shared context
that does nothing. On, a span also enters a profiler record of its name
(`_record`), so it stands in the profiler's host timeline beside the device
operations, and records

- its name, its unit (kind, id) and its parent span;
- its host start and end in the profiler's clock (`time.time_ns()`);
- on a CUDA unit, a pair of CUDA events on the current stream: the span's
  device interval is the time between the device reaching the two. The
  port runs on one stream, so the intervals nest, and a span's self time
  is its interval less its children's.

Spans opened while autograd runs the backward on its device thread take
the span the caller waits in as their parent: there is one stack of open
spans, and the caller is blocked while the backward runs.

Records are kept in a bounded buffer (the oldest go first, counted in
`dropped()`). `summary(kind, last_units)` sums them per span name over a
kind's last units; `export(path)` writes them as JSON lines.
"""

from __future__ import annotations

import collections
import json
import time

import torch

MAX_SPANS = 1 << 16
_on = torch.autograd._profiler_enabled
# A function-scope record: a host `cpu_op` in the profiler's trace. A
# user-scope `record_function` is also mirrored onto the device timeline as
# a `gpu_user_annotation` over the kernels it launched, which a reader of
# the trace's device operations counts as one more operation, busy for the
# whole span, idle gaps included.
_record = getattr(torch._C._profiler, "_RecordFunctionFast", None) or (
    torch.autograd.profiler.record_function)
_stack: list = []
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_count = {"spans": 0, "units": 0}


class LaunchCounter:
    """How often one thing happened at one place in the program: a wrapper's
    CUDA kernel launches (never its plain CPU version), the path's host
    reads (HOST_READS). Reset with `launches = 0`."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


HOST_READS = LaunchCounter("host_reads")


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, val, tb):
        return None


OFF = _Off()


class Span:
    """One recorded span. `dev_ms` is its device interval in ms (None off
    CUDA); `children` are the spans opened directly inside it."""

    __slots__ = ("name", "kind", "uid", "serial", "tag", "parent", "children", "device",
                 "t0", "t1", "_ev", "_rf", "_dev_ms")

    def __init__(self, name: str, kind: str | None, uid, tag, device):
        self.name, self.kind, self.uid, self.tag = name, kind, uid, tag
        self.device, self.children, self.parent, self._ev, self._dev_ms = device, [], None, None, None

    def __enter__(self):
        parent = _stack[-1] if _stack else None
        self.parent = parent
        if self.kind is None:  # a span inside a unit belongs to it
            if parent is not None:
                self.kind, self.uid, self.serial = parent.kind, parent.uid, parent.serial
                self.device = parent.device
            else:
                self.serial = None
        else:
            _count["units"] += 1
            self.serial = _count["units"]
        self._rf = _record(self.name)
        self._rf.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self._ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._ev[0].record(torch.cuda.current_stream(self.device))
        _stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        _stack.pop()
        if self._ev is not None:
            self._ev[1].record(torch.cuda.current_stream(self.device))
        self._rf.__exit__(*exc)
        self._rf = None
        if self.parent is not None:
            self.parent.children.append(self)
        _count["spans"] += 1
        _spans.append(self)
        return False

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def dev_ms(self) -> float | None:
        if self._dev_ms is None and self._ev is not None:
            self._ev[1].synchronize()
            self._dev_ms = self._ev[0].elapsed_time(self._ev[1])
        return self._dev_ms

    @property
    def self_dev_ms(self) -> float | None:
        d = self.dev_ms
        if d is None:
            return None
        return d - sum(c.dev_ms or 0.0 for c in self.children)

    def record(self) -> dict:
        return {"name": self.name, "kind": self.kind, "uid": self.uid, "unit": self.serial,
                "tag": self.tag, "parent": None if self.parent is None else self.parent.name,
                "t0_ns": self.t0, "t1_ns": self.t1, "dev_ms": self.dev_ms,
                "self_dev_ms": self.self_dev_ms}


def span(name: str, tag=None):
    """A span named `name` inside whatever span is open; `tag` tells
    repeated spans of one unit apart (a field view's camera index)."""
    if not _on():
        return OFF
    return Span(name, None, None, tag, None)


def unit(kind: str, uid, on=None):
    """The span of one unit of work: its kind ("step", "view", "field_call"),
    its id and where it runs, a tensor of the unit or a device (on CUDA its
    spans record device intervals)."""
    if not _on():
        return OFF
    dev = None if on is None else on.device if isinstance(on, torch.Tensor) else torch.device(on)
    return Span(kind, kind, uid, None, dev)


def read(what: str):
    """A device-to-host read of `what` (span `read.<what>`), counted in
    HOST_READS."""
    HOST_READS.launches += 1
    if not _on():
        return OFF
    return Span("read." + what, None, None, None, None)


def copy(what: str):
    """A host-to-device copy of `what` (span `copy.<what>`)."""
    if not _on():
        return OFF
    return Span("copy." + what, None, None, None, None)


def read_in_backward(what: str, *outs) -> None:
    """Name the device-to-host read that autograd's backward of each of
    `outs` makes (torch.prod's counts its input's zeros on the host): a
    `read.<what>` span around the backward node of each, counted in
    HOST_READS when the node runs."""
    for t in outs:
        node = t.grad_fn
        if node is not None:
            held = []
            node.register_prehook(_BackwardRead(what, held).enter)
            node.register_hook(_BackwardRead(what, held).exit)


class _BackwardRead:
    __slots__ = ("what", "held")

    def __init__(self, what, held):
        self.what, self.held = what, held

    def enter(self, grad_outputs):
        ctx = read(self.what)
        ctx.__enter__()
        self.held.append(ctx)

    def exit(self, grad_inputs, grad_outputs):
        self.held.pop().__exit__(None, None, None)


def spans() -> list:
    """The recorded spans, oldest first."""
    return list(_spans)


def dropped() -> int:
    """Spans recorded but no longer kept."""
    return _count["spans"] - len(_spans)


def summary(kind: str, last_units: int | None = None) -> dict:
    """The spans of a kind's last `last_units` units (all kept, if None):
    per span name, summed over those units, host ms, device ms (the span's
    interval, its children included), self device ms and count; the unit
    spans themselves under the kind's name. Device numbers are None where
    the units ran off CUDA. Also, per unit, the same by name (`per_unit`),
    and the units' ids."""
    units = [s for s in _spans if s.name == kind and s.kind == kind]
    if last_units is not None:
        units = units[-last_units:] if last_units > 0 else []
    keep = {u.serial for u in units}
    per = {u.serial: {} for u in units}
    for s in _spans:
        if s.serial in keep and s.kind == kind:
            _add(per[s.serial], s)
    total: dict = {}
    for d in per.values():
        for name, v in d.items():
            t = total.setdefault(name, {"host_ms": 0.0, "device_ms": 0.0, "self_device_ms": 0.0,
                                        "count": 0})
            t["host_ms"] += v["host_ms"]
            t["count"] += v["count"]
            for k in ("device_ms", "self_device_ms"):
                t[k] = None if t[k] is None or v[k] is None else t[k] + v[k]
    return {"kind": kind, "units": len(units), "ids": [u.uid for u in units],
            "dropped": dropped(), "spans": total, "per_unit": list(per.values())}


def _add(d: dict, s: Span) -> None:
    v = d.setdefault(s.name, {"host_ms": 0.0, "device_ms": 0.0, "self_device_ms": 0.0,
                              "count": 0})
    v["host_ms"] += s.host_ms
    v["count"] += 1
    dm, sm = s.dev_ms, s.self_dev_ms
    v["device_ms"] = None if dm is None or v["device_ms"] is None else v["device_ms"] + dm
    v["self_device_ms"] = None if sm is None or v["self_device_ms"] is None else (
        v["self_device_ms"] + sm)


def export(path: str) -> int:
    """Write the kept spans to `path`, one JSON object a line, oldest first.
    Returns the number written."""
    recs = [s.record() for s in _spans]
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return len(recs)
