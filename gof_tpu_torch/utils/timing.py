"""Device timing and the card's bound, shared by chip_smoke.py and the probe
entry points (gof_tpu_torch/scripts/).

`time_ms` times a call with CUDA events on the card, or the host clock on
the CPU (CPU times, not device metrics). `bound_ms` is the least time an
H100 SXM could take for a function: its bytes over the memory rate or its
operations over the peak rate of their type, whichever is larger.
"""

from __future__ import annotations

import statistics
import time

import torch

# NVIDIA H100 SXM, published dense peaks (the rates at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound_ms(nbytes: float, ops: float = 0.0, kind: str = "f32"):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type.
    Returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def time_ms(fn, args_list, device: torch.device, reps: int = 16, warmup: int = 1) -> float:
    """Median milliseconds of one fn(*args) call, cycling through args_list.

    On CUDA each call sits between two CUDA events, behind a short device
    sleep that lets the host enqueue the call before the device reaches it,
    so the time is the device's, not the Python wrapper's. On the CPU, the
    host clock."""
    cuda = device.type == "cuda"
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    ts = []
    if cuda:
        torch.cuda.synchronize()
    for i in range(reps):
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)  # ~1 ms of device clock cycles
            e0.record()
            fn(*args_list[i % len(args_list)])
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            fn(*args_list[i % len(args_list)])
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)
