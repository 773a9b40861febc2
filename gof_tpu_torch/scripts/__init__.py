"""Entry points that port gof_tpu's TPU cost probes (scripts/*_probe.py):

    python -m gof_tpu_torch.scripts.pallas_gather_probe [--cpu]
    python -m gof_tpu_torch.scripts.mxu_gather_probe [--cpu]

and the checks and report lines they share. Times come from
gof_tpu_torch.utils.timing: CUDA events on the card; with `--cpu` the plain
PyTorch versions run and the host clock times them (CPU times, not device
metrics).
"""

from __future__ import annotations

import torch

from gof_tpu_torch.utils.timing import bound_ms, time_ms


def exact(got, want, lib=None) -> dict:
    """The kernel's output against its plain version (and the library
    call's output, where one computes the same function): bit-equal?"""
    r = {"exact": bool(torch.equal(got, want)),
         "max_abs_err": float((got - want).abs().max()) if got.numel() else 0.0}
    if lib is not None:
        r["library_exact"] = bool(torch.equal(got, lib))
    return r


def probe(fn, plain, library, args_list, device, reps: int, nbytes_: int, check) -> dict:
    """Time the kernel, its plain version and the library call (None where
    no single call computes the function) on the same inputs, cycling
    through args_list; the bound of moving nbytes_; then `check(kernel's
    output, plain's, library's)` on the first inputs."""
    r = {"ms": time_ms(fn, args_list, device, reps),
         "plain_ms": time_ms(plain, args_list, device, reps),
         "library_ms": None if library is None else time_ms(library, args_list, device, reps)}
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes_)
    a = args_list[0]
    r.update(check(fn(*a), plain(*a), None if library is None else library(*a)))
    return r


def pick_device(cpu: bool) -> torch.device:
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu for the CPU path")
    return torch.device("cuda")


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def report(name: str, r: dict) -> None:
    """One probe's line: name, kernel ms, then plain, library and bound ms."""
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    print(f"{name:58s} {r['ms']:8.4f} ms  plain_ms {r['plain_ms']:.4f}  library_ms {lib}  "
          f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
