"""Build and load the port's CUDA kernels (csrc/*.cu) on first use.

The sources are compiled by nvcc for sm_90a into one shared library with a
plain C interface, loaded with ctypes. The library lands in
`build/gof_tpu_torch/<hash>/` at the repository root, keyed by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses it.
Nothing is built at import: the first kernel launch calls `library()`.

`-fmad=false` keeps nvcc from contracting a*b+c into FMAs: each kernel then
rounds every operation as its plain PyTorch version does, so the two agree
to the last bit where they run the same operations in the same order.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("expand.cu", "rasterize_fwd.cu")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "gof_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libgof_tpu_torch.so"

_PTR = ctypes.c_void_p
_SIGNATURES = {
    # device, tbl, ncols, P, gidx, cap, out, stream
    "gof_expand": (ctypes.c_int, _PTR, ctypes.c_int, ctypes.c_longlong, _PTR,
                   ctypes.c_longlong, _PTR, _PTR),
    # device, payload, cap, bounds, meta, ntx, ntiles, with_reg, out, livec, stream
    "gof_rasterize_fwd": (ctypes.c_int, _PTR, ctypes.c_longlong, _PTR, _PTR, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _PTR, _PTR, _PTR),
}


class LaunchCounter:
    """Number of times a wrapper launched its CUDA kernel (never counts the
    plain CPU version). Reset with `launches = 0`."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    Returns its path; raises with nvcc's output if the build fails."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(CSRC / s) for s in SOURCES]]
    r = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    """nvcc's output of the current build (ptxas register/smem report)."""
    return (BUILD_ROOT / source_hash() / "build.log").read_text()


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.gof_error_string.argtypes = [ctypes.c_int]
    lib.gof_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().gof_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
