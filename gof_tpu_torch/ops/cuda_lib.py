"""Build and load the port's CUDA kernels (csrc/*.cu) on first use.

Each source is compiled by its own nvcc process for sm_90a, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The library lands in
`build/gof_tpu_torch/<hash>/` at the repository root, keyed by a hash of the
sources and their flags, so an edit rebuilds and an unchanged tree reuses
it. Nothing is built at import: the first kernel launch calls `library()`.

Every source but K1's and K3's is built with `-fmad=false`, which keeps
nvcc from contracting a*b+c into FMAs: each kernel then rounds every
operation as its plain PyTorch version does, so the two agree to the last
bit where they run the same operations in the same order. K1
(rasterize_fwd.cu) and K3 (rasterize_bwd.cu) are built with contraction
on: their alpha/transmittance chain (csrc/ray_alpha.cuh, shared with K5),
which must keep the plain version's bits, is written with intrinsics that
nvcc never contracts, and their accumulations and gradients, held to their
plain versions by tolerance, run on FMAs. The headers (csrc/*.cuh) are
part of the library's hash.
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
EXACT = ("-fmad=false",)
CONTRACT = ("-fmad=true",)
SOURCES = {  # each source and its own nvcc flags
    "expand.cu": EXACT, "rasterize_fwd.cu": CONTRACT, "rasterize_bwd.cu": CONTRACT,
    "reduce.cu": EXACT, "integrate.cu": EXACT, "gather_probes.cu": EXACT,
}
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "gof_tpu_torch"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libgof_tpu_torch.so"

_PTR = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    # device, tbl, ncols, P, gidx, cap, out, stream
    "gof_expand": (ctypes.c_int, _PTR, ctypes.c_int, ctypes.c_longlong, _PTR,
                   ctypes.c_longlong, _PTR, _PTR),
    # device, payload, cap, bounds, meta, ntx, ntiles, with_reg, out, livec, stream
    "gof_rasterize_fwd": (ctypes.c_int, _PTR, ctypes.c_longlong, _PTR, _PTR, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _PTR, _PTR, _PTR),
    # device, payload, cap, slot ids, bounds, fout, gout, meta, ntx, ntiles, halfw, halfh,
    # with_stats, with_reg, R, rows, gid, tile order, T mismatches, stream
    "gof_rasterize_bwd": (ctypes.c_int, _PTR, ctypes.c_longlong, _PTR, _PTR, _PTR, _PTR, _PTR,
                          ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _PTR, _PTR, _PTR, _PTR,
                          _PTR),
    # device, rows_a, ca, rows_b, cb, R, gid, P, workspace, vals, out, stream
    "gof_reduce": (ctypes.c_int, _PTR, ctypes.c_int, _PTR, ctypes.c_int, _LL, _PTR, _LL, _PTR,
                   _PTR, _PTR, _PTR),
    # device, vals, R, cp, c, gid, P, workspace, out, stream
    "gof_reduce_rows": (ctypes.c_int, _PTR, _LL, ctypes.c_int, ctypes.c_int, _PTR, _LL, _PTR,
                        _PTR, _PTR),
    # device, payload, cap, seg_s, seg_e, n_blocks, rays, nslots, point_of_slot, n_points, out,
    # stream
    "gof_integrate": (ctypes.c_int, _PTR, ctypes.c_longlong, _PTR, _PTR, ctypes.c_int, _PTR,
                      ctypes.c_longlong, _PTR, ctypes.c_longlong, _PTR, _PTR),
    # the gather/scatter probes (gather_probes.cu)
    # device, idx, n, table, page, w, out, stream
    "gof_take_gather": (ctypes.c_int, _PTR, _LL, _PTR, _LL, _LL, _PTR, _PTR),
    "gof_vidx_gather": (ctypes.c_int, _PTR, _LL, _PTR, _LL, _LL, _PTR, _PTR),
    # device, idx, n, table, page, w, tB (bf16 scratch), ws (int32 scratch), srt, out, stream
    "gof_onehot_gather": (ctypes.c_int, _PTR, _LL, _PTR, _LL, _LL, _PTR, _PTR, _PTR, _PTR,
                          _PTR),
    # device, idx, n, rows, w, page, out, stream
    "gof_scat": (ctypes.c_int, _PTR, _LL, _PTR, _LL, _LL, _PTR, _PTR),
    # device, table, rows, wg, c8, tB, stream
    "gof_s8_layout": (ctypes.c_int, _PTR, _LL, _LL, _LL, _PTR, _PTR),
    # device, pages, nch, npages, order, starts, stream
    "gof_page_group": (ctypes.c_int, _PTR, _LL, _LL, _PTR, _PTR, _PTR),
    # device, pages, order, starts, idx, nch, ch, tB, npages, wg, c8, out, stream
    "gof_s8_onehot": (ctypes.c_int, _PTR, _PTR, _PTR, _PTR, _LL, _LL, _PTR, _LL, _LL, _LL, _PTR,
                      _PTR),
    # device, off, nch, wg, val, cv, base, bstride, ch, out, stream
    "gof_rld": (ctypes.c_int, _PTR, _LL, _LL, _PTR, _LL, _PTR, _LL, _LL, _PTR, _PTR),
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
    for name, flags in SOURCES.items():
        h.update(name.encode())
        h.update(" ".join(flags).encode())
        h.update((CSRC / name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    nvcc per source, run in parallel, then one link. Returns the library's
    path; raises with nvcc's output if a step fails."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(o), str(CSRC / s)]
            for (s, flags), o in zip(SOURCES.items(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(" ".join(c) + "\n" + out)
        if p.returncode != 0:
            failed.append(f"nvcc failed ({p.returncode}):\n{out}")
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    if not failed:
        link = [nvcc, *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)]
        r = subprocess.run(link, capture_output=True, text=True)
        logs.append(" ".join(link) + "\n" + r.stdout + r.stderr)
        if r.returncode != 0:
            failed.append(f"nvcc link failed ({r.returncode}):\n{r.stdout}{r.stderr}")
    (out_dir / "build.log").write_text("\n".join(logs))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
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
    lib.gof_reduce_workspace.argtypes = [_LL, _LL]  # P, R -> int32 words
    lib.gof_reduce_workspace.restype = _LL
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
