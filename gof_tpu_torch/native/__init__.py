"""Native COLMAP reader (C++ over ctypes; counterpart of gof_tpu/native).

`load()` builds `colmap_io.cpp` with g++ at first use into
`build/gof_tpu_torch/native/<hash>/libgof_io.so` at the repository root
(keyed by a hash of the source and the flags, so an edit rebuilds), loads
it, and returns the library; it returns None where there is no g++ or the
build fails. `data/colmap.py` reads through it when it loads and through
its Python parsers otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "colmap_io.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "gof_tpu_torch" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libgof_io.so"

_LIB = None
_TRIED = False


def lib_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / key / LIB_NAME


def build() -> Optional[Path]:
    """Compile the reader (once per source hash). Returns the library's path,
    or None without g++ or when the compile fails."""
    out = lib_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([gxx, *FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: a concurrent loader sees a whole file
    return out


def load() -> Optional[ctypes.CDLL]:
    """The reader's library (built at first use), or None."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    c = ctypes.c_longlong
    p = ctypes.c_char_p
    lib.colmap_count_points3d.restype = c
    lib.colmap_count_points3d.argtypes = [p]
    lib.colmap_read_points3d.restype = c
    lib.colmap_read_points3d.argtypes = [p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, c]
    lib.colmap_count_images.restype = c
    lib.colmap_count_images.argtypes = [p]
    lib.colmap_read_images.restype = c
    lib.colmap_read_images.argtypes = [p] + [ctypes.c_void_p] * 5 + [c, c]
    lib.colmap_read_cameras.restype = c
    lib.colmap_read_cameras.argtypes = [p] + [ctypes.c_void_p] * 4 + [c]
    _LIB = lib
    return _LIB


def read_points3d_native(path: str):
    lib = load()
    if lib is None:
        return None
    n = lib.colmap_count_points3d(path.encode())
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    got = lib.colmap_read_points3d(path.encode(), xyz.ctypes.data, rgb.ctypes.data,
                                   err.ctypes.data, n)
    if got != n:
        return None
    return xyz, rgb, err


def read_images_native(path: str):
    lib = load()
    if lib is None:
        return None
    n = lib.colmap_count_images(path.encode())
    if n < 0:
        return None
    stride = 512
    ids = np.empty((n,), np.int32)
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    cam_ids = np.empty((n,), np.int32)
    names = np.zeros((n, stride), np.uint8)
    got = lib.colmap_read_images(path.encode(), ids.ctypes.data, qvec.ctypes.data,
                                 tvec.ctypes.data, cam_ids.ctypes.data, names.ctypes.data,
                                 stride, n)
    if got != n:
        return None
    name_list = [bytes(names[i]).split(b"\0", 1)[0].decode() for i in range(n)]
    return ids, qvec, tvec, cam_ids, name_list


def read_cameras_native(path: str):
    lib = load()
    if lib is None:
        return None
    cap = 4096  # cameras.bin is tiny; over-allocate
    ids = np.empty((cap,), np.int32)
    models = np.empty((cap,), np.int32)
    wh = np.empty((cap, 2), np.int64)
    params = np.empty((cap, 12), np.float64)
    got = lib.colmap_read_cameras(path.encode(), ids.ctypes.data, models.ctypes.data,
                                  wh.ctypes.data, params.ctypes.data, cap)
    if got < 0:
        return None
    n = int(got)
    return ids[:n], models[:n], wh[:n], params[:n]
