"""Chunked device-to-host copies (counterpart of gof_tpu/utils/hostio.py).

`device_get` copies a tensor to a numpy array in row slices of at most
`chunk_bytes` each, into one preallocated host array, so no single transfer
(and no staging buffer) is larger than a slice; `tree_get` maps it over
nested dicts, lists, tuples, named tuples and dataclasses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CHUNK_BYTES = 1 << 18  # 256 KiB per transfer


def device_get(x, chunk_bytes: int = CHUNK_BYTES):
    """x as a numpy array (a tensor's copy; anything else through
    np.asarray, non-arrays unchanged), with no single device-to-host
    transfer larger than chunk_bytes."""
    if not torch.is_tensor(x):
        return np.asarray(x) if hasattr(x, "shape") else x
    x = x.detach()
    if x.dim() == 0:
        return x.cpu().numpy()
    out = np.empty(tuple(x.shape), dtype=torch.empty((), dtype=x.dtype).numpy().dtype)
    for lo, hi in row_slices(x.shape[0], x[0].numel() * x.element_size(), chunk_bytes):
        out[lo:hi] = x[lo:hi].cpu().numpy()
    return out


def row_slices(n_rows: int, row_bytes: int, chunk_bytes: int = CHUNK_BYTES) -> list:
    """[lo, hi) row ranges covering n_rows rows of row_bytes each, each at
    most chunk_bytes (at least one row)."""
    rows = max(1, chunk_bytes // max(row_bytes, 1))
    return [(lo, min(lo + rows, n_rows)) for lo in range(0, n_rows, rows)]


def tree_get(tree, chunk_bytes: int = CHUNK_BYTES):
    """device_get over a tree of dicts, lists, tuples, named tuples and
    dataclass instances (their types kept)."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_get(v, chunk_bytes)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_get(v, chunk_bytes) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_get(v, chunk_bytes) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_get(getattr(tree, f.name), chunk_bytes)
                                            for f in dataclasses.fields(tree)})
    return device_get(tree, chunk_bytes)
