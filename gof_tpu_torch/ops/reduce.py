"""Deterministic per-gaussian gradient reduction (counterpart of
gof_tpu/ops/reduce.py).

`reduce_rows_by_gid(rows [C, R], gid [R], P) -> [P, C]` sums the backward's
compacted gradient rows per gaussian id and drops the sentinel id P. On CUDA
tensors it sorts the ids (`segment_order`: a stable `torch.sort`, as gof_tpu
sorts with `lax.sort` outside its Pallas kernel, then one `searchsorted` for
each id's segment), and launches kernel csrc/reduce.cu, which sums every
(id, column) over its segment in ascending row order: the result is
bit-identical from run to run, as gof_tpu's reduction promises and the
original CUDA code's atomics did not. On CPU tensors it runs the plain
version, a scatter-add into [P + 1, C].
"""

from __future__ import annotations

import torch

from . import cuda_lib

REDUCE = cuda_lib.LaunchCounter("reduce")


def segment_order(ids: torch.Tensor, n: int):
    """ids [R] in [0, n] (n the sentinel): the permutation of a stable sort
    of the ids (ascending row within an id) and each id's segment start in
    it, [n + 1]; id i owns sorted positions [starts[i], starts[i + 1])."""
    ids_sorted, perm = torch.sort(ids, stable=True)
    starts = torch.searchsorted(
        ids_sorted, torch.arange(n + 1, dtype=ids.dtype, device=ids.device), side="left")
    return perm, starts


def reduce_rows_by_gid_reference(rows_t: torch.Tensor, gidc: torch.Tensor, P: int) -> torch.Tensor:
    """Plain version: scatter-add of rows_t.T into [P + 1, C], sentinel row
    dropped."""
    C = rows_t.shape[0]
    out = rows_t.new_zeros((P + 1, C))
    out.index_add_(0, gidc.long(), rows_t.T)
    return out[:P]


def reduce_rows_by_gid(rows_t: torch.Tensor, gidc: torch.Tensor, P: int) -> torch.Tensor:
    """Per-gaussian sums of compacted gradient rows.

    rows_t: [C, R] f32 (any id order); gidc: [R] int32 in [0, P] (P is the
    sentinel, dropped). Returns [P, C]. CPU tensors take the plain version;
    CUDA tensors launch csrc/reduce.cu or raise.
    """
    if rows_t.device.type == "cpu" and gidc.device.type == "cpu":
        return reduce_rows_by_gid_reference(rows_t, gidc, P)
    cuda_lib.require(rows_t.is_cuda and gidc.device == rows_t.device,
                     f"reduce: tensors on {rows_t.device} and {gidc.device}")
    cuda_lib.require(rows_t.dtype == torch.float32 and gidc.dtype == torch.int32,
                     f"reduce: dtypes {rows_t.dtype}, {gidc.dtype} (need float32, int32)")
    cuda_lib.require(rows_t.dim() == 2 and gidc.dim() == 1 and gidc.shape[0] == rows_t.shape[1],
                     f"reduce: rows {tuple(rows_t.shape)}, gid {tuple(gidc.shape)} "
                     "(need [C, R], [R])")
    cuda_lib.require(rows_t.is_contiguous() and gidc.is_contiguous(),
                     "reduce: non-contiguous input")
    cuda_lib.require(P > 0, "reduce: P must be positive")
    C, R = rows_t.shape
    perm, starts = segment_order(gidc, P)
    out = torch.empty((C, P), dtype=torch.float32, device=rows_t.device)
    rc = cuda_lib.library().gof_reduce(
        rows_t.device.index, rows_t.data_ptr(), R, C, perm.data_ptr(), starts.data_ptr(), P,
        out.data_ptr(), cuda_lib.stream_ptr(rows_t))
    cuda_lib.check(rc, "reduce")
    REDUCE.launches += 1
    return out.T
