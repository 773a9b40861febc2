"""Deterministic per-gaussian gradient reduction (counterpart of
gof_tpu/ops/reduce.py).

`reduce_rows_by_gid(rows [C, R], gid [R], P) -> [P, C]` sums the backward's
compacted gradient rows per gaussian id and drops the sentinel id P. Each
(id, column) is summed in ascending row order from +0.0, with no float
atomics, so the result is bit-identical from run to run, as gof_tpu's
reduction promises and the original CUDA code's atomics did not. CUDA
tensors launch csrc/reduce.cu, a counting sort of the rows into one bucket
per id (count, scan, fill) and a reduce that orders each bucket by row and
folds it; CPU tensors run the plain version, a sequential scatter-add into
[P + 1, C], which sums in the same order. `reduce_row_blocks` takes the
columns as several row arrays, so the backward's gradient and statistics
rows need no concatenation.

`segment_order` (a stable id sort and each id's segment start) is K10's
presort (ops/gather_probes.py::scatmxu); `bucket_order_reference` is the
plain twin of the order K4's reduce walks.
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


def bucket_order_reference(gidc: torch.Tensor, P: int):
    """The rows K4 folds and their order, by counting (a row-by-row loop):
    the rows with an id in [0, P), bucketed by id, each bucket in ascending
    row order, and each bucket's start, [P + 1] (id g owns positions
    [starts[g], starts[g + 1])). The kernel's fill places rows in any order
    inside their bucket, and its reduce sorts each bucket into this one."""
    g = gidc.long()
    cnt = torch.bincount(g[(g >= 0) & (g < P)], minlength=P)
    starts = torch.zeros(P + 1, dtype=torch.int64)
    torch.cumsum(cnt.cpu(), 0, out=starts[1:])
    cursor = starts[:-1].tolist()
    order = [0] * int(starts[-1])
    for r, i in enumerate(g.tolist()):
        if 0 <= i < P:
            order[cursor[i]] = r
            cursor[i] += 1
    return torch.tensor(order, dtype=torch.int64), starts


def reduce_rows_by_gid_reference(rows_t: torch.Tensor, gidc: torch.Tensor, P: int) -> torch.Tensor:
    """Plain version: scatter-add of rows_t.T into [P + 1, C], sentinel row
    dropped. On the CPU index_add_ adds the rows one by one in ascending
    row order, K4's order."""
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
    return reduce_row_blocks([rows_t], gidc, P)


def reduce_row_blocks(blocks, gidc: torch.Tensor, P: int) -> torch.Tensor:
    """`reduce_rows_by_gid` of the rows stacked from `blocks`, one or two
    [C_i, R] f32 arrays: [P, sum C_i], column order as stacked."""
    blocks = list(blocks)
    cuda_lib.require(1 <= len(blocks) <= 2, f"reduce: {len(blocks)} row arrays (need 1 or 2)")
    for b in blocks:
        cuda_lib.require(b.dim() == 2 and gidc.dim() == 1 and gidc.shape[0] == b.shape[1],
                         f"reduce: rows {tuple(b.shape)}, gid {tuple(gidc.shape)} "
                         "(need [C, R], [R])")
    if all(b.device.type == "cpu" for b in blocks) and gidc.device.type == "cpu":
        rows = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=0)
        return reduce_rows_by_gid_reference(rows, gidc, P)
    dev = blocks[0].device
    cuda_lib.require(all(b.is_cuda and b.device == dev for b in blocks) and gidc.device == dev,
                     f"reduce: tensors on {[str(b.device) for b in blocks]} and {gidc.device}")
    cuda_lib.require(all(b.dtype == torch.float32 for b in blocks) and gidc.dtype == torch.int32,
                     f"reduce: dtypes {[b.dtype for b in blocks]}, {gidc.dtype} "
                     "(need float32, int32)")
    cuda_lib.require(all(b.is_contiguous() for b in blocks) and gidc.is_contiguous(),
                     "reduce: non-contiguous input")
    cuda_lib.require(P > 0, "reduce: P must be positive")
    R = gidc.shape[0]
    (a, ca), (b, cb) = [(x, x.shape[0]) for x in blocks] + [(None, 0)] * (2 - len(blocks))
    C = ca + cb
    lib = cuda_lib.library()
    ws = torch.empty(lib.gof_reduce_workspace(P, R), dtype=torch.int32, device=dev)
    vals = torch.empty((R, (C + 3) // 4 * 4), dtype=torch.float32, device=dev)
    out = torch.empty((C, P), dtype=torch.float32, device=dev)
    rc = lib.gof_reduce(dev.index, a.data_ptr(), ca, None if b is None else b.data_ptr(), cb, R,
                        gidc.data_ptr(), P, ws.data_ptr(), vals.data_ptr(), out.data_ptr(),
                        cuda_lib.stream_ptr(a))
    cuda_lib.check(rc, "reduce")
    REDUCE.launches += 1
    return out.T
