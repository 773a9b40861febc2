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
columns as one or two column-major row arrays; `reduce_row_major` takes
rows that are already row-major ([R, cp], the backward blend's row buffer
and K10's rows), so the kernel skips its copy to row-major.

`segment_order` (a stable id sort and each id's segment start) is the plain
order that `bucket_order_reference`, the plain twin of the order K4's
reduce walks, is held to.
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


def _on_cpu_or_one_cuda(name: str, tensors) -> bool:
    """True for all-CPU tensors; otherwise all must lie on one CUDA device."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    cuda_lib.require(all(t.is_cuda and t.device == dev for t in tensors),
                     f"{name}: tensors on {[str(t.device) for t in tensors]}")
    return False


def reduce_row_blocks(blocks, gidc: torch.Tensor, P: int) -> torch.Tensor:
    """`reduce_rows_by_gid` of the rows stacked from `blocks`, one or two
    [C_i, R] f32 arrays: [P, sum C_i], column order as stacked."""
    blocks = list(blocks)
    cuda_lib.require(1 <= len(blocks) <= 2, f"reduce: {len(blocks)} row arrays (need 1 or 2)")
    for b in blocks:
        cuda_lib.require(b.dim() == 2 and gidc.dim() == 1 and gidc.shape[0] == b.shape[1],
                         f"reduce: rows {tuple(b.shape)}, gid {tuple(gidc.shape)} "
                         "(need [C, R], [R])")
    if _on_cpu_or_one_cuda("reduce", blocks + [gidc]):
        rows = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=0)
        return reduce_rows_by_gid_reference(rows, gidc, P)
    dev = blocks[0].device
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


def reduce_row_major(vals: torch.Tensor, gidc: torch.Tensor, P: int, c: int = 0) -> torch.Tensor:
    """`reduce_rows_by_gid` of rows that are already row-major: vals [R, cp]
    f32, of which the first c columns (all when c is 0) are summed per id,
    each in ascending row order from +0.0. Returns [P, c]. On CUDA vals is
    contiguous and 16-byte aligned with cp a multiple of 4, and ids outside
    [0, P) are dropped; CPU tensors take the plain version of the
    transposed rows (ids in [0, P], P the sentinel)."""
    c = c or vals.shape[1]
    cuda_lib.require(vals.dim() == 2 and gidc.dim() == 1 and gidc.shape[0] == vals.shape[0]
                     and 0 < c <= vals.shape[1],
                     f"reduce_row_major: vals {tuple(vals.shape)}, gid {tuple(gidc.shape)}, "
                     f"c {c} (need [R, cp], [R], 0 < c <= cp)")
    cuda_lib.require(P > 0, "reduce_row_major: P must be positive")
    if _on_cpu_or_one_cuda("reduce_row_major", [vals, gidc]):
        return reduce_rows_by_gid_reference(vals[:, :c].T, gidc, P)
    out = sum_rows_by_id(vals, gidc, P, c)
    REDUCE.launches += 1
    return out.T


def sum_rows_by_id(vals: torch.Tensor, ids: torch.Tensor, P: int, c: int) -> torch.Tensor:
    """csrc/reduce.cu's row-major entry on CUDA tensors, uncounted: the sums
    of vals[:, :c] per id in [0, P), as [c, P] (ids outside [0, P) dropped).
    Raises on what the kernel does not take."""
    cuda_lib.require(vals.dtype == torch.float32 and ids.dtype == torch.int32,
                     f"reduce_row_major: dtypes {vals.dtype}, {ids.dtype} (need float32, int32)")
    cuda_lib.require(vals.is_contiguous() and ids.is_contiguous(),
                     "reduce_row_major: non-contiguous input")
    R, cp = vals.shape
    cuda_lib.require(cp % 4 == 0 and vals.data_ptr() % 16 == 0,
                     f"reduce_row_major: rows of {cp} floats (need a multiple of 4, 16-byte "
                     "aligned)")
    dev = vals.device
    lib = cuda_lib.library()
    ws = torch.empty(lib.gof_reduce_workspace(P, R), dtype=torch.int32, device=dev)
    out = torch.empty((c, P), dtype=torch.float32, device=dev)
    rc = lib.gof_reduce_rows(dev.index, vals.data_ptr(), R, cp, c, ids.data_ptr(), P,
                             ws.data_ptr(), out.data_ptr(), cuda_lib.stream_ptr(vals))
    cuda_lib.check(rc, "reduce_row_major")
    return out
