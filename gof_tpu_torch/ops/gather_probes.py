"""The gather/scatter probes' kernels (counterparts of the Pallas kernels of
scripts/pallas_gather_probe.py, K6-K10, and scripts/mxu_gather_probe.py,
K11-K13).

Each function keeps the JAX function's name, argument order and array
shapes, the `[nchunks, 1, chunk]` int32 index layout included; the shape
constants the scripts read from module globals (PAGE, PAGE_B, CH, WG) are
trailing keyword arguments with the scripts' values. CPU tensors take the
plain PyTorch version `<name>_reference`; CUDA tensors launch the kernel in
csrc/gather_probes.cu or raise. Dtypes and shapes are checked on both paths.

Edge behaviour, as the Pallas kernels give it (run in interpret mode):
- take_gather (K6): jnp.take's fill mode: an index in [-PAGE, 0) wraps, any
  other index outside [0, PAGE) gives a zero row;
- vidx_gather (K7): a negative index wraps once, then the row is clamped to
  [0, PAGE - 1]; on the card K6's kernel with the clamp, any W;
- onehot_gather (K8): bf16(table)[idx] as f32; an index outside [0, PAGE)
  gives a zero row; defined on finite tables; on the card a one-hot product
  over only the k-steps the rows hit, after a counting sort of the rows;
- scat (K9): `.at[idx].add`: an index in [-PAGE, 0) wraps, others outside
  [0, PAGE) are dropped; summed with 16-byte vector atomics, in no fixed
  order;
- scatmxu (K10): the segment sum with every index outside [0, PAGE) dropped
  (no wrap), summed per output row in ascending input row: deterministic,
  and bit-equal to its plain version (on the card, K4's counting-sort
  reduce, csrc/reduce.cu);
- int8_gather (K11): int32(table[idx]); an index outside [0, WG) gives zero;
- rld (K12): run-length decode, out[k] = val[w] for off[w] <= k < off[w+1]
  (the last run open up to 2^30), 0 where no run covers k, k = base + row
  in int32 arithmetic (wrapping); the offsets of each chunk are
  non-decreasing (a run-length table); on the card each block reads only
  the offsets inside its rows' k range, any WG;
- paged_gather (K13): int32(table[idx]) when idx lies in the chunk's page
  pages[i] (rows [pages[i] * WG, (pages[i] + 1) * WG)), else 0; a page
  outside the table gives zero rows.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .reduce import sum_rows_by_id

TAKE = cuda_lib.LaunchCounter("take_gather")
VIDX = cuda_lib.LaunchCounter("vidx_gather")
ONEHOT = cuda_lib.LaunchCounter("onehot_gather")
SCAT = cuda_lib.LaunchCounter("scat")
SCATMXU = cuda_lib.LaunchCounter("scatmxu")
INT8 = cuda_lib.LaunchCounter("int8_gather")
RLD = cuda_lib.LaunchCounter("rld")
PAGED = cuda_lib.LaunchCounter("paged_gather")
COUNTERS = (TAKE, VIDX, ONEHOT, SCAT, SCATMXU, INT8, RLD, PAGED)

SMEM_MAX = 232_448  # dynamic shared memory a block may use on Hopper
RUN_END = 2**30  # rld: where the last run ends


def _check(name: str, *specs) -> None:
    """specs: (label, tensor, dtype, ndim) each."""
    for label, t, dtype, ndim in specs:
        cuda_lib.require(t.dtype == dtype, f"{name}: {label} is {t.dtype} (need {dtype})")
        cuda_lib.require(t.dim() == ndim, f"{name}: {label} has shape {tuple(t.shape)} "
                                          f"(need {ndim} dims)")


def _check_idx(name: str, idx: torch.Tensor) -> None:
    _check(name, ("idx", idx, torch.int32, 3))
    cuda_lib.require(idx.shape[1] == 1, f"{name}: idx {tuple(idx.shape)} (need [n, 1, chunk])")


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _require_cuda(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    cuda_lib.require(all(t.is_cuda and t.device == dev for t in ts),
                     f"{name}: tensors on {[str(t.device) for t in ts]}")
    cuda_lib.require(all(t.is_contiguous() for t in ts), f"{name}: non-contiguous input")


def _launch(counter: cuda_lib.LaunchCounter, t: torch.Tensor, *args) -> None:
    """Call gof_<counter.name>(device, *args, stream), raise on a CUDA error,
    count the launch."""
    fn = getattr(cuda_lib.library(), f"gof_{counter.name}")
    cuda_lib.check(fn(t.device.index, *args, cuda_lib.stream_ptr(t)), counter.name)
    counter.launches += 1


# ---------------------------------------------------------------------------
# K6, K7: row gathers from a [PAGE, W] f32 table
# ---------------------------------------------------------------------------


def take_gather_reference(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    page = table.shape[0]
    j = idx.reshape(-1).long()
    ok = (j >= -page) & (j < page)
    return table[j.remainder(page)].masked_fill_(~ok[:, None], 0)


def take_gather(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K6: idx [nchunk, 1, chunk] int32, table [PAGE, W] f32 -> [n, W] f32.
    On CUDA a warp per 32 rows, 16-byte pieces where W % 4 == 0 and the
    table is 16-byte aligned, 4-byte pieces otherwise (any W, any view)."""
    _check_idx("take_gather", idx)
    _check("take_gather", ("table", table, torch.float32, 2))
    cuda_lib.require(table.shape[0] > 0, "take_gather: empty table")
    if _on_cpu(idx, table):
        return take_gather_reference(idx, table)
    _require_cuda("take_gather", idx, table)
    page, w = table.shape
    out = torch.empty((idx.numel(), w), dtype=torch.float32, device=table.device)
    _launch(TAKE, table, idx.data_ptr(), idx.numel(), table.data_ptr(), page, w, out.data_ptr())
    return out


def vidx_gather_reference(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    page = table.shape[0]
    j = idx.reshape(-1).long()
    return table[torch.where(j < 0, j + page, j).clamp_(0, page - 1)]


def vidx_gather(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K7: the same shapes as take_gather, with the ref indexer's wrap-then-
    clamp semantics; on CUDA take_gather's kernel with the clamp."""
    _check_idx("vidx_gather", idx)
    _check("vidx_gather", ("table", table, torch.float32, 2))
    cuda_lib.require(table.shape[0] > 0, "vidx_gather: empty table")
    if _on_cpu(idx, table):
        return vidx_gather_reference(idx, table)
    _require_cuda("vidx_gather", idx, table)
    page, w = table.shape
    out = torch.empty((idx.numel(), w), dtype=torch.float32, device=table.device)
    _launch(VIDX, table, idx.data_ptr(), idx.numel(), table.data_ptr(), page, w, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K8: the one-hot bf16 product
# ---------------------------------------------------------------------------


def onehot_gather_reference(idx: torch.Tensor, table: torch.Tensor,
                            page_b: int = 2048) -> torch.Tensor:
    """page_b, the wrapper's page size, does not change the result."""
    page = table.shape[0]
    j = idx.reshape(-1).long()
    ok = (j >= 0) & (j < page)
    return table.bfloat16().float()[j.clamp(0, page - 1)].masked_fill_(~ok[:, None], 0)


def onehot_gather(idx: torch.Tensor, table: torch.Tensor, page_b: int = 2048) -> torch.Tensor:
    """K8: idx [nchunk, 1, chunk] int32, table [PAGE, W] f32 -> [n, W] f32
    = bf16(table)[idx], by one-hot bf16 products on the tensor cores. PAGE %
    page_b == 0 (the TPU kernel's pages); page_b does not change the result.

    Defined on finite tables (the script draws them): a one-hot product
    gives 0 x inf = NaN in the rows that share a non-finite entry's k-step.
    On CUDA, four passes: the table rounded to bf16 in wgmma's B layout; a
    counting sort of the rows by k-step (16 table rows; indices outside
    [0, PAGE) in a bucket of their own); then per 64 sorted rows one
    m64n32k16 product per k-step the rows hit (not every k-step of every
    page), each row written to its own place. A -0.0 entry comes out +0.0
    (equal under ==, as torch.equal compares). The kernel needs W % 32 == 0
    and PAGE % 16 == 0, and fewer than 2**31 rows."""
    _check_idx("onehot_gather", idx)
    _check("onehot_gather", ("table", table, torch.float32, 2))
    page, w = table.shape
    cuda_lib.require(page > 0 and page_b > 0 and page % page_b == 0,
                     f"onehot_gather: PAGE {page} is not a multiple of PAGE_B {page_b}")
    if _on_cpu(idx, table):
        return onehot_gather_reference(idx, table, page_b)
    _require_cuda("onehot_gather", idx, table)
    nb = page // 16 + 1  # the k-steps and the bucket off the table
    cuda_lib.require(w % 32 == 0 and page % 16 == 0 and 4 * nb + 1024 <= SMEM_MAX,
                     f"onehot_gather: W {w}, PAGE {page} (need W a multiple of 32, PAGE a "
                     "multiple of 16 up to 925,680)")
    n = idx.numel()
    cuda_lib.require(n < 2**31, f"onehot_gather: {n} indices (need fewer than 2**31)")
    dev = table.device
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    tB = torch.empty(page * w, dtype=torch.bfloat16, device=dev)
    ws = torch.empty(2 * nb + 1, dtype=torch.int32, device=dev)
    srt = torch.empty((n, 2), dtype=torch.int32, device=dev)
    _launch(ONEHOT, table, idx.data_ptr(), n, table.data_ptr(), page, w, tB.data_ptr(),
            ws.data_ptr(), srt.data_ptr(), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K9, K10: segment sums of [n, W] f32 rows into [PAGE, W]
# ---------------------------------------------------------------------------


def _check_scatter(name: str, idx: torch.Tensor, rows: torch.Tensor, page: int) -> None:
    _check_idx(name, idx)
    _check(name, ("rows", rows, torch.float32, 2))
    cuda_lib.require(rows.shape[0] == idx.numel(),
                     f"{name}: rows {tuple(rows.shape)} for {idx.numel()} indices")
    cuda_lib.require(page > 0, f"{name}: PAGE must be positive")


def scat_reference(idx: torch.Tensor, rows: torch.Tensor, page: int = 16384) -> torch.Tensor:
    j = idx.reshape(-1).long()
    ok = (j >= -page) & (j < page)
    out = rows.new_zeros((page + 1, rows.shape[1]))
    out.index_add_(0, torch.where(ok, j.remainder(page), page), rows)
    return out[:page]


def scat(idx: torch.Tensor, rows: torch.Tensor, page: int = 16384) -> torch.Tensor:
    """K9: idx [nchunk, 1, chunk] int32, rows [n, W] f32 -> [PAGE, W] f32,
    the segment sum by atomic adds (order-dependent). On CUDA each 16 bytes
    of a row go by one vector reduction (red.global.add.v4.f32), so the
    kernel needs W % 4 == 0 and 16-byte aligned rows."""
    _check_scatter("scat", idx, rows, page)
    if _on_cpu(idx, rows):
        return scat_reference(idx, rows, page)
    _require_cuda("scat", idx, rows)
    w = rows.shape[1]
    cuda_lib.require(w % 4 == 0 and rows.data_ptr() % 16 == 0,
                     f"scat: W = {w} (need a multiple of 4, 16-byte aligned rows)")
    out = torch.zeros((page, w), dtype=torch.float32, device=rows.device)
    _launch(SCAT, rows, idx.data_ptr(), idx.numel(), rows.data_ptr(), w, page, out.data_ptr())
    return out


def _ids_in_page(idx: torch.Tensor, page: int) -> torch.Tensor:
    """Ids in [0, page), and the sentinel `page` for the rest."""
    j = idx.reshape(-1)
    return torch.where((j >= 0) & (j < page), j, page)


def scatmxu_reference(idx: torch.Tensor, rows: torch.Tensor, page: int = 16384) -> torch.Tensor:
    key, order = torch.sort(_ids_in_page(idx, page), stable=True)
    out = rows.new_zeros((page + 1, rows.shape[1]))
    out.index_add_(0, key.long(), rows[order])
    return out[:page]


def scatmxu(idx: torch.Tensor, rows: torch.Tensor, page: int = 16384) -> torch.Tensor:
    """K10: the same shapes as scat; indices outside [0, PAGE) are dropped
    and each (row, column) is summed in ascending input row, so the result
    equals the plain version's bit for bit and across launches. On CUDA the
    rows go as they are ([n, W], W a multiple of 4) into K4's counting-sort
    reduce (ops/reduce.py::sum_rows_by_id), which drops every id outside
    [0, PAGE) itself; the result is a [PAGE, W] view of its [W, PAGE]
    output."""
    _check_scatter("scatmxu", idx, rows, page)
    if _on_cpu(idx, rows):
        return scatmxu_reference(idx, rows, page)
    _require_cuda("scatmxu", idx, rows)
    out = sum_rows_by_id(rows, idx.reshape(-1), page, rows.shape[1])
    SCATMXU.launches += 1
    return out.T


# ---------------------------------------------------------------------------
# K11, K13: the one-hot int8 products
# ---------------------------------------------------------------------------


def _s8_kernel_ok(name: str, wg: int, c8: int) -> None:
    cuda_lib.require(wg % 64 == 0 and c8 % 64 == 0 and 64 * (wg + 16) <= SMEM_MAX,
                     f"{name}: WG {wg}, C {c8} (need multiples of 64, WG up to 3584)")


def _s8_blocks(rows: int, wg: int, c8: int):
    """A [rows, c8] table's view as the kernel's B blocks: [page, k-step,
    k half, 16 k bytes, slab, 8-column group, column]."""
    return (rows // wg, wg // 32, 2, 16, c8 // 64, 8, 8)


_S8_ORDER = (0, 4, 1, 2, 5, 6, 3)  # -> [page, slab, k-step, k half, group, column, k byte]


def s8_operand_layout_reference(table: torch.Tensor, wg: int) -> torch.Tensor:
    """The int8 table [npages * wg, c8] in the kernel's B layout, flat: per
    (page, 64-column slab) one block of wg * 64 bytes; in it per 32-row
    k-step 2048 bytes, the two 16-row halves 1024 bytes apart, each a run
    of 8 core matrices (8 columns x 16 k bytes, 128 bytes)."""
    rows, c8 = table.shape
    return table.reshape(_s8_blocks(rows, wg, c8)).permute(_S8_ORDER).reshape(-1)


def s8_operand_layout_inverse_reference(tB: torch.Tensor, rows: int, wg: int,
                                        c8: int) -> torch.Tensor:
    """The [rows, c8] table back from its B layout."""
    shape = _s8_blocks(rows, wg, c8)
    inv = [_S8_ORDER.index(i) for i in range(len(_S8_ORDER))]
    return tB.reshape([shape[i] for i in _S8_ORDER]).permute(inv).reshape(rows, c8)


def s8_operand_layout(table: torch.Tensor, wg: int) -> torch.Tensor:
    """K11/K13's prep pass: `s8_operand_layout_reference` by a kernel on CUDA
    tensors (wg and c8 multiples of 64)."""
    if table.device.type == "cpu":
        return s8_operand_layout_reference(table, wg)
    rows, c8 = table.shape
    tB = torch.empty(rows * c8, dtype=torch.int8, device=table.device)
    cuda_lib.check(cuda_lib.library().gof_s8_layout(table.device.index, table.data_ptr(), rows,
                                                    wg, c8, tB.data_ptr(),
                                                    cuda_lib.stream_ptr(table)), "s8_layout")
    return tB


def group_chunks_by_page_reference(pages: torch.Tensor, npages: int):
    """The chunk ids grouped by page, stably (ascending page; pages outside
    [0, npages) last), int32 [nch], and where each group starts, int32
    [npages + 2] (the pages outside the table at starts[npages])."""
    p = pages.long()
    bucket = torch.where((p >= 0) & (p < npages), p, npages)
    order = torch.sort(bucket, stable=True).indices.to(torch.int32)
    starts = torch.zeros(npages + 2, dtype=torch.int32, device=pages.device)
    torch.cumsum(torch.bincount(bucket, minlength=npages + 1), 0, out=starts[1:])
    return order, starts


def group_chunks_by_page(pages: torch.Tensor, npages: int):
    """K13's grouping pass: `group_chunks_by_page_reference` by one warp's
    counting sort on CUDA tensors, with no host read."""
    if pages.device.type == "cpu":
        return group_chunks_by_page_reference(pages, npages)
    dev = pages.device
    order = torch.empty(pages.shape[0], dtype=torch.int32, device=dev)
    starts = torch.empty(npages + 2, dtype=torch.int32, device=dev)
    cuda_lib.check(cuda_lib.library().gof_page_group(dev.index, pages.data_ptr(), pages.shape[0],
                                                     npages, order.data_ptr(), starts.data_ptr(),
                                                     cuda_lib.stream_ptr(pages)), "page_group")
    return order, starts


def _s8_onehot(counter, pages, order, starts, idx, tB, npages: int, wg: int, c8: int):
    """Launch the one-hot product (csrc/gather_probes.cu::s8_onehot_kernel)
    into a new [NCH * CH, c8] int32 output."""
    nch, _, ch = idx.shape
    out = torch.empty((nch * ch, c8), dtype=torch.int32, device=idx.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = cuda_lib.library().gof_s8_onehot(idx.device.index, ptr(pages), ptr(order), ptr(starts),
                                         idx.data_ptr(), nch, ch, tB.data_ptr(), npages, wg, c8,
                                         out.data_ptr(), cuda_lib.stream_ptr(idx))
    cuda_lib.check(rc, counter.name)
    counter.launches += 1
    return out


def int8_gather_reference(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    wg = table.shape[0]
    j = idx.reshape(-1).long()
    ok = (j >= 0) & (j < wg)
    return table[j.clamp(0, wg - 1)].to(torch.int32).masked_fill_(~ok[:, None], 0)


def int8_gather(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K11: idx [NCH, 1, CH] int32, table [WG, C8] int8 -> [NCH * CH, C8]
    int32, the widened gather by one-hot int8 products: K13's kernel with
    every chunk on page 0."""
    _check_idx("int8_gather", idx)
    _check("int8_gather", ("table", table, torch.int8, 2))
    cuda_lib.require(table.shape[0] > 0, "int8_gather: empty table")
    if _on_cpu(idx, table):
        return int8_gather_reference(idx, table)
    _require_cuda("int8_gather", idx, table)
    wg, c8 = table.shape
    _s8_kernel_ok("int8_gather", wg, c8)
    return _s8_onehot(INT8, None, None, None, idx, s8_operand_layout(table, wg), 1, wg, c8)


def paged_gather_reference(pages: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
                           wg: int = 2048) -> torch.Tensor:
    rows = table.shape[0]
    p = pages.long()[:, None]
    j = idx[:, 0, :].long()
    ok = (p >= 0) & (p < rows // wg) & (j >= p * wg) & (j < (p + 1) * wg)
    out = table[j.clamp(0, rows - 1)].to(torch.int32).masked_fill_(~ok[..., None], 0)
    return out.reshape(-1, table.shape[1])


def paged_gather(pages: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
                 wg: int = 2048) -> torch.Tensor:
    """K13: pages [NCH] int32, idx [NCH, 1, CH] int32, table [npages * WG, C8]
    int8 -> [NCH * CH, C8] int32: chunk i gathers from page pages[i] only.
    On CUDA: the B layout pass, the grouping of chunks by page, then the
    one-hot product, which stages each (page, slab) once per block."""
    _check_idx("paged_gather", idx)
    _check("paged_gather", ("pages", pages, torch.int32, 1), ("table", table, torch.int8, 2))
    cuda_lib.require(pages.shape[0] == idx.shape[0],
                     f"paged_gather: {pages.shape[0]} pages for {idx.shape[0]} chunks")
    cuda_lib.require(wg > 0 and table.shape[0] > 0 and table.shape[0] % wg == 0,
                     f"paged_gather: table rows {table.shape[0]} not a multiple of WG {wg}")
    if _on_cpu(pages, idx, table):
        return paged_gather_reference(pages, idx, table, wg)
    _require_cuda("paged_gather", pages, idx, table)
    c8 = table.shape[1]
    _s8_kernel_ok("paged_gather", wg, c8)
    npages = table.shape[0] // wg
    order, starts = group_chunks_by_page(pages, npages)
    return _s8_onehot(PAGED, pages, order, starts, idx, s8_operand_layout(table, wg), npages, wg,
                      c8)


# ---------------------------------------------------------------------------
# K12: run-length decode
# ---------------------------------------------------------------------------


def rld_reference(off: torch.Tensor, val: torch.Tensor, base: torch.Tensor,
                  ch: int = 1024) -> torch.Tensor:
    wg = off.shape[2]
    k = base[:, 0, :1] + torch.arange(ch, dtype=torch.int32, device=off.device)
    w = torch.searchsorted(off[:, 0, :].contiguous(), k, right=True) - 1
    covered = (w >= 0) & ((w < wg - 1) | (k < RUN_END))
    out = val[w.clamp(min=0)].masked_fill_(~covered[..., None], 0)
    return out.reshape(-1, val.shape[1])


def rld(off: torch.Tensor, val: torch.Tensor, base: torch.Tensor, ch: int = 1024) -> torch.Tensor:
    """K12: off [NCH, 1, WG] int32 (non-decreasing along WG), val [WG, CV]
    int32, base [NCH, 1, B] int32 (chunk i covers k = base[i, 0, 0] + row)
    -> [NCH * ch, CV] int32. The kernel needs CV % 4 == 0 and a 16-byte
    aligned val; it takes any WG."""
    _check("rld", ("off", off, torch.int32, 3), ("val", val, torch.int32, 2),
           ("base", base, torch.int32, 3))
    nch, one, wg = off.shape
    cuda_lib.require(one == 1 and wg > 0 and val.shape[0] == wg,
                     f"rld: off {tuple(off.shape)}, val {tuple(val.shape)} (need [NCH, 1, WG], "
                     "[WG, CV])")
    cuda_lib.require(base.shape[0] == nch and base.shape[1] == 1 and base.shape[2] > 0,
                     f"rld: base {tuple(base.shape)} for {nch} chunks")
    if _on_cpu(off, val, base):
        return rld_reference(off, val, base, ch)
    _require_cuda("rld", off, val, base)
    cv = val.shape[1]
    cuda_lib.require(cv % 4 == 0 and val.data_ptr() % 16 == 0,
                     f"rld: CV {cv} (need a multiple of 4, val 16-byte aligned)")
    out = torch.empty((nch * ch, cv), dtype=torch.int32, device=off.device)
    _launch(RLD, off, off.data_ptr(), nch, wg, val.data_ptr(), cv, base.data_ptr(),
            base.shape[2], ch, out.data_ptr())
    return out
