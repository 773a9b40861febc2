"""Tile binning (counterpart of gof_tpu/ops/binning.py).

Same pipeline and the same slot order as gof_tpu: gaussians are grouped into
padded size classes, a slot's owner is closed-form arithmetic inside its
class, one class-expansion gather (ops/class_gather.py, a CUDA kernel on the
GPU) resolves the owners' attributes, and a sort by (tile, depth bits,
gaussian id) yields the per-tile depth-ordered lists — with exactly the
reference's tie order.

What differs from gof_tpu: there is no static key capacity. The slot array
is sized from the real demand with one host read per view (as the original
CUDA code reads `num_rendered`), rounded up to CHUNK_SIZE, so nothing
overflows and `overflow` is always a False tensor. The 3-key sort is two
stable torch sorts: by id, then by the int64 key (tile << 32) + depth bits.

`compact_live` cuts each tile's list to the prefix the previous visit of
the same camera walked (temporal liveness culling), sized likewise from its
demand.

`bin_items_aligned` bins items that touch one tile each (the integrate
path's query points) into block-aligned segments, in gof_tpu's order, with
its slot array likewise sized to the demand.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..constants import TILE_H, TILE_W
from . import class_gather

CHUNK_SIZE = 128  # gaussians per window of the blend kernel

# Size classes: exact classes 1..EXACT_MAX, then powers of two.
EXACT_MAX = 32

_DEAD_DEPTH = 2**31 - 1


@dataclass
class TileRect:
    x0: torch.Tensor  # inclusive tile mins (int32)
    y0: torch.Tensor
    w: torch.Tensor  # rect extents in tiles (int32, >= 0)
    h: torch.Tensor


def tile_grid(width: int, height: int):
    """Number of tiles along x/y for an image."""
    return -(-width // TILE_W), -(-height // TILE_H)


def _floor_to_int(x: torch.Tensor, hi: int) -> torch.Tensor:
    # clamp before the cast: gof_tpu's XLA cast saturates, torch's does not
    return torch.clamp(torch.floor(x), -1.0, hi + 1.0).to(torch.int32)


def gaussian_rects(mean2d, radius, valid, ntx: int, nty: int, radius_xy=None) -> TileRect:
    """Tile rect per Gaussian (getRect, auxiliary.h:64-74), unbounded."""
    px, py = mean2d[:, 0], mean2d[:, 1]
    if radius_xy is None:
        rx = ry = radius
    else:
        rx, ry = radius_xy[:, 0], radius_xy[:, 1]
    x0 = torch.clamp(_floor_to_int((px - rx) / TILE_W, ntx), 0, ntx)
    y0 = torch.clamp(_floor_to_int((py - ry) / TILE_H, nty), 0, nty)
    x1 = torch.clamp(_floor_to_int((px + rx + TILE_W - 1) / TILE_W, ntx), 0, ntx)
    y1 = torch.clamp(_floor_to_int((py + ry + TILE_H - 1) / TILE_H, nty), 0, nty)
    zero = torch.zeros_like(x0)
    w = torch.where(valid, torch.clamp_min(x1 - x0, 0), zero)
    h = torch.where(valid, torch.clamp_min(y1 - y0, 0), zero)
    return TileRect(x0=x0, y0=y0, w=w, h=h)


@dataclass
class Binning:
    """(tile, depth)-sorted duplicated Gaussian list, sized to the demand.

    `slot_to_gaussian` indexes the original Gaussian arrays; slots past
    `num_keys` hold id P and lie outside every segment.
    """

    slot_to_gaussian: torch.Tensor  # [CAP] int32, == P for padding
    bounds: torch.Tensor  # [NTILES+1] int32: tile t owns slots [b[t], b[t+1])
    num_keys: torch.Tensor  # 0-d int: real (post-cull) keys, == bounds[-1]
    overflow: torch.Tensor  # 0-d bool, always False (no static capacity)
    num_slots: torch.Tensor  # 0-d int: class-padded slot demand (>= num_keys)


def class_sizes(max_count: int) -> list[int]:
    """Padded-size ladder: 1..EXACT_MAX exact, then powers of two covering
    max_count (= ntiles for unbounded rects)."""
    sizes = list(range(1, EXACT_MAX + 1))
    s = EXACT_MAX * 2
    while s < max_count:
        sizes.append(s)
        s *= 2
    if max_count > EXACT_MAX:
        sizes.append(s)
    return sizes


@dataclass
class ClassExpansion:
    """Slot -> owner map of the class layout, and the attr table to gather."""

    cols: list  # [P] int32 attribute columns, in class-sorted order
    gidx: torch.Tensor  # [CAP] int64 owner rank in class-sorted order
    j: torch.Tensor  # [CAP] int64 key index inside the owner's rect
    num_slots: int  # class-padded slot demand
    capacity: int  # slot array length: num_slots rounded up to CHUNK_SIZE


def class_expansion(depth, rects: TileRect, ntiles: int, mean2d=None, radius=None) -> ClassExpansion:
    """Steps 1-3 of bin_gaussians: group gaussians by padded size class,
    read the slot demand to the host, and compute every slot's owner."""
    dev = depth.device
    P = depth.shape[0]
    counts = (rects.w * rects.h).to(torch.int64)

    sizes = class_sizes(ntiles)
    sizes_t = torch.tensor(sizes, dtype=torch.int64, device=dev)
    # 1. padded size per gaussian: the smallest class size >= count
    cls = torch.clamp(torch.searchsorted(sizes_t, counts, side="left"), max=len(sizes) - 1)
    padded = torch.where(counts > 0, sizes_t[cls], torch.zeros_like(counts))

    # 2. group gaussians by class (stable: ids ascend inside a class)
    order = torch.sort(padded, stable=True).indices
    packed_rect = (rects.x0.to(torch.int32)
                   | (rects.y0.to(torch.int32) << 10)
                   | (torch.clamp_max(rects.w, 1023).to(torch.int32) << 20))
    depth_i = depth.to(torch.float32).contiguous().view(torch.int32)
    gid = torch.arange(P, dtype=torch.int32, device=dev)
    cols = [packed_rect, depth_i, counts.to(torch.int32), gid]
    if mean2d is not None and radius is not None:
        cols += [mean2d[:, 0].to(torch.float32).contiguous().view(torch.int32),
                 mean2d[:, 1].to(torch.float32).contiguous().view(torch.int32),
                 radius.to(torch.float32).contiguous().view(torch.int32)]
    cols = [v[order] for v in cols]
    gs_pad = padded[order]
    queries = torch.tensor(sizes + [sizes[-1] + 1], dtype=torch.int64, device=dev)
    gb = torch.searchsorted(gs_pad, queries, side="left")  # [nc+1]
    nslots_c = (gb[1:] - gb[:-1]) * sizes_t
    class_start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                             torch.cumsum(nslots_c, 0)])
    num_slots = int(class_start[-1])  # the one host read per view
    capacity = max(-(-num_slots // CHUNK_SIZE) * CHUNK_SIZE, CHUNK_SIZE)

    # 3. per-slot owner: inside class c (stride S_c), rank = local // S_c
    k = torch.arange(capacity, dtype=torch.int64, device=dev)
    c = torch.searchsorted(class_start[:-1], k, side="right") - 1
    stride = sizes_t[c]
    local = k - class_start[c]
    rank = local // stride
    return ClassExpansion(cols=cols, gidx=gb[c] + rank, j=local - rank * stride,
                          num_slots=num_slots, capacity=capacity)


def slot_order(tile: torch.Tensor, depth_bits: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """The permutation that orders slots by (tile, depth bits, gaussian id):
    a stable sort by id, then a stable sort by the int64 key
    (tile << 32) + depth bits; signed depth bits keep gof_tpu's int32
    comparison order."""
    o1 = torch.sort(gid, stable=True).indices
    key = tile.long()[o1] * (1 << 32) + depth_bits.long()[o1]
    return o1[torch.sort(key, stable=True).indices]


def bin_gaussians(depth, rects: TileRect, ntx: int, nty: int,
                  mean2d=None, radius=None) -> Binning:
    """Build the (tile, depth)-ordered duplicated Gaussian list.

    depth: [P] view-space depths (> 0 for valid Gaussians; invalid ones have
    rects.w/h == 0). mean2d/radius: when given, keys whose whole tile lies
    farther than `radius` from the center are culled, as in gof_tpu.
    """
    P = depth.shape[0]
    ntiles = ntx * nty
    ex = class_expansion(depth, rects, ntiles, mean2d, radius)
    a = class_gather.expand(ex.cols, ex.gidx, P)
    rect_s, depth_s, cnt_s, gid_s = a[0], a[1], a[2], a[3]
    k = torch.arange(ex.capacity, dtype=torch.int64, device=depth.device)
    j = ex.j
    live = (k < ex.num_slots) & (j < cnt_s) & (ex.gidx < P)

    x0e = rect_s & 1023
    y0e = (rect_s >> 10) & 1023
    rw = torch.clamp_min((rect_s >> 20) & 1023, 1)
    jdiv = j // rw
    tilex = x0e + (j - jdiv * rw)
    tiley = y0e + jdiv
    tile = tiley * ntx + tilex
    if len(a) > 4:
        # circle-vs-tile cull: bbox corner tiles entirely outside the alpha
        # circle blend exactly zero, so their keys are dropped
        mx, my, rad = (v.view(torch.float32) for v in a[4:7])
        px0 = (tilex * TILE_W).to(torch.float32)
        py0 = (tiley * TILE_H).to(torch.float32)
        dx = mx - torch.minimum(torch.maximum(mx, px0), px0 + TILE_W)
        dy = my - torch.minimum(torch.maximum(my, py0), py0 + TILE_H)
        live = live & (dx * dx + dy * dy <= rad * rad)
    tile = torch.where(live, tile, ntiles)  # sentinel sorts last
    depth_bits = torch.where(live, depth_s.to(torch.int64), _DEAD_DEPTH)
    gid_sort = torch.where(live, gid_s.to(torch.int64), P)
    num_keys = live.sum()

    # 4. (tile, depth bits, id) order
    perm = slot_order(tile, depth_bits, gid_sort)
    tile_sorted = tile[perm]

    # 5. per-tile segment bounds
    bounds = torch.searchsorted(
        tile_sorted, torch.arange(ntiles + 1, dtype=torch.int64, device=depth.device),
        side="left")
    return Binning(
        slot_to_gaussian=gid_sort[perm].to(torch.int32),
        bounds=bounds.to(torch.int32),
        num_keys=num_keys,
        overflow=torch.zeros((), dtype=torch.bool, device=depth.device),
        num_slots=torch.tensor(ex.num_slots, device=depth.device),
    )


# ---------------------------------------------------------------------------
# Temporal liveness compaction
# ---------------------------------------------------------------------------

# chunks of headroom added to every cached live count (the drift of the
# window phase at a segment's head plus slow motion of the saturation
# boundary between visits of one camera)
LIVE_MARGIN_CHUNKS = 2

LIM_INF = 1 << 24  # "no limit" sentinel, in chunks


def _expand(values: torch.Tensor, starts: torch.Tensor, in_cap: torch.Tensor,
            capacity: int) -> torch.Tensor:
    """Per-segment int constants to per-slot values: segment i covers slots
    [starts[i], starts[i+1]). A scatter-add of the deltas v[i] - v[i-1] at
    the starts, then a cumsum (empty segments telescope)."""
    v = values.to(torch.int64)
    prev = torch.cat([v.new_zeros(1), v[:-1]])
    delta = torch.where(in_cap, v - prev, torch.zeros_like(v))
    d = v.new_zeros(capacity)
    d.index_add_(0, torch.where(in_cap, starts, torch.zeros_like(starts)), delta)
    return torch.cumsum(d, 0)


def compact_live(b: Binning, lim_chunks: torch.Tensor, num_gaussians: int):
    """Cut the sorted key list to per-tile live prefixes (gof_tpu's
    compact_live, binning.py:377-450).

    The forward blend walks each tile front to back and stops once every
    pixel's transmittance is below TRANSMITTANCE_EPS: keys past that point
    are never read and get no gradient. Saturation boundaries move slowly
    between visits of one camera, so the previous visit's walked chunk
    count (plus LIVE_MARGIN_CHUNKS) bounds this visit's prefix. The kept
    slots are per-tile prefixes of the existing sort, so this is index
    arithmetic (a scatter-add and a cumsum of per-tile offsets, then one
    gather): no new sort. A stale bound is detected by the caller, not
    trusted: a tile that is `truncated` and still unsaturated rendered
    wrong, and the train step skips its update.

    The compacted list is sized from its demand (one host read), rounded up
    to CHUNK_SIZE, with id P past the demand, so `live_overflow` is always
    False; gof_tpu's static live capacity has no counterpart.

    lim_chunks: [NTILES] int per-tile bounds in chunks (LIM_INF: none).
    Returns (Binning, truncated [NTILES] bool, live_overflow, live_demand).
    """
    dev = b.bounds.device
    seg_start = b.bounds[:-1].to(torch.int64)
    seg_len = b.bounds[1:].to(torch.int64) - seg_start
    # clamp before the chunk -> key scale, so LIM_INF cannot wrap an int32
    lim = torch.clamp(lim_chunks.to(torch.int32), max=1 << 22) * CHUNK_SIZE
    lim_keys = torch.minimum(seg_len, lim.to(torch.int64))
    truncated = lim_keys < seg_len
    live_start = torch.cat([seg_len.new_zeros(1), torch.cumsum(lim_keys, 0)])
    demand = int(live_start[-1])  # the one host read
    lcap = max(-(-demand // CHUNK_SIZE) * CHUNK_SIZE, CHUNK_SIZE)
    j = torch.arange(lcap, dtype=torch.int64, device=dev)
    starts = live_start[:-1]
    off = _expand(seg_start - starts, starts, starts < lcap, lcap)
    src = torch.clamp(j + off, 0, b.slot_to_gaussian.shape[0] - 1)
    gid = torch.where(j < demand, b.slot_to_gaussian[src].to(torch.int64), num_gaussians)
    live_demand = torch.tensor(demand, dtype=torch.int32, device=dev)
    bc = Binning(slot_to_gaussian=gid.to(torch.int32), bounds=live_start.to(torch.int32),
                 num_keys=live_demand, overflow=b.overflow, num_slots=b.num_slots)
    return bc, truncated, torch.zeros((), dtype=torch.bool, device=dev), live_demand


# ---------------------------------------------------------------------------
# Block-aligned relayout (point-integration path only)
# ---------------------------------------------------------------------------


@dataclass
class AlignedBins:
    """Per-tile item lists padded to `block`-aligned segments (the point side
    of the integrate kernel, where each tile's query points fill whole
    1024-point blocks). Sized to the demand: the slot array holds exactly
    sum(tile_blocks) * block slots."""

    slot_to_item: torch.Tensor  # [CAP_PAD] int32, == N for padding
    tile_start: torch.Tensor  # [NTILES] int32 block-aligned segment starts
    tile_blocks: torch.Tensor  # [NTILES] int32 number of blocks
    num_keys: torch.Tensor  # 0-d int: items that lie in a tile
    overflow: torch.Tensor  # 0-d bool, always False (no static capacity)


def aligned_capacity(capacity: int, ntiles: int, block: int) -> int:
    """Slots that `capacity` items can need once every tile's segment is
    padded to whole blocks (gof_tpu's static bound)."""
    cap_pad = capacity + ntiles * (block - 1)
    return -(-cap_pad // block) * block


def bin_items_aligned(tile_of_item: torch.Tensor, ntiles: int, block: int) -> AlignedBins:
    """Bin items that each touch exactly one tile (tile id `ntiles` =
    invalid) into block-padded segments, item ids ascending inside a tile as
    gof_tpu's stable sort leaves them. The slot count is read to the host
    once."""
    dev = tile_of_item.device
    N = tile_of_item.shape[0]
    tile = tile_of_item.to(torch.int64)
    valid = tile < ntiles
    tile_sorted, item_sorted = torch.sort(tile, stable=True)
    bounds = torch.searchsorted(tile_sorted, torch.arange(ntiles + 1, device=dev), side="left")
    seg_start = bounds[:-1]
    seg_len = bounds[1:] - seg_start
    blocks = -(-seg_len // block)
    pad_start = torch.cumsum(blocks * block, 0) - blocks * block
    cap_pad = int(blocks.sum()) * block  # the one host read

    f = torch.arange(cap_pad, device=dev)
    t = torch.searchsorted(pad_start, f, side="right") - 1
    local = f - pad_start[t]
    in_seg = local < seg_len[t]
    src = torch.clamp(seg_start[t] + local, max=max(N - 1, 0))
    slot_to_item = torch.where(in_seg, item_sorted[src], N)
    return AlignedBins(
        slot_to_item=slot_to_item.to(torch.int32),
        tile_start=pad_start.to(torch.int32),
        tile_blocks=blocks.to(torch.int32),
        num_keys=valid.sum(),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )
