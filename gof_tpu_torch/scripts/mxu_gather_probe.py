"""The primitives of a windowed matrix-unit binning, on this card. The port
of scripts/mxu_gather_probe.py (K11-K13 and its sort timings):

    python -m gof_tpu_torch.scripts.mxu_gather_probe [--cpu]

(1) int8_gather, a one-hot int8 product as a widened row gather (K11); (2)
rld, a run-length decode (K12; its bound counts only the offsets and val
rows the chunks' rows need, `rld_bytes`); (3) paged_gather, each chunk
gathering from its own page of a larger table (K13); (4) the sorts of the
port's binning and reduce: the script's two keys (tile, depth) with one and with two
carries at 4,194,304 keys, ordered by ops/binning.py's slot_order (with the
carried gaussian id as its third key: a stable sort by id, then a stable
sort of the int64 key), the carries gathered after; and one key with one
carry at 1,310,720, the script's reduce presort as a stable torch.sort
(K4 and K10 count-sort instead: csrc/reduce.cu). The inputs
are the script's: np.random.default_rng(0) draws them in its order and at
its shapes (the shape flags exist for small test runs). Timings cycle
distinct input buffers. `main` returns the numbers as a dict.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from gof_tpu_torch.ops import gather_probes as gp
from gof_tpu_torch.ops.binning import slot_order
from gof_tpu_torch.scripts import device_name, exact, pick_device, probe, report
from gof_tpu_torch.utils.timing import bound_ms, nbytes, time_ms

C8 = 128  # int8 table columns, the script's C8
CV = 8  # int32 value columns of the decode, the script's CV
REPS = 16  # timed calls of each function, as the script's timeit


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ch", type=int, default=1024, help="rows per chunk (CH)")
    p.add_argument("--wg", type=int, default=2048, help="window / page rows (WG)")
    p.add_argument("--nch", type=int, default=512, help="chunks (NCH)")
    p.add_argument("--cap", type=int, default=4_194_304, help="keys of the two-key sorts")
    p.add_argument("--presort", type=int, default=1_310_720, help="keys of the one-key sort")
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    return p.parse_args(argv)


def inputs(a):
    """The script's draws, in its order (its four RLD spot-check chunks
    included, so the later draws match)."""
    rng = np.random.default_rng(0)
    d = {}
    d["tbl8"] = rng.integers(-128, 127, (a.wg, C8)).astype(np.int8)
    d["idxs"] = [rng.integers(0, a.wg, (a.nch, 1, a.ch)).astype(np.int32) for _ in range(4)]
    off = np.sort(rng.integers(0, a.nch * a.ch, (a.nch, 1, a.wg))).astype(np.int32)
    off[:, 0, 0] = 0
    d["off"] = off
    d["val"] = rng.integers(0, 2**23, (a.wg, CV)).astype(np.int32)
    base = np.zeros((a.nch, 1, 8), np.int32)
    base[:, 0, 0] = np.arange(a.nch) * a.ch
    d["base"] = base
    d["spot_chunks"] = [int(rng.integers(0, a.nch)) for _ in range(4)]
    d["big_tbl8"] = rng.integers(-128, 127, (a.wg * 8, C8)).astype(np.int8)
    pages = rng.integers(0, 8, a.nch).astype(np.int32)
    idx = np.empty((a.nch, 1, a.ch), np.int32)
    for i in range(a.nch):
        idx[i, 0] = rng.integers(pages[i] * a.wg, (pages[i] + 1) * a.wg, a.ch)
    d["pages"], d["paged_idx"] = pages, idx
    d["tiles"] = [rng.integers(0, 4056, a.cap).astype(np.int32) for _ in range(3)]
    d["db"] = rng.integers(0, 2**30, a.cap).astype(np.int32)
    d["gid"] = rng.integers(0, 2**20, a.cap).astype(np.int32)
    d["dup"] = rng.integers(0, a.cap, a.cap).astype(np.int32)
    d["gids_s"] = [rng.integers(0, 2**20, a.presort).astype(np.int32) for _ in range(3)]
    return d


RLD_EDGE_CASES = ("all_zero", "dense", "run_end", "wrap", "uncovered", "wide_wg")


def rld_edge_offsets(case: str, nch: int, ch: int, wg: int, rng):
    """K12's edge cases, as offsets [nch, 1, WG] and bases [nch, 1, 8]
    (int64) on the script's kind of draw (sorted offsets over nch * ch
    positions, chunk i's rows from k = i * ch): "all_zero", every offset 0
    (every k on the last run); "dense", chunk nch // 2's offsets all inside
    its own ch k, with repeats; "run_end", bases that put each chunk's k
    across 2^30, where the last run ends; "wrap", offsets over the whole
    int32 range and bases that put k across the int32 wrap; "uncovered",
    chunk 0's first offset at its row ch // 2; "wide_wg", WG =
    65,536."""
    if case == "wide_wg":
        wg = 65536
    off = np.sort(rng.integers(0, nch * ch, (nch, 1, wg)), axis=-1)
    base = np.zeros((nch, 1, 8), np.int64)
    base[:, 0, 0] = np.arange(nch) * ch
    c = nch // 2
    if case == "all_zero":
        off[:] = 0
    elif case == "dense":
        off[c, 0] = np.sort(rng.integers(c * ch, (c + 1) * ch, wg))
    elif case == "run_end":
        base[:, 0, 0] = 2**30 - ch // 2 + 3 * np.arange(nch)
    elif case == "wrap":
        off = rng.integers(-2**31, 2**31, (nch, 1, wg))
        off[:, 0, 0] = -2**31
        off[-1, 0, -40:] = rng.integers(2**31 - ch, 2**31, 40)  # runs just below the wrap
        off = np.sort(off, axis=-1)
        base[:, 0, 0] = 2**31 - 1 - ch // 2 - 5 * np.arange(nch)
    elif case == "uncovered":
        off[0, 0] = np.sort(rng.integers(ch // 2, nch * ch, wg))
        off[0, 0, 0] = ch // 2
    return off, base


def rld_bytes(off, val, base, ch: int) -> int:
    """The bytes K12 must move on these inputs: the output, each chunk's
    base, the val rows some row uses, and per chunk its offsets from the
    first row's run to one past the last row's (those decide every row),
    plus one binary search's reads to find them."""
    nch, _, wg = off.shape
    k = base[:, 0, :1] + torch.arange(ch, dtype=torch.int32, device=off.device)
    w = torch.searchsorted(off[:, 0, :].contiguous(), k, right=True) - 1  # [nch, ch]
    used = w[(w >= 0) & ((w < wg - 1) | (k < gp.RUN_END))].unique().numel()
    lo, hi = w.min(1).values.clamp(min=0), (w.max(1).values + 1).clamp(max=wg - 1)
    offsets = int((hi - lo + 1).sum()) + nch * math.ceil(math.log2(wg + 1))
    return nch * ch * val.shape[1] * 4 + nch * 4 + used * val.shape[1] * 4 + offsets * 4


def main(argv=None) -> dict:
    a = parse(argv)
    dev = pick_device(a.cpu)
    d = inputs(a)

    def T(x):
        return torch.from_numpy(x).to(dev)

    print(f"device {device_name(dev)}; CH {a.ch}, WG {a.wg}, C8 {C8}, NCH {a.nch}, CV {CV}")
    res = {}
    n = a.nch * a.ch
    s8_ops = 2.0 * n * a.wg * C8  # the one-hot product, int8 multiply-adds x 2

    def widened(table, i):
        return torch.index_select(table, 0, i.reshape(-1)).to(torch.int32)

    # ---------------------------------------------------------- 1. int8 MXU
    tbl8 = T(d["tbl8"])
    idxs = [T(i) for i in d["idxs"]]
    r = res["int8_gather"] = probe(gp.int8_gather, gp.int8_gather_reference,
                                   lambda i, t: widened(t, i), [(i, tbl8) for i in idxs], dev,
                                   REPS, nbytes(idxs[0], tbl8) + n * C8 * 4, exact)
    r["library"] = "torch.index_select(table, 0, idx).to(torch.int32) (2 calls)"
    r["product_bound_ms"] = bound_ms(0, s8_ops, "int8")[0]
    print(f"int8 onehot gather exact: {r['exact']} (index_select exact {r['library_exact']})")
    report(f"int8 onehot gather [{n}] win={a.wg} C={C8}", r)
    print(f"   product bound {r['product_bound_ms']:.4f} ms (int8)")

    # ------------------------------------------------------- 2. run-length decode
    off, val, base = T(d["off"]), T(d["val"]), T(d["base"])
    rolls = [(torch.roll(off, s, 0), val, torch.roll(base, s, 0)) for s in range(4)]
    r = res["rld"] = probe(lambda *x: gp.rld(*x, ch=a.ch),
                           lambda *x: gp.rld_reference(*x, ch=a.ch), None, rolls, dev, REPS,
                           rld_bytes(off, val, base, a.ch), exact)
    r["library"] = None
    # every input read whole, offsets included
    r["bound_all_inputs_ms"] = bound_ms(nbytes(off, val, base) + n * CV * 4)[0]
    # the script's spot check, numpy's searchsorted on its four chunks
    out = gp.rld(off, val, base, ch=a.ch)
    spots = []
    for ch in d["spot_chunks"]:
        o = d["off"][ch, 0]
        k = np.arange(ch * a.ch, (ch + 1) * a.ch)
        w = np.searchsorted(o, k, side="right") - 1
        inb = (w >= 0) & (k < np.concatenate([o[1:], [2**30]])[np.clip(w, 0, a.wg - 1)])
        exp = np.where(inb[:, None], d["val"][np.clip(w, 0, a.wg - 1)], 0)
        spots.append(bool(np.array_equal(out[ch * a.ch:(ch + 1) * a.ch].cpu().numpy(), exp)))
        print(f"RLD chunk {ch} exact: {spots[-1]}")
    r["spot_exact"] = all(spots)
    report(f"RLD range search [{n}] win={a.wg} C={CV}", r)
    print(f"   exact vs plain: {r['exact']}; bound with every input read whole "
          f"{r['bound_all_inputs_ms']:.4f} ms")

    # ------------------------------------------------------- 3. paged gather
    big = T(d["big_tbl8"])
    pages, pidx = T(d["pages"]), T(d["paged_idx"])
    pargs = [(torch.roll(pages, s, 0), torch.roll(pidx, s, 0), big) for s in range(4)]
    r = res["paged_gather"] = probe(
        lambda *x: gp.paged_gather(*x, wg=a.wg),
        lambda *x: gp.paged_gather_reference(*x, wg=a.wg), lambda p, i, t: widened(t, i), pargs,
        dev, REPS,
        nbytes(pages, pidx, big) + n * C8 * 4, exact)
    r["library"] = "torch.index_select(table, 0, idx).to(torch.int32) (2 calls)"
    r["product_bound_ms"] = bound_ms(0, s8_ops, "int8")[0]
    print(f"paged gather exact: {r['exact']} (index_select exact {r['library_exact']})")
    report("paged gather (chunks grouped by page)", r)
    print(f"   product bound {r['product_bound_ms']:.4f} ms (int8)")

    # ------------------------------------------- 4. sorts with carries
    tiles = [T(t) for t in d["tiles"]]
    db, gid, dup = T(d["db"]), T(d["gid"]), T(d["dup"])

    def sort2carry1(t, db_, g):
        return g[slot_order(t, db_, g)]

    def sort2carry2(t, db_, g, u):
        o = slot_order(t, db_, g)
        return g[o], u[o]

    def sort1carry1(g, u):
        return u[torch.sort(g, stable=True).indices]

    gids_s = [T(g) for g in d["gids_s"]]
    rid = torch.arange(a.presort, dtype=torch.int32, device=dev)
    sorts = {
        f"2key+1carry @{a.cap} (binning slot_order)": time_ms(sort2carry1, [(t, db, gid) for t in tiles], dev, REPS),
        f"2key+2carry @{a.cap} (binning slot_order)": time_ms(sort2carry2, [(t, db, gid, dup) for t in tiles], dev,
                                         REPS),
        f"1key+1carry @{a.presort} (reduce presort)": time_ms(
            sort1carry1, [(g, rid) for g in gids_s], dev, REPS)}
    o = slot_order(tiles[0], db, gid)
    key, g = (tiles[0].long() * (1 << 32) + db.long())[o], gid[o]
    ordered = bool(((key[1:] > key[:-1]) | ((key[1:] == key[:-1]) & (g[1:] >= g[:-1]))).all())
    for name, ms in sorts.items():
        print(f"{'torch.sort ' + name:58s} {ms:8.4f} ms", flush=True)
    print(f"   (tile, depth, id) order sorted: {ordered}")
    return {"device": device_name(dev), "kernels": res, "sorts": sorts, "sort_ordered": ordered}


if __name__ == "__main__":
    main()
