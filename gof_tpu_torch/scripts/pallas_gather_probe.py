"""How fast can this card gather rows from a table and scatter-add rows into
one? The port of scripts/pallas_gather_probe.py (K6-K10):

    python -m gof_tpu_torch.scripts.pallas_gather_probe [--cpu]

(1) take_gather, jnp.take's semantics (K6); (1b) vidx_gather, the ref
indexer's (K7; K6's kernel with a clamp); (2) the one-hot bf16
product over pages of PAGE_B rows (K8); (3) scat, the segment sum by atomic
adds (K9); (4) scatmxu, the deterministic segment sum (K10, on K4's
counting-sort reduce). The inputs are the script's: np.random.default_rng(0)
draws the table, the indices and the rows in its order and at its shapes
(the shape flags exist for small test runs). Each line gives the kernel's
time, its plain version's, the PyTorch library call's for the same function
and the card's bound, then the check against the plain version and the
library call. `main` returns the same numbers as a dict.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gof_tpu_torch.ops import gather_probes as gp
from gof_tpu_torch.scripts import device_name, exact, pick_device, probe, report
from gof_tpu_torch.utils.timing import bound_ms, nbytes

W = 32  # table columns, the script's W
N_BUFFERS = 4  # distinct index buffers cycled through while timing
REPS = 20  # timed calls of each function, as the script's timeit


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--page", type=int, default=16384, help="table rows (PAGE)")
    p.add_argument("--chunk", type=int, default=2048, help="indices per chunk (CHUNK)")
    p.add_argument("--nchunk", type=int, default=256, help="chunks (NCHUNK)")
    p.add_argument("--page_b", type=int, default=2048, help="rows per one-hot page (PAGE_B)")
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    return p.parse_args(argv)


def inputs(page: int, chunk: int, nchunk: int):
    """The script's draws, in its order: table, idx, then rows."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(page, W)).astype(np.float32)
    idx = rng.integers(0, page, (nchunk, 1, chunk)).astype(np.int32)
    rows = rng.normal(size=(nchunk * chunk, W)).astype(np.float32)
    return table, idx, rows


def within(got, want) -> bool:
    """K9/K10 sum in another order than the plain version and the library
    call: rtol 1e-5, atol 1e-5 x max |want|."""
    return bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * float(want.abs().max())).all())


def close(got, want, lib) -> dict:
    return {"max_abs_err": float((got - want).abs().max()),
            "max_abs_plain": float(want.abs().max()), "within_tol": within(got, want),
            "library_within_tol": within(got, lib)}


def main(argv=None) -> dict:
    a = parse(argv)
    dev = pick_device(a.cpu)
    table_np, idx_np, rows_np = inputs(a.page, a.chunk, a.nchunk)
    table = torch.from_numpy(table_np).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    rows = torch.from_numpy(rows_np).to(dev)
    n = idx.numel()
    idxs = [idx] + [torch.roll(idx, s * 7919) for s in range(1, N_BUFFERS)]
    print(f"device {device_name(dev)}; table [{a.page}, {W}] f32, idx [{a.nchunk}, 1, "
          f"{a.chunk}] int32, rows [{n}, {W}] f32")
    res = {}
    gather_bytes = nbytes(idx, table) + n * W * 4
    targs = [(i, table) for i in idxs]

    def index_select(i, t):
        return torch.index_select(t, 0, i.reshape(-1))

    # --- 1. jnp.take semantics (K6), 1b. vector-index semantics (K7) ---
    for name, fn, plain, label in (
            ("take_gather", gp.take_gather, gp.take_gather_reference,
             f"take_gather (jnp.take) from table [{a.page},{W}]"),
            ("vidx_gather", gp.vidx_gather, gp.vidx_gather_reference,
             "vidx_gather (tbl[idx_vec, :])")):
        r = res[name] = probe(fn, plain, index_select, targs, dev, REPS, gather_bytes, exact)
        r["library"] = "torch.index_select(table, 0, idx)"
        report(label, r)
        print(f"   correct: {r['exact'] and r['library_exact']}")

    # --- 2. one-hot bf16 product over pages of PAGE_B rows (K8) ---
    tbl_bf = table.bfloat16().float()
    r = res["onehot_gather"] = probe(
        lambda i, t: gp.onehot_gather(i, t, a.page_b),
        lambda i, t: gp.onehot_gather_reference(i, t, a.page_b),
        lambda i, t: index_select(i, tbl_bf), targs, dev, REPS, gather_bytes, exact)
    r["library"] = "torch.index_select(bf16-rounded table, 0, idx)"
    r["product_bound_ms"] = bound_ms(0, 2.0 * n * a.page * W, "bf16")[0]
    report("one-hot product gather (bf16, f32 accumulate)", r)
    print(f"   max err: {r['max_abs_err']} (exact {r['exact']}, index_select exact "
          f"{r['library_exact']}); product bound {r['product_bound_ms']:.4f} ms (bf16)")

    # --- 3. scatter-add by atomics (K9), 4. deterministic segment sum (K10) ---
    def index_add(i, r_):
        return torch.zeros((a.page, W), device=dev).index_add_(0, i.reshape(-1), r_)

    scat_bytes = nbytes(idx, rows) + a.page * W * 4
    for name, fn, plain, label in (
            ("scat", gp.scat, gp.scat_reference, f"scat: atomic segment sum into [{a.page},{W}]"),
            ("scatmxu", gp.scatmxu, gp.scatmxu_reference,
             "scatmxu: deterministic segment sum (counting sort)")):
        r = res[name] = probe(lambda i, r_, f=fn: f(i, r_, a.page),
                              lambda i, r_, f=plain: f(i, r_, a.page), index_add,
                              [(i, rows) for i in idxs], dev, REPS, scat_bytes, close)
        r["library"] = "zeros.index_add_(0, idx, rows)"
        extra = ""
        if name == "scatmxu":
            r["deterministic"] = bool(torch.equal(fn(idx, rows, a.page), fn(idx, rows, a.page)))
            extra = f"; bit-identical across launches {r['deterministic']}"
        report(label, r)
        print(f"   max err: {r['max_abs_err']:.3e} (max |plain| {r['max_abs_plain']:.3e}; within "
              f"rtol 1e-5 / atol 1e-5 x max: {r['within_tol']}; of index_add_: "
              f"{r['library_within_tol']}){extra}")
    return {"device": device_name(dev), "kernels": res}


if __name__ == "__main__":
    main()
