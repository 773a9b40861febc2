"""The gather/scatter probes' plain versions against gof_tpu's Pallas kernels.

The JAX side is the unmodified scripts/pallas_gather_probe.py and
scripts/mxu_gather_probe.py, which run their full-size probes when
imported: each test parses the script with `ast`, keeps its imports and
`def`s, executes those with the shape constants set small and `pl` swapped
for a namespace whose `pallas_call` runs in interpret mode. Inputs come from
numpy seeds and include the edge indices each kernel treats specially
(negative, past the table, int32's extremes). Bit-exact for every gather
(K6-K8, K11-K13); the segment sums (K9, K10) sum in another order than the
TPU kernels and are held to rtol 1e-5, atol 1e-5 x max |JAX|.
"""

import ast
import functools
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gof_tpu_torch.ops import gather_probes as gp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SMALL_PALLAS = dict(PAGE=256, W=32, CHUNK=128, NCHUNK=4, PAGE_B=64)
SMALL_MXU = dict(CH=128, WG=256, C8=128, NCH=4, CV=8)
I32_MIN, I32_MAX = -2**31, 2**31 - 1


def load_probe(name: str, **consts) -> dict:
    """The probe script's imports and functions, without its module-level
    runs, with `consts` as its shape constants and Pallas in interpret mode."""
    path = REPO / "scripts" / name
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    ns = {"__name__": f"probe_{path.stem}"}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    attrs = {k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")}
    attrs["pallas_call"] = functools.partial(pl.pallas_call, interpret=True)
    ns["pl"] = types.SimpleNamespace(**attrs)
    ns.update(consts)
    return ns


@pytest.fixture(scope="module")
def pallas_probe():
    return load_probe("pallas_gather_probe.py", **SMALL_PALLAS)


@pytest.fixture(scope="module")
def mxu_probe():
    return load_probe("mxu_gather_probe.py", **SMALL_MXU)


def edge_idx(seed: int, shape, page: int) -> np.ndarray:
    """Indices over [-page - 8, page + 8) with int32's extremes and the
    boundaries of [-page, page) at the front."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-page - 8, page + 8, shape).astype(np.int32)
    idx.reshape(-1)[:8] = [I32_MIN, I32_MAX, -page - 1, -page, -1, 0, page - 1, page]
    return idx


def pallas_tables(seed=0):
    c = SMALL_PALLAS
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(c["PAGE"], c["W"])).astype(np.float32)
    rows = rng.normal(size=(c["NCHUNK"] * c["CHUNK"], c["W"])).astype(np.float32)
    return table, rows


@pytest.mark.parametrize("name", ["take_gather", "vidx_gather", "onehot_gather"])
def test_gathers_match_pallas(pallas_probe, name):
    c = SMALL_PALLAS
    table, _ = pallas_tables()
    idx = edge_idx(1, (c["NCHUNK"], 1, c["CHUNK"]), c["PAGE"])
    want = np.asarray(pallas_probe[name](jnp.asarray(idx), jnp.asarray(table)))
    kw = {"page_b": c["PAGE_B"]} if name == "onehot_gather" else {}
    got = getattr(gp, name)(torch.from_numpy(idx), torch.from_numpy(table), **kw)
    assert tuple(got.shape) == want.shape == (idx.size, c["W"])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.abs().sum(1) > 0).sum() > idx.size // 3


def test_gather_edge_rows():
    """The edge semantics spelled out: take wraps [-PAGE, 0) and zero-fills
    the rest; vidx wraps once and clamps; the one-hot zero-fills all but
    [0, PAGE)."""
    table, _ = pallas_tables()
    t = torch.from_numpy(table)
    page = t.shape[0]
    idx = torch.tensor([[[-page - 1, -page, -1, page, I32_MIN, I32_MAX, 5, 0]]], dtype=torch.int32)
    zero = torch.zeros_like(t[0])
    take = gp.take_gather(idx, t)
    for got, want in zip(take, [zero, t[0], t[-1], zero, zero, zero, t[5], t[0]]):
        assert torch.equal(got, want)
    vidx = gp.vidx_gather(idx, t)
    for got, want in zip(vidx, [t[0], t[0], t[-1], t[-1], t[0], t[-1], t[5], t[0]]):
        assert torch.equal(got, want)
    oh = gp.onehot_gather(idx, t, page_b=64)
    bf = t.bfloat16().float()
    for got, want in zip(oh, [zero, zero, zero, zero, zero, zero, bf[5], bf[0]]):
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def pallas_probe_w30():
    return load_probe("pallas_gather_probe.py", **dict(SMALL_PALLAS, W=30))


@pytest.mark.parametrize("case", ["w30", "unaligned"])
@pytest.mark.parametrize("name", ["take_gather", "vidx_gather"])
def test_row_gathers_any_width_and_view_match_pallas(pallas_probe, pallas_probe_w30, name, case):
    """K6 and K7 at a width the 16-byte pieces do not take (W = 30) and on a
    table view one float past its buffer's start (on the card, the 4-byte
    body takes both)."""
    c = SMALL_PALLAS
    page = c["PAGE"]
    w = 30 if case == "w30" else c["W"]
    vals = np.random.default_rng(17).normal(size=(page, w)).astype(np.float32)
    table = torch.from_numpy(vals)
    if case == "unaligned":
        table = torch.zeros(page * w + 1)[1:].view(page, w)
        table.copy_(torch.from_numpy(vals))
    idx = edge_idx(18, (c["NCHUNK"], 1, c["CHUNK"]), page)
    probe = pallas_probe_w30 if case == "w30" else pallas_probe
    want = np.asarray(probe[name](jnp.asarray(idx), jnp.asarray(vals)))
    got = getattr(gp, name)(torch.from_numpy(idx), table)
    assert tuple(got.shape) == want.shape == (idx.size, w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["scat", "scatmxu"])
def test_scatters_match_pallas(pallas_probe, name):
    c = SMALL_PALLAS
    _, rows = pallas_tables()
    idx = edge_idx(2, (c["NCHUNK"], 1, c["CHUNK"]), c["PAGE"])
    want = np.asarray(pallas_probe[name](jnp.asarray(idx), jnp.asarray(rows)))
    got = getattr(gp, name)(torch.from_numpy(idx), torch.from_numpy(rows), page=c["PAGE"])
    assert tuple(got.shape) == want.shape == (c["PAGE"], c["W"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


INDEX_DISTS = ["uniform", "sorted", "one_index", "own_kstep", "outside"]


def dist_idx(kind: str, shape, page: int, seed: int = 12) -> np.ndarray:
    """The index distributions K8's and K9's speed depends on: the uniform
    draw, the same draw sorted, every row on one index, consecutive rows on
    distinct k-steps (16 table rows each, cycling over all of them), and
    every index outside the table (outside [-PAGE, PAGE), so K9 wraps none)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    r = np.arange(n)
    v = {"uniform": lambda: rng.integers(0, page, n),
         "sorted": lambda: np.sort(rng.integers(0, page, n)),
         "one_index": lambda: np.full(n, page // 3),
         "own_kstep": lambda: 16 * (r % (page // 16)) + (r // (page // 16) + 5 * r) % 16,
         "outside": lambda: rng.choice([I32_MIN, I32_MAX, -page - 1, -2 * page, page, page + 7],
                                       n)}[kind]()
    return v.astype(np.int32).reshape(shape)


@pytest.mark.parametrize("dist", INDEX_DISTS)
@pytest.mark.parametrize("name", ["onehot_gather", "scat"])
def test_index_distributions_match_pallas(pallas_probe, name, dist):
    """K8 bit-equal, K9 within rtol 1e-5 / atol 1e-5 x max |JAX| of the
    Pallas kernels on each distribution the new designs' speed depends on."""
    c = SMALL_PALLAS
    table, rows = pallas_tables()
    idx = dist_idx(dist, (c["NCHUNK"], 1, c["CHUNK"]), c["PAGE"])
    if name == "onehot_gather":
        want = np.asarray(pallas_probe[name](jnp.asarray(idx), jnp.asarray(table)))
        got = gp.onehot_gather(torch.from_numpy(idx), torch.from_numpy(table), page_b=c["PAGE_B"])
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        want = np.asarray(pallas_probe[name](jnp.asarray(idx), jnp.asarray(rows)))
        got = gp.scat(torch.from_numpy(idx), torch.from_numpy(rows), page=c["PAGE"])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert tuple(got.shape) == want.shape
    assert bool(got.any()) == (dist != "outside")


def test_scatter_edge_semantics_differ():
    """scat wraps negative indices (`.at[].add`); scatmxu drops them (the
    one-hot product matches no row)."""
    rows = torch.ones((4, 32))
    idx = torch.tensor([[[-1, -256, 256, 3]]], dtype=torch.int32)
    s = gp.scat(idx, rows, page=256)
    m = gp.scatmxu(idx, rows, page=256)
    assert s[:, 0].sum() == 3 and s[255, 0] == 1 and s[0, 0] == 1 and s[3, 0] == 1
    assert m[:, 0].sum() == 1 and m[3, 0] == 1


def test_scatmxu_sums_in_ascending_row_order():
    """Each output row is 0 + r_0 + r_1 + ... in input order (f32), the
    order the kernel sums in, whatever the ids' order."""
    rng = np.random.default_rng(3)
    rows = torch.from_numpy((rng.normal(size=(4096, 32)) * 10.0 ** rng.integers(-4, 5, (4096, 1)))
                            .astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 7, (2, 1, 2048)).astype(np.int32))
    got = gp.scatmxu(idx, rows, page=7)
    flat = idx.reshape(-1)
    for o in range(7):
        acc = torch.zeros(32)
        for r in torch.nonzero(flat == o)[:, 0]:
            acc = acc + rows[r]
        assert torch.equal(got[o], acc)


@pytest.mark.parametrize("page", [7, 256])
def test_scatmxu_cpu_path_is_the_row_major_reduce(page):
    """scatmxu's CPU path (its plain version, unchanged) equals, bit for
    bit, the plain version of the reduce its CUDA path launches, fed the ids
    with everything outside [0, PAGE) on the sentinel."""
    from gof_tpu_torch.ops import reduce as tred

    rng = np.random.default_rng(page)
    idx = torch.from_numpy(rng.integers(-page - 3, page + 3, (4, 1, 128)).astype(np.int32))
    rows = torch.from_numpy((rng.normal(size=(512, 32))
                             * 10.0 ** rng.integers(-4, 5, (512, 1))).astype(np.float32))
    got = gp.scatmxu(idx, rows, page)
    assert torch.equal(got, gp.scatmxu_reference(idx, rows, page))
    assert torch.equal(got, tred.reduce_row_major(rows, gp._ids_in_page(idx, page), page))



def test_int8_gather_matches_pallas(mxu_probe):
    c = SMALL_MXU
    rng = np.random.default_rng(4)
    tbl = rng.integers(-128, 128, (c["WG"], c["C8"])).astype(np.int8)
    idx = edge_idx(5, (c["NCH"], 1, c["CH"]), c["WG"])
    want = np.asarray(mxu_probe["int8_gather"](jnp.asarray(idx), jnp.asarray(tbl)))
    got = gp.int8_gather(torch.from_numpy(idx), torch.from_numpy(tbl))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[:8].any(dim=1)[[0, 1, 2, 3, 4, 7]].any()  # out of [0, WG): zero


def rld_inputs(seed=6):
    """Sorted offsets with repeats (empty runs), a chunk whose first run
    starts past its rows (uncovered rows), a chunk past every run's start."""
    c = SMALL_MXU
    rng = np.random.default_rng(seed)
    n = c["NCH"] * c["CH"]
    off = np.sort(rng.integers(0, n, (c["NCH"], 1, c["WG"])), axis=-1).astype(np.int32)
    off[:, 0, :3] = 0
    off[1, 0] = np.sort(rng.integers(c["CH"] + 40, n, c["WG"]))
    off[2, 0] = np.sort(rng.integers(0, c["CH"], c["WG"]))
    val = rng.integers(0, 2**23, (c["WG"], c["CV"])).astype(np.int32)
    base = np.zeros((c["NCH"], 1, 8), np.int32)
    base[:, 0, 0] = np.arange(c["NCH"]) * c["CH"]
    base[:, 0, 1:] = rng.integers(-100, 100, (c["NCH"], 7))  # ignored
    return off, val, base


def test_rld_matches_pallas(mxu_probe):
    c = SMALL_MXU
    off, val, base = rld_inputs()
    want = np.asarray(mxu_probe["rld"](jnp.asarray(off), jnp.asarray(val), jnp.asarray(base)))
    got = gp.rld(torch.from_numpy(off), torch.from_numpy(val), torch.from_numpy(base), ch=c["CH"])
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (c["NCH"] * c["CH"], 8)
    np.testing.assert_array_equal(got.numpy(), want)
    uncovered = got[c["CH"]:c["CH"] + 40]
    assert not uncovered.any() and got[2 * c["CH"]:3 * c["CH"]].all()


@pytest.mark.parametrize("case", ["all_zero", "dense", "run_end"])
def test_rld_edge_offsets_match_pallas(mxu_probe, case):
    """mxu_gather_probe.rld_edge_offsets' cases whose offsets the TPU
    kernel decodes exactly (values below 2^24, where its f32 product is
    exact): every offset 0 (every k on the last run), one chunk with all WG
    offsets inside its CH rows (dense, with repeats), and bases that put each
    chunk's k across 2^30 (the last run's end)."""
    from gof_tpu_torch.scripts.mxu_gather_probe import rld_edge_offsets

    c = SMALL_MXU
    rng = np.random.default_rng(19)
    off, base = (x.astype(np.int32) for x in rld_edge_offsets(case, c["NCH"], c["CH"], c["WG"],
                                                                rng))
    val = rng.integers(0, 2**24, (c["WG"], c["CV"])).astype(np.int32)
    want = np.asarray(mxu_probe["rld"](jnp.asarray(off), jnp.asarray(val), jnp.asarray(base)))
    got = gp.rld(torch.from_numpy(off), torch.from_numpy(val), torch.from_numpy(base), ch=c["CH"])
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "run_end":  # rows below 2^30 on the last run, the rest uncovered
        half = c["CH"] // 2
        assert got.reshape(c["NCH"], c["CH"], -1)[0, :half].eq(torch.from_numpy(val[-1])).all()
        assert not got.reshape(c["NCH"], c["CH"], -1)[0, half:].any()


def test_rld_bytes_counts_what_the_rows_need():
    """K12's bound: the output, each chunk's base, the val rows used, and
    per chunk its offsets from the first row's run to one past the last
    row's plus one binary search's reads."""
    from gof_tpu_torch.scripts.mxu_gather_probe import rld_bytes

    off = torch.tensor([[[0, 5, 5, 9, 100, 200, 300, 400]],
                        [[50, 60, 70, 80, 90, 95, 99, 120]]], dtype=torch.int32)
    val = torch.zeros((8, 4), dtype=torch.int32)
    base = torch.tensor([[[4]], [[0]]], dtype=torch.int32)
    # chunk 0, k 4..13: runs 0, 2 (run 1 is empty) and 3, offsets 0..4;
    # chunk 1, k 0..9: no run, offset 0 alone; 3 val rows; 4 reads per
    # search (WG 8)
    want = 2 * 10 * 16 + 2 * 4 + 3 * 16 + (5 + 1 + 2 * 4) * 4
    assert rld_bytes(off, val, base, 10) == want


def test_paged_gather_matches_pallas(mxu_probe):
    c = SMALL_MXU
    wg = c["WG"]
    rng = np.random.default_rng(7)
    big = rng.integers(-128, 128, (wg * 8, c["C8"])).astype(np.int8)
    pages = rng.integers(0, 8, c["NCH"]).astype(np.int32)
    idx = np.empty((c["NCH"], 1, c["CH"]), np.int32)
    for i in range(c["NCH"]):  # 3/4 in the chunk's page, the rest anywhere
        inside = rng.integers(pages[i] * wg, (pages[i] + 1) * wg, c["CH"])
        idx[i, 0] = np.where(rng.uniform(size=c["CH"]) < 0.75, inside,
                             rng.integers(-wg, 9 * wg, c["CH"]))
    idx[0, 0, :3] = [I32_MIN, I32_MAX, -1]
    want = np.asarray(mxu_probe["paged_gather"](jnp.asarray(pages), jnp.asarray(idx),
                                                jnp.asarray(big)))
    got = gp.paged_gather(torch.from_numpy(pages), torch.from_numpy(idx), torch.from_numpy(big),
                          wg=wg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int((got != 0).any(dim=1).sum()) < got.shape[0]


def wrapper_calls():
    """(name, call(device, idx dtype)) for each of the eight wrappers."""
    def idx(dev, dt, hi=64):
        return torch.arange(128, dtype=dt, device=dev).reshape(2, 1, 64) % hi

    f32 = lambda shape, dev: torch.zeros(shape, device=dev)  # noqa: E731
    i8 = lambda shape, dev: torch.zeros(shape, dtype=torch.int8, device=dev)  # noqa: E731
    return {
        "take_gather": lambda d, dt: gp.take_gather(idx(d, dt), f32((64, 32), "cpu")),
        "vidx_gather": lambda d, dt: gp.vidx_gather(idx(d, dt), f32((64, 32), "cpu")),
        "onehot_gather": lambda d, dt: gp.onehot_gather(idx(d, dt), f32((64, 32), "cpu"), 32),
        "scat": lambda d, dt: gp.scat(idx(d, dt), f32((128, 32), "cpu"), 64),
        "scatmxu": lambda d, dt: gp.scatmxu(idx(d, dt), f32((128, 32), "cpu"), 64),
        "int8_gather": lambda d, dt: gp.int8_gather(idx(d, dt), i8((64, 64), "cpu")),
        "rld": lambda d, dt: gp.rld(idx(d, dt), torch.zeros((64, 8), dtype=torch.int32),
                                    torch.zeros((2, 1, 8), dtype=torch.int32), 64),
        "paged_gather": lambda d, dt: gp.paged_gather(torch.zeros(2, dtype=torch.int32),
                                                      idx(d, dt), i8((128, 64), "cpu"), 64),
    }


@pytest.mark.parametrize("name", list(wrapper_calls()))
def test_wrappers_refuse_mixed_devices_and_dtypes(name):
    call = wrapper_calls()[name]
    counter = next(k for k in gp.COUNTERS if k.name == name)
    before = counter.launches
    call("cpu", torch.int32)  # the plain version: no launch counted
    assert counter.launches == before
    with pytest.raises(ValueError):
        call("cpu", torch.int64)
    with pytest.raises(ValueError):
        call("meta", torch.int32)


def test_wrappers_refuse_bad_shapes():
    t = torch.zeros((64, 32))
    with pytest.raises(ValueError):  # idx must be [n, 1, chunk]
        gp.take_gather(torch.zeros((2, 64), dtype=torch.int32), t)
    with pytest.raises(ValueError):  # rows must match the indices
        gp.scat(torch.zeros((2, 1, 64), dtype=torch.int32), torch.zeros((100, 32)), 64)
    with pytest.raises(ValueError):  # PAGE a multiple of PAGE_B
        gp.onehot_gather(torch.zeros((2, 1, 64), dtype=torch.int32), t, 48)
    with pytest.raises(ValueError):  # table rows a multiple of WG
        gp.paged_gather(torch.zeros(2, dtype=torch.int32),
                        torch.zeros((2, 1, 8), dtype=torch.int32),
                        torch.zeros((100, 64), dtype=torch.int8), 64)


def test_pallas_probe_entry_point_cpu():
    from gof_tpu_torch.scripts import pallas_gather_probe

    out = pallas_gather_probe.main(["--cpu", "--page", "256", "--chunk", "128", "--nchunk", "4",
                                    "--page_b", "64"])
    k = out["kernels"]
    assert out["device"] == "cpu"
    assert set(k) == {"take_gather", "vidx_gather", "onehot_gather", "scat", "scatmxu"}
    for name in ("take_gather", "vidx_gather", "onehot_gather"):
        assert k[name]["exact"] and k[name]["library_exact"] and k[name]["max_abs_err"] == 0
    for name in ("scat", "scatmxu"):
        assert k[name]["within_tol"] and k[name]["library_within_tol"]
    assert k["scatmxu"]["deterministic"]
    for r in k.values():
        assert {"ms", "plain_ms", "library_ms", "bound_ms", "bound_by"} <= set(r)
        assert r["bound_ms"] > 0 and r["bound_by"] == "bytes"
    assert k["onehot_gather"]["product_bound_ms"] > 0


def test_mxu_probe_entry_point_cpu():
    from gof_tpu_torch.scripts import mxu_gather_probe

    out = mxu_gather_probe.main(["--cpu", "--ch", "128", "--wg", "256", "--nch", "4", "--cap",
                                 "5000", "--presort", "3000"])
    k = out["kernels"]
    assert set(k) == {"int8_gather", "rld", "paged_gather"}
    assert all(r["exact"] for r in k.values())
    assert k["int8_gather"]["library_exact"] and k["paged_gather"]["library_exact"]
    assert k["rld"]["spot_exact"] and k["rld"]["library_ms"] is None
    assert len(out["sorts"]) == 3 and out["sort_ordered"]


def test_entry_points_need_cuda_without_cpu_flag():
    from gof_tpu_torch.scripts import mxu_gather_probe, pallas_gather_probe

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mod in (pallas_gather_probe, mxu_gather_probe):
        with pytest.raises(RuntimeError):
            mod.main([])


@pytest.mark.parametrize("kind", ["random", "single_page", "all_outside"])
def test_group_chunks_by_page_is_a_stable_argsort(kind):
    """K13's grouping of chunk ids by page: a stable argsort of the pages
    (pages outside [0, npages) last), and each group's start."""
    rng = np.random.default_rng(8)
    npages = 8
    pages = {"random": rng.integers(-3, npages + 3, 500), "single_page": np.full(300, 5),
             "all_outside": rng.choice([-1, npages, I32_MAX, I32_MIN], 40)}[kind].astype(np.int32)
    order, starts = gp.group_chunks_by_page(torch.from_numpy(pages), npages)
    bucket = np.where((pages >= 0) & (pages < npages), pages, npages)
    np.testing.assert_array_equal(order.numpy(), np.argsort(bucket, kind="stable"))
    np.testing.assert_array_equal(
        starts.numpy(), np.concatenate([[0], np.cumsum(np.bincount(bucket, minlength=npages + 1))]))


@pytest.mark.parametrize("rows,wg,c8", [(256, 256, 128), (8 * 192, 192, 64), (2048, 2048, 128)])
def test_s8_operand_layout_is_a_permutation_its_inverse_undoes(rows, wg, c8):
    """The B layout K11/K13's product reads: every table byte once, at
    ((page * slabs + slab) * (wg / 32) + k-step) * 2048 + half * 1024
    + column * 16 + k byte; the inverse restores the table."""
    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.integers(-128, 128, (rows, c8)).astype(np.int8))
    tB = gp.s8_operand_layout(table, wg)
    assert tB.shape == (rows * c8,)
    assert torch.equal(torch.sort(tB).values, torch.sort(table.reshape(-1)).values)
    assert torch.equal(gp.s8_operand_layout_inverse_reference(tB, rows, wg, c8), table)
    t = table.numpy()
    for r, c in zip(rng.integers(0, rows, 50), rng.integers(0, c8, 50)):
        page, k = divmod(int(r), wg)
        kstep, kk = divmod(k, 32)
        half, kb = divmod(kk, 16)
        slab, col = divmod(int(c), 64)
        off = ((page * (c8 // 64) + slab) * (wg // 32) + kstep) * 2048 + half * 1024 + col * 16 + kb
        assert int(tB[off]) == int(t[r, c])


@pytest.mark.parametrize("page", [0, 3, 7])
def test_paged_gather_single_page_matches_pallas(mxu_probe, page):
    """Every chunk on one page (K13's grouping gives one group)."""
    c = SMALL_MXU
    wg = c["WG"]
    rng = np.random.default_rng(10 + page)
    big = rng.integers(-128, 128, (wg * 8, c["C8"])).astype(np.int8)
    pages = np.full(c["NCH"], page, np.int32)
    idx = rng.integers(page * wg - 8, (page + 1) * wg + 8, (c["NCH"], 1, c["CH"])).astype(np.int32)
    want = np.asarray(mxu_probe["paged_gather"](jnp.asarray(pages), jnp.asarray(idx),
                                                jnp.asarray(big)))
    got = gp.paged_gather(torch.from_numpy(pages), torch.from_numpy(idx), torch.from_numpy(big),
                          wg=wg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_gather_pages_outside_the_table_give_zero_rows():
    """The port's rule for a page outside [0, npages) (the TPU kernel's
    block index would leave the table there)."""
    wg, c8 = 64, 64
    rng = np.random.default_rng(11)
    big = torch.from_numpy(rng.integers(-128, 128, (wg * 4, c8)).astype(np.int8))
    pages = torch.tensor([-1, 4, 2, I32_MIN], dtype=torch.int32)
    idx = torch.from_numpy(rng.integers(0, 4 * wg, (4, 1, 32)).astype(np.int32))
    idx[2, 0] = torch.arange(2 * wg, 2 * wg + 32)
    got = gp.paged_gather(pages, idx, big, wg=wg).reshape(4, 32, c8)
    assert not got[[0, 1, 3]].any()
    assert torch.equal(got[2], big[2 * wg:2 * wg + 32].to(torch.int32))


def test_probe_steps_variants_apply_to_the_shipped_source():
    """Each design probe_steps.py times beside the shipped K8 and K9 is
    gather_probes.cu with the changes it names (a kernel added, a named host
    function's body or a constant replaced); each change must match the
    shipped source exactly once, so a rename there shows here, not on the
    card."""
    import sys

    sys.path.insert(0, str(REPO))
    import blend_steps
    import probe_steps
    from gof_tpu_torch.ops import cuda_lib

    src = (cuda_lib.CSRC / "gather_probes.cu").read_text()
    for name, (changes, _) in probe_steps.variants().items():
        text = src
        for fname, old, new in changes:
            assert fname == "gather_probes.cu", name
            text = blend_steps.apply(text, old, new)
        assert (text != src) == bool(changes), name
