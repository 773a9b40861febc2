"""The per-gaussian reduction's plain version against gof_tpu's.

`reduce_rows_by_gid` (CPU tensors: the plain scatter-add) against the Pallas
`sorted_segment_reduce` in interpret mode, fed id-sorted rows as gof_tpu's
`reduce_rows_by_gid` feeds it, and against `jax.ops.segment_sum`, on the
shapes of tests/test_reduce.py, an all-sentinel input and unsorted sparse
ids. Tolerance rtol = atol = 1e-5, as tests/test_reduce.py holds the kernel
to segment_sum (the three sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu.ops import reduce as red
from gof_tpu_torch.ops import reduce as tred

torch.set_num_threads(2)


def case(R, P, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, P + 1, R)  # includes the sentinel P
    rng.shuffle(ids)
    return rng.normal(size=(24, R)).astype(np.float32), ids.astype(np.int32)


def sparse_case():
    R, P = 6144, 300_000
    rng = np.random.default_rng(0)
    ids = np.concatenate([rng.integers(0, 50, R // 3), rng.integers(P - 40, P, R // 3),
                          rng.integers(0, P + 1, R - 2 * (R // 3))]).astype(np.int32)
    rng.shuffle(ids)
    return rng.normal(size=(16, R)).astype(np.float32), ids, P


def jax_refs(rows, ids, P):
    seg = np.asarray(jax.ops.segment_sum(jnp.asarray(rows).T, jnp.asarray(ids),
                                         num_segments=P + 1)[:P])
    R = rows.shape[1]
    ids_sorted, perm = jax.lax.sort((jnp.asarray(ids), jnp.arange(R, dtype=jnp.int32)),
                                    num_keys=1)
    out = red.sorted_segment_reduce(jnp.asarray(rows).T[perm].T, ids_sorted, P, interpret=True)
    return seg, np.asarray(out[:, :P]).T


@pytest.mark.parametrize("R,P", [(2048, 100), (4096, 5000), (8192, 63)])
def test_reduce_matches_gof_tpu(R, P):
    rows, ids = case(R, P, seed=R + P)
    got = tred.reduce_rows_by_gid(torch.from_numpy(rows), torch.from_numpy(ids), P)
    assert tuple(got.shape) == (P, 24)
    seg, kern = jax_refs(rows, ids, P)
    np.testing.assert_allclose(got.numpy(), seg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), kern, rtol=1e-5, atol=1e-5)


def test_reduce_unsorted_sparse_ids():
    rows, ids, P = sparse_case()
    got = tred.reduce_rows_by_gid(torch.from_numpy(rows), torch.from_numpy(ids), P)
    seg, kern = jax_refs(rows, ids, P)
    np.testing.assert_allclose(got.numpy(), seg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), kern, rtol=1e-5, atol=1e-5)
    # the sparse middle: at most its 2048 rows' ids receive anything
    assert (np.abs(got.numpy()[50:P - 40]).sum(1) != 0).sum() <= 2048


def test_reduce_all_sentinel():
    R, P = 2048, 777
    rows = torch.from_numpy(np.random.default_rng(1).normal(size=(16, R)).astype(np.float32))
    got = tred.reduce_rows_by_gid(rows, torch.full((R,), P, dtype=torch.int32), P)
    assert tuple(got.shape) == (P, 16) and float(got.abs().max()) == 0.0


def test_reduce_counts_no_cpu_launch_and_refuses_other_devices():
    rows, ids = case(2048, 100, 0)
    before = tred.REDUCE.launches
    tred.reduce_rows_by_gid(torch.from_numpy(rows), torch.from_numpy(ids), 100)
    assert tred.REDUCE.launches == before
    with pytest.raises(ValueError):
        tred.reduce_rows_by_gid(torch.from_numpy(rows).to("meta"),
                                torch.from_numpy(ids).to("meta"), 100)


@pytest.mark.parametrize("R,P", [(1000, 37), (64, 200)])
def test_segment_order_is_a_stable_sort_with_starts(R, P):
    """The sort and segment starts the K4 and K10 kernels read: a stable
    argsort of the ids and each id's first sorted position."""
    ids = np.random.default_rng(R).integers(0, P + 1, R).astype(np.int32)
    perm, starts = tred.segment_order(torch.from_numpy(ids), P)
    np.testing.assert_array_equal(perm.numpy(), np.argsort(ids, kind="stable"))
    np.testing.assert_array_equal(starts.numpy(),
                                  np.searchsorted(np.sort(ids), np.arange(P + 1), side="left"))


def skewed_case(kind: str, R=6000, P=300, seed=2):
    """One id owning most rows, or every row on one id, amid the sentinel."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, P + 1, R).astype(np.int32)
    if kind == "one_id_4500_rows":
        ids[rng.permutation(R)[:4500]] = 17
    else:
        ids[:] = 0
    rows = (rng.normal(size=(24, R)) * 10.0 ** rng.integers(-4, 5, (1, R))).astype(np.float32)
    return rows, ids, P


@pytest.mark.parametrize("kind", ["one_id_4500_rows", "all_rows_on_one_id"])
def test_reduce_skewed_ids_match_segment_sum(kind):
    rows, ids, P = skewed_case(kind)
    got = tred.reduce_rows_by_gid(torch.from_numpy(rows), torch.from_numpy(ids), P)
    seg = np.asarray(jax.ops.segment_sum(jnp.asarray(rows).T, jnp.asarray(ids),
                                         num_segments=P + 1)[:P])
    np.testing.assert_allclose(got.numpy(), seg, rtol=1e-5, atol=1e-5 * np.abs(seg).max())


@pytest.mark.parametrize("kind", ["uniform", "one_id_4500_rows", "all_rows_on_one_id"])
def test_plain_reduce_folds_each_id_in_ascending_row_order(kind):
    """The plain version is, bit for bit, 0.0 + r_0 + r_1 + ... over each
    id's rows in ascending row order (f32): the order K4 sums in."""
    if kind == "uniform":
        rows, ids = case(3000, 40, seed=5)
        rows = (rows * 10.0 ** np.random.default_rng(6).integers(-4, 5, (1, 3000))).astype(np.float32)
        P = 40
    else:
        rows, ids, P = skewed_case(kind)
    got = tred.reduce_rows_by_gid(torch.from_numpy(rows), torch.from_numpy(ids), P).numpy()
    want = np.zeros((P, rows.shape[0]), np.float32)
    for r, g in enumerate(ids):
        if g < P:
            want[g] = want[g] + rows[:, r]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["uniform", "one_id_4500_rows", "all_rows_on_one_id",
                                  "all_sentinel"])
def test_bucket_order_is_segment_order(kind):
    """K4's bucket order (rows by id, ascending row in an id, sentinel rows
    dropped) is segment_order's stable sort up to the sentinel's segment."""
    if kind == "uniform":
        _, ids = case(3000, 40, seed=7)
        P = 40
    elif kind == "all_sentinel":
        ids, P = np.full(500, 33, np.int32), 33
    else:
        _, ids, P = skewed_case(kind)
    order, starts = tred.bucket_order_reference(torch.from_numpy(ids), P)
    perm, seg_starts = tred.segment_order(torch.from_numpy(ids), P)
    np.testing.assert_array_equal(starts.numpy(), seg_starts.numpy())
    np.testing.assert_array_equal(order.numpy(), perm[:int(seg_starts[P])].numpy())


def test_reduce_row_blocks_equals_the_stacked_rows():
    rows, ids = case(2048, 100, 3)
    t, g = torch.from_numpy(rows), torch.from_numpy(ids)
    got = tred.reduce_row_blocks([t[:16], t[16:]], g, 100)
    assert torch.equal(got, tred.reduce_rows_by_gid(t, g, 100))
    with pytest.raises(ValueError):
        tred.reduce_row_blocks([t[:8], t[8:16], t[16:]], g, 100)
    with pytest.raises(ValueError):
        tred.reduce_row_blocks([t[:16], t[16:, :100]], g, 100)


@pytest.mark.parametrize("kind", ["uniform", "one_id_4500_rows", "all_rows_on_one_id",
                                  "all_sentinel"])
@pytest.mark.parametrize("c", [19, 24])
def test_row_major_plain_is_the_transposed_reduce(kind, c):
    """The row-major entry's plain version ([R, cp] rows, the first c
    columns) is the plain reduce of the transposed rows, bit for bit."""
    if kind == "uniform":
        rows, ids = case(3000, 40, seed=8)
        P = 40
    elif kind == "all_sentinel":
        rows, ids = case(3000, 40, seed=9)
        ids, P = np.full_like(ids, 40), 40
    else:
        rows, ids, P = skewed_case(kind)
    vals, g = torch.from_numpy(np.ascontiguousarray(rows.T)), torch.from_numpy(ids)
    before = tred.REDUCE.launches
    got = tred.reduce_row_major(vals, g, P, c)
    assert tred.REDUCE.launches == before
    assert tuple(got.shape) == (P, c)
    assert torch.equal(got, tred.reduce_rows_by_gid_reference(torch.from_numpy(rows[:c]), g, P))
    assert torch.equal(got, tred.reduce_rows_by_gid(torch.from_numpy(rows[:c]), g, P))
    if kind == "all_sentinel":
        assert float(got.abs().max()) == 0.0


def test_row_major_refuses_bad_shapes_and_devices():
    rows, ids = case(256, 10, 1)
    vals, g = torch.from_numpy(np.ascontiguousarray(rows.T)), torch.from_numpy(ids)
    assert torch.equal(tred.reduce_row_major(vals, g, 10), tred.reduce_row_major(vals, g, 10, 24))
    with pytest.raises(ValueError):  # more columns than the rows hold
        tred.reduce_row_major(vals, g, 10, 25)
    with pytest.raises(ValueError):
        tred.reduce_row_major(vals, g[:-1], 10)
    with pytest.raises(ValueError):
        tred.reduce_row_major(vals.to("meta"), g, 10)
