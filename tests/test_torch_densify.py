"""gof_tpu_torch's densify-and-prune and pool growth against gof_tpu's.

Inputs are made with numpy from a seed and fed to both packages; gof_tpu's
densify_and_prune runs jitted, once per case, at capacities 64-256. The port
cannot draw gof_tpu's noise (jax.random has no torch counterpart, ROADMAP
C13), so each case computes gof_tpu's own draws here, as gof_tpu does
(gaussians.py:287-292), and hands them to the port.

Tolerances: `active`, the report, the placed slots, the zeroed moment rows
and every other value exactly, except `xyz` (the noise's einsum with R·s)
and `scaling` (log(exp(s) / 1.6)), which agree within 1e-6 relative. The
inputs keep every compared value at least 1e-5 relative away from each
threshold (max_grad, percent_dense·extent, 0.1·extent, min_opacity and the
quantile Q), so that a last-ulp difference cannot flip a mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import train as jtrain
from gof_tpu.model import gaussians as jgm
from gof_tpu_torch import train as ttrain
from gof_tpu_torch.model import gaussians as tgm

torch.set_num_threads(2)

RTOL = 1e-6
MARGIN = 1e-5
SH_DEGREE = 1


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep", ["one", "some", "all"])
@pytest.mark.parametrize("q", [0.0, 0.3, 0.77, 1.0])
def test_masked_quantile_matches(keep, q):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1e-3, 64).astype(np.float32)
    mask = {"one": np.arange(64) == 17, "some": rng.uniform(size=64) < 0.4,
            "all": np.ones(64, bool)}[keep]
    want = jax.jit(jgm._masked_quantile)(jnp.asarray(x), jnp.asarray(mask), jnp.float32(q))
    got = tgm._masked_quantile(t(x), t(mask), torch.tensor(q, dtype=torch.float32))
    assert got.dtype == torch.float32
    assert got.numpy() == np.asarray(want), (float(got), float(want))
    if keep == "one":
        assert float(got) == x[17]


@pytest.mark.parametrize("wants", ["fewer", "equal", "more"])
def test_assign_free_slots_matches(wants):
    rng = np.random.default_rng(1)
    C = 64
    active = rng.uniform(size=C) < 0.6
    n_free = int((~active).sum())
    n_want = {"fewer": n_free // 2, "equal": n_free, "more": n_free + 9}[wants]
    want = np.zeros(C, bool)
    want[rng.choice(C, n_want, replace=False)] = True
    jt, jok = jgm._assign_free_slots(jnp.asarray(active), jnp.asarray(want))
    tt, tok = tgm._assign_free_slots(t(active), t(want))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tok.sum()) == min(n_want, n_free)
    placed = tt.numpy()[tok.numpy()]
    assert len(set(placed)) == len(placed) and not active[placed].any()


# ---------------------------------------------------------------------------
# densify_and_prune
# ---------------------------------------------------------------------------


def random_case(rng, C, n_active, split_frac=0.5, big_frac=0.0, select_frac=0.3,
                extent=2.0, pd=0.01, max_grad=2e-4):
    """A padded pool whose active gaussians sit clear of every threshold:
    clone-sized (max scale under pd·extent) or split-sized, some above the
    world-size bound (big_frac), opacities on both sides of 0.05, and
    gradient statistics on both sides of max_grad (about select_frac over)."""
    K = (SH_DEGREE + 1) ** 2
    xyz = rng.uniform(-2, 2, (C, 3))
    q = rng.normal(size=(C, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    thr = pd * extent
    kind = rng.uniform(size=C)
    maxs = np.where(kind < split_frac, rng.uniform(1.5, 4.0, C) * thr,
                    rng.uniform(0.2, 0.8, C) * thr)
    big = rng.uniform(size=C) < big_frac
    maxs = np.where(big, rng.uniform(1.1, 2.5, C) * 0.1 * extent, maxs)
    scaling = np.log(maxs[:, None] * rng.uniform(0.3, 1.0, (C, 3)))
    scaling[np.arange(C), rng.integers(0, 3, C)] = np.log(maxs)
    op = rng.uniform(0.01, 0.9, C)
    denom = rng.integers(0, 6, C).astype(np.float64)
    g = max_grad * np.where(rng.uniform(size=C) < select_frac, rng.uniform(1.2, 5, C),
                            rng.uniform(0.05, 0.8, C))
    gabs = rng.uniform(0.1, 3.0, C) * max_grad
    xyz[n_active:], scaling[n_active:], op[n_active:] = 0.0, -10.0, 0.5
    q[n_active:] = (1.0, 0, 0, 0)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    params = jgm.GaussianParams(
        xyz=f32(xyz), features_dc=f32(rng.normal(0, 0.5, (C, 1, 3))),
        features_rest=f32(rng.normal(0, 0.1, (C, K - 1, 3))), scaling=f32(scaling),
        rotation=f32(q), opacity=f32(np.log(op / (1 - op))))
    active = np.arange(C) < n_active
    denom[~active] = 0
    state = jgm.GaussianState(
        active=active, filter_3d=f32(rng.uniform(1e-4, 1e-3, C)),
        max_radii2d=f32(rng.uniform(0, 9, C)), grad_accum=f32(g * denom),
        grad_abs_accum=f32(gabs * denom), denom=f32(denom))
    return params, state, dict(max_grad=max_grad, min_opacity=0.05, extent=extent,
                               percent_dense=pd)


def check_margins(params, state, kw):
    """Every active value the masks compare lies MARGIN clear of its
    threshold (Q: clear of it or equal to it, as a sorted value is)."""
    a = state.active
    d = np.maximum(state.denom, 1e-12)
    grads = np.where(state.denom > 0, state.grad_accum / d, 0)[a]
    gabs = np.where(state.denom > 0, state.grad_abs_accum / d, 0)
    Q = float(tgm._masked_quantile(
        t(gabs), t(a), 1.0 - ((grads >= kw["max_grad"]).sum() / max(a.sum(), 1))))
    maxs = np.exp(params.scaling.astype(np.float64)).max(-1)[a]
    op = 1 / (1 + np.exp(-params.opacity.astype(np.float64)[a]))
    for v, thr in ((grads[grads > 0], kw["max_grad"]),
                   (maxs, kw["percent_dense"] * kw["extent"]),
                   (maxs, 0.1 * kw["extent"]), (maxs / 1.6, 0.1 * kw["extent"]),
                   (op, kw["min_opacity"]), (gabs[a][gabs[a] != Q], Q)):
        v = v[np.isfinite(v)]
        assert (np.abs(v - thr) > MARGIN * thr).all(), thr


def case_under(rng):
    p, s, kw = random_case(rng, 256, 120)
    return p, s, kw, False, True


def case_overflow(rng):
    p, s, kw = random_case(rng, 128, 100, select_frac=0.6)
    return p, s, kw, False, True


def case_size_prune(rng):
    p, s, kw = random_case(rng, 256, 150, big_frac=0.15)
    return p, s, kw, True, True


def case_nonfinite(rng):
    p, s, kw = random_case(rng, 128, 80)
    xyz, scaling = p.xyz.copy(), p.scaling.copy()
    g, gabs, denom = s.grad_accum.copy(), s.grad_abs_accum.copy(), s.denom.copy()
    xyz[3] = np.nan  # selected: what it places inherits the NaN
    denom[3], g[3], gabs[3] = 2.0, 100 * kw["max_grad"], 0.5 * kw["max_grad"]
    scaling[9, 1] = np.inf
    return (p._replace(xyz=xyz, scaling=scaling),
            s._replace(grad_accum=g, grad_abs_accum=gabs, denom=denom), kw, False, True)


def case_ratio0(rng):
    """tests/test_model.py::test_prune_low_opacity: no gradient reaches
    max_grad, so ratio = 0, Q = the largest |grad| and only its owner (slot
    10) is selected (cloned or split, by its size); the 5 low-opacity
    gaussians are pruned."""
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    cols = rng.random((20, 3)).astype(np.float32)
    params, state = jax.device_get(jgm.init_from_points(pts, cols, SH_DEGREE, 64))
    op = np.asarray(params.opacity).copy()
    op[:5] = np.asarray(jgm.inverse_sigmoid(jnp.float32(0.001)))
    gabs = np.zeros(64, np.float32)
    gabs[:20] = np.linspace(1e-6, 1e-5, 20)
    gabs[10], gabs[19] = gabs[19], gabs[10]
    state = state._replace(denom=np.ones(64, np.float32), grad_abs_accum=gabs)
    kw = dict(max_grad=999.0, min_opacity=0.005, extent=10.0, percent_dense=0.01)
    return params._replace(opacity=op), state, kw, False, True


def case_no_moments(rng):
    p, s, kw = random_case(rng, 128, 60)
    return p, s, kw, False, False


CASES = {"under": case_under, "overflow": case_overflow, "size_prune": case_size_prune,
         "nonfinite": case_nonfinite, "ratio0": case_ratio0, "no_moments": case_no_moments}


def jax_moments(rng, params):
    """A gof_tpu FusedAdamState with non-zero moments and count."""
    ncol = sum(jtrain._gauss_cols(params))
    C = params.xyz.shape[0]
    return jtrain.FusedAdamState(
        count=np.int32(37), mu_flat=rng.normal(0, 1e-3, (ncol, C)).astype(np.float32),
        nu_flat=rng.uniform(1e-9, 1e-6, (ncol, C)).astype(np.float32))


def densify_case(name):
    """CASES[name] through gof_tpu's jitted densify_and_prune and the port's
    (with gof_tpu's draws): (params, state, kw, use_size, with_moments, C,
    noise, jmom, gof_tpu's result, the port's inputs (tp_, ts), the port's
    result)."""
    rng = np.random.default_rng(10 + list(CASES).index(name))
    params, state, kw, use_size, with_moments = CASES[name](rng)
    if name != "ratio0":
        check_margins(params, state, kw)
    C = params.xyz.shape[0]
    jmom = jax_moments(rng, params) if with_moments else None
    key = jax.random.PRNGKey(3)
    # gof_tpu's own draws (gaussians.py:287-292)
    noise = tuple(t(jax.random.normal(k, (C, 3))) for k in jax.random.split(key, 3))

    f = jax.jit(lambda p, s, o, k: jgm.densify_and_prune(
        p, s, o, k, kw["max_grad"], kw["min_opacity"], kw["extent"], kw["percent_dense"],
        use_size))
    jres = jax.device_get(f(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                            jax.tree.map(jnp.asarray, jmom), key))

    tp_, ts = tgm.from_numpy(params, state)
    tmom = ttrain.from_numpy(jmom, tp_) if with_moments else None
    res = tgm.densify_and_prune(tp_, ts, tmom, noise, kw["max_grad"], kw["min_opacity"],
                                kw["extent"], kw["percent_dense"], use_size)
    return (params, state, kw, use_size, with_moments, C, noise, jmom, jres, (tp_, ts), res)


@pytest.mark.parametrize("name", list(CASES))
def test_densify_and_prune_matches(name):
    (params, state, kw, use_size, with_moments, C, noise, jmom, (jp, js, jm, jrep), (tp_, ts),
     (gp, gs, gm_, rep)) = densify_case(name)

    assert [int(x) for x in rep] == [int(x) for x in jrep], (rep, jrep)
    np.testing.assert_array_equal(gs.active.numpy(), np.asarray(js.active))
    np.testing.assert_array_equal(gs.filter_3d.numpy(), np.asarray(js.filter_3d))
    for f_ in ("max_radii2d", "grad_accum", "grad_abs_accum", "denom"):
        assert not getattr(gs, f_).any() and not np.asarray(getattr(js, f_)).any()
    act = np.asarray(js.active)
    for f_ in ttrain.GAUSS_FIELDS:
        got = getattr(gp, f_).numpy()[act]
        want = np.asarray(getattr(jp, f_))[act]
        if f_ in ("xyz", "scaling"):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want, err_msg=f_)
    if with_moments:
        want = ttrain.from_numpy(jm, gp)
        assert gm_.count == want.count == 37
        for f_ in ttrain.GAUSS_FIELDS:
            for m in ("mu", "nu"):
                np.testing.assert_array_equal(getattr(getattr(gm_, m), f_).numpy(),
                                              getattr(getattr(want, m), f_).numpy())
    else:
        assert gm_ is None and jm is None

    # what each case is there to show
    n0 = int(state.active.sum())
    if name == "under":
        assert rep.n_cloned > 0 and rep.n_split > 0 and rep.n_pruned > 0
        assert not rep.pool_overflow
        assert int(gs.active.sum()) == n0 + rep.n_cloned + rep.n_split - rep.n_pruned
    if name == "overflow":
        assert rep.pool_overflow
    if name == "size_prune":
        no_size = tgm.densify_and_prune(tp_, ts, None, noise, kw["max_grad"], kw["min_opacity"],
                                        kw["extent"], kw["percent_dense"], False)[3]
        assert rep.n_pruned > no_size.n_pruned > 0
    if name == "nonfinite":
        assert not gs.active.numpy()[[3, 9]].any()
        assert (~np.isfinite(gp.xyz.numpy()[~act & np.asarray(np.arange(C) >= 80)])).any()
    if name == "ratio0":
        assert (int(rep.n_cloned + rep.n_split), int(rep.n_pruned),
                int(gs.active.sum())) == (1, 5, 16)


def test_densify_zeroes_only_placed_moment_rows():
    """ROADMAP C6, by name: every moment field is zeroed at exactly the
    slots a placement wrote; removed split originals and pruned rows keep
    their (stale) moments, and count is unchanged."""
    rng = np.random.default_rng(30)
    params, state, kw = random_case(rng, 256, 120)
    tp_, ts = tgm.from_numpy(params, state)
    mom = ttrain.from_numpy(jax_moments(rng, params), tp_)
    noise = tuple(torch.randn((256, 3), generator=torch.Generator().manual_seed(s))
                  for s in range(3))
    gp, gs, gm_, rep = tgm.densify_and_prune(tp_, ts, mom, noise, kw["max_grad"],
                                             kw["min_opacity"], kw["extent"],
                                             kw["percent_dense"], False)
    placed = ~ts.active & (gp.opacity != tp_.opacity)
    assert not rep.pool_overflow and int(placed.sum()) == int(rep.n_cloned) + 2 * int(rep.n_split)
    for m in ("mu", "nu"):
        for f in ttrain.GAUSS_FIELDS:
            new, old = getattr(getattr(gm_, m), f), getattr(getattr(mom, m), f)
            assert not new[placed].any()
            assert torch.equal(new[~placed], old[~placed])
    assert gm_.count == mom.count


# ---------------------------------------------------------------------------
# Pool growth, moments layout
# ---------------------------------------------------------------------------


def test_grow_capacity_matches():
    rng = np.random.default_rng(40)
    params, state, _ = random_case(rng, 64, 50)
    jmom = jax_moments(rng, params)
    jtp = jtrain.TrainParams(gauss=jax.tree.map(jnp.asarray, params), app_net=None,
                             app_emb=None)
    jp, js, jo = jax.device_get(jtrain.grow_capacity(
        jtp, jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, jmom), 64, 128))
    g, s = tgm.from_numpy(params, state)
    tp_, ts, to = ttrain.grow_capacity(ttrain.TrainParams(gauss=g), s,
                                       ttrain.from_numpy(jmom, g), 64, 128)
    for f in ttrain.GAUSS_FIELDS:
        np.testing.assert_array_equal(getattr(tp_.gauss, f).numpy(),
                                      np.asarray(getattr(jp.gauss, f)), err_msg=f)
    for f in ttrain.STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    want = ttrain.from_numpy(jo, tp_.gauss)
    assert to.count == want.count == 37
    for m in ("mu", "nu"):
        for f in ttrain.GAUSS_FIELDS:
            np.testing.assert_array_equal(getattr(getattr(to, m), f).numpy(),
                                          getattr(getattr(want, m), f).numpy())
    assert tp_.gauss.xyz.shape[0] == 128 and not ts.active[64:].any()
    assert (tp_.gauss.rotation[64:] == torch.tensor([1.0, 0, 0, 0])).all()


def test_adam_to_numpy_inverts_from_numpy():
    rng = np.random.default_rng(41)
    params, _, _ = random_case(rng, 64, 64)
    jmom = jax_moments(rng, params)
    g, _ = tgm.from_numpy(params, jgm.GaussianState(*[np.zeros(64)] * 6))
    port = ttrain.from_numpy(jmom, g)
    back = ttrain.adam_to_numpy(port)
    assert back.count == 37
    np.testing.assert_array_equal(back.mu_flat, jmom.mu_flat)
    np.testing.assert_array_equal(back.nu_flat, jmom.nu_flat)
    again = ttrain.from_numpy(back, g)
    for m in ("mu", "nu"):
        for f in ttrain.GAUSS_FIELDS:
            assert torch.equal(getattr(getattr(again, m), f), getattr(getattr(port, m), f))


@pytest.mark.parametrize("name", list(CASES))
def test_densify_breakdown_accounts_for_the_call(name):
    """chip_smoke.densify_breakdown, the record of a densify call that the
    C27 ladder and the smoke's RunRecorder keep, recomputed from each
    case's inputs and result: the same record from gof_tpu's call and the
    port's; it accounts for the report (the recomputed splits and the
    three prune criteria); without drops the counts add up (a clone adds
    one, a split one net, a prune takes one away); and each case shows
    what it is there to show: dropped placements on overflow, size prunes
    with the size prune on, non-finite prunes, the classic threshold
    selecting nothing at ratio 0 (only the quantile half)."""
    import chip_smoke

    (params, state, kw, use_size, _, _, _, _, (jp, js, _, jrep), (tp_, ts),
     (gp, gs, _, rep)) = densify_case(name)
    consts = (kw["max_grad"], kw["min_opacity"], kw["extent"], kw["percent_dense"], use_size)
    got = chip_smoke.densify_breakdown(tp_, ts, gp, gs, rep, *consts)
    want = chip_smoke.densify_breakdown(params, state, jp, js, jrep, *consts)
    assert got == want, (got, want)
    assert got["accounted"]
    if not got["dropped"]:  # a split replaces its original by two children
        assert got["after"] == got["before"] + got["clones"] + got["splits"] - got["pruned"]
    assert got["pruned"] <= got["pruned opacity"] + got["pruned size"] + got["pruned non-finite"]
    assert (got["dropped"] > 0) == bool(rep.pool_overflow)
    assert (got["pruned size"] > 0) == (name == "size_prune")
    assert (got["pruned non-finite"] > 0) == (name == "nonfinite")
    if name == "ratio0":
        assert got["classic"] == 0 and got["quantile only"] == 1
    else:
        assert got["classic"] > 0 and got["quantile only"] > 0
