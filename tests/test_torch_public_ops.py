"""The public names the port adds to reach the JAX package's surface,
each held to its JAX counterpart on the same seeded inputs.

  * ops.knn.knn_search: idx bitwise, dist to 1e-12, both metrics, with
    duplicate rows (tie-breaks);
  * ops.knn_device.smooth_dev: smoothing's 1e-4 (f32 sums in another
    order), and bitwise equal to smooth_dev_multi's first matrix;
  * ops.coldeltacor.col_delta_cor_partial_compact_dev: the colDeltaCor
    tolerances of test_torch_sampled.py (rtol 1e-3 / atol 1e-4);
  * native.balance_knn_loop (native/balance.cpp): bitwise against the
    JAX package's balance_knn_loop and the port's numpy loop, plain and
    constrained, with and without distance, with exhausted sights;
  * native.choice_noreplace_rows / _state: rows, draws and state bitwise
    against the JAX package's (numpy's own loop where its library does
    not load), the two- and three-part returns;
  * the aliases and export lists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velocyto_tpu as vt
from velocyto_tpu import native as jnative
from velocyto_tpu.ops import coldeltacor as jcdc
from velocyto_tpu.ops import knn as jknn
from velocyto_tpu.ops import knn_device as jkd

import velocyto_tpu_torch as vtt
import velocyto_tpu_torch.ops as tops
from velocyto_tpu_torch import kernels, native
from velocyto_tpu_torch.ops import coldeltacor as tcdc
from velocyto_tpu_torch.ops import knn as tknn
from velocyto_tpu_torch.ops import knn_device as tkd

CPU = torch.device("cpu")
SEED = 15071990


# --- knn_search -------------------------------------------------------

@pytest.mark.parametrize("metric", ["euclidean", "correlation"])
@pytest.mark.parametrize("n,d,k", [(150, 6, 12), (90, 40, 90)])
def test_knn_search_matches_jax(metric, n, d, k):
    rng = np.random.RandomState(4)
    x = rng.randn(n, d)
    x[7] = x[3]                          # a tie at distance 0
    x[11] = x[3]
    dist, idx = tknn.knn_search(x, k, metric=metric, device=CPU)
    j_dist, j_idx = jknn.knn_search(x, k, metric=metric)
    assert dist.dtype == np.float64 and idx.dtype == np.int64
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_allclose(dist, j_dist, rtol=1e-12, atol=1e-12)
    # self first; the copies of cell 3 put it (the lowest index) first
    first = np.arange(n)
    first[[7, 11]] = 3
    np.testing.assert_array_equal(idx[:, 0], first)


def test_knn_search_over_mesh_matches_single_device():
    x = np.random.RandomState(5).randn(300, 5)
    base = tknn.knn_search(x, 20, device=CPU)
    mesh = vtt.make_mesh(devices=[CPU] * 2)
    for got in (tknn.knn_search(x, 20, mesh=mesh),
                tknn.knn_search_sharded(mesh, x, 20)):
        np.testing.assert_array_equal(got[1], base[1])
        np.testing.assert_array_equal(got[0], base[0])


# --- smooth_dev -------------------------------------------------------

def test_smooth_dev_matches_jax_and_multi():
    rng = np.random.RandomState(6)
    g, n, k = 23, 80, 9
    data = (rng.rand(g, n) * 5).astype(np.float32)
    idx = np.stack([rng.choice(n, k, replace=False) for _ in range(n)])
    idx[::7, -1] = -1                    # unset slots carry weight 0
    w = rng.rand(n, k).astype(np.float32)
    w[idx < 0] = 0
    w /= w.sum(1, keepdims=True)
    got = tkd.smooth_dev(torch.from_numpy(data), torch.from_numpy(idx),
                         torch.from_numpy(w))
    want = np.asarray(jkd.smooth_dev(jnp.asarray(data), jnp.asarray(idx),
                                     jnp.asarray(w)))
    assert got.shape == (g, n) and got.device == CPU
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    multi = tkd.smooth_dev_multi((torch.from_numpy(data),
                                  torch.from_numpy(2 * data)),
                                 torch.from_numpy(idx), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), multi[0].numpy())


# --- col_delta_cor_partial_compact_dev ---------------------------------

@pytest.mark.parametrize("transform,psc", [("linear", 0.0), ("sqrt", 0.0),
                                           ("sqrt", 1e-10), ("log10", 1.0)])
def test_partial_compact_dev_matches_jax(transform, psc):
    rng = np.random.RandomState(7)
    g, n, nn = 41, 60, 17
    e = (rng.rand(g, n) * 10).astype(np.float32)
    d = rng.randn(g, n).astype(np.float32)
    ixs = np.stack([rng.choice(np.delete(np.arange(n), i), nn, replace=False)
                    for i in range(n)])
    got = tcdc.col_delta_cor_partial_compact_dev(e, d, ixs, transform, psc,
                                                 device=CPU)
    want = np.asarray(jcdc.col_delta_cor_partial_compact_dev(
        e, d, ixs, transform, psc))
    assert got.dtype == torch.float32 and got.shape == (n, nn)
    assert got.device == CPU and kernels.partial_launches == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    # numpy and tensors give the same; the single field of the compact call
    single = tcdc.col_delta_cor_partial_compact(
        torch.from_numpy(e), torch.from_numpy(d), torch.from_numpy(ixs),
        transform, psc)
    again = tcdc.col_delta_cor_partial_compact_dev(
        torch.from_numpy(e), torch.from_numpy(d), torch.from_numpy(ixs),
        transform, psc, device="cpu")
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    np.testing.assert_array_equal(got.numpy(), again.numpy())


# --- the native balance loop ------------------------------------------

def _candidates(n, sight, seed):
    """(n, sight) candidate rows of distinct cells, each row's own cell
    somewhere in most rows, and ascending distances."""
    rng = np.random.RandomState(seed)
    dsi = np.stack([rng.permutation(n)[:sight] for _ in range(n)])
    for i in range(n):
        if rng.rand() < 0.8 and i not in dsi[i]:
            dsi[i, rng.randint(sight)] = i
    dist = np.sort(rng.rand(n, sight), axis=1)
    lsi = np.argsort(np.bincount(dsi.ravel(), minlength=n),
                     kind="mergesort")[::-1]
    return dsi.astype(np.int64), dist, lsi


# (n, sight, k, maxl): loose caps, tight caps where most sights run out
# (self-fill), and k = 0
BALANCE_CASES = [(200, 30, 8, 40), (200, 30, 10, 3), (120, 12, 12, 2),
                 (50, 10, 0, 5)]


@pytest.mark.parametrize("return_distance", [True, False])
@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("n,sight,k,maxl", BALANCE_CASES)
def test_native_balance_bitwise(n, sight, k, maxl, constrained,
                                return_distance):
    dsi, dist, lsi = _candidates(n, sight, seed=n + sight + k)
    cst = (np.arange(n) % 4).astype(np.int64) if constrained else None
    got = native.balance_knn_loop(dsi, dist, lsi, maxl, k, return_distance,
                                  cst)
    plain = tknn.balance_knn_loop_plain(dsi, dist, lsi, maxl, k,
                                        return_distance, cst)
    jax_ = jknn.balance_knn_loop(dsi, dist, lsi, maxl, k, return_distance,
                                 cst)
    for want in (plain, jax_):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert got[1].shape == (n, k + 1) and (got[2] <= maxl).all()
    if maxl <= 3 and k:
        own = got[1][:, 1:] == np.arange(n)[:, None]
        assert own.any(), "no sight ran out: the self-fill is untested"


def test_balance_paths_go_through_the_native_loop(monkeypatch):
    """ops.knn.balance_knn_loop, knn_balance and BalancedKNN reach
    native.balance_knn_loop; the constrained alias is the same call."""
    dsi, dist, lsi = _candidates(100, 20, seed=9)
    calls = []
    loop = native.balance_knn_loop

    def counted(*args):
        calls.append(args[4])
        return loop(*args)
    monkeypatch.setattr(native, "balance_knn_loop", counted)
    groups = (np.arange(100) % 3).astype(np.int64)
    a = tknn.balance_knn_loop_constrained(dsi, dist, lsi, groups, 4, 6, True)
    b = tknn.balance_knn_loop(dsi, dist, lsi, 4, 6, True, constraint=groups)
    c = jknn.balance_knn_loop_constrained(dsi, dist, lsi, groups, 4, 6, True)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    tknn.knn_balance(dsi, dist, maxl=4, k=6)
    x = np.random.RandomState(1).randn(60, 4)
    bk = tknn.BalancedKNN(k=5, sight_k=15, maxl=8, device=CPU).fit(x)
    got = bk.kneighbors()
    want = jknn.BalancedKNN(k=5, sight_k=15, maxl=8).fit(x).kneighbors()
    # the graph exact; f64 distances summed in another order
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert calls == [6, 6, 6, 5]


@pytest.mark.parametrize("bad", ["short_sight", "index", "lsi", "dist",
                                 "constraint"])
def test_native_balance_refuses_malformed_inputs(bad):
    dsi, dist, lsi = _candidates(40, 10, seed=3)
    cst, k = None, 4
    if bad == "short_sight":
        k = 11
    elif bad == "index":
        dsi[5, 2] = 40
    elif bad == "lsi":
        lsi = lsi[:-1]
    elif bad == "dist":
        dist = dist[:, :-1]
    else:
        cst = np.zeros(39, np.int64)
    with pytest.raises(ValueError):
        native.balance_knn_loop(dsi, dist, lsi, 3, k, True, cst)


# --- the neighbour sampler's two contracts -----------------------------

@pytest.mark.parametrize("n,nn_k,n_samp", [(300, 61, 30), (50, 9, 8)])
def test_choice_noreplace_rows_two_and_three_parts(n, nn_k, n_samp):
    p = np.linspace(0.5, 0.1, nn_k)
    p = p / p.sum()
    two = native.choice_noreplace_rows(SEED, n, nn_k, n_samp, p)
    three = native.choice_noreplace_rows_state(SEED, n, nn_k, n_samp, p)
    assert len(two) == 2 and len(three) == 3
    want_two = jnative.choice_noreplace_rows(SEED, n, nn_k, n_samp, p)
    want_three = jnative.choice_noreplace_rows_state(SEED, n, nn_k, n_samp,
                                                     p)
    if want_two is None:                 # no libvtpu: numpy's own loop
        rows, state = native.choice_rows_plain(SEED, n, nn_k, n_samp, p)
        want_two = (rows, two[1])
        want_three = (rows, two[1], state)
    np.testing.assert_array_equal(two[0], want_two[0])
    assert two[1] == want_two[1] and isinstance(two[1], int)
    np.testing.assert_array_equal(three[0], want_three[0])
    assert three[1] == want_three[1]
    s, w = three[2], want_three[2]
    assert s[0] == w[0] and s[2:] == w[2:]
    np.testing.assert_array_equal(s[1], w[1])
    np.random.set_state(s)               # a valid numpy state


# --- aliases and export lists -----------------------------------------

def test_aliases_and_reexports():
    from velocyto_tpu_torch import models, utils
    from velocyto_tpu_torch.counting import soa_engine
    from velocyto_tpu_torch.models import velocity
    from velocyto_tpu_torch.parallel import feeders
    assert models.velocity_step_jit is velocity.velocity_step
    assert feeders.feeder_byte_ranges is soa_engine.feeder_byte_ranges
    assert utils.rds.__name__ == "velocyto_tpu_torch.utils.rds"
    assert vtt.knn_search is tknn.knn_search
    assert vtt.col_delta_cor_partial_compact is \
        tcdc.col_delta_cor_partial_compact
    assert vtt.scatter_viz is vtt.analysis.scatter_viz
    assert vtt.ixs_thatsort_a2b is vtt.analysis.ixs_thatsort_a2b
    assert vtt.MIN_FLANK == vt.MIN_FLANK
    assert vtt.LOOM_NUMERIC_DTYPE == vt.LOOM_NUMERIC_DTYPE


@pytest.mark.parametrize("name", tops.__all__)
def test_ops_exports(name):
    """Each name of the JAX package's ops list is importable from the
    port's ops and is the object of its defining module."""
    import velocyto_tpu.ops as jops
    assert name in jops.__all__
    ours = getattr(tops, name)
    mod = __import__(ours.__module__, fromlist=["_"])
    assert getattr(mod, name) is ours
