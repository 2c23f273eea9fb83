"""The port's greedy kNN balance (velocyto_tpu_torch.ops.knn_device: the
plain per-node scan that CPU tensors take, the dispatch to the hand
kernel kernels/knn_balance.cu for CUDA tensors, and the balanced graph
built from them) against the JAX package's device balance scan and
balanced graph, and against the port's host loop.

Inputs: numpy-seeded points (duplicated rows forced in where a case says
so), their exact kNN candidates from the JAX package's host search
(velocyto_tpu.ops.knn.knn_search), the same arrays handed to both
packages.  Every decision is integer logic and every distance a copy, so
dsi_new, dist_new and the in-degrees l are compared bitwise (tolerance 0);
the balanced graph built from each package's own search has its indices
and in-degrees equal and its distances within rtol 1e-12 (the two f64
re-scores sum in another order).
The kernel itself runs only on a card (chip_smoke.py holds it bitwise to
the plain scan and the host loop there); here its wrapper's checks and
route rule are tested, before any build."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velocyto_tpu as vt  # noqa: F401  (sets the JAX package's x64 config)
from velocyto_tpu.ops import knn_device as jkd
from velocyto_tpu.ops.knn import knn_search

from velocyto_tpu_torch import kernels
from velocyto_tpu_torch.ops import knn as tknn
from velocyto_tpu_torch.ops import knn_device as tkd

from test_torch_svr import _constants, _OnCard

# the cases of tests/test_knn_device.py:55-124 (dup: duplicated points,
# so a node can sit beyond position 0 of its own row; groups: constrained)
CASES = {
    "plain": dict(n=200, sight=31, k=12, maxl=20, d=10),
    "self_fill": dict(n=120, sight=15, k=10, maxl=2, d=6),
    "constrained": dict(n=150, sight=23, k=8, maxl=12, d=5, groups=3),
    "maxl_eq_k": dict(n=300, sight=41, k=10, maxl=10, d=4, dup=True),
    "maxl_eq_k_plus_1": dict(n=300, sight=41, k=10, maxl=11, d=4, dup=True),
    "n_below_32": dict(n=17, sight=9, k=4, maxl=5, d=4, dup=True),
    "n_not_multiple_of_32": dict(n=257, sight=33, k=16, maxl=40, d=4,
                                 dup=True),
}


def _case(n, sight, k, maxl, d, dup=False, groups=None, seed=42):
    """(dist (n, sight) f64, dsi (n, sight) int64, groups or None) from
    seeded points."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    if dup:
        x[:: max(2, n // 8)] = x[0]
    cst = rng.randint(0, groups, n) if groups else None
    dist, dsi = knn_search(x, min(sight, n))
    return dist, dsi.astype(np.int64), cst


def _assert_same(got, want, msg=""):
    for name, g, w in zip(("dist_new", "dsi_new", "l"), got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w),
                                      err_msg=f"{name} {msg}")


@pytest.mark.parametrize("name", list(CASES))
def test_plain_scan_matches_jax_device_scan(name):
    case = CASES[name]
    dist, dsi, cst = _case(**case)
    want = jkd.balance_knn_dev(jnp.asarray(dsi, jnp.int32),
                               jnp.asarray(dist, jnp.float64),
                               maxl=case["maxl"], k=case["k"], constraint=cst)
    got = tkd.balance_knn_dev(torch.as_tensor(dsi), torch.as_tensor(dist),
                              maxl=case["maxl"], k=case["k"], constraint=cst)
    assert got[0].dtype == torch.float64 and got[1].dtype == torch.int64
    assert got[1].shape == (case["n"], case["k"] + 1)
    _assert_same(got, want, name)


@pytest.mark.parametrize("k, maxl", [(0, 5), (6, 0), (0, 0)],
                         ids=["k0", "maxl0", "both0"])
def test_plain_scan_edges_match_host_loop(k, maxl):
    """k == 0 examines nothing (slot 0 stays -1); maxl == 0 accepts
    nothing, so every row self-fills."""
    dist, dsi, _ = _case(n=90, sight=12, k=k, maxl=maxl, d=3, dup=True)
    lsi = tkd._hub_order_impl(torch.as_tensor(dsi))
    got = tkd._balance_scan_plain(torch.as_tensor(dsi),
                                  torch.as_tensor(dist), lsi, None, maxl, k)
    want = tknn.balance_knn_loop(dsi, dist, lsi.numpy(), maxl, k, True)
    _assert_same(got, want)
    if k == 0:
        assert (got[1] == -1).all() and (got[0] == 0).all()
    if maxl == 0 and k:
        assert (got[2] == 0).all()
        assert (got[1][:, 1:] == torch.arange(90)[:, None]).all()


def test_plain_scan_takes_string_groups():
    """Group labels of any dtype: only their equality matters."""
    dist, dsi, cst = _case(**CASES["constrained"])
    names = np.array(["a", "b", "c"], dtype=object)[cst]
    kw = dict(maxl=12, k=8)
    got = tkd.balance_knn_dev(torch.as_tensor(dsi), torch.as_tensor(dist),
                              constraint=names, **kw)
    want = tkd.balance_knn_dev(torch.as_tensor(dsi), torch.as_tensor(dist),
                               constraint=torch.as_tensor(cst), **kw)
    _assert_same(got, [t.numpy() for t in want])


@pytest.mark.parametrize("groups", [None, 4], ids=["free", "constrained"])
def test_balanced_graph_matches_jax(groups):
    rng = np.random.RandomState(7)
    x = rng.randn(240, 6)
    x[::30] = x[1]
    cst = rng.randint(0, groups, 240) if groups else None
    kw = dict(k=9, sight_k=30, maxl=14, constraint=cst)
    g = tkd.balanced_knn_graph_dev(x, device="cpu", **kw)
    jg = jkd.balanced_knn_graph_dev(x, **kw)
    np.testing.assert_array_equal(g.idx.numpy(), np.asarray(jg.idx))
    # the distances are the two searches' f64 re-scores, summed in
    # another order (test_torch_pipeline.py's kNN tolerance); the balance
    # copies them
    np.testing.assert_allclose(g.dist.numpy(), np.asarray(jg.dist),
                               rtol=1e-12, atol=0)
    np.testing.assert_array_equal(g.indeg.numpy(), np.asarray(jg.indeg))
    assert g.idx.dtype == torch.int64 and g.dist.dtype == torch.float64
    # the in-degree is that of the balanced rows, never above the cap
    assert int(g.indeg.max()) <= 14
    rows = g.idx[:, 1:]
    own = rows == torch.arange(240)[:, None]
    counts = torch.bincount(rows[~own & (rows >= 0)], minlength=240)
    assert torch.equal(counts, g.indeg)
    assert tkd.knn_graph_dev(x, k=5, device="cpu").indeg is None


def test_balanced_graph_stays_on_the_device(monkeypatch):
    """No host loop and no copy to numpy or to the host inside the
    chain."""
    def refuse(*args, **kwargs):
        raise AssertionError("the balanced kNN chain left the device")
    monkeypatch.setattr(tknn, "balance_knn_loop", refuse)
    monkeypatch.setattr(torch.Tensor, "numpy", refuse)
    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    x = torch.as_tensor(np.random.RandomState(3).randn(150, 5))
    g = tkd.balanced_knn_graph_dev(x, k=6, sight_k=20, maxl=9, device="cpu")
    assert g.idx.shape == (150, 7) and g.indeg.shape == (150,)


def test_cuda_tensors_go_to_the_kernel_and_raise_without_fallback(
        monkeypatch):
    calls = []

    def failing_kernel(*args):
        calls.append(args)
        raise RuntimeError("knn_balance launch failed: cudaError 1")
    monkeypatch.setattr(kernels, "knn_balance", failing_kernel)
    monkeypatch.setattr(tkd, "_balance_scan_plain", lambda *a: pytest.fail(
        "fell back to the plain scan"))
    dist, dsi, _ = _case(**CASES["plain"])
    on_card = [_OnCard(torch.as_tensor(a)) for a in (dsi, dist)]
    lsi = _OnCard(torch.zeros(200, dtype=torch.int64))
    with pytest.raises(RuntimeError, match="launch failed"):
        tkd._balance_scan_impl(*on_card, lsi, None, 20, 12)
    assert len(calls) == 1 and calls[0][4:] == (20, 12)


_I64, _F64 = torch.int64, torch.float64


def _inputs(n=40, sight=8, k=5, dsi_dtype=_I64, dist_dtype=_F64,
            lsi_dtype=_I64, lsi_n=None, cst_dtype=None, transpose=False):
    dsi = torch.zeros((n, sight), dtype=dsi_dtype)
    dist = torch.zeros((n, sight), dtype=dist_dtype)
    if transpose:
        dsi = torch.zeros((sight, n), dtype=dsi_dtype).T
    lsi = torch.zeros(lsi_n or n, dtype=lsi_dtype)
    cst = None if cst_dtype is None else torch.zeros(n, dtype=cst_dtype)
    return dsi, dist, lsi, cst, k


@pytest.mark.parametrize("kw", [
    dict(dsi_dtype=torch.int32), dict(dist_dtype=torch.float32),
    dict(lsi_dtype=torch.int32), dict(cst_dtype=torch.int64),
    dict(lsi_n=39), dict(transpose=True), dict(sight=4, k=5),
    dict(n=0), dict(k=-1)],
    ids=["dsi_int32", "dist_f32", "lsi_int32", "constraint_int64",
         "lsi_length", "layout", "sight_below_k", "empty", "negative_k"])
def test_kernel_refuses_before_building(kw):
    """knn_balance refuses wrong dtypes, shapes, layouts and sight < k,
    and CPU tensors, before any build."""
    dsi, dist, lsi, cst, k = _inputs(**kw)
    wrap = [None if t is None else _OnCard(t) for t in (dsi, dist, lsi, cst)]
    with pytest.raises((ValueError, TypeError)):
        kernels.knn_balance(*wrap, 3, k)
    dsi, dist, lsi, cst, k = _inputs()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.knn_balance(dsi, dist, lsi, cst, 3, k)
    assert kernels._lib is None and kernels.balance_launches == 0


def test_kernel_refuses_a_route_that_cannot_hold_l():
    dsi, dist, lsi, cst, k = (_OnCard(t) if isinstance(t, torch.Tensor)
                              else t for t in _inputs())
    for route in ("warp", "block"):
        with pytest.raises(ValueError, match="route"):
            kernels.knn_balance(dsi, dist, lsi, cst, 3, k, route=route)
    big = [_OnCard(t) if isinstance(t, torch.Tensor) else t
           for t in _inputs(n=120000, sight=1, k=1)]
    with pytest.raises(ValueError, match="route"):
        kernels.knn_balance(*big[:4], 3, 1, route="shared")
    assert kernels._lib is None and kernels.balance_launches == 0


@pytest.mark.parametrize("n, reps, route, rows", [
    (1023, 10, "shared", None), (2048, 0, "shared", None),
    (2048, 10, "warp", None), (200000, 10, "shared", None),
    (2048, 10, "shared", torch.zeros((2047, 8), dtype=torch.int64)),
    (2048, 10, "shared", torch.zeros((2048, 8), dtype=torch.int32))])
def test_probe_refuses_before_building(n, reps, route, rows):
    rows = None if rows is None else _OnCard(rows)
    with pytest.raises((ValueError, TypeError)):
        kernels.balance_probe(n, reps, route, device="cuda", rows=rows)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.balance_probe(2048, 10, "shared", device="cpu")
    assert kernels._lib is None


@pytest.mark.parametrize("n, maxl, route", [
    (1, 1500, "shared"), (20000, 1500, "shared"), (50000, 1500, "shared"),
    (114688, 1500, "shared"),           # 229,376 B of uint16: all of it
    (114689, 1500, "global"),           # 16 B more
    (70000, 65535, "shared"),           # l stops at 65,535: fits uint16
    (70000, 65536, "global"),
    (65536, 10 ** 9, "shared"),         # l never passes n - 1 = 65,535
    (65537, 10 ** 9, "global"),
    (100000, -3, "shared"),             # nothing is ever accepted
    (200000, 0, "global")])
def test_route_rule(n, maxl, route):
    """l stays in shared memory as uint16 while every in-degree (at most
    min(maxl, n - 1)) fits 16 bits and 2 B a cell fit the block's shared
    memory; above, in global memory."""
    assert kernels.balance_route(n, maxl) == route


@pytest.mark.parametrize("name, value", [
    ("kThreads", kernels._BALANCE_THREADS),
    ("kMaxSmem", kernels._BALANCE_SMEM),
    ("kMaxL16", kernels._BALANCE_MAX_L16)])
def test_route_rule_constants_match_kernel(name, value):
    """The route rule's sizes are the kernel's, read from its source."""
    assert _constants("knn_balance.cu")[name] == value
