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
The kernels themselves (the walk, which writes acceptance bits, and the
decode) run only on a card (chip_smoke.py holds them bitwise to the
plain scan and the host loop there); here the decode's plain twin is
held to the plain scan through bits built from its acceptances, and the
wrappers' checks and the plan rule are tested, before any build."""
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


@pytest.mark.parametrize("n, sight, k, maxl, grouped, plan", [
    # the operating point, k=500 (T = 768): l and the ring of 8 stages
    # (770 indices, 6,160 B, and 136 B of results each) in shared memory at
    # 20k and 50k
    (20000, 3001, 500, 1500, False, ("shared", 8, 768, None)),
    (50000, 3001, 500, 1500, False, ("shared", 8, 768, None)),
    # the ring shortens as l grows: 2n + 6,296 R <= 229,376 B
    (89504, 3001, 500, 1500, False, ("shared", 8, 768, None)),
    (89505, 3001, 500, 1500, False, ("shared", 6, 768, None)),
    (108392, 3001, 500, 1500, False, ("shared", 2, 768, None)),
    (108393, 3001, 500, 1500, False, ("global", 8, 768, None)),
    # l stops at min(maxl, n - 1): uint16 holds it up to 65,535
    (70000, 3001, 500, 65535, False, ("shared", 8, 768, None)),
    (70000, 3001, 500, 65536, False, ("global", 8, 768, None)),
    (65536, 3001, 500, 10 ** 9, False, ("shared", 8, 768, None)),
    (65537, 3001, 500, 10 ** 9, False, ("global", 8, 768, None)),
    (100000, 3001, 500, -3, False, ("shared", 4, 768, None)),
    (200000, 3001, 500, 0, False, ("global", 8, 768, None)),
    # groups: uint16 labels beside l while 4n + 8 x 6,296 fit
    (20000, 3001, 500, 1500, True, ("shared", 8, 768, "shared")),
    (44752, 3001, 500, 1500, True, ("shared", 8, 768, "shared")),
    (44753, 3001, 500, 1500, True, ("shared", 8, 768, "staged")),
    (50000, 3001, 500, 1500, True, ("shared", 8, 768, "staged")),
    (200000, 3001, 500, 1500, True, ("global", 8, 768, "staged")),
    # T: the JAX package's depth, at most the row and 1,024
    (20000, 3001, 400, 1500, False, ("shared", 8, 640, None)),
    (200, 31, 12, 20, False, ("shared", 8, 31, None)),
    (1, 1, 0, 1500, False, ("shared", 8, 1, None)),
    (20000, 3001, 1000, 1500, False, ("shared", 8, 1024, None))])
def test_route_rule(n, sight, k, maxl, grouped, plan):
    """l stays in shared memory as uint16 while every in-degree (at most
    min(maxl, n - 1)) fits 16 bits and 2 B a cell fit the block's shared
    memory beside the shortest ring; above, in global memory.  The ring
    takes the longest even R up to 8 that fits; labels sit beside l while
    they fit with the longest ring, else they are staged through it."""
    assert tuple(kernels.balance_plan(n, sight, k, maxl, grouped)) == plan


@pytest.mark.parametrize("k, sight", [(500, 3001), (400, 3001), (12, 31),
                                      (100, 150), (20, 600), (600, 3001)])
def test_plan_depth_is_the_jax_depth(k, sight):
    """T is the JAX package's truncation depth (its _balance_plan), up to
    the kernel's 1,024."""
    assert kernels.balance_depth(sight, k) == \
        min(jkd._balance_plan(1000, sight, k)[1], 1024)


def test_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="route"):
        kernels.balance_plan(108393, 3001, 500, 1500, False, route="shared")
    with pytest.raises(ValueError, match="stages"):
        kernels.balance_plan(108392, 3001, 500, 1500, False, stages=4)
    for stages in (1, 3, 10):
        with pytest.raises(ValueError, match="stages"):
            kernels.balance_plan(20000, 3001, 500, 1500, False,
                                 stages=stages)
    assert kernels.balance_plan(20000, 3001, 500, 1500, False,
                                route="global", stages=2) == \
        ("global", 2, 768, None)
    # labels: forced either way where they fit, never without groups
    assert kernels.balance_plan(20000, 3001, 500, 1500, True,
                                labels="staged") == \
        ("shared", 8, 768, "staged")
    with pytest.raises(ValueError, match="labels"):
        kernels.balance_plan(20000, 3001, 500, 1500, False, labels="staged")
    with pytest.raises(ValueError, match="labels"):
        kernels.balance_plan(70000, 3001, 500, 1500, True, route="global",
                             labels="shared")
    with pytest.raises(ValueError, match="labels"):
        kernels.balance_plan(60000, 3001, 500, 1500, True, labels="shared")


@pytest.mark.parametrize("name, value", [
    ("kThreads", kernels._BALANCE_THREADS),
    ("kMaxDepth", kernels._BALANCE_MAX_DEPTH),
    ("kMaxStages", kernels._BALANCE_MAX_STAGES),
    ("kMaxSmem", kernels._BALANCE_SMEM),
    ("kOutWords", kernels._BALANCE_OUT_WORDS),
    ("kMaxL16", kernels._BALANCE_MAX_L16),
    ("kProbeMinCells", kernels._BALANCE_PROBE_MIN)])
def test_route_rule_constants_match_kernel(name, value):
    """The route rule's sizes are the kernel's, read from its source."""
    assert _constants("knn_balance.cu")[name] == value


@pytest.mark.parametrize("kind", ["negative", "past_n", "wide"])
def test_raw_labels_balance_as_their_dense_ranks(kind):
    """Group labels of any int32 value (negative, n or more) balance as
    the dense ranks the walk is handed (kernels._dense_labels) do: in the
    plain scan, the host loop and the JAX package's device scan."""
    case = CASES["constrained"]
    dist, dsi, cst = _case(**case)
    n, maxl, k = case["n"], case["maxl"], case["k"]
    raw = {"negative": cst * 7919 - 40000, "past_n": cst + n,
           "wide": np.array([-2 ** 31, 0, 2 ** 31 - 1])[cst]}[kind]
    raw = raw.astype(np.int32)
    dense = kernels._dense_labels(torch.as_tensor(raw))
    assert dense.dtype == torch.int32 and dense.shape == (n,)
    assert int(dense.min()) == 0 and int(dense.max()) == len(np.unique(raw)) - 1
    np.testing.assert_array_equal(
        (dense[:, None] == dense[None, :]).numpy(),
        raw[:, None] == raw[None, :])
    dsi_t, dist_t = torch.as_tensor(dsi), torch.as_tensor(dist)
    lsi = tkd._hub_order_impl(dsi_t)
    got = tkd._balance_scan_plain(dsi_t, dist_t, lsi, torch.as_tensor(raw),
                                  maxl, k)
    want = tkd._balance_scan_plain(dsi_t, dist_t, lsi, dense, maxl, k)
    _assert_same(got, [t.numpy() for t in want], kind)
    _assert_same(got, tknn.balance_knn_loop(dsi, dist, lsi.numpy(), maxl, k,
                                            True, raw), kind)
    _assert_same(got, jkd.balance_knn_dev(
        jnp.asarray(dsi, jnp.int32), jnp.asarray(dist, jnp.float64),
        maxl=maxl, k=k, constraint=raw), kind)


# ---------------------------------------------------------------------------
# the decode's plain twin, from the plain scan's acceptances
# ---------------------------------------------------------------------------

# the regimes the walk's bits must carry (tests at CPU size): 12 groups,
# maxl == k, a small cap that self-fills (maxl = 50 below k), rows examined
# past the staged depth T, indices outside [0, n)
DECODE_CASES = {
    "constrained_12": dict(n=600, sight=80, k=20, maxl=30, d=5, groups=12),
    "maxl_eq_k": dict(n=500, sight=60, k=15, maxl=15, d=4, dup=True),
    "self_fill_50": dict(n=400, sight=150, k=100, maxl=50, d=5),
    "past_T": dict(n=700, sight=600, k=20, maxl=3, d=4),
    "out_of_range": dict(n=300, sight=40, k=10, maxl=15, d=4, bad=True),
}


def _bits_of(dsi, dsi_new, k, garbage=None):
    """The walk's (bits, meta) for the balanced rows dsi_new of the
    candidates dsi: the positions of the accepted candidates as bits, the
    accepted count and whether slot 0 holds the node.  With garbage (a
    RandomState), the words past each row's last accepted one are random
    where the row took k (the walk never writes them)."""
    n, sight = dsi.shape
    words = -(-sight // 32)
    bits = np.zeros((n, words), dtype=np.uint32)
    meta = np.zeros((n, 2), dtype=np.int32)
    for el in range(n):
        acc = [v for v in dsi_new[el, 1:] if v != el]
        pos = [int(np.flatnonzero(dsi[el] == v)[0]) for v in acc]
        assert pos == sorted(pos)               # acceptance order is row order
        for j in pos:
            bits[el, j // 32] |= np.uint32(1 << (j % 32))
        meta[el] = len(acc), int(dsi_new[el, 0] == el)
        if garbage is not None and len(acc) == k:
            first = pos[-1] // 32 + 1 if pos else 0
            bits[el, first:] = garbage.randint(0, 2 ** 32, words - first,
                                               dtype=np.uint64)
    return torch.as_tensor(bits.view(np.int32)), torch.as_tensor(meta)


def _decode_case(n, sight, k, maxl, d, dup=False, groups=None, bad=False):
    dist, dsi, cst = _case(n, sight, k, maxl, d, dup=dup, groups=groups)
    if bad:           # indices outside [0, n), never accepted
        rng = np.random.RandomState(5)
        for v in (-1, n, n + 7, 2 ** 40):
            rows = rng.randint(0, n, n // 4)
            dsi[rows, rng.randint(1, sight, n // 4)] = v
    dsi_t, dist_t = torch.as_tensor(dsi), torch.as_tensor(dist)
    c = None if cst is None else torch.as_tensor(cst, dtype=torch.int32)
    lsi = tkd._hub_order_impl(dsi_t.clamp(0, n - 1))
    want = tkd._balance_scan_plain(dsi_t, dist_t, lsi, c, maxl, k)
    return dsi_t, dist_t, lsi, c, want


@pytest.mark.parametrize("garbage", [False, True], ids=["clean", "garbage"])
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_plain_reproduces_the_scan(name, garbage):
    """The decode's plain twin, fed the bits of the plain scan's
    acceptances, gives the plain scan's dist_new and dsi_new bitwise;
    words the walk never writes do not matter."""
    case = DECODE_CASES[name]
    dsi, dist, lsi, c, want = _decode_case(**case)
    k = case["k"]
    bits, meta = _bits_of(dsi.numpy(), want[1].numpy(), k,
                          np.random.RandomState(1) if garbage else None)
    got = tkd._balance_decode_plain(bits, meta, dsi, dist, k, block=128)
    _assert_same(got, [t.numpy() for t in want[:2]], name)
    # the case shows its regime
    took = meta[:, 0]
    if name == "self_fill_50" or name == "past_T":
        assert int((took < k).sum()) > 0
    if name == "past_T":             # accepted positions at or past T
        depth = kernels.balance_depth(case["sight"], k)
        clean = _bits_of(dsi.numpy(), want[1].numpy(), k)[0]
        assert depth % 32 == 0 and bool((clean[:, depth // 32:] != 0).any())
    if name == "out_of_range":
        assert bool((dsi < 0).any()) and bool((dsi >= case["n"]).any())
        assert not bool(((want[1] >= case["n"]) |
                         (want[1] < -1)).any())


def test_decode_plain_unvisited_rows_and_k0():
    """A row the walk never visited (meta p = -1) decodes as -1 with
    distance 0; k = 0 leaves slot 0 alone."""
    dsi, dist, lsi, c, want = _decode_case(**DECODE_CASES["maxl_eq_k"])
    bits, meta = _bits_of(dsi.numpy(), want[1].numpy(), 15)
    meta[7] = torch.tensor([-1, 0])
    got = tkd._balance_decode_plain(bits, meta, dsi, dist, 15)
    assert bool((got[1][7] == -1).all()) and bool((got[0][7] == 0).all())
    keep = torch.arange(dsi.shape[0]) != 7
    assert torch.equal(got[1][keep], want[1][keep])
    z = tkd._balance_scan_plain(dsi, dist, lsi, None, 15, 0)
    bits, meta = _bits_of(dsi.numpy(), z[1].numpy(), 0)
    _assert_same(tkd._balance_decode_plain(bits, meta, dsi, dist, 0),
                 [t.numpy() for t in z[:2]])


@pytest.mark.parametrize("kw", [
    dict(bits_dtype=torch.int64), dict(bits_words=3),
    dict(meta_shape=(40, 3)), dict(meta_dtype=torch.int64),
    dict(dist_dtype=torch.float32), dict(k=9), dict(k=-1)],
    ids=["bits_int64", "bits_words", "meta_shape", "meta_int64",
         "dist_f32", "sight_below_k", "negative_k"])
def test_decode_refuses_before_building(kw):
    n, sight = 40, 8
    bits = torch.zeros((n, kw.get("bits_words", 1)),
                       dtype=kw.get("bits_dtype", torch.int32))
    meta = torch.zeros(kw.get("meta_shape", (n, 2)),
                       dtype=kw.get("meta_dtype", torch.int32))
    dsi = torch.zeros((n, sight), dtype=torch.int64)
    dist = torch.zeros((n, sight), dtype=kw.get("dist_dtype", torch.float64))
    with pytest.raises((ValueError, TypeError)):
        kernels.balance_decode(*map(_OnCard, (bits, meta, dsi, dist)),
                               kw.get("k", 5))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.balance_decode(torch.zeros((n, 1), dtype=torch.int32),
                               torch.zeros((n, 2), dtype=torch.int32), dsi,
                               dist.double(), 5)
    assert kernels._lib is None and kernels.balance_decode_launches == 0


@pytest.mark.parametrize("kw", [dict(labels="warp"), dict(stages=0),
                                dict(stages=3), dict(stages=10),
                                dict(route="warp")])
def test_walk_refuses_before_building(kw):
    dsi, _dist, lsi, cst, k = (_OnCard(t) if isinstance(t, torch.Tensor)
                               else t for t in _inputs())
    with pytest.raises(ValueError):
        kernels.balance_walk(dsi, lsi, cst, 3, k, **kw)
    with pytest.raises(ValueError):
        kernels.knn_balance(dsi, _dist, lsi, cst, 3, k, **kw)
    assert kernels._lib is None and kernels.balance_launches == 0
