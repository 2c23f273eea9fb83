"""The flat block-table kernel's schedule (runs of table rows, in the
locality rank of their centers), the ring with a center order and the
wrapper's refusals, on the CPU.

The runs (kernels.flat_runs) are held to a numpy
construction on _ring_plan's tables, uniform and kNN-structured indices
both, dummy tails included; the ring with order= to the ring without it
(bitwise: on the CPU both take the plain twin) and to the JAX package's
col_delta_cor_partial_ring at the JAX mesh tests' tolerances.  Every
refusal happens before any build.
"""
import numpy as np
import pytest
import torch

from velocyto_tpu.ops import coldeltacor as jcdc
from velocyto_tpu.parallel import make_mesh as jmake_mesh

from test_torch_mesh import _OnCard
from velocyto_tpu_torch import kernels
from velocyto_tpu_torch.ops import coldeltacor as tcdc
from velocyto_tpu_torch.parallel import make_mesh
from velocyto_tpu_torch.utils import profiling

CPU = torch.device("cpu")
_I32 = dict(dtype=torch.int32)


def _uniform(rng, n, nn):
    return np.stack([rng.choice(n, nn, replace=False) for _ in range(n)])


def _knn_line(n, nn):
    """Each cell's nn nearest cells on a line (itself left out): a center
    near one end has no neighbour in the far chunks, so its row of those
    tables is empty and their dummy tails are long."""
    pos = np.arange(n)
    dist = np.abs(pos[:, None] - pos[None, :]).astype(np.float64)
    dist[pos, pos] = np.inf
    return np.argsort(dist, axis=1, kind="stable")[:, :nn]


def _np_runs(qrow, rank, cap=kernels._RUN_ROWS):
    """run_start and run_order by a loop: maximal segments of one center
    cut every cap rows, then stably sorted by the rank of their center."""
    starts = []
    i = 0
    while i < len(qrow):
        j = i
        while j < len(qrow) and qrow[j] == qrow[i]:
            j += 1
        starts.extend(range(i, j, cap))
        i = j
    starts.append(len(qrow))
    heads = qrow[starts[:-1]]
    order = np.arange(len(heads)) if rank is None else \
        np.argsort(rank[heads], kind="stable")
    return np.array(starts), order


def _embedding(rng, n):
    return torch.from_numpy(rng.rand(n, 2))


@pytest.mark.parametrize("n,nn,shards,q,kind,cut", [
    (37, 11, 8, 4, "uniform", False), (64, 16, 4, 16, "uniform", False),
    (50, 13, 2, 3, "knn", False), (10, 3, 8, 3, "uniform", False),
    # the far tables' dummy tails, and one center's own rows, pass 128
    (400, 60, 4, 2, "knn", True), (300, 290, 1, 2, "uniform", True)])
def test_runs_match_numpy(rng, n, nn, shards, q, kind, cut):
    """kernels.flat_runs on every table of a ring plan against the numpy
    loop, in table order and in the locality rank of each shard's
    centers; every table row lies in exactly one run, each run holds one
    center and at most 128 rows (segments longer than that are cut), and
    run_order is a permutation that follows the rank."""
    cap = kernels._RUN_ROWS
    ixs = _uniform(rng, n, nn) if kind == "uniform" else _knn_line(n, nn)
    chunk = (n + shards - 1) // shards
    qloc, qrow, _inv, bmax = tcdc._ring_plan(ixs, shards, chunk, q=q)
    order = tcdc.locality_order(_embedding(rng, n))
    tails = longest = 0
    for p in range(shards):
        lo, hi = p * chunk, min(n, (p + 1) * chunk)
        rank = tcdc.shard_rank(order, lo, hi, chunk)
        for v in range(shards):
            t_qrow = torch.from_numpy(qrow[p, v])
            used = int(np.count_nonzero(np.diff(
                np.r_[0, qrow[p, v]]) != 0)) if hi > lo else 0
            tails += used < bmax
            for rk in (None, rank):
                start, run_order = kernels.flat_runs(t_qrow, rk)
                assert start.dtype == run_order.dtype == torch.int32
                want_start, want_order = _np_runs(
                    qrow[p, v], None if rk is None else rk.numpy())
                np.testing.assert_array_equal(start.numpy(), want_start)
                np.testing.assert_array_equal(run_order.numpy(), want_order)
                s = start.numpy().astype(np.int64)
                owner = np.repeat(np.arange(len(s) - 1), np.diff(s))
                assert len(owner) == bmax and s[0] == 0 and s[-1] == bmax
                assert np.all(np.diff(s) >= 1) and np.all(np.diff(s) <= cap)
                heads = qrow[p, v][s[:-1]]
                np.testing.assert_array_equal(qrow[p, v], heads[owner])
                segment = np.diff(np.flatnonzero(np.r_[
                    True, qrow[p, v][1:] != qrow[p, v][:-1], True]))
                longest = max(longest, int(segment.max()))
                ro = run_order.numpy()
                np.testing.assert_array_equal(np.sort(ro),
                                              np.arange(len(s) - 1))
                if rk is not None:
                    keys = rk.numpy()[heads[ro]]
                    assert np.all(np.diff(keys) >= 0)
                    tie = np.diff(keys) == 0
                    assert np.all(np.diff(ro)[tie] > 0)
    assert tails > 0 or shards == 1     # some table has a dummy tail
    assert (longest > cap) == cut


def test_shard_rank_inverts_chunk_order(rng):
    """shard_rank is the inverse of chunk_order on the shard's rows, its
    padding rows ranked after them."""
    order = tcdc.locality_order(_embedding(rng, 23))
    for lo, hi, rows in ((0, 6, 6), (18, 23, 6), (24, 23, 6)):
        rank = tcdc.shard_rank(order, lo, hi, rows)
        assert sorted(rank.tolist()) == list(range(rows))
        if hi > lo:
            mine = tcdc.chunk_order(order, lo, hi).to(torch.int64)
            np.testing.assert_array_equal(rank[mine].numpy(),
                                          np.arange(hi - lo))


@pytest.mark.parametrize("kind", ["uniform", "knn"])
@pytest.mark.parametrize("transform,psc", [("sqrt", 1e-10), ("log10", 1.0),
                                           ("linear", 0.0)])
def test_ring_order_changes_nothing(rng, kind, transform, psc):
    """The ring with a locality order equals the ring without it bitwise,
    and the JAX package's ring at the JAX mesh tests' tolerances, both
    fields; n not divisible by the 8 shards."""
    g, n, nn = 17, 45, 9
    e = (rng.rand(g, n) * 10).astype(np.float32)
    d = rng.randn(g, n).astype(np.float32)
    d2 = rng.randn(g, n).astype(np.float32)
    ixs = _uniform(rng, n, nn) if kind == "uniform" else _knn_line(n, nn)
    mesh = make_mesh(devices=[CPU] * 8)
    order = tcdc.locality_order(_embedding(rng, n))
    plain = tcdc.col_delta_cor_partial_ring_dev(mesh, e, d, ixs, transform,
                                                psc, dmat_random=d2)
    ordered = tcdc.col_delta_cor_partial_ring_dev(
        mesh, e, d, ixs, transform, psc, dmat_random=d2, order=order)
    for a, b in zip(plain, ordered):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for k, dm in enumerate((d, d2)):
        want = jcdc.col_delta_cor_partial_ring(jmake_mesh(), e, dm, ixs,
                                               transform, psc)
        np.testing.assert_allclose(ordered[k].numpy(), want, rtol=1e-4,
                                   atol=1e-5)


def test_ring_refuses_a_bad_order(rng):
    e = rng.rand(5, 12).astype(np.float32)
    mesh = make_mesh(devices=[CPU] * 4)
    with pytest.raises(ValueError, match="permutation"):
        tcdc.col_delta_cor_partial_ring_dev(
            mesh, e, e, _uniform(rng, 12, 3), "sqrt", 1e-10,
            order=torch.zeros(12, **_I32))


def test_ring_split_records_its_pieces(rng):
    """Under a profile, one ring call holds the five vtt.ring.* spans of
    its pieces, in order; without one, the call is the same, bitwise."""
    e = rng.rand(7, 30).astype(np.float32)
    ixs = _uniform(rng, 30, 5)
    mesh = make_mesh(devices=[CPU] * 2)
    with profiling.trace() as prof:
        got = tcdc.col_delta_cor_partial_ring_dev(mesh, e, e, ixs, "sqrt",
                                                  1e-10)
    ranges = profiling.span_ranges(prof)
    assert sorted(ranges) == ["ring.gather", "ring.launches", "ring.plan",
                              "ring.schedule", "ring.upload"]
    first = {name: min(s for s, _ in rs) for name, rs in ranges.items()}
    assert sorted(first, key=first.get) == [
        "ring.upload", "ring.plan", "ring.schedule", "ring.launches",
        "ring.gather"]
    assert all(e >= s for rs in ranges.values() for s, e in rs)
    plain = tcdc.col_delta_cor_partial_ring_dev(mesh, e, e, ixs, "sqrt",
                                                1e-10)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_ring_launches_take_the_schedule_unchecked(monkeypatch):
    """A ring step hands the flat wrapper the schedule kernels.flat_runs
    built and asks it not to check it (no synchronisation between the
    ring's launches)."""
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return "launched"
    monkeypatch.setattr(kernels, "coldeltacor_flat", spy)
    kw = _flat_kw()
    got = tcdc._flat_rows(kw["e_visit"], kw["e_ctr"], kw["d_ctr"],
                          kw["qloc"], kw["qrow"], 1, 1e-10, None,
                          kw["run_start"], kw["run_order"])
    assert got == "launched" and len(calls) == 1
    assert calls[0]["check"] is False
    assert calls[0]["run_start"] is kw["run_start"] and \
        calls[0]["run_order"] is kw["run_order"]


def _flat_kw(**bad):
    kw = dict(e_visit=_OnCard(torch.zeros(5, 8)),
              e_ctr=_OnCard(torch.zeros(4, 8)),
              d_ctr=_OnCard(torch.zeros(4, 8)),
              qloc=_OnCard(torch.zeros((6, 4), **_I32)),
              qrow=_OnCard(torch.tensor([0, 0, 1, 1, 1, 3], **_I32)),
              transform=1, psc=1e-10,
              run_start=_OnCard(torch.tensor([0, 2, 5, 6], **_I32)),
              run_order=_OnCard(torch.tensor([2, 0, 1], **_I32)))
    kw.update(bad)
    return kw


def _starts(*v):
    return _OnCard(torch.tensor(v, **_I32))


@pytest.mark.parametrize("bad,match", [
    (dict(run_start=_starts(1, 2, 5, 6)), "start at 0"),
    (dict(run_start=_starts(0, 2, 5, 5)), "start at 0"),
    (dict(run_start=_starts(0, 2, 5, 7)), "start at 0"),
    (dict(run_start=_starts(0, 5, 2, 6)), "increase"),
    (dict(run_start=_starts(0, 2, 2, 6)), "increase"),
    (dict(run_order=_starts(0, 0, 1)), "permutation"),
    (dict(run_order=_starts(0, 1, 3)), "permutation"),
    (dict(run_order=_starts(-1, 0, 1)), "permutation"),
    (dict(run_order=_starts(0, 1)), r"\(S \+ 1,\)"),
    (dict(run_start=_starts(0), run_order=_OnCard(torch.zeros(0, **_I32))),
     r"\(S \+ 1,\)"),
    (dict(run_start=_starts(0, 3, 6), run_order=_starts(0, 1)), "center"),
    (dict(run_start=_starts(0, 2, 6), run_order=_starts(1, 0)), "center"),
    (dict(run_start=None), "run_order needs"),
    (dict(run_start=_OnCard(torch.tensor([0, 2, 5, 6]))), "int32"),
    (dict(run_order=_OnCard(torch.tensor([2, 0, 1]).float())), "int32"),
    (dict(run_order=_OnCard(torch.zeros((3, 1), **_I32))), "1-D"),
    (dict(run_start=_OnCard(torch.tensor([0, 2, 5, 6], **_I32), index=1)),
     "one device"),
])
def test_flat_kernel_refuses_a_bad_schedule_before_building(bad, match):
    """The flat wrapper refuses a schedule that does not start at 0, end
    at F, increase, take each run once or keep one center a run, one of
    the wrong dtype, rank or device, and a run_order without its
    run_start, before any build."""
    with pytest.raises((ValueError, TypeError), match=match):
        kernels.coldeltacor_flat(**_flat_kw(**bad))
    assert kernels._lib is None and kernels.flat_launches == 0


@pytest.mark.parametrize("bad", [
    dict(run_order=_starts(0, 1)),
    dict(run_start=_starts(0), run_order=_OnCard(torch.zeros(0, **_I32))),
    dict(run_start=_starts(*range(8)), run_order=_starts(*range(7))),
])
def test_unchecked_schedule_keeps_its_shape_checks(bad):
    """check=False skips only the value check: a run_order that is not
    (S,), no run, or more runs than table rows is still refused before
    any build."""
    with pytest.raises(ValueError, match=r"\(S \+ 1,\)"):
        kernels.coldeltacor_flat(**_flat_kw(**bad), check=False)
    assert kernels._lib is None and kernels.flat_launches == 0


def test_built_schedules_pass_the_check(rng):
    """Every schedule kernels.flat_runs builds passes the wrapper's check, in
    table order and in a locality rank, long runs cut or not."""
    n, shards = 400, 4
    chunk = n // shards
    _qloc, qrow, _inv, bmax = tcdc._ring_plan(_knn_line(n, 60), shards,
                                              chunk, q=2)
    order = tcdc.locality_order(_embedding(rng, n))
    for p in range(shards):
        rank = tcdc.shard_rank(order, p * chunk, (p + 1) * chunk, chunk)
        for v in range(shards):
            t = torch.from_numpy(qrow[p, v])
            for rk in (None, rank):
                kernels._check_schedule(*kernels.flat_runs(t, rk), t, bmax)
