"""The port's mesh surface against the JAX package's, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices; the port's on
a mesh of 8 CPU shards (make_mesh(devices=[cpu] * 8)), where every
kernel takes its plain twin.  Each port result is held to the JAX
package's mesh function and to the port's own mesh-free result, at the
JAX mesh tests' tolerances (tests/test_coldeltacor.py, test_knn.py,
test_velocity_model.py, test_checkpoint.py).  The wrappers' checks of the
new kernel arguments run before any build.
"""
import numpy as np
import pytest
import torch

from velocyto_tpu.ops import coldeltacor as jcdc
from velocyto_tpu.parallel import make_mesh as jmake_mesh

from velocyto_tpu_torch import kernels
from velocyto_tpu_torch.ops import coldeltacor as tcdc
from velocyto_tpu_torch.parallel import (CELLS, cells_sharding, make_mesh,
                                         replicated)

CPU = torch.device("cpu")


@pytest.fixture
def mesh():
    return make_mesh(devices=[CPU] * 8)


def _case(rng, g, n, nn, scale=1.0):
    e = (rng.rand(g, n) * scale).astype(np.float32)
    d = rng.randn(g, n).astype(np.float32)
    ixs = np.stack([rng.choice(n, nn, replace=False) for _ in range(n)])
    return e, d, ixs


def test_mesh_layout_and_value_error():
    """make_mesh's shape and its ValueError on a grid that does not cover
    the devices (velocyto_tpu/parallel/mesh.py:39-41); a device may
    repeat."""
    m = make_mesh(n_cell_shards=4, n_gene_shards=2, devices=[CPU] * 8)
    assert m.shape == {CELLS: 4, "genes": 2} and m.size == 8
    assert m.devices.shape == (4, 2) and m.first_device == CPU
    assert [s.index for s in m.cell_shards()] == [0, 1, 2, 3]
    assert [s.stream for s in m.flat_shards()] == [None] * 8
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(n_cell_shards=3, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        jmake_mesh(n_cell_shards=3)


def test_partial_sharded_matches_single(rng, mesh):
    g, n, nn = 17, 24, 5
    e, d, ixs = _case(rng, g, n, nn)
    jax_out = jcdc.col_delta_cor_partial_sharded(jmake_mesh(), e, d, ixs,
                                                 "sqrt", 1e-10)
    single = tcdc.col_delta_cor_partial_compact(
        torch.from_numpy(e), torch.from_numpy(d), torch.from_numpy(ixs),
        "sqrt", 1e-10).numpy()
    sharded = tcdc.col_delta_cor_partial_sharded(mesh, e, d, ixs, "sqrt",
                                                 1e-10)
    np.testing.assert_allclose(sharded, jax_out, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sharded, single, rtol=1e-4, atol=1e-5)


def test_partial_sharded_dual_and_order(rng, mesh):
    """The dual form gives each field's single call, and a center order
    (split per shard by chunk_order) changes nothing."""
    e, d, ixs = _case(rng, 13, 40, 6)
    E, D = torch.from_numpy(e), torch.from_numpy(d)
    order = torch.randperm(40, generator=torch.Generator().manual_seed(0))
    main, rndm = tcdc.col_delta_cor_partial_sharded_dev(
        mesh, E, D, ixs, "sqrt", 1e-10, dmat_random=-D,
        order=order.to(torch.int32))
    one = tcdc.col_delta_cor_partial_sharded_dev(mesh, E, D, ixs, "sqrt",
                                                 1e-10)
    two = tcdc.col_delta_cor_partial_sharded_dev(mesh, E, -D, ixs, "sqrt",
                                                 1e-10)
    np.testing.assert_array_equal(main.numpy(), one.numpy())
    np.testing.assert_array_equal(rndm.numpy(), two.numpy())
    with pytest.raises(ValueError, match="permutation"):
        tcdc.col_delta_cor_partial_sharded_dev(
            mesh, E, D, ixs, "sqrt", 1e-10,
            order=torch.zeros(40, dtype=torch.int32))


@pytest.mark.parametrize("transform,psc", [("sqrt", 1e-10), ("sqrt", 0.0),
                                           ("log10", 1.0), ("linear", 0.0)])
def test_partial_ring_matches_single(rng, mesh, transform, psc):
    """The ring (expression split over the mesh, chunks handed round)
    equals the single-device compact kernel; n not divisible by 8."""
    g, n, nn = 19, 53, 9
    e, d, ixs = _case(rng, g, n, nn, scale=10.0)
    jax_ring = jcdc.col_delta_cor_partial_ring(jmake_mesh(), e, d, ixs,
                                               transform, psc)
    single = tcdc.col_delta_cor_partial_compact(
        torch.from_numpy(e), torch.from_numpy(d), torch.from_numpy(ixs),
        transform, psc).numpy()
    ring = tcdc.col_delta_cor_partial_ring(mesh, e, d, ixs, transform, psc)
    np.testing.assert_allclose(ring, jax_ring, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ring, single, rtol=1e-4, atol=1e-5)


def test_ring_dual_equals_two_calls(rng, mesh):
    e, d, ixs = _case(rng, 11, 30, 7)
    main, rndm = tcdc.col_delta_cor_partial_ring_dev(mesh, e, d, ixs, "sqrt",
                                                     1e-10, dmat_random=2 * d)
    ring = tcdc.col_delta_cor_partial_ring
    np.testing.assert_array_equal(main.numpy(),
                                  ring(mesh, e, d, ixs, "sqrt", 1e-10))
    np.testing.assert_array_equal(rndm.numpy(),
                                  ring(mesh, e, 2 * d, ixs, "sqrt", 1e-10))


@pytest.mark.parametrize("n,nn,shards,q", [(37, 11, 8, 4), (64, 16, 4, 16),
                                           (50, 13, 8, 16), (10, 3, 8, 3)])
def test_ring_plan_equals_jax(rng, n, nn, shards, q):
    """The port's copy of _ring_plan gives the JAX package's tables, array
    for array, and they rebuild every row's neighbours."""
    chunk = (n + shards - 1) // shards
    ixs = np.stack([rng.choice(n, nn, replace=False) for _ in range(n)])
    got = tcdc._ring_plan(ixs, shards, chunk, q=q)
    want = jcdc._ring_plan(ixs, shards, chunk, q=q)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    qloc, qrow, inv_pos, bmax = got
    for r in range(n):
        p = r // chunk
        pos = inv_pos[r].astype(np.int64)
        v = pos // (bmax * q)
        b = (pos % (bmax * q)) // q
        np.testing.assert_array_equal(qloc[p, v, b, pos % q] + v * chunk,
                                      ixs[r])
        np.testing.assert_array_equal(qrow[p, v, b], r - p * chunk)


def test_sharded_routes_to_ring_over_threshold(rng, mesh, monkeypatch):
    """Above _REPLICATION_BYTES of expression the sharded call takes the
    ring, with the same result, and hands it its center order."""
    e, d, ixs = _case(rng, 13, 40, 6)
    base = tcdc.col_delta_cor_partial_sharded(mesh, e, d, ixs, "sqrt", 1e-10)
    calls = []
    ring = tcdc.col_delta_cor_partial_ring_dev

    def spy(*args, **kw):
        calls.append((args[0], kw.get("order")))
        return ring(*args, **kw)
    monkeypatch.setattr(tcdc, "col_delta_cor_partial_ring_dev", spy)
    monkeypatch.setattr(tcdc, "_REPLICATION_BYTES", 1)
    routed = tcdc.col_delta_cor_partial_sharded(mesh, e, d, ixs, "sqrt",
                                                1e-10)
    assert calls == [(mesh, None)]
    np.testing.assert_allclose(routed, base, rtol=1e-4, atol=1e-5)
    order = torch.randperm(40, generator=torch.Generator().manual_seed(1)
                           ).to(torch.int32)
    ordered = tcdc.col_delta_cor_partial_sharded_dev(
        mesh, torch.from_numpy(e), torch.from_numpy(d), ixs, "sqrt", 1e-10,
        order=order)
    assert len(calls) == 2 and calls[1][0] is mesh and \
        torch.equal(calls[1][1], order)
    np.testing.assert_array_equal(ordered.numpy(), routed)
    monkeypatch.setattr(jcdc, "_REPLICATION_BYTES", 1)
    np.testing.assert_allclose(routed, jcdc.col_delta_cor_partial_sharded(
        jmake_mesh(), e, d, ixs, "sqrt", 1e-10), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("transform,psc", [("sqrt", 1e-10), ("log10", 1.0),
                                           ("linear", 0.0)])
def test_dense_sharded_matches_jax_and_single(rng, mesh, transform, psc):
    """col_delta_cor(..., mesh=): each shard takes its center range of the
    dense plain twin; against the JAX package's sharded dense and the
    port's mesh-free call (the 0/0 diagonal left out)."""
    g, n = 21, 45
    e = (rng.rand(g, n) * 5).astype(np.float32)
    d = rng.randn(g, n).astype(np.float32)
    off = ~np.eye(n, dtype=bool)
    jax_out = jcdc.col_delta_cor(e, d, transform, psc, mesh=jmake_mesh())
    E, D = torch.from_numpy(e), torch.from_numpy(d)
    got = tcdc.col_delta_cor(E, D, transform, psc, mesh=mesh)
    single = tcdc.col_delta_cor(E, D, transform, psc)
    assert got.shape == (n, n)
    np.testing.assert_allclose(got.numpy()[off], jax_out[off], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy()[off], single.numpy()[off],
                               rtol=1e-4, atol=1e-5)
    main, rndm = tcdc.col_delta_cor(E, D, transform, psc, mesh=mesh,
                                    dmat_random=-D)
    np.testing.assert_array_equal(main.numpy(), got.numpy())
    np.testing.assert_array_equal(
        rndm.numpy(), tcdc.col_delta_cor(E, -D, transform, psc,
                                         mesh=mesh).numpy())


def test_dense_center_range_plain(rng):
    """The plain twin's center range is the same rows of the whole call,
    and refuses a range outside the centers."""
    e = torch.from_numpy((rng.rand(9, 30) * 5).astype(np.float32))
    d = torch.from_numpy(rng.randn(9, 30).astype(np.float32))
    whole = tcdc._col_delta_cor_dense_plain(e, d, 1, 1e-10)
    part = tcdc._col_delta_cor_dense_plain(e, d, 1, 1e-10, c0=7, m=11)
    np.testing.assert_allclose(part.numpy(), whole[7:18].numpy(), rtol=1e-6,
                               atol=1e-7)
    for c0, m in ((-1, 3), (0, 0), (25, 6)):
        with pytest.raises(ValueError, match="center range"):
            tcdc._col_delta_cor_dense_plain(e, d, 1, 1e-10, c0=c0, m=m)


@pytest.mark.parametrize("transform,psc", [("sqrt", 1e-10), ("log10", 1.0),
                                           ("linear", 0.0)])
def test_flat_plain_matches_jax(rng, transform, psc):
    """The flat block-table plain twin against the JAX package's
    _partial_flat_impl on one shard's table of one ring plan."""
    import jax.numpy as jnp
    g, n, nn, shards = 15, 44, 10, 4
    e, d, ixs = _case(rng, g, n, nn, scale=10.0)
    chunk = (n + shards - 1) // shards
    qloc, qrow, _inv, _bmax = tcdc._ring_plan(ixs, shards, chunk, q=8)
    e_rows, d_rows = e.T, d.T
    tcode = tcdc._TRANSFORMS[transform]
    for p, v in ((0, 0), (1, 3), (3, 2)):
        visit = e_rows[v * chunk:(v + 1) * chunk]
        ctr = slice(p * chunk, (p + 1) * chunk)
        want = np.asarray(jcdc._partial_flat_impl(
            jnp.asarray(visit), jnp.asarray(e_rows[ctr]),
            jnp.asarray(d_rows[ctr]), jnp.asarray(qloc[p, v]),
            jnp.asarray(qrow[p, v]), tcode, psc))
        got = tcdc._col_delta_cor_flat_plain(
            torch.from_numpy(np.ascontiguousarray(visit)),
            torch.from_numpy(np.ascontiguousarray(e_rows[ctr])),
            torch.from_numpy(np.ascontiguousarray(d_rows[ctr])),
            torch.from_numpy(qloc[p, v]), torch.from_numpy(qrow[p, v]),
            tcode, psc)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_knn_search_sharded_matches_single(rng, mesh):
    """Bitwise: the sharded candidate pass, then the single-device f64
    re-score and tie-breaks."""
    from velocyto_tpu.ops import knn_search_sharded as jknn_sharded
    from velocyto_tpu_torch.ops.knn import knn_search_sharded
    from velocyto_tpu_torch.ops.knn_device import knn_search_dev
    X = rng.randn(300, 8)
    for k in (10, 150):
        jd, ji = jknn_sharded(jmake_mesh(), X, k)
        d1, i1 = knn_search_dev(X, k, device=CPU)
        d2, i2 = knn_search_sharded(mesh, X, k)
        np.testing.assert_array_equal(i2, i1.numpy())
        np.testing.assert_array_equal(d2, d1.numpy())
        np.testing.assert_array_equal(i2, ji)
        np.testing.assert_allclose(d2, jd, rtol=1e-12)


def test_balanced_knn_and_distance_matrix_take_a_mesh(rng, mesh):
    from velocyto_tpu_torch.ops.knn import BalancedKNN, knn_distance_matrix
    X = rng.randn(120, 6)
    a = BalancedKNN(k=5, sight_k=15, maxl=10, device=CPU).fit(X)
    b = BalancedKNN(k=5, sight_k=15, maxl=10, device=CPU, mesh=mesh).fit(X)
    assert (a.kneighbors_graph() != b.kneighbors_graph()).nnz == 0
    assert (knn_distance_matrix(X, k=7, device=CPU)
            != knn_distance_matrix(X, k=7, mesh=mesh)).nnz == 0


def test_velocity_step_sharded_matches_unsharded():
    """make_sharded_velocity_step on a 4 x 2 mesh against the port's
    velocity_step and the JAX package's sharded step (rtol 5e-3 / atol
    5e-5, test_velocity_model.py:112-113)."""
    from velocyto_tpu.models import velocity as jvel
    from velocyto_tpu_torch.models import velocity as tvel
    args = tvel.example_inputs(g=64, n=128, k=8, nn=16, d=2, device=CPU)
    single = tvel.velocity_step(*args)
    mesh = make_mesh(n_cell_shards=4, n_gene_shards=2, devices=[CPU] * 8)
    sharded = tvel.make_sharded_velocity_step(mesh)(*args)
    jmesh = jmake_mesh(n_cell_shards=4, n_gene_shards=2)
    with jmesh:
        jax_out = jvel.make_sharded_velocity_step(jmesh)(
            *jvel.example_inputs(g=64, n=128, k=8, nn=16, d=2))
    for name, a, b, c in zip(single._fields, single, sharded, jax_out):
        assert b.shape == a.shape, name
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-3,
                                   atol=5e-5, err_msg=name)
        np.testing.assert_allclose(b.numpy(), np.asarray(c), rtol=5e-3,
                                   atol=5e-5, err_msg=name)


def test_load_with_sharding(tmp_path):
    """A key loaded with cells_sharding comes back as one tensor per shard
    whose concatenation is the unsharded load; replicated gives the whole
    array to every shard."""
    from velocyto_tpu_torch.io.checkpoint import load_state, save_state
    mesh = make_mesh(devices=[CPU] * 3)
    state = {"X": np.arange(64.0).reshape(8, 8),
             "T": torch.arange(30.0).reshape(3, 10), "k": 7}
    path = str(tmp_path / "ckpt")
    save_state(path, state)
    got = load_state(path, device=CPU, shardings={
        "X": cells_sharding(mesh), "T": cells_sharding(mesh, 2, 1),
        "missing": replicated(mesh)})
    assert [tuple(t.shape) for t in got["X"]] == [(3, 8), (3, 8), (2, 8)]
    np.testing.assert_array_equal(torch.cat(got["X"]).numpy(), state["X"])
    assert [tuple(t.shape) for t in got["T"]] == [(3, 4), (3, 3), (3, 3)]
    assert torch.equal(torch.cat(got["T"], dim=1), state["T"])
    assert got["k"] == 7 and "missing" not in got
    whole = load_state(path, device=CPU, shardings={"T": replicated(mesh)})
    assert len(whole["T"]) == 3 and all(torch.equal(t, state["T"])
                                        for t in whole["T"])
    np.testing.assert_array_equal(whole["X"], state["X"])


class _OnCard:
    """A CPU tensor that reports a CUDA device, so a wrapper's checks run
    past the device test on a machine without a card."""

    def __init__(self, t, index=0):
        self._t = t
        self.device = torch.device("cuda", index)

    is_cuda = True

    def __getattr__(self, name):
        return getattr(self._t, name)


def _f32(*shape):
    return _OnCard(torch.zeros(shape))


@pytest.mark.parametrize("c0,m", [(-1, 4), (0, 0), (10, 3), (0, 13),
                                  (2.0, 4)])
def test_dense_center_range_refused_before_building(c0, m):
    """K1's center range: a negative c0, an empty range, c0 + m > N or a
    non-integer bound raises before any build."""
    e = _f32(5, 12)
    with pytest.raises(ValueError, match="center range"):
        kernels.coldeltacor_dense(e, e, 1, 1e-10, c0=c0, m=m)
    assert kernels._lib is None and kernels.dense_launches == 0


_I32 = dict(dtype=torch.int32)


@pytest.mark.parametrize("bad", [
    dict(qloc=_OnCard(torch.zeros((6, 4), dtype=torch.int64))),     # dtype
    dict(qrow=_OnCard(torch.zeros(6, dtype=torch.int64))),
    dict(qloc=_OnCard(torch.zeros(6, 4, **_I32).float())),
    dict(qloc=_OnCard(torch.zeros(24, **_I32))),                      # rank
    dict(qrow=_OnCard(torch.zeros(5, **_I32))),                       # shape
    dict(qrow=_OnCard(torch.zeros((6, 1), **_I32))),
    dict(qloc=_OnCard(torch.zeros((6, 4), **_I32), index=1)),         # device
    dict(qrow=_OnCard(torch.zeros(6, **_I32), index=1)),
    dict(e_ctr=_f32(3, 9)),                                   # centers
    dict(d_ctr=_f32(3, 8)),
    dict(d_ctr2=_f32(4, 7)),
    dict(e_visit=_OnCard(torch.zeros((5, 8), dtype=torch.float64))),
    dict(qloc=_OnCard(torch.zeros((0, 4), **_I32)),
         qrow=_OnCard(torch.zeros(0, **_I32))),                      # empty
    dict(transform=3),
])
def test_flat_kernel_refuses_before_building(bad):
    """The flat block-table wrapper refuses a wrong dtype, rank, shape or
    device of qloc / qrow or of the rows, and an unknown transform, before
    any build; CPU tensors are refused too."""
    kw = dict(e_visit=_f32(5, 8), e_ctr=_f32(4, 8), d_ctr=_f32(4, 8),
              qloc=_OnCard(torch.zeros((6, 4), **_I32)),
              qrow=_OnCard(torch.zeros(6, **_I32)), transform=1, psc=1e-10)
    kw.update(bad)
    with pytest.raises((ValueError, TypeError)):
        kernels.coldeltacor_flat(**kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.coldeltacor_flat(torch.zeros(5, 8), torch.zeros(4, 8),
                                 torch.zeros(4, 8),
                                 torch.zeros((6, 4), **_I32),
                                 torch.zeros(6, **_I32), 1, 1e-10)
    assert kernels._lib is None and kernels.flat_launches == 0


def test_flat_signature_is_bound():
    """The ctypes binding of the flat kernel matches its C entry point's
    parameter count in the source."""
    import re
    src = (kernels._HERE / "coldeltacor_partial.cu").read_text()
    sig = re.search(r'extern "C" int vtt_coldeltacor_flat\(([^)]*)\)', src)
    params = [p for p in sig.group(1).split(",") if p.strip()]
    stem, symbol, argtypes = kernels._SIGNATURES["coldeltacor_flat"]
    assert (stem, symbol) == ("coldeltacor_partial", "vtt_coldeltacor_flat")
    assert len(argtypes) == len(params) == 19
    sig = re.search(r'extern "C" int vtt_coldeltacor_dense\(([^)]*)\)',
                    (kernels._HERE / "coldeltacor_dense.cu").read_text())
    params = [p for p in sig.group(1).split(",") if p.strip()]
    assert len(kernels._SIGNATURES["coldeltacor_dense"][2]) == \
        len(params) == 13
