"""The dual dense colDeltaCor, the center order of the sampled kernel and
the card defaults of the device kNN entry points, on the CPU.

The dense dual form (``col_delta_cor(..., dmat_random=...)``) is held
against two single calls (exactly: on the CPU it is two plain calls) and
against the JAX package's Pallas kernel in interpret mode at the JAX
tests' tolerance (rtol 2e-3, atol 2e-4, off the diagonal: f32 moment
cancellation differs with summation order).  The full-mode pipeline's
correlations are held against the JAX package at test_torch_pipeline.py's
tolerance (rtol 1e-3, atol 1e-4).  ``locality_order`` and the order
argument change no output, so their checks are exact.  Inputs are made
with numpy from a seed."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velocyto_tpu as vt
from velocyto_tpu.ops.coldeltacor import (_TRANSFORMS,
                                          _col_delta_cor_dense_pallas)

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch import analysis as tanalysis
from velocyto_tpu_torch.models import velocity as tvelocity
from velocyto_tpu_torch.ops import knn_device as kd
from velocyto_tpu_torch.ops.coldeltacor import (_hilbert_index,
                                                chunk_order, col_delta_cor,
                                                col_delta_cor_partial_compact,
                                                locality_order)

from test_torch_coldeltacor import PAIRS, _inputs
from test_torch_pipeline import CPU, GOLDEN, _fresh, _pipeline
from test_torch_sampled import _partial_inputs, _sampled


# --- the dual dense form ---------------------------------------------

@pytest.mark.parametrize("partial", [False, True], ids=["full", "partial"])
@pytest.mark.parametrize("transform,psc", PAIRS)
@pytest.mark.parametrize("g,n", [(37, 29), (64, 100)])
def test_dual_dense_equals_two_singles_and_pallas(g, n, transform, psc,
                                                  partial):
    e, d, mask = _inputs(g, n)
    d2 = np.random.RandomState(n).randn(g, n).astype(np.float32)
    et, dt, d2t = map(torch.from_numpy, (e, d, d2))
    main, rndm = col_delta_cor(et, dt, transform, psc, partial,
                               dmat_random=d2t)
    assert main.dtype == rndm.dtype == torch.float32
    np.testing.assert_array_equal(
        main.numpy(), col_delta_cor(et, dt, transform, psc, partial).numpy())
    np.testing.assert_array_equal(
        rndm.numpy(), col_delta_cor(et, d2t, transform, psc, partial).numpy())
    for got, dm in ((main, d), (rndm, d2)):
        pallas = np.asarray(_col_delta_cor_dense_pallas(
            jnp.asarray(e), jnp.asarray(dm), _TRANSFORMS[transform], psc,
            interpret=True, partial_semantics=partial))
        np.testing.assert_allclose(got.numpy()[mask], pallas[mask],
                                   rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def full_runs():
    golden = np.load(GOLDEN)
    calls = []
    dense = tanalysis.col_delta_cor

    def spy(*args, **kw):
        calls.append(kw.get("dmat_random") is not None)
        return dense(*args, **kw)

    tanalysis.col_delta_cor = spy
    try:
        port = _pipeline(_fresh(vtt, golden, device=CPU), golden)
    finally:
        tanalysis.col_delta_cor = dense
    return {"jax": _pipeline(_fresh(vt, golden), golden), "port": port,
            "calls": calls}


def test_full_mode_makes_one_dual_call(full_runs):
    """estimate_transition_prob(knn_random=False, calculate_randomized=
    True) asks for the main field and the control in one call (one kernel
    launch on the card)."""
    assert full_runs["calls"] == [True]


@pytest.mark.parametrize("name", ["corrcoef", "corrcoef_random"])
def test_full_mode_dual_correlations_match_jax(full_runs, name):
    np.testing.assert_allclose(full_runs["port"][name],
                               full_runs["jax"][name], rtol=1e-3, atol=1e-4)


# --- the locality order ----------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 3, 5])
def test_hilbert_index_walks_the_grid_in_unit_steps(bits):
    n = 1 << bits
    x, y = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    code = _hilbert_index(x.reshape(-1), y.reshape(-1), bits)
    assert sorted(code.tolist()) == list(range(n * n))
    walk = torch.argsort(code)
    steps = (x.reshape(-1)[walk].diff().abs() +
             y.reshape(-1)[walk].diff().abs())
    assert bool((steps == 1).all())


@pytest.mark.parametrize("dims", [2, 3])
def test_locality_order_is_a_local_permutation(dims):
    rng = np.random.RandomState(dims)
    pts = torch.as_tensor(np.concatenate(
        [rng.randn(600, dims), rng.randn(400, dims) * 0.3 + 5.0]))
    order = locality_order(pts)
    assert order.dtype == torch.int32 and order.shape == (1000,)
    assert sorted(order.tolist()) == list(range(1000))
    walked = pts[order.long(), :2]
    near = (walked[1:] - walked[:-1]).norm(dim=1).mean()
    shuffled = pts[torch.randperm(1000, generator=torch.Generator()
                                  .manual_seed(0)), :2]
    far = (shuffled[1:] - shuffled[:-1]).norm(dim=1).mean()
    assert float(near) < 0.1 * float(far)
    # each point's nearest embedding neighbour lies close in the order
    d2 = torch.cdist(pts[:, :2], pts[:, :2])
    d2.fill_diagonal_(float("inf"))
    nearest = d2.argmin(1)
    rank = torch.empty(1000, dtype=torch.int64)
    rank[order.long()] = torch.arange(1000)
    gap = (rank - rank[nearest]).abs().to(torch.float64)
    assert float(gap.median()) <= 8


def test_locality_order_of_identical_points_is_identity():
    order = locality_order(torch.ones((7, 2)))
    assert order.tolist() == list(range(7))


@pytest.mark.parametrize("transform,psc", PAIRS)
def test_partial_compact_output_does_not_depend_on_order(transform, psc):
    e, d, ixs = _partial_inputs(37, 29, 13)
    d2 = np.random.RandomState(1).randn(*d.shape).astype(np.float32)
    et, dt, d2t = (torch.from_numpy(np.ascontiguousarray(m.T))
                   for m in (e, d, d2))
    ix = torch.from_numpy(ixs)
    order = locality_order(torch.from_numpy(
        np.random.RandomState(2).randn(29, 2)))
    for kw in ({}, {"dmat_random": d2t}):
        plain = col_delta_cor_partial_compact(et, dt, ix, transform, psc,
                                              **kw)
        ordered = col_delta_cor_partial_compact(et, dt, ix, transform, psc,
                                                order=order, **kw)
        for a, b in zip(plain if kw else [plain],
                        ordered if kw else [ordered]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("edit", ["repeat", "short", "above", "negative",
                                  "float"])
def test_partial_compact_refuses_an_order_that_is_not_a_permutation(edit):
    """A center missing from the order would leave its output row
    unwritten on the card, so the public entry point refuses it on either
    device."""
    e, d, ixs = _partial_inputs(37, 29, 13)
    et, dt = (torch.from_numpy(np.ascontiguousarray(m.T)) for m in (e, d))
    ix = torch.from_numpy(ixs)
    good = torch.randperm(29, generator=torch.Generator().manual_seed(3))
    col_delta_cor_partial_compact(et, dt, ix, "sqrt", 1e-10, order=good)
    bad = {"repeat": torch.cat([good[:-1], good[:1]]), "short": good[:-1],
           "above": torch.where(good == 0, 29, good),
           "negative": torch.where(good == 0, -1, good),
           "float": good.to(torch.float32)}[edit]
    with pytest.raises(ValueError, match="permutation"):
        col_delta_cor_partial_compact(et, dt, ix, "sqrt", 1e-10, order=bad)


def _chunk_spy(monkeypatch):
    """Record (lo, hi, ids dtype, order) of each chunk the sampled path
    runs through make_partial_compact_chunked."""
    seen = []
    make = tanalysis.make_partial_compact_chunked

    def spy_make(*args, **kw):
        prep_d, run = make(*args, **kw)

        def spy_run(d_rows, lo, hi, ixs, *rest, **run_kw):
            seen.append((lo, hi, ixs.dtype, run_kw.get("order")))
            return run(d_rows, lo, hi, ixs, *rest, **run_kw)
        return prep_d, spy_run

    monkeypatch.setattr(tanalysis, "make_partial_compact_chunked", spy_make)
    return seen


def test_sampled_path_hands_the_kernel_int32_ids(monkeypatch):
    """The sampled neighbour ids are built as int32, the dtype the kernel
    reads, so the path converts nothing before a chunk's launch."""
    golden = np.load(GOLDEN)
    seen = _chunk_spy(monkeypatch)
    v = _fresh(vtt, golden, device=CPU)
    _sampled(v, golden, randomized=True, scaling=False)
    assert [s[2] for s in seen] == [torch.int32] * tanalysis.SAMPLER_CHUNKS
    assert v._compact_ixs.dtype == np.int64    # the host view keeps int64


def _order_spy(monkeypatch, module):
    seen = []
    compact = module.col_delta_cor_partial_compact

    def spy(*args, **kw):
        seen.append(kw.get("order"))
        return compact(*args, **kw)

    monkeypatch.setattr(module, "col_delta_cor_partial_compact", spy)
    return seen


def test_sampled_path_passes_the_embedding_locality_order(monkeypatch):
    """Each chunk's centers go to the kernel in the embedding-locality
    order restricted to the chunk: the chunk's rows in the order the
    global order lists them, minus the chunk's first row."""
    golden = np.load(GOLDEN)
    seen = _chunk_spy(monkeypatch)
    v = _fresh(vtt, golden, device=CPU)
    _sampled(v, golden, randomized=True, scaling=False)
    want = locality_order(torch.as_tensor(golden["ts"]))
    n = want.shape[0]
    assert len(seen) == tanalysis.SAMPLER_CHUNKS
    assert [s[0] for s in seen] == [0] + [s[1] for s in seen[:-1]]
    assert seen[-1][1] == n
    for lo, hi, _dtype, order in seen:
        rows = want[(want >= lo) & (want < hi)] - lo
        assert torch.equal(order, rows)
        assert torch.equal(order, chunk_order(want, lo, hi))


def test_velocity_step_passes_the_embedding_locality_order(monkeypatch):
    seen = _order_spy(monkeypatch, tvelocity)
    args = tvelocity.example_inputs(g=32, n=64, k=4, nn=8, device="cpu")
    tvelocity.velocity_step(*args)
    assert len(seen) == 1 and torch.equal(seen[0], locality_order(args[4]))


# --- the device kNN entry points default to the card ------------------

@pytest.mark.parametrize("fn,kw", [
    (kd.knn_search_dev, {"k": 5}),
    (kd.balanced_knn_graph_dev, {"k": 4, "sight_k": 8, "maxl": 6}),
    (kd.knn_graph_dev, {"k": 4})],
    ids=["knn_search_dev", "balanced_knn_graph_dev", "knn_graph_dev"])
def test_device_knn_defaults_to_the_card(fn, kw):
    """A numpy input without device= goes to the card: it runs there
    where one exists and raises where torch has no CUDA; a tensor input
    stays on its own device."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    x = np.random.RandomState(0).randn(40, 3)
    if torch.cuda.is_available():
        out = fn(x, **kw)
        idx = out[1] if isinstance(out, tuple) else out.idx
        assert idx.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            fn(x, **kw)
    out = fn(torch.as_tensor(x), **kw)
    idx = out[1] if isinstance(out, tuple) else out.idx
    assert idx.device.type == "cpu"
