"""The port's sampled transition-probability path
(estimate_transition_prob(knn_random=True)) on the CPU, against the JAX
package and the reference goldens.

Inputs: tests/golden/golden.npz through test_golden.py's calls, or numpy
arrays made from a seed.  Tolerances: the neighbour sampler, the sampled
positions, the kNN masks and numpy's RNG state are exact (ROADMAP's
exactness contracts); correlations rtol 1e-3 / atol 1e-4 (f32 moment
cancellation in another summation order); transition probabilities
rtol 1e-3 / atol 1e-6 and embedding shifts and scalings rtol 1e-3 /
atol 1e-5, test_golden.py's tolerances."""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import velocyto_tpu as vt
from velocyto_tpu import analysis as janalysis
from velocyto_tpu import native as jnative
from velocyto_tpu.ops.coldeltacor import _TRANSFORMS, _partial_impl

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch import analysis as tanalysis
from velocyto_tpu_torch import kernels, native
from velocyto_tpu_torch.ops.coldeltacor import (_col_delta_cor_partial_plain,
                                                col_delta_cor_partial_compact)

from oracles import col_delta_cor_partial as oracle_partial
from test_torch_pipeline import CPU, GOLDEN, _fresh, _front

SEED = 15071990
# test_torch_coldeltacor.py's transform/psc pairs
PAIRS = [("linear", 0.0), ("sqrt", 0.0), ("sqrt", 1e-10), ("log10", 1.0),
         ("log10", 1e-10)]


# --- the neighbour sampler -------------------------------------------

@pytest.mark.parametrize("n,nn_k,n_samp", [(300, 61, 30), (2000, 401, 200)])
def test_sampler_matches_numpy_loop_and_jax_native(n, nn_k, n_samp):
    p = np.linspace(0.5, 0.1, nn_k)
    p = p / p.sum()
    got, draws, state = native.choice_noreplace_rows_state(SEED, n, nn_k,
                                                         n_samp, p)
    want, want_state = native.choice_rows_plain(SEED, n, nn_k, n_samp, p)
    np.testing.assert_array_equal(got, want)
    assert state[0] == want_state[0] and state[2:] == want_state[2:]
    np.testing.assert_array_equal(state[1], want_state[1])
    assert draws >= n * n_samp
    j_rows, j_draws, j_state = jnative.choice_noreplace_rows_chunked(
        SEED, n, nn_k, n_samp, p)
    np.testing.assert_array_equal(got, j_rows)
    assert draws == j_draws and state[2] == j_state[2]
    np.testing.assert_array_equal(state[1], j_state[1])


def test_sampler_refuses_too_few_positive_weights():
    p = np.array([0.5, 0.5, 0.0, 0.0])
    with pytest.raises(ValueError, match="non-zero"):
        native.choice_noreplace_rows(SEED, 3, 4, 3, p)


# --- the sampled colDeltaCor ------------------------------------------

def _partial_inputs(g, n, nn, seed=0):
    rng = np.random.RandomState(seed)
    e = (rng.rand(n, g) * 10).astype(np.float32)
    e[5] = e[3]                          # duplicate cells: delta == 0
    e[7, : g // 2] = e[2, : g // 2]      # delta == 0 on half the genes
    d = rng.randn(n, g).astype(np.float32)
    ixs = np.stack([rng.choice(np.delete(np.arange(n), i), nn, replace=False)
                    for i in range(n)])
    ixs[3, 0], ixs[7, 0] = 5, 2          # the sign-quirk pairs
    return e, d, ixs


@pytest.mark.parametrize("transform,psc", PAIRS)
@pytest.mark.parametrize("g,n,nn", [(37, 29, 13), (50, 300, 200)],
                         ids=["small", "nn_not_tile_multiple"])
def test_partial_plain_matches_jax_and_oracle(g, n, nn, transform, psc):
    e, d, ixs = _partial_inputs(g, n, nn)
    tcode = _TRANSFORMS[transform]
    et, dt = torch.from_numpy(e), torch.from_numpy(d)
    got = _col_delta_cor_partial_plain(et, et, dt, torch.from_numpy(ixs),
                                       tcode, psc).numpy()
    want = np.asarray(_partial_impl(jnp.asarray(e), jnp.asarray(e),
                                    jnp.asarray(d), jnp.asarray(ixs, jnp.int32),
                                    tcode, psc))
    oracle = oracle_partial(e.T.astype(np.float64), d.T.astype(np.float64),
                            ixs, transform, psc)
    # the duplicate pair's transform is constant: 0/0, or rounding noise
    rows = np.arange(n)[:, None]
    ok = ~(((rows == 3) & (ixs == 5)) | ((rows == 5) & (ixs == 3)))
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[ok], oracle[ok], rtol=1e-3, atol=1e-4)


def test_partial_compact_on_cpu_uses_plain_version_and_dual_form():
    e, d, ixs = _partial_inputs(37, 29, 13)
    d2 = np.random.RandomState(1).randn(*d.shape).astype(np.float32)
    E, D, D2 = (torch.from_numpy(np.ascontiguousarray(a.T)) for a in (e, d, d2))
    ix = torch.from_numpy(ixs)
    single = col_delta_cor_partial_compact(E, D, ix, "sqrt", 1e-10)
    main, rndm = col_delta_cor_partial_compact(E, D, ix, "sqrt", 1e-10,
                                               dmat_random=D2)
    et = torch.from_numpy(e)
    plain = _col_delta_cor_partial_plain(et, et, torch.from_numpy(d), ix, 1,
                                         1e-10)
    plain2 = _col_delta_cor_partial_plain(et, et, torch.from_numpy(d2), ix, 1,
                                          1e-10)
    for got, want in ((single, plain), (main, plain), (rndm, plain2)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert kernels.partial_launches == 0 and kernels._lib is None


# --- the sampled path's helpers ---------------------------------------

@pytest.mark.parametrize("row_offset", [0, 17])
def test_sample_neighbors_matches_jax(row_offset):
    rng = np.random.RandomState(2)
    n, cols, n_samp = 40, 11, 5
    idx = np.stack([rng.permutation(80)[:cols] for _ in range(n)])
    for i in range(n):                   # own cell in most rows, anywhere
        if rng.rand() < 0.8:
            idx[i, rng.randint(cols)] = i + row_offset
    samp = np.stack([rng.choice(cols - 1, n_samp, replace=False)
                     for _ in range(n)])
    got = tanalysis._sample_neighbors_dev(torch.from_numpy(idx),
                                          torch.from_numpy(samp), row_offset)
    want = janalysis._sample_neighbors_dev(jnp.asarray(idx, jnp.int32),
                                           jnp.asarray(samp), row_offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["log", "sqrt", "linear", "logratio"])
def test_corr_transform_dev_matches_jax(kind):
    rng = np.random.RandomState(3)
    hi = (rng.rand(30, 40) * 5).astype(np.float32)
    ds = rng.randn(30, 40).astype(np.float32)
    ds[0, :5] = 0.0
    psc = 1.0 if kind in ("log", "logratio") else 1e-10
    got = tanalysis._corr_transform_dev(torch.from_numpy(hi),
                                        torch.from_numpy(ds), 1.0, psc, kind)
    want = janalysis._corr_transform_dev(jnp.asarray(hi), jnp.asarray(ds),
                                         1.0, psc, kind)
    # f32 elementwise; XLA's and torch's log2 may differ by an ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# --- the sampled pipeline against the goldens and the JAX package -----

def _sampled(v, golden, randomized, scaling):
    """test_golden.py's front stages and knn_random call; returns each
    output and numpy's RNG state right after the sampling."""
    _front(v, balanced=False)
    v.fit_gammas()
    v.gammas = golden["gammas"].copy()
    v.q = golden["q"].copy()
    v.predict_U()
    v.calculate_velocity()
    v.calculate_shift(assumption="constant_velocity")
    v.extrapolate_cell_at_t(delta_t=1.)
    v.ts = golden["ts"].copy()
    v.estimate_transition_prob(hidim="Sx_sz", embed="ts", transform="sqrt",
                               knn_random=True, sampled_fraction=0.5,
                               calculate_randomized=randomized)
    out = {"rng_state": np.random.get_state()}
    v.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=scaling)
    names = ["sampling_ixs", "embedding_knn", "corrcoef", "transition_prob",
             "delta_embedding"]
    if randomized:
        names += ["delta_S_rndm", "corrcoef_random", "transition_prob_random",
                  "delta_embedding_random"]
    if scaling:
        names += ["scaling"] + (["scaling_rndm"] if randomized else [])
    for name in names:
        out[name] = getattr(v, name)
    out["embedding_knn"] = out["embedding_knn"].toarray()
    return out


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module", params=[(False, False), (True, False),
                                        (True, True)],
                ids=["plain", "randomized", "randomized_scaled"])
def sampled_runs(request, golden):
    randomized, scaling = request.param
    jax_v, port_v = _fresh(vt, golden), _fresh(vtt, golden, device=CPU)
    return {"jax": _sampled(jax_v, golden, randomized, scaling),
            "port": _sampled(port_v, golden, randomized, scaling),
            "port_v": port_v, "randomized": randomized, "scaling": scaling}


def test_sampled_exact_outputs_match_jax(sampled_runs):
    port, jax_out = sampled_runs["port"], sampled_runs["jax"]
    for name in ("sampling_ixs", "embedding_knn"):
        np.testing.assert_array_equal(port[name], jax_out[name])
    a, b = port["rng_state"], jax_out["rng_state"]
    assert a[0] == b[0] and a[2:] == b[2:]
    np.testing.assert_array_equal(a[1], b[1])


# (output, rtol, atol) of the port against the JAX package
SAMPLED_VS_JAX = [
    ("delta_S_rndm", 1e-5, 1e-5),       # delta_S's own tolerance
    ("corrcoef", 1e-3, 1e-4), ("transition_prob", 1e-3, 1e-6),
    ("delta_embedding", 1e-3, 1e-5), ("corrcoef_random", 1e-3, 1e-4),
    ("transition_prob_random", 1e-3, 1e-6),
    ("delta_embedding_random", 1e-3, 1e-5), ("scaling", 1e-3, 1e-5),
    ("scaling_rndm", 1e-3, 1e-5)]


@pytest.mark.parametrize("name,rtol,atol", SAMPLED_VS_JAX,
                         ids=[c[0] for c in SAMPLED_VS_JAX])
def test_sampled_outputs_match_jax(sampled_runs, name, rtol, atol):
    port, jax_out = sampled_runs["port"], sampled_runs["jax"]
    assert (name in port) == (name in jax_out)
    if name in port:
        np.testing.assert_allclose(port[name], jax_out[name], rtol=rtol,
                                   atol=atol)


def test_sampled_matches_golden(sampled_runs, golden):
    """test_golden.py::test_knn_random_mode_matches_reference's checks
    (the goldens hold the unscaled run; the randomized control draws
    before the sampling, which re-seeds)."""
    port = sampled_runs["port"]
    np.testing.assert_array_equal(port["sampling_ixs"],
                                  golden["knnr_sampling_ixs"])
    np.testing.assert_array_equal(port["embedding_knn"],
                                  golden["knnr_embedding_knn"])
    np.testing.assert_allclose(port["corrcoef"], golden["knnr_corrcoef"],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(port["transition_prob"],
                               golden["knnr_transition_prob"],
                               rtol=1e-3, atol=1e-6)
    if not sampled_runs["scaling"]:
        np.testing.assert_allclose(port["delta_embedding"],
                                   golden["knnr_delta_embedding"],
                                   rtol=1e-3, atol=1e-5)


def test_sampled_transition_from_jax_state(golden):
    """Started from the JAX package's own state, the randomized control
    is bit-identical and the sampled correlations agree to f32
    tolerance."""
    jax_v = _state(vt, golden)
    jax_v.estimate_transition_prob(hidim="Sx_sz", embed="ts", knn_random=True,
                                   n_neighbors=30, sampled_fraction=0.5,
                                   calculate_randomized=True)
    port = vtt.state_from_numpy({n: getattr(jax_v, n) for n in (
        "S", "Sx_sz", "delta_S", "ts", "used_delta_t")}, "cpu")
    port.estimate_transition_prob(hidim="Sx_sz", embed="ts", knn_random=True,
                                  n_neighbors=30, sampled_fraction=0.5,
                                  calculate_randomized=True)
    np.testing.assert_array_equal(port.delta_S_rndm, jax_v.delta_S_rndm)
    np.testing.assert_array_equal(port.sampling_ixs, jax_v.sampling_ixs)
    for name in ("corrcoef", "corrcoef_random"):
        np.testing.assert_allclose(getattr(port, name), getattr(jax_v, name),
                                   rtol=1e-3, atol=1e-4)


def test_sampled_state_stays_compact(sampled_runs):
    """Nothing (N, N) exists on the device: the correlations are the
    compact (N, nn) tensors, and the sampled neighbours exclude each
    row's own cell and lie in its embedding kNN."""
    v = sampled_runs["port_v"]
    ixs = v._compact_ixs_dev
    n = ixs.shape[0]
    assert tuple(v._corr_dev.shape) == tuple(ixs.shape) == (n, 12)
    assert not any(t.dim() == 2 and t.shape == (n, n)
                   for t in (v._get_dev(name, None) for name, e in
                             v._table().items()
                             if isinstance(e, tanalysis._Device)))
    assert not bool((ixs == torch.arange(n)[:, None]).any())
    knn = tanalysis.kd.knn_search_dev(v.ts, 26, device=CPU)[1]
    assert bool((ixs[:, :, None] == knn[:, None, :]).any(-1).all())


# --- faults, NaNs and mode switching ----------------------------------

def _state(mod, golden, **extra):
    """A JAX-package or port object at the estimate_transition_prob
    stage, from the goldens' stage outputs."""
    attrs = dict(S=golden["S"].copy(), Sx_sz=golden["Sx"].copy(),
                 delta_S=golden["delta_S"].copy(), ts=golden["ts"].copy(),
                 used_delta_t=1.0, **extra)
    if mod is vt:
        v = vt.VelocytoLoom.__new__(vt.VelocytoLoom)
        for name, value in attrs.items():
            setattr(v, name, value)
        return v
    return vtt.state_from_numpy(attrs, "cpu")


def test_edited_full_mode_corrcoef_reaches_embedding_shift(golden):
    """In full mode the JAX package keeps corrcoef as a host array, so an
    in-place edit reaches calculate_embedding_shift; the port must do the
    same with the host view it hands out."""
    out = {}
    for mod in (vt, vtt):
        v = _state(mod, golden)
        v.estimate_transition_prob(hidim="Sx_sz", embed="ts",
                                   knn_random=False, n_neighbors=20,
                                   calculate_randomized=True)
        v.corrcoef[:] = 0
        v.corrcoef_random[:5] = 0.5
        v.calculate_embedding_shift(sigma_corr=0.05,
                                    expression_scaling=False)
        out[mod] = v
    port, jax_v = out[vtt], out[vt]
    mask = port.embedding_knn.toarray()
    np.testing.assert_allclose(port.transition_prob,
                               mask / mask.sum(1, keepdims=True), rtol=1e-6)
    for name, rtol, atol in (("transition_prob", 1e-3, 1e-6),
                             ("transition_prob_random", 1e-3, 1e-6),
                             ("delta_embedding", 1e-3, 1e-5),
                             ("delta_embedding_random", 1e-3, 1e-5)):
        np.testing.assert_allclose(getattr(port, name), getattr(jax_v, name),
                                   rtol=rtol, atol=atol)


def test_edited_sampled_corrcoef_takes_dense_path(golden):
    out = {}
    for mod in (vt, vtt):
        v = _state(mod, golden)
        v.estimate_transition_prob(hidim="Sx_sz", embed="ts",
                                   knn_random=True, n_neighbors=20,
                                   sampled_fraction=0.5,
                                   calculate_randomized=False)
        v.corrcoef[v.corrcoef != 0] = 0.3
        assert not v._compact_state_valid()
        v.calculate_embedding_shift(sigma_corr=0.05,
                                    expression_scaling=False)
        out[mod] = v
    np.testing.assert_allclose(out[vtt].transition_prob,
                               out[vt].transition_prob, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(out[vtt].delta_embedding,
                               out[vt].delta_embedding, rtol=1e-3, atol=1e-5)


def test_nan_correlations_become_one_with_warning(golden, caplog):
    """Two identical cells give a constant transform, 0/0 correlations:
    both packages set them to 1.0 and warn."""
    sx = golden["Sx"].copy()
    ts = golden["ts"].copy()
    sx[:, 1] = sx[:, 0]
    ts[1] = ts[0] + 1e-6                 # embedding neighbours
    out = {}
    for mod in (vt, vtt):
        v = _state(mod, golden)
        v.Sx_sz, v.ts = sx, ts
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            v.estimate_transition_prob(hidim="Sx_sz", embed="ts",
                                       knn_random=True, n_neighbors=40,
                                       sampled_fraction=1.0,
                                       calculate_randomized=False)
        assert any("Nans encountered" in r.message for r in caplog.records)
        out[mod] = v.corrcoef
    assert out[vtt][0, 1] == 1.0 and out[vtt][1, 0] == 1.0
    assert not np.isnan(out[vtt]).any()
    np.testing.assert_allclose(out[vtt], out[vt], rtol=1e-3, atol=1e-4)


def test_mode_switching_drops_stale_state(golden):
    """full -> sampled -> full on both packages: each call's outputs
    match, and the other mode's state is gone."""
    objs = {mod: _state(mod, golden) for mod in (vt, vtt)}
    for knn_random in (False, True, False):
        for mod, v in objs.items():
            v.estimate_transition_prob(hidim="Sx_sz", embed="ts",
                                       knn_random=knn_random,
                                       n_neighbors=20, sampled_fraction=0.5,
                                       calculate_randomized=True)
            v.calculate_embedding_shift(sigma_corr=0.05,
                                        expression_scaling=False)
        port, jax_v = objs[vtt], objs[vt]
        assert port.corr_calc == jax_v.corr_calc
        np.testing.assert_array_equal(port.embedding_knn.toarray(),
                                      jax_v.embedding_knn.toarray())
        for name in ("corrcoef", "corrcoef_random"):
            np.testing.assert_allclose(getattr(port, name),
                                       getattr(jax_v, name),
                                       rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(port.transition_prob,
                                   jax_v.transition_prob, rtol=1e-3,
                                   atol=1e-6)
        np.testing.assert_allclose(port.delta_embedding,
                                   jax_v.delta_embedding, rtol=1e-3,
                                   atol=1e-5)
        d, table = port.__dict__, port._table()
        # both modes keep their embedding neighbour ids on the device and
        # build embedding_knn from them; the sampled mode its compact
        # correlations too, the full mode its dense ones
        n = len(port.ts)
        assert tuple(d["_compact_ixs_dev"].shape) == \
            (n, 10 if knn_random else 21)
        if knn_random:
            assert not isinstance(table.get("corrcoef"), tanalysis._Device)
            assert d["_corr_dev"] is not None
        else:
            assert "_corr_dev" not in d and "_compact_ixs" not in d
            assert "_compact_ixs" not in table
            assert isinstance(table["corrcoef"], tanalysis._Device)
