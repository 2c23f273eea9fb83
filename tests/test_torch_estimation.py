"""The port's reference-parity estimation API (velocyto_tpu_torch.estimation:
the six colDeltaCor shims and the re-exported fits) and its fused
velocity_step (velocyto_tpu_torch.models.velocity) on the CPU, against the
JAX package and against the port's own step-by-step chain.

Inputs: numpy arrays from a seed; the chain is test_velocity_model.py's.
Tolerances: correlations rtol 2e-3 / atol 2e-4 (the JAX tests' colDeltaCor
tolerance: float32 moments summed in another order); gamma fits rtol
1e-4 / atol 1e-5; velocity_step against the JAX package at the
pipeline's stage tolerances (test_torch_pipeline.py), and against the
chain at test_velocity_model.py's."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

import velocyto_tpu as vt
from velocyto_tpu import estimation as jest
from velocyto_tpu.models import velocity as jvel
from velocyto_tpu.ops import gamma as jgamma
from velocyto_tpu.ops import knn as jknn

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch import analysis as tanalysis
from velocyto_tpu_torch import estimation as test_
from velocyto_tpu_torch import kernels
from velocyto_tpu_torch.models import velocity as tvel
from velocyto_tpu_torch.ops import knn as tknn
from velocyto_tpu_torch.ops.smoothing import csr_to_compact

CORR_TOL = dict(rtol=2e-3, atol=2e-4)
GAMMA_TOL = dict(rtol=1e-4, atol=1e-5)
SHIMS = ["colDeltaCor", "colDeltaCorSqrt", "colDeltaCorLog10",
         "colDeltaCorpartial", "colDeltaCorSqrtpartial",
         "colDeltaCorLog10partial"]


def _shim_inputs(g=37, n=53, nn=9, seed=4):
    rng = np.random.RandomState(seed)
    emat = rng.rand(g, n) * 5
    dmat = rng.randn(g, n)
    ixs = np.stack([rng.choice(n, nn, replace=False) for _ in range(n)])
    return emat, dmat, ixs


@pytest.mark.parametrize("name", SHIMS)
def test_shim_matches_jax(name):
    emat, dmat, ixs = _shim_inputs()
    args = (emat, dmat, ixs) if name.endswith("partial") else (emat, dmat)
    got = getattr(test_, name)(*args, threads=4, device="cpu")
    want = getattr(jest, name)(*args)
    assert isinstance(got, np.ndarray) and got.shape == (53, 53)
    assert got.dtype == np.asarray(want).dtype
    if name.endswith("partial"):
        off = np.ones_like(got, dtype=bool)
        off[np.arange(53)[:, None], ixs] = False
        assert not got[off].any()               # zero off the samples
    np.testing.assert_allclose(got, want, **CORR_TOL)
    assert inspect.signature(getattr(test_, name)).parameters[
        "device"].default == "cuda"               # never a silent CPU


def test_partial_shim_sums_repeated_positions_like_jax():
    emat, dmat, ixs = _shim_inputs(nn=4)
    ixs[:, 1] = ixs[:, 0]
    np.testing.assert_allclose(
        test_.colDeltaCorSqrtpartial(emat, dmat, ixs, psc=1e-10,
                                     device="cpu"),
        jest.colDeltaCorSqrtpartial(emat, dmat, ixs, psc=1e-10), **CORR_TOL)


def test_shims_launch_no_kernel_on_the_cpu():
    kernels.reset_counts()
    emat, dmat, ixs = _shim_inputs()
    test_.colDeltaCor(emat, dmat, device="cpu")
    test_.colDeltaCorpartial(emat, dmat, ixs, device="cpu")
    assert (kernels.dense_launches, kernels.partial_launches) == (0, 0)


# --- the re-exported fits ------------------------------------------------

def _fit_inputs():
    rng = np.random.RandomState(8)
    X = rng.gamma(2.0, 1.0, (40, 150))
    Y = 0.4 * X + rng.rand(40, 150)
    Y[3] *= 4.0                       # unspliced above spliced: caps bind
    X[5] = 0.0                        # no spliced signal: NaN slope
    Y[6] = 0.0                        # no unspliced signal: slope 0
    W = (rng.rand(40, 150) > 0.4).astype(np.float64)
    return Y, X, W


FITS = {
    "fit_slope": lambda m, Y, X, W, **k: m.fit_slope(Y, X, **k),
    "fit_slope_weighted": lambda m, Y, X, W, **k: m.fit_slope_weighted(
        Y, X, W, return_R2=True, **k),
    "fit_slope_weighted_bounds": lambda m, Y, X, W, **k:
        m.fit_slope_weighted(Y, X, W, bounds=(0.1, 0.35), **k),
    "fit_slope_weighted_limit": lambda m, Y, X, W, **k:
        m.fit_slope_weighted(Y, X, W, return_R2=True, limit_gamma=True, **k),
    "fit_slope_offset": lambda m, Y, X, W, **k: m.fit_slope_offset(Y, X, **k),
    "fit_slope_offset_fixperc": lambda m, Y, X, W, **k: m.fit_slope_offset(
        Y, X, fixperc_q=True, **k),
    "fit_slope_weighted_offset_fixperc": lambda m, Y, X, W, **k:
        m.fit_slope_weighted_offset(Y, X, W, fixperc_q=True,
                                    return_R2=False, **k),
}


@pytest.mark.parametrize("fit", list(FITS))
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_reexported_fit_matches_jax(fit, as_tensor):
    Y, X, W = _fit_inputs()
    args = [torch.as_tensor(M) for M in (Y, X, W)] if as_tensor \
        else [Y, X, W]
    got = FITS[fit](test_, *args, device="cpu")
    want = FITS[fit](jgamma, Y, X, W)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, **GAMMA_TOL)


def test_clusters_stats_matches_jax():
    rng = np.random.RandomState(2)
    U, S = rng.rand(2, 30, 200)
    ix = rng.randint(0, 5, 200)
    ix[ix == 4] = 3                               # cluster 4 empty
    ix[:10] = 4                                   # ... then small
    got = test_.clusters_stats(U, S, np.arange(5), ix, size_limit=20)
    for a, b in zip(got, jgamma.clusters_stats(U, S, np.arange(5), ix,
                                               size_limit=20)):
        np.testing.assert_array_equal(a, b)


# --- kNN estimators -------------------------------------------------------

@pytest.mark.parametrize("mode", ["distance", "connectivity"])
def test_balanced_knn_estimator_matches_jax(mode):
    rng = np.random.RandomState(6)
    x = rng.randn(90, 5)
    kw = dict(k=6, sight_k=20, maxl=9, mode=mode)
    port = vtt.BalancedKNN(device="cpu", **kw).fit(x)
    ref = jknn.BalancedKNN(**kw).fit(x)
    a = port.kneighbors_graph(mode=mode)
    b = ref.kneighbors_graph(mode=mode)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.data, b.data, rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(port.dsi, ref.dsi)
    data = rng.rand(90, 4)
    np.testing.assert_allclose(port.smooth_data(data, mutual=True),
                               ref.smooth_data(data, mutual=True))


@pytest.mark.parametrize("metric", ["euclidean", "correlation"])
def test_mutual_knn_utilities_match_jax(metric):
    rng = np.random.RandomState(7)
    m = rng.rand(12, 70)
    a = tknn.knn_distance_matrix(m.T, metric=metric, k=8, mode="distance",
                                 device="cpu")
    b = jknn.knn_distance_matrix(m.T, metric=metric, k=8, mode="distance")
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.data, b.data, rtol=1e-12, atol=1e-15)
    w_a, knn_a = tknn.knn_smooth_weights(m, metric=metric, k_search=8,
                                         k_mutual=4, device="cpu")
    w_b, _ = jknn.knn_smooth_weights(m, metric=metric, k_search=8,
                                     k_mutual=4)
    np.testing.assert_allclose(w_a.toarray(), w_b.toarray(), rtol=1e-12)
    top = tknn.take_top(tknn.make_mutual(a), 3)
    assert all(len(r) <= 3 for r in top.rows)


# --- velocity_step ------------------------------------------------------

# velocity_step against the JAX package: the pipeline's stage tolerances,
# except that delta_embedding sums unit vectors weighted by the
# probabilities, so it carries their absolute error (exp(corr / 0.05)
# scales the correlations' 1e-4) unscaled: atol 1e-4, not 1e-5
OUT_TOL = {"gammas": GAMMA_TOL, "q": GAMMA_TOL,
           "velocity": dict(rtol=1e-4, atol=1e-4),
           "corr": dict(rtol=1e-3, atol=1e-4),
           "transition_prob": dict(rtol=1e-3, atol=1e-6),
           "delta_embedding": dict(rtol=1e-3, atol=1e-4)}


def _assert_outputs_match(got, want):
    for name in tvel.VelocityOutputs._fields:
        a = getattr(got, name)
        assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **OUT_TOL[name])


def test_example_inputs_equal_jax():
    for a, b in zip(tvel.example_inputs(g=32, n=64, device="cpu"),
                    jvel.example_inputs(g=32, n=64)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_velocity_step_matches_jax_on_example_inputs():
    args = tvel.example_inputs(g=64, n=128, k=8, nn=16, d=2, device="cpu")
    kernels.reset_counts()
    got = tvel.velocity_step(*args)
    assert kernels.partial_launches == 0          # plain version on the CPU
    _assert_outputs_match(got, jvel.velocity_step_jit(
        *(jnp.asarray(a.numpy()) for a in args)))


def _chain(mod, S, U, **extra):
    """test_velocity_model.py's step-by-step chain."""
    n, g = S.shape[1], S.shape[0]
    v = mod.VelocytoLoom.__new__(mod.VelocytoLoom)
    for name, value in extra.items():
        setattr(v, name, value)
    v.S, v.U, v.A = S.copy(), U.copy(), np.zeros_like(S)
    v.initial_cell_size = S.sum(0)
    v.initial_Ucell_size = U.sum(0)
    v.ca = {"CellID": np.array([f"c{i}" for i in range(n)])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(g)])}
    v._normalize_S(relative_size=v.initial_cell_size,
                   target_size=np.mean(v.initial_cell_size))
    v._normalize_U(relative_size=v.initial_Ucell_size,
                   target_size=np.mean(v.initial_Ucell_size))
    v.S_norm = np.log2(v.S_sz + 1)
    v.perform_PCA(which="S_norm", n_components=10)
    v.knn_imputation(k=8, balanced=False, n_jobs=1)
    v.fit_gammas(weighted=True, weights="maxmin", fit_offset=True,
                 limit_gamma=False)
    v.predict_U()
    v.calculate_velocity()
    v.calculate_shift(assumption="constant_velocity")
    v.extrapolate_cell_at_t(delta_t=1.)
    v.ts = np.ascontiguousarray(v.pcs[:, :2])
    v.estimate_transition_prob(hidim="Sx_sz", embed="ts", transform="sqrt",
                               knn_random=True, sampled_fraction=0.5,
                               calculate_randomized=False)
    v.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=False)
    nbr_idx, nbr_w = csr_to_compact(sparse.csr_matrix(v.knn_smoothing_w))
    knn = sparse.csr_matrix(v.embedding_knn)
    nn = int(np.diff(knn.indptr)[0])
    sample_ixs = knn.indices.reshape(n, nn).astype(np.int32)
    return v, (v.S_sz, v.U_sz, nbr_idx, nbr_w, v.ts, sample_ixs)


@pytest.fixture(scope="module")
def chains():
    rng = np.random.default_rng(3)
    n, g = 96, 48
    gamma_true = rng.uniform(0.2, 1.2, g)
    base = rng.gamma(2.0, 2.0, (g, n))
    S = rng.poisson(base).astype(np.float32)
    U = rng.poisson(0.4 * gamma_true[:, None] * base + 0.1).astype(np.float32)
    return {"jax": _chain(vt, S, U),
            "port": _chain(vtt, S, U, device=torch.device("cpu"))}


def _torch_args(inputs):
    S_sz, U_sz, nbr_idx, nbr_w, ts, sample_ixs = inputs
    f32 = torch.float32
    return (torch.as_tensor(S_sz, dtype=f32), torch.as_tensor(U_sz, dtype=f32),
            torch.as_tensor(nbr_idx, dtype=torch.int32),
            torch.as_tensor(nbr_w, dtype=f32), torch.as_tensor(ts, dtype=f32),
            torch.as_tensor(sample_ixs, dtype=torch.int32))


def test_velocity_step_matches_jax_velocity_step_jit(chains):
    _v, inputs = chains["jax"]
    got = tvel.velocity_step(*_torch_args(inputs))
    want = jvel.velocity_step_jit(*(jnp.asarray(a.numpy())
                                    for a in _torch_args(inputs)))
    _assert_outputs_match(got, want)


def test_velocity_step_matches_the_port_chain(chains):
    """test_velocity_model.py::test_velocity_step_matches_chain on the
    port, at its tolerances."""
    v, inputs = chains["port"]
    out = tvel.velocity_step(*_torch_args(inputs))
    np.testing.assert_allclose(out.gammas.numpy(), v.gammas, rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(out.q.numpy(), v.q, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(out.velocity.numpy(), v.velocity, rtol=2e-3,
                               atol=2e-2)
    n = v.S.shape[1]
    sample_ixs = inputs[5]
    rows = np.arange(n)[:, None]
    np.testing.assert_allclose(out.corr.numpy(), v.corrcoef[rows, sample_ixs],
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(out.transition_prob.numpy(),
                               v.transition_prob[rows, sample_ixs],
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(out.delta_embedding.numpy(), v.delta_embedding,
                               rtol=2e-3, atol=2e-4)
    # the sampled positions are the chain's, in its order, and its own
    # compact softmax agrees too
    np.testing.assert_array_equal(sample_ixs, v._compact_ixs)
    np.testing.assert_allclose(
        tanalysis._compact_softmax(v._corr_dev, 0.05).numpy(),
        out.transition_prob.numpy(), rtol=2e-3, atol=2e-4)
