"""The port's Markov diffusion (velocyto_tpu_torch.Diffusion and
VelocytoLoom.prepare_markov / run_markov on the CPU) against the JAX
package, test_aux.py's checks and the reference goldens.

Inputs: numpy arrays from a seed (test_aux.py's), and
tests/golden/golden.npz through test_golden.py's calls.  Tolerances:
the transition matrices are float64 on both sides (1e-12, or 1e-6 where
the inputs are float32 stage outputs); path_integral / time_evolution
are float32 matrix-vector loops summed in another order (rtol 1e-4);
map_trajectory, frontier and trajectory walk on the host and are equal;
goldens at test_golden.py's tolerances."""
import numpy as np
import pytest
import torch
from scipy import sparse
from scipy.stats import norm as _norm

import velocyto_tpu as vt

import velocyto_tpu_torch as vtt

from test_torch_pipeline import CPU, GOLDEN, _fresh, _front

MODES = ["path_integral", "time_evolution", "map_trajectory", "frontier",
         "trajectory"]


@pytest.fixture
def diffusion_setup():
    rng = np.random.RandomState(0)
    n = 40
    emb = rng.randn(n, 2)
    delta = rng.randn(n, 2) * 0.1
    return emb, delta


@pytest.mark.parametrize("reverse", [False, True])
def test_transition_matrix2_matches_jax(diffusion_setup, reverse):
    emb, delta = diffusion_setup
    tr = vtt.Diffusion("cpu").compute_transition_matrix2(
        emb, delta, sigma=0.5, reverse=reverse)
    want = vt.Diffusion().compute_transition_matrix2(emb, delta, sigma=0.5,
                                                     reverse=reverse)
    np.testing.assert_allclose(np.asarray(tr.sum(1)).ravel(), 1.0, atol=1e-6)
    np.testing.assert_allclose(tr.toarray(), want.toarray(), rtol=1e-12,
                               atol=1e-15)


def test_transition_matrix2_large_n_matches_dense():
    """test_aux.py's N > 4096 case: the device query path picks the same
    20-NN sets and probabilities as the dense host oracle that
    test_aux.py holds the JAX package to."""
    rng = np.random.RandomState(3)
    n = 5000
    emb = rng.randn(n, 2)
    delta = rng.randn(n, 2) * 0.1
    tr = vtt.Diffusion("cpu").compute_transition_matrix2(emb, delta,
                                                         sigma=0.5)
    assert tr.shape == (n, n)
    np.testing.assert_allclose(np.asarray(tr.sum(1)).ravel(), 1.0, atol=1e-6)
    x1 = emb + delta
    for r in rng.choice(n, 40, replace=False):
        dists = np.linalg.norm(x1[r][None, :] - emb, axis=-1)
        nearest = np.argsort(dists)[:20]
        probs = _norm.pdf(dists[nearest], 0, 0.5)
        want = np.zeros(n)
        want[nearest] = probs / np.abs(probs).sum()
        np.testing.assert_allclose(np.asarray(tr[r].todense()).ravel(), want,
                                   atol=1e-9)


@pytest.mark.parametrize("reverse,epsilon", [(False, 0.0), (True, 0.05)])
def test_transition_matrix_on_knn_matches_jax(diffusion_setup, reverse,
                                              epsilon):
    emb, delta = diffusion_setup
    knn = vtt.knn_distance_matrix(emb, k=6, device="cpu")
    tr = vtt.Diffusion("cpu").compute_transition_matrix(
        knn, emb, delta, epsilon=epsilon, reverse=reverse)
    want = vt.Diffusion().compute_transition_matrix(
        knn, emb, delta, epsilon=epsilon, reverse=reverse)
    np.testing.assert_allclose(tr.toarray(), want.toarray(), rtol=1e-12)


@pytest.mark.parametrize("tr_form", ["csr", "dense", "tensor"])
@pytest.mark.parametrize("mode", MODES)
def test_diffuse_modes_match_jax(diffusion_setup, mode, tr_form):
    emb, delta = diffusion_setup
    tr = vt.Diffusion().compute_transition_matrix2(emb, delta, sigma=0.5)
    x0 = np.zeros(emb.shape[0])
    x0[0] = 1.0
    if mode == "trajectory":
        x0 = np.full(emb.shape[0], 1.0 / emb.shape[0])
    given = {"csr": tr, "dense": tr.toarray(),
             "tensor": torch.as_tensor(tr.toarray())}[tr_form]
    np.random.seed(11)
    got = vtt.Diffusion("cpu").diffuse(x0, given, n_steps=25, mode=mode)
    np.random.seed(11)
    want = vt.Diffusion().diffuse(x0, tr, n_steps=25, mode=mode)
    if mode in ("path_integral", "time_evolution"):
        assert got.shape == (1, emb.shape[0])
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-7)
        if mode == "time_evolution":
            np.testing.assert_allclose(got.sum(), 1.0, atol=1e-4)
    else:
        assert isinstance(got, list) and len(got) == 26
        assert got == list(want)


def test_diffuse_rejects_unknown_mode(diffusion_setup):
    emb, delta = diffusion_setup
    tr = vtt.Diffusion("cpu").compute_transition_matrix2(emb, delta, 0.5)
    with pytest.raises(NotImplementedError):
        vtt.Diffusion("cpu").diffuse(np.ones(40), tr, mode="teleport")


# --- prepare_markov / run_markov ---------------------------------------

def _sampled_session(mod, golden, **extra):
    """test_golden.py's state before its Markov test: the full-mode
    chain, then the sampled transition probabilities."""
    v = _fresh(mod, golden, **extra)
    _front(v, balanced=False)
    v.gammas, v.q = golden["gammas"].copy(), golden["q"].copy()
    v.predict_U()
    v.calculate_velocity()
    v.calculate_shift(assumption="constant_velocity")
    v.extrapolate_cell_at_t(delta_t=1.)
    v.ts = golden["ts"].copy()
    v.estimate_transition_prob(hidim="Sx_sz", embed="ts", transform="sqrt",
                               knn_random=True, sampled_fraction=0.5,
                               calculate_randomized=False)
    v.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=False)
    return v


@pytest.fixture(scope="module")
def sessions():
    golden = np.load(GOLDEN)
    return {"golden": golden, "jax": _sampled_session(vt, golden),
            "port": _sampled_session(vtt, golden, device=CPU)}


def test_markov_matches_golden_and_jax(sessions):
    """test_golden.py::test_markov_matches_reference's calls.  The port
    builds tr on the device from the compact sampled state, with no
    dense transition_prob on the host, and hands out the csr view only
    when .tr is read."""
    golden, jax_v, port = (sessions[k] for k in ("golden", "jax", "port"))
    out = {}
    for tag, v in (("jax", jax_v), ("port", port)):
        v.prepare_markov(sigma_D=np.std(v.ts), sigma_W=0.5 * np.std(v.ts),
                         direction="forward")
        if tag == "port":
            assert "transition_prob" not in v.__dict__
            tr = v._table()["tr"]
            assert "tr" not in v.__dict__ and tr.view is None
            tr_dev = v._get_dev("tr", None)
            assert tr_dev.dtype == torch.float64
            np.testing.assert_allclose(tr_dev.sum(1).numpy(), 1.0,
                                       rtol=1e-12)
            v.run_markov(n_steps=500)
            assert tr.view is None
        else:
            v.run_markov(n_steps=500)
        assert sparse.issparse(v.tr)
        out[tag] = (v.tr.toarray(), np.asarray(v.diffused).ravel())
    tr, diffused = out["port"]
    np.testing.assert_allclose(tr, golden["markov_tr"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(diffused, golden["markov_diffused"].ravel(),
                               rtol=1e-3, atol=1e-6)
    # the sampled correlations agree to float32 tolerance, which
    # exp(corr / 0.05) carries into tr (test_golden.py's tr tolerance)
    np.testing.assert_allclose(tr, out["jax"][0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(diffused, out["jax"][1], rtol=1e-3,
                               atol=1e-6)


def _markov_pair(sessions):
    """The JAX session, and a port object started from its
    transition_prob and embedding: tr is then float64 arithmetic on the
    same numbers."""
    jax_v = sessions["jax"]
    port = vtt.state_from_numpy({"transition_prob": jax_v.transition_prob,
                                 "embedding": jax_v.embedding}, "cpu")
    return {"jax": jax_v, "port": port}


@pytest.mark.parametrize("direction,subset,mode", [
    ("backwards", False, "time_evolution"),
    ("forward", True, "path_integral"),
    ("backwards", True, "map_trajectory")])
def test_markov_variants_match_jax(sessions, direction, subset, mode):
    cells = np.arange(0, 120, 2)[::-1] if subset else None
    got = {}
    for tag, v in _markov_pair(sessions).items():
        v.prepare_markov(sigma_D=1.0, sigma_W=0.5, direction=direction,
                         cells_ixs=cells)
        v.run_markov(n_steps=40, mode=mode,
                     starting_p=np.linspace(1, 2, 60 if subset else 120))
        got[tag] = (v.tr.toarray(), v.diffused)
    np.testing.assert_allclose(got["port"][0], got["jax"][0], rtol=1e-12,
                               atol=1e-15)
    if mode == "map_trajectory":
        assert got["port"][1] == got["jax"][1]
    else:
        np.testing.assert_allclose(got["port"][1], got["jax"][1], rtol=1e-4,
                                   atol=1e-9)


def test_markov_reads_an_edited_transition_prob(sessions):
    """A transition_prob the caller read and edited reaches
    prepare_markov, as it does in the JAX package."""
    got = {}
    for tag in ("jax", "port"):
        v = sessions[tag]
        v.prepare_markov(sigma_D=1.0, sigma_W=0.5)
        before = v.tr.toarray()
        v.transition_prob[:, :10] = 0.0
        v.prepare_markov(sigma_D=1.0, sigma_W=0.5)
        got[tag] = v.tr.toarray()
        del v.transition_prob              # back to the untouched state
        assert np.abs(got[tag] - before).max() > 1e-2
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-4, atol=1e-6)


def test_run_markov_on_a_tr_from_the_jax_package(sessions):
    jax_v = sessions["jax"]
    jax_v.prepare_markov(sigma_D=1.0, sigma_W=0.5)
    jax_v.run_markov(n_steps=100)
    port = vtt.state_from_numpy({"tr": jax_v.tr}, "cpu")
    assert port._get_dev("tr", None).dtype == torch.float64
    port.run_markov(n_steps=100)
    np.testing.assert_allclose(port.diffused, jax_v.diffused, rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(port.tr.toarray(), jax_v.tr.toarray(),
                               rtol=0, atol=0)


def test_prepare_markov_rejects_unknown_direction(sessions):
    with pytest.raises(NotImplementedError):
        sessions["port"].prepare_markov(1.0, 0.5, direction="sideways")
