"""The port's estimation pipeline (velocyto_tpu_torch.VelocytoLoom on the
CPU) against the JAX package and against the reference goldens.

The inputs are tests/golden/golden.npz, fed to both packages with the
same calls as test_golden.py.  Stage-alone tests start a port stage from
the JAX package's state (state_from_numpy) and compare that stage only.
Tolerances: normalize/PCA 1e-5 relative; kNN graphs exact; smoothing
1e-4 (f32 sums in another order); gamma fits rtol 1e-4 / atol 1e-5 (f32
closed forms on both sides); velocity chain 1e-5; correlations rtol 1e-3
/ atol 1e-4 (f32 moment cancellation); transition probabilities and
embedding shifts at test_golden.py's tolerances."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import velocyto_tpu as vt
from velocyto_tpu.ops import gamma as jgamma
from velocyto_tpu.ops import knn as jknn
from velocyto_tpu.ops import knn_device as jkd

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch.ops import gamma as tgamma
from velocyto_tpu_torch.ops import knn as tknn
from velocyto_tpu_torch.ops import knn_device as tkd

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _fresh(mod, golden, **extra):
    v = mod.VelocytoLoom.__new__(mod.VelocytoLoom)
    for name, value in extra.items():
        setattr(v, name, value)
    v.S = golden["S"].copy()
    v.U = golden["U"].copy()
    v.A = np.zeros_like(v.S)
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    n, g = v.S.shape[1], v.S.shape[0]
    v.ca = {"CellID": np.array([f"c{i}" for i in range(n)])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(g)])}
    return v


def _front(v, balanced):
    v._normalize_S(relative_size=v.initial_cell_size,
                   target_size=np.mean(v.initial_cell_size))
    v._normalize_U(relative_size=v.initial_Ucell_size,
                   target_size=np.mean(v.initial_Ucell_size))
    v.S_norm = np.log2(v.S_sz + 1)
    v.perform_PCA(which="S_norm", n_components=20)
    if balanced:
        v.knn_imputation(k=10, balanced=True, b_sight=30, b_maxl=15,
                         n_jobs=1)
    else:
        v.knn_imputation(k=10, balanced=False, n_jobs=1, metric="euclidean")


def _pipeline(v, golden):
    """test_golden.py's calls, in its order; returns each stage's output."""
    out = {}
    _front(v, balanced=False)
    out.update(S_sz=v.S_sz, U_sz=v.U_sz, pcs=v.pcs,
               pca_explained=v.pca.explained_variance_ratio_[:20],
               knn=v.knn, Sx=v.Sx, Ux=v.Ux)
    v.fit_gammas(limit_gamma=False, fit_offset=True, use_imputed_data=True,
                 use_size_norm=True, weighted=True, weights="maxmin_diag")
    out.update(gammas=v.gammas, q=v.q, R2=v.R2)
    v.gammas = golden["gammas"].copy()
    v.q = golden["q"].copy()
    v.predict_U()
    v.calculate_velocity()
    v.calculate_shift(assumption="constant_velocity")
    v.extrapolate_cell_at_t(delta_t=1.)
    out.update(Upred=v.Upred, velocity=v.velocity, delta_S=v.delta_S,
               Sx_sz_t=v.Sx_sz_t)
    v.ts = golden["ts"].copy()
    v.estimate_transition_prob(hidim="Sx_sz", embed="ts", transform="sqrt",
                               knn_random=False, calculate_randomized=True)
    out.update(corrcoef=v.corrcoef, corrcoef_random=v.corrcoef_random,
               embedding_knn=v.embedding_knn)
    v.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=False)
    out.update(transition_prob=v.transition_prob,
               transition_prob_random=v.transition_prob_random,
               delta_embedding=v.delta_embedding,
               delta_embedding_random=v.delta_embedding_random)
    v.calculate_grid_arrows(smooth=0.5, steps=(10, 10), n_neighbors=20)
    out.update(flow_grid=v.flow_grid, flow=v.flow, flow_rndm=v.flow_rndm)
    v.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=True,
                                scaling_penalty=1.)
    out.update(scaling=v.scaling, delta_embedding_scaled=v.delta_embedding)
    return out


@pytest.fixture(scope="module")
def runs(golden):
    jax_v = _fresh(vt, golden)
    port_v = _fresh(vtt, golden, device=CPU)
    return {"jax": _pipeline(jax_v, golden), "port": _pipeline(port_v, golden),
            "jax_v": jax_v, "port_v": port_v}


@pytest.fixture(scope="module")
def balanced_runs(golden):
    out = {}
    for tag, v in (("jax", _fresh(vt, golden)),
                   ("port", _fresh(vtt, golden, device=CPU))):
        _front(v, balanced=True)
        out[tag] = v
    return out


# (stage output, rtol, atol) of the port against the JAX package
AGAINST_JAX = [
    ("S_sz", 1e-5, 0), ("U_sz", 1e-5, 0), ("pcs", 1e-5, 0),
    ("pca_explained", 1e-5, 0),
    ("Sx", 1e-4, 1e-4), ("Ux", 1e-4, 1e-4),
    ("gammas", 1e-4, 1e-5), ("q", 1e-4, 1e-5), ("R2", 1e-4, 1e-5),
    ("Upred", 1e-5, 1e-5), ("velocity", 1e-5, 1e-5),
    ("delta_S", 1e-5, 1e-5), ("Sx_sz_t", 1e-5, 1e-5),
    ("corrcoef", 1e-3, 1e-4), ("corrcoef_random", 1e-3, 1e-4),
    ("transition_prob", 1e-3, 1e-6), ("transition_prob_random", 1e-3, 1e-6),
    ("delta_embedding", 1e-3, 1e-5), ("delta_embedding_random", 1e-3, 1e-5),
    ("flow_grid", 1e-4, 1e-6), ("flow", 1e-3, 1e-5), ("flow_rndm", 1e-3, 1e-5),
    ("scaling", 1e-3, 1e-5), ("delta_embedding_scaled", 1e-3, 1e-5),
]

# (stage output, golden key, rtol, atol): test_golden.py's tolerances
AGAINST_GOLDEN = [
    ("S_sz", "S_sz", 1e-5, 0), ("U_sz", "U_sz", 1e-5, 0),
    ("pca_explained", "pca_explained", 1e-4, 1e-7),
    ("Sx", "Sx", 1e-4, 1e-4), ("Ux", "Ux", 1e-4, 1e-4),
    ("gammas", "gammas", 2e-2, 2e-3), ("q", "q", 5e-2, 2e-2),
    ("Upred", "Upred", 1e-5, 1e-5), ("velocity", "velocity", 1e-5, 1e-5),
    ("delta_S", "delta_S", 1e-5, 1e-5), ("Sx_sz_t", "Sx_sz_t", 1e-5, 1e-5),
    ("corrcoef", "corrcoef", 1e-3, 1e-4),
    ("transition_prob", "transition_prob", 1e-3, 1e-6),
    ("delta_embedding", "delta_embedding", 1e-3, 1e-5),
    ("flow_grid", "flow_grid", 1e-4, 1e-6), ("flow", "flow", 1e-3, 1e-5),
    ("scaling", "scaling", 1e-3, 1e-5),
    ("delta_embedding_scaled", "delta_embedding_scaled", 1e-3, 1e-5),
]


@pytest.mark.parametrize("name,rtol,atol", AGAINST_JAX,
                         ids=[c[0] for c in AGAINST_JAX])
def test_stage_matches_jax(runs, name, rtol, atol):
    np.testing.assert_allclose(runs["port"][name], runs["jax"][name],
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,key,rtol,atol", AGAINST_GOLDEN,
                         ids=[c[0] for c in AGAINST_GOLDEN])
def test_stage_matches_golden(runs, golden, name, key, rtol, atol):
    np.testing.assert_allclose(runs["port"][name], golden[key],
                               rtol=rtol, atol=atol)


def _assert_same_graph(a, b):
    a, b = a.tocsr(), b.tocsr()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    # f64 distances: the same diff-form sum, possibly in another order
    np.testing.assert_allclose(a.data, b.data, rtol=1e-12, atol=1e-12)


def test_plain_knn_graph_equals_jax(runs):
    _assert_same_graph(runs["port"]["knn"], runs["jax"]["knn"])


def test_embedding_knn_equals_jax(runs):
    a, b = runs["port"]["embedding_knn"], runs["jax"]["embedding_knn"]
    np.testing.assert_array_equal(a.toarray(), b.toarray())


def test_balanced_knn_graph_equals_jax_and_golden(balanced_runs, golden):
    port, jax_v = balanced_runs["port"], balanced_runs["jax"]
    _assert_same_graph(port.knn, jax_v.knn)
    np.testing.assert_array_equal(port.knn.toarray() > 0,
                                  golden["bal_knn"] > 0)
    np.testing.assert_allclose(port.knn_smoothing_w.toarray(),
                               jax_v.knn_smoothing_w.toarray(), rtol=1e-12)


@pytest.mark.parametrize("name", ["Sx", "Ux"])
def test_balanced_smoothing_matches_jax_and_golden(balanced_runs, golden,
                                                   name):
    got = getattr(balanced_runs["port"], name)
    np.testing.assert_allclose(got, getattr(balanced_runs["jax"], name),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, golden["bal_" + name], rtol=1e-4,
                               atol=1e-4)


def _candidate_table(rng, n, sight):
    """Random (n, sight) candidate rows of distinct cells with the row's
    own cell somewhere in most rows (as a kNN search returns it), and
    ascending distances."""
    dsi = np.stack([rng.permutation(n)[:sight] for _ in range(n)])
    for i in range(n):
        if rng.rand() < 0.8 and i not in dsi[i]:
            dsi[i, rng.randint(sight)] = i
    dist = np.sort(rng.rand(n, sight), axis=1)
    return dsi.astype(np.int64), dist


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["plain", "constrained"])
@pytest.mark.parametrize("return_distance", [True, False])
def test_balance_knn_loop_matches_jax_host(constrained, return_distance):
    rng = np.random.RandomState(7)
    n, sight, k, maxl = 60, 9, 5, 4          # small maxl: sights exhaust
    dsi, dist = _candidate_table(rng, n, sight)
    lsi = np.argsort(np.bincount(dsi.ravel(), minlength=n),
                     kind="mergesort")[::-1]
    cst = rng.randint(0, 3, n).astype(np.int64) if constrained else None
    got = tknn.balance_knn_loop(dsi, dist, lsi, maxl, k, return_distance,
                                cst)
    want = jknn.balance_knn_loop(dsi, dist, lsi, maxl, k, return_distance,
                                 cst)
    assert np.any(got[1][:, 1:] == np.arange(n)[:, None])   # self-filled
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_knn_balance_wrapper_matches_jax():
    rng = np.random.RandomState(11)
    dsi, dist = _candidate_table(rng, 80, 12)
    for d, k in ((dist, 7), (None, 7), (dist, 0)):
        got = tknn.knn_balance(dsi, d, maxl=6, k=k)
        want = jknn.knn_balance(dsi, d, maxl=6, k=k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric", ["euclidean", "correlation"])
def test_knn_search_dev_matches_jax(metric):
    rng = np.random.RandomState(3)
    x = rng.randn(150, 6)
    x[10] = x[20]                         # an exact tie
    x[30] = x[20]
    d_t, i_t = tkd.knn_search_dev(x, 17, metric=metric, device=CPU)
    d_j, i_j = jkd.knn_search_dev(x, 17, metric=metric)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-12,
                               atol=1e-12)


def test_knn_query_matches_jax():
    rng = np.random.RandomState(5)
    data, query = rng.randn(200, 2), rng.randn(37, 2)
    d_t, i_t = tknn._knn_query_impl(data, query, 15, CPU)
    d_j, i_j = jknn._knn_query_impl(data, query, 15)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-12)


@pytest.mark.parametrize("scheme", ["sum", "prod", "maxmin_weighted",
                                    "maxmin", "maxmin_diag",
                                    "maxmin_double"])
def test_fit_weights_match_jax(scheme):
    rng = np.random.RandomState(2)
    S, U = rng.gamma(2.0, 1.0, (2, 30, 90)).astype(np.float32)
    Sx, Ux = (M + rng.rand(30, 90).astype(np.float32) for M in (S, U))
    got = tgamma.compute_fit_weights(
        scheme, *(torch.from_numpy(M) for M in (S, U, Sx, Ux)))
    want = jgamma.compute_fit_weights(scheme, S, U, Sx, Ux)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("fixperc_q,limit_gamma",
                         [(False, False), (False, True), (True, False)])
def test_fit_slope_weighted_offset_matches_jax(fixperc_q, limit_gamma):
    rng = np.random.RandomState(4)
    X = rng.gamma(2.0, 1.0, (40, 120)).astype(np.float32)
    Y = (0.4 * X + rng.rand(40, 120)).astype(np.float32)
    Y[3] *= 4.0                       # unspliced above spliced: cap binds
    X[5] = 0.0                        # no spliced signal: NaN slope
    W = (rng.rand(40, 120) > 0.5).astype(np.float32)
    got = tgamma.fit_slope_weighted_offset(
        *(torch.from_numpy(M) for M in (Y, X, W)), fixperc_q=fixperc_q,
        return_R2=True, limit_gamma=limit_gamma)
    want = jgamma.fit_slope_weighted_offset(Y, X, W, fixperc_q=fixperc_q,
                                            return_R2=True,
                                            limit_gamma=limit_gamma)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# --- stage-alone: a port stage started from the JAX package's state ---

def test_fit_gammas_from_jax_state(runs):
    jax_v = runs["jax_v"]
    port = vtt.state_from_numpy(
        {n: getattr(jax_v, n) for n in ("S", "U", "Sx", "Ux", "Sx_sz",
                                        "Ux_sz")}, "cpu")
    port.fit_gammas()
    for name in ("gammas", "q", "R2"):
        np.testing.assert_allclose(getattr(port, name),
                                   runs["jax"][name], rtol=1e-4, atol=1e-5)


def test_transition_prob_from_jax_state(runs):
    """Same input state: the randomized control's permutation is
    bit-identical, the correlations agree to f32 tolerance."""
    jax_v = runs["jax_v"]
    attrs = {n: getattr(jax_v, n) for n in ("S", "Sx_sz", "delta_S", "ts",
                                            "used_delta_t")}
    port = vtt.state_from_numpy(attrs, "cpu")
    port.estimate_transition_prob(hidim="Sx_sz", embed="ts",
                                  transform="sqrt", knn_random=False,
                                  calculate_randomized=True)
    np.testing.assert_array_equal(port.delta_S_rndm, jax_v.delta_S_rndm)
    for name in ("corrcoef", "corrcoef_random"):
        np.testing.assert_allclose(getattr(port, name), runs["jax"][name],
                                   rtol=1e-3, atol=1e-4)


def test_embedding_shift_from_jax_state(runs):
    jax_v = runs["jax_v"]
    names = ("corrcoef", "corrcoef_random", "embedding_knn", "embedding",
             "corr_calc", "which_hidim", "Sx_sz", "delta_S", "delta_S_rndm")
    port = vtt.state_from_numpy({n: getattr(jax_v, n) for n in names}, "cpu")
    port.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=True)
    np.testing.assert_allclose(port.transition_prob, jax_v.transition_prob,
                               rtol=1e-3, atol=1e-6)
    for name in ("delta_embedding", "delta_embedding_random", "scaling",
                 "scaling_rndm"):
        np.testing.assert_allclose(getattr(port, name), getattr(jax_v, name),
                                   rtol=1e-3, atol=1e-5)


def test_state_from_numpy_round_trips(runs):
    jax_v = runs["jax_v"]
    names = ("S", "U", "ca", "ra", "Sx_sz", "Ux_sz", "gammas", "q",
             "delta_S", "ts")
    attrs = {n: getattr(jax_v, n) for n in names}
    port = vtt.state_from_numpy(attrs, "cpu")
    assert port.device == CPU
    for n in names:
        if isinstance(attrs[n], dict):
            assert port.__dict__[n] is attrs[n]
        else:
            np.testing.assert_array_equal(getattr(port, n), attrs[n])
    # a device-backed stage output reads back as numpy and seeds an
    # identical second object
    port.predict_U()
    again = vtt.state_from_numpy({"Upred": port.Upred}, "cpu")
    np.testing.assert_array_equal(again._get_dev("Upred").numpy(),
                                  port._get_dev("Upred").numpy())


def test_loom_opens_through_port(tmp_path, golden):
    path = str(tmp_path / "t.loom")
    S, U = golden["S"], golden["U"]
    n, g = S.shape[1], S.shape[0]
    vt.io.loom.create(path, {"": S, "spliced": S, "unspliced": U,
                             "ambiguous": np.zeros_like(S)},
                      {"Gene": np.array([f"g{i}" for i in range(g)])},
                      {"CellID": np.array([f"c{i}" for i in range(n)])})
    port = vtt.VelocytoLoom(path, device="cpu")
    ref = vt.VelocytoLoom(path)
    assert port.device == CPU
    for name in ("S", "U", "A", "initial_cell_size"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    assert list(port.ra["Gene"]) == list(ref.ra["Gene"])
    assert list(port.ca["CellID"]) == list(ref.ca["CellID"])


JAX_FREE = r"""
import sys
sys.modules["jax"] = None                 # any jax import now fails
import numpy as np
import velocyto_tpu_torch as vtt
assert "velocyto_tpu" not in sys.modules
rng = np.random.RandomState(0)
g, n = 30, 70
base = rng.gamma(2.0, 1.0, (n, 4)) @ rng.gamma(2.0, 1.0, (4, g))
v = vtt.VelocytoLoom.__new__(vtt.VelocytoLoom)
v.device = "cpu"
v.S = rng.poisson(base).astype(np.float32).T
v.U = rng.poisson(0.3 * base.T + 0.05).astype(np.float32)
v._normalize_S()
v._normalize_U()
v.perform_PCA(n_components=10)
v.knn_imputation(k=6, balanced=True, b_sight=20, b_maxl=12)
v.fit_gammas()
v.predict_U(); v.calculate_velocity(); v.calculate_shift()
v.extrapolate_cell_at_t(delta_t=1.)
v.ts = v.pcs[:, :2]
v.estimate_transition_prob(hidim="Sx_sz", embed="ts", knn_random=False,
                           n_neighbors=20)
v.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=False)
v.calculate_grid_arrows(smooth=0.5, steps=(6, 6), n_neighbors=10)
assert np.isfinite(v.delta_embedding).all() and np.isfinite(v.flow).all()
assert v.corrcoef.shape == (n, n)
v.estimate_transition_prob(hidim="Sx_sz", embed="ts", knn_random=True,
                           n_neighbors=20, sampled_fraction=0.5)
v.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=True)
v.calculate_grid_arrows(smooth=0.5, steps=(6, 6), n_neighbors=10)
assert v.sampling_ixs.shape == (n, 10) and v._corr_dev.shape == (n, 10)
assert np.isfinite(v.delta_embedding).all() and np.isfinite(v.flow).all()
assert np.isfinite(v.flow_rndm).all() and v.transition_prob.shape == (n, n)
# the mesh surface: a mesh of 2 CPU shards gives the same transition
from velocyto_tpu_torch.parallel import make_mesh
de = v.delta_embedding.copy()
v.mesh = make_mesh(devices=["cpu"] * 2)
v.estimate_transition_prob(hidim="Sx_sz", embed="ts", knn_random=True,
                           n_neighbors=20, sampled_fraction=0.5)
v.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=True)
assert np.allclose(v.delta_embedding, de, rtol=1e-4, atol=1e-6)
assert "velocyto_tpu" not in sys.modules
# counting: the tracked fixture through the native SoA engine
import velocyto_tpu_torch.counting as cnt
import velocyto_tpu_torch.native as nat
assert nat.available()
c = cnt.ExInCounter("s", cnt.LOGICS["Permissive10X"],
                    valid_bcset={f"C{i:03d}" for i in range(15)})
c.peek("tests/golden/cnt_fix.bam")
c.read_transcriptmodels("tests/golden/cnt_ann.gtf")
c.mark_up_introns(["tests/golden/cnt_fix.bam"], multimap=False)
d, cells = c.count(["tests/golden/cnt_fix_cellsorted.bam"], multimap=False,
                   cell_batch_size=5)
assert c._soa.readers_opened == ["NativeBamReader", "NativeBamReader"]
g = np.load("tests/golden/counting_golden.npz")
o = np.argsort(cells)
assert (np.array(cells)[o] == g["Permissive10X__cells"]).all()
for layer, arrs in d.items():
    assert (np.concatenate(arrs, 1)[:, o] ==
            g[f"Permissive10X__{layer}"]).all(), layer
assert "click" not in sys.modules and "h5py" not in sys.modules
assert not any(m == "jax" or m.startswith(("jax.", "velocyto_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("JAX-FREE OK")
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", JAX_FREE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX-FREE OK" in proc.stdout
