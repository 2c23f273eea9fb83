"""The port's epsilon-SVR (velocyto_tpu_torch.ops.svr, the plain solver on
the CPU) against sklearn's SVR, which the JAX package calls, and the two
SVR users of VelocytoLoom against the JAX package.

Inputs: the goldens' CV-vs-mean fit (tests/golden/golden.npz, the inputs
of test_golden.py's score_cv_vs_mean call) and numpy-seeded synthetic
fits of both shapes velocyto makes: log2 CV against log2 mean with
gamma = 150 / n (score_cv_vs_mean), and U totals against S totals with
C = 100, gamma = 1e-6 (adjust_totS_totU).

Tolerances: the solver follows libsvm's working-set sequence, so the
iteration count and the support set are equal, and the dual
coefficients and the intercept agree to 1e-12 relative (they are equal
to the bit wherever torch's float64 exp rounds like the C library's);
predictions agree to rtol 1e-9 / atol 1e-12, the difference being the
order of the float64 sums over the support vectors.  The VelocytoLoom
outputs fed by the fits agree to the same 1e-9 / 1e-12; the selections
made from them are equal."""
from pathlib import Path

import numpy as np
import pytest
import torch
from sklearn.svm import SVR as SkSVR

import velocyto_tpu as vt

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch import kernels
from velocyto_tpu_torch.ops.svr import SVR, smo_solve

from test_torch_pipeline import CPU, GOLDEN

PRED_TOL = dict(rtol=1e-9, atol=1e-12)
COEF_TOL = dict(rtol=1e-12, atol=0)


def _golden_cv_fit():
    """log2 mean and log2 CV of the goldens' detected genes, as
    score_cv_vs_mean(min_expr_cells=2, max_expr_avg=35) computes them."""
    S = np.load(GOLDEN)["S"]
    detected = ((S > 0).sum(1) > 2) & (S.mean(1) < 35) & (S.mean(1) > 0)
    Sf = S[detected]
    mu, sigma = Sf.mean(1), Sf.std(1, ddof=1)
    log_m = np.log2(mu)
    return log_m, np.log2(sigma / mu), dict(gamma=150.0 / len(mu))


def _cv_fit(seed, n=1500):
    rng = np.random.RandomState(seed)
    log_m = np.log2(rng.lognormal(0.0, 1.5, n))
    log_cv = -0.5 * log_m + 0.4 * rng.randn(n)
    return log_m, log_cv, dict(gamma=150.0 / n)


def _totals_fit(seed, n=1000):
    rng = np.random.RandomState(100 + seed)
    tot_s = rng.gamma(5.0, 400.0, n)
    tot_u = 0.3 * tot_s + 30.0 * rng.randn(n)
    return tot_s, tot_u, dict(C=100.0, gamma=1e-6)


CASES = {"golden_cv": _golden_cv_fit,
         **{f"cv_seed{s}": (lambda s=s: _cv_fit(s)) for s in range(3)},
         **{f"totals_seed{s}": (lambda s=s: _totals_fit(s)) for s in range(3)}}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_follows_libsvm(case):
    x, y, kw = CASES[case]()
    sk = SkSVR(**kw).fit(x[:, None], y)
    port = SVR(device=CPU, **kw).fit(x, y)
    assert port.n_iter_ == sk.n_iter_ > 0
    np.testing.assert_array_equal(port.support_, sk.support_)
    np.testing.assert_allclose(port.dual_coef_, sk.dual_coef_, **COEF_TOL)
    np.testing.assert_allclose(port.intercept_, sk.intercept_, **COEF_TOL)
    np.testing.assert_array_equal(port.support_vectors_, sk.support_vectors_)
    got = port.predict(torch.as_tensor(x))
    assert got.dtype == torch.float64 and got.device == CPU
    np.testing.assert_allclose(got.numpy(), sk.predict(x[:, None]),
                               **PRED_TOL)


@pytest.mark.parametrize("case", ["cv_seed0", "totals_seed1"])
def test_from_numpy_predicts_as_sklearn(case):
    x, y, kw = CASES[case]()
    sk = SkSVR(**kw).fit(x[:, None], y)
    port = SVR.from_numpy(sk.support_vectors_, sk.dual_coef_, sk.intercept_,
                          sk._gamma, device=CPU)
    grid = np.linspace(x.min() - 1.0, x.max() + 1.0, 257)
    np.testing.assert_allclose(port.predict(grid[:, None]).numpy(),
                               sk.predict(grid[:, None]), **PRED_TOL)


def test_solver_options_and_shapes():
    """Other box bounds follow libsvm too; X may be (n,) or (n, 1), and
    more features are refused."""
    x, y, kw = _cv_fit(7, n=400)
    for C in (0.05, 3.0, 1e3):
        sk = SkSVR(C=C, **kw).fit(x[:, None], y)
        port = SVR(C=C, device=CPU, **kw).fit(x[:, None], y)
        assert port.n_iter_ == sk.n_iter_, C
        np.testing.assert_allclose(port.dual_coef_, sk.dual_coef_, **COEF_TOL)
        np.testing.assert_allclose(port.intercept_, sk.intercept_, **COEF_TOL)
    with pytest.raises(ValueError, match="one feature"):
        SVR(device=CPU).fit(np.zeros((4, 2)), np.zeros(4))
    alpha, rho, it = smo_solve(torch.as_tensor(x), torch.as_tensor(y), **kw)
    assert alpha.shape == (800,) and bool((alpha >= 0).all()) and it > 0
    assert kernels.svr_launches == 0        # CPU tensors: the plain solver


@pytest.mark.parametrize("device, reps", [("cpu", 10), ("cuda", 0)])
def test_sync_probe_refuses_before_building(device, reps):
    """The solver's latency probe runs on a CUDA device only, and for at
    least one round; it refuses anything else before any build."""
    with pytest.raises(ValueError):
        kernels.svr_sync_probe(reps, device)
    assert kernels._lib is None


def test_route_rule():
    """The state stays in shared memory for the heuristic session's two
    fits (12,000 genes, 20,000 cells) and every size whose share (37 B a
    position, in whole rounds of 512 positions a block) fits 200 KiB in
    each of the cluster's 16 blocks; above it, in global memory."""
    for l in (1, 600, 12000, 20000):
        assert kernels.svr_route(l) == "shared", l
    # the largest l whose 2l positions fill each of 16 blocks to 10 rounds
    # of 512 (189,440 B), and the next one, which needs 11 (208,384 B)
    assert kernels.svr_route(40960) == "shared"
    assert kernels.svr_route(40961) == "global"
    assert kernels.svr_route(100000) == kernels.svr_route(2 ** 29) == \
        "global"


def _constants(source):
    """{name: value} of the `constexpr int` constants of a kernel source,
    each evaluated over the ones before it."""
    import re
    found = {}
    text = (Path(kernels.__file__).parent / source).read_text()
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        found[name] = eval(expr, {}, dict(found))
    return found


@pytest.mark.parametrize("name, value", [
    ("kThreads", kernels._SVR_THREADS), ("kCluster", kernels.SVR_CLUSTER),
    ("kSlotBytes", kernels._SVR_SLOT_BYTES), ("kMaxSmem", kernels._SVR_SMEM)])
def test_route_rule_constants_match_kernel(name, value):
    """The route rule's sizes are the kernel's, read from its source."""
    assert _constants("svr_smo.cu")[name] == value


class _OnCard:
    """A CPU tensor that reports a CUDA device, so a wrapper's checks run
    past the device test on a machine without a card."""

    def __init__(self, t):
        self._t = t

    is_cuda = True
    device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


_F64 = dict(dtype=torch.float64)


@pytest.mark.parametrize("x, target, kw", [
    (torch.zeros(8), torch.zeros(8, **_F64), {}),             # dtype
    (torch.zeros(8, 1, **_F64), torch.zeros(8, **_F64), {}),  # rank
    (torch.zeros(8, **_F64), torch.zeros(7, **_F64), {}),     # lengths
    (torch.zeros(0, **_F64), torch.zeros(0, **_F64), {}),     # empty
    (torch.zeros(8, **_F64), torch.zeros(8, **_F64), {"route": "warp"}),
    (torch.zeros(8, **_F64), torch.zeros(8, **_F64), {"route": "cluster"}),
    (torch.zeros(8, **_F64), torch.zeros(8, **_F64), {"route": "block"}),
    (torch.zeros(50000, **_F64), torch.zeros(50000, **_F64),
     {"route": "shared"}),                           # beyond shared memory
])
def test_solver_refuses_before_building(x, target, kw):
    """svr_smo refuses bad dtypes, ranks, lengths and routes, and CPU
    tensors, before any build."""
    with pytest.raises((ValueError, TypeError)):
        kernels.svr_smo(_OnCard(x), _OnCard(target), 1.0, 0.1, 1.0, 1e-3,
                        **kw)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.svr_smo(x.to(torch.float64), target.to(torch.float64), 1.0,
                        0.1, 1.0, 1e-3)
    assert kernels._lib is None and kernels.svr_launches == 0


def _synthetic_loom(mod, seed, **extra):
    """A VelocytoLoom of the given package holding Poisson counts with
    gene-wise overdispersion (1,500 genes x 200 cells)."""
    rng = np.random.RandomState(seed)
    mean = rng.lognormal(-1.0, 1.5, 1500)[:, None]
    disp = rng.gamma(2.0, 0.5, (1500, 1))
    lam = rng.gamma(1.0 / disp, mean * disp, (1500, 200))
    v = mod.VelocytoLoom.__new__(mod.VelocytoLoom)
    for name, value in extra.items():
        setattr(v, name, value)
    v.S = rng.poisson(lam).astype(np.float64)
    v.U = rng.poisson(0.3 * lam + 0.05).astype(np.float64)
    v.A = np.zeros_like(v.S)
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    v.ca = {"CellID": np.array([f"c{i}" for i in range(200)])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(1500)])}
    return v


@pytest.mark.parametrize("which", ["S", "U"])
def test_score_cv_vs_mean_matches_jax(which):
    vs = [_synthetic_loom(vt, 5), _synthetic_loom(vtt, 5, device=CPU)]
    for v in vs:
        v.score_cv_vs_mean(N=300, which=which, max_expr_avg=40)
    name = "cv_mean_" if which == "S" else "Ucv_mean_"
    jax_v, port = vs
    # the reference keeps score >= the (N+1)-th largest score: N + 1 genes
    assert getattr(port, name + "selected").sum() == 301
    np.testing.assert_array_equal(getattr(port, name + "selected"),
                                  getattr(jax_v, name + "selected"))
    np.testing.assert_allclose(getattr(port, name + "score"),
                               getattr(jax_v, name + "score"), **PRED_TOL)


@pytest.mark.parametrize("fit_with_low_U", [True, False])
def test_adjust_totS_totU_matches_jax(fit_with_low_U):
    vs = [_synthetic_loom(vt, 6), _synthetic_loom(vtt, 6, device=CPU)]
    for v in vs:
        v.normalize_by_total(min_perc_U=5)
        v.adjust_totS_totU(fit_with_low_U=fit_with_low_U,
                           normalize_total=True)
    jax_v, port = vs
    assert port.small_U_pop.any() and not port.small_U_pop.all()
    np.testing.assert_array_equal(port.S_sz, jax_v.S_sz)
    np.testing.assert_allclose(port.U_sz, jax_v.U_sz, **PRED_TOL)
