"""normalize's views built on read and normalize + PCA on the object's
device (velocyto_tpu_torch.VelocytoLoom on the CPU) against the JAX
package.

normalize keeps S_sz, S_norm, U_sz and U_norm as a plan (the raw counts,
the cell factors, the pseudocount): perform_PCA and the kNN smoothing
build their own copies on the device from the raw counts, so a session
of the tutorial's calls builds no host view, and each host view, once
read, is bitwise the JAX package's eager value.  A view read and edited
(or assigned) is what later stages read, as in the JAX package.
Tolerances: the PCs and explained variances those of
test_torch_analysis_family.py (rtol 1e-4, atol 1e-5; the device S_norm
is within its log2's rounding of the host one), the smoothings 1e-4,
the SVR-adjusted U_sz the SVR's rtol 1e-9."""
import numpy as np
import pytest
import torch

import velocyto_tpu as vt

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch import analysis
from velocyto_tpu_torch.ops import pca as opca

CPU = torch.device("cpu")
GENES, CELLS = 40, 300          # cells > 1.5 genes: PCA's Gram route
VIEWS = ("S_sz", "U_sz", "S_norm", "U_norm")
PCA_TOL = dict(rtol=1e-4, atol=1e-5)
SMOOTH_TOL = dict(rtol=1e-4, atol=1e-4)


def _counts(dtype=np.float32, empty_cell=True):
    rng = np.random.RandomState(0)
    rate = rng.gamma(2.0, 1.0, (GENES, 3)) @ rng.gamma(2.0, 1.0, (3, CELLS))
    S = rng.poisson(rate).astype(dtype)
    U = rng.poisson(0.4 * rate).astype(dtype)
    if empty_cell:
        U[:, 7] = 0             # a cell with no unspliced counts
    return S, U


def _loom(mod, S, U, **extra):
    """A loom as the reader leaves it, of either package."""
    v = mod.VelocytoLoom.__new__(mod.VelocytoLoom)
    for name, value in extra.items():
        setattr(v, name, value)
    v.S, v.U, v.A = S.copy(), U.copy(), np.zeros_like(S)
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    v.ca = {"CellID": np.array([f"c{i}" for i in range(S.shape[1])])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(S.shape[0])])}
    return v


def _pair(empty_cell=True):
    S, U = _counts(empty_cell=empty_cell)
    return _loom(vt, S, U), _loom(vtt, S, U, device=CPU)


def _counters():
    return analysis.normalize_host_views, opca.pca_torch_grams


FRONT = {
    "both": lambda v: v.normalize("both"),
    "unsized_pcount": lambda v: v.normalize("both", size=False, pcount=0.5),
    "by_total": lambda v: v.normalize_by_total(min_perc_U=1),
}


@pytest.mark.parametrize("case", list(FRONT))
def test_normalize_and_pca_build_no_host_view(case):
    _, port = _pair()
    views0, grams0 = _counters()
    FRONT[case](port)
    port.perform_PCA(which="S_norm", n_components=10)
    port.knn_imputation(k=10, balanced=True, b_sight=30, b_maxl=15)
    views1, grams1 = _counters()
    assert (views1 - views0, grams1 - grams0) == (0, 1)
    plans = {n: e for n, e in port._table().items()
             if isinstance(e, analysis._NormView)}
    assert set(plans) == set(VIEWS)
    assert plans["S_sz"] is plans["S_norm"] is not plans["U_sz"]
    assert not set(VIEWS) & set(port.__dict__)


@pytest.mark.parametrize("case", list(FRONT))
@pytest.mark.parametrize("name", ["pcs", "explained_variance_",
                                  "explained_variance_ratio_", "mean_"])
def test_pca_on_the_device_matches_jax(case, name):
    jax_v, port = _pair()
    for v in (jax_v, port):
        FRONT[case](v)
        v.perform_PCA(which="S_norm", n_components=10)
    got = port.pcs if name == "pcs" else getattr(port.pca, name)
    want = jax_v.pcs if name == "pcs" else getattr(jax_v.pca, name)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, **PCA_TOL)


@pytest.mark.parametrize("name", VIEWS)
@pytest.mark.parametrize("case", list(FRONT))
def test_a_view_read_is_the_eager_value(case, name):
    jax_v, port = _pair()
    for v in (jax_v, port):
        FRONT[case](v)
    port.perform_PCA(which="S_norm", n_components=10)
    views0, _ = _counters()
    got = getattr(port, name)
    spliced = name.startswith("S")
    sz, norm = analysis._scaled_pair(
        port.S if spliced else port.U,
        port.norm_factor if spliced else port.Unorm_factor,
        0.5 if case == "unsized_pcount" else 1, True,
        clean_nonfinite=not spliced)
    np.testing.assert_array_equal(got, sz if name.endswith("_sz") else norm)
    np.testing.assert_array_equal(got, getattr(jax_v, name))
    assert got.dtype == getattr(jax_v, name).dtype
    # a log view carries the size-normalized view it passes through
    assert analysis.normalize_host_views - views0 == \
        (2 if name.endswith("_norm") else 1)
    assert getattr(port, name) is got


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64,
                                   np.uint32])
@pytest.mark.parametrize("name", VIEWS)
def test_the_device_copy_is_the_host_value(dtype, name):
    """Counts of any dtype: the device copy of a size-normalized view is
    bitwise the host value, the log view within log2's rounding."""
    S, U = _counts(dtype)
    v = _loom(vtt, S, U, device=CPU)
    v.normalize("both")
    dev = v._get_dev(name, torch.float64).numpy()
    host = getattr(v, name)
    if name.endswith("_sz"):
        np.testing.assert_array_equal(dev, host.astype(np.float64))
    else:
        eps = np.finfo(host.dtype).eps
        np.testing.assert_allclose(dev, host, rtol=2 * eps, atol=2 * eps)


EDITS = {
    # (normalize, the edit after it, which view perform_PCA reads)
    "adjust_totS_totU": (lambda v: v.normalize_by_total(min_perc_U=1),
                         lambda v: v.adjust_totS_totU(), "U_sz"),
    "renormalize": (lambda v: v.normalize("both", size=False),
                    lambda v: v.normalize_median("renormalize"), "S_sz"),
    "assign_S_norm": (lambda v: v.normalize("both"), lambda v: setattr(
        v, "S_norm", np.log2(v.S_sz + 3.0)), "S_norm"),
}


def _downstream(v, which):
    v.perform_PCA(which=which, n_components=10)
    v.knn_imputation(k=10, balanced=False)
    return {"pcs": v.pcs, "Sx": v.Sx, "Ux": v.Ux}


@pytest.mark.parametrize("case", list(EDITS))
def test_an_edit_after_a_read_reaches_the_stages(case):
    front, edit, which = EDITS[case]
    jax_v, port = _pair(empty_cell=False)    # the renormalizations' sums
    for v in (jax_v, port):
        front(v)
        edit(v)
    got, want = _downstream(port, which), _downstream(jax_v, which)
    np.testing.assert_allclose(got["pcs"], want["pcs"], **PCA_TOL)
    for name in ("Sx", "Ux"):
        np.testing.assert_allclose(got[name], want[name], **SMOOTH_TOL)
    # the edit is what the stages read: without it they read otherwise
    _, plain = _pair(empty_cell=False)
    front(plain)
    unedited = _downstream(plain, which)
    assert any(not np.allclose(got[k], unedited[k], **SMOOTH_TOL)
               for k in got)


@pytest.mark.parametrize("name", VIEWS)
def test_filter_cells_after_normalize_keeps_the_views(name):
    jax_v, port = _pair()
    keep = np.arange(CELLS) % 5 != 0
    for v in (jax_v, port):
        v.normalize("both")
        v.filter_cells(keep)
    # the writes of S and U built the views from the counts they replaced
    assert not set(VIEWS) & set(port._table())
    np.testing.assert_array_equal(port.S, jax_v.S)
    np.testing.assert_array_equal(getattr(port, name), getattr(jax_v, name))


def test_phase_portrait_filter_keeps_the_views_pending():
    """filter_genes_by_phase_portrait filters the views still pending
    over the kept genes of their counts, building none."""
    jax_v, port = _pair()
    for v in (jax_v, port):
        v.normalize("both")
        v.perform_PCA(which="S_norm", n_components=10)
        v.knn_imputation(k=10, balanced=False)
        v.fit_gammas()
    views0, _ = _counters()
    for v in (jax_v, port):
        v.filter_genes_by_phase_portrait(minR2=0.01, min_gamma=0.001,
                                         minCorr=None)
    assert analysis.normalize_host_views == views0
    assert 0 < port.S.shape[0] < GENES
    for name in VIEWS:
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(jax_v, name), err_msg=name)


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    _, port = _pair()
    port.normalize("both")
    port.perform_PCA(which="S_norm", n_components=10)
    path = str(tmp_path_factory.mktemp("norm") / "port.hdf5")
    port.to_hdf5(path)
    return port, vtt.load_velocyto_hdf5(path, device="cpu")


@pytest.mark.parametrize("name", VIEWS)
def test_an_hdf5_round_trip_carries_the_views(round_trip, name):
    port, loaded = round_trip
    assert not set(VIEWS) & set(port._table())
    assert name in loaded.__dict__
    np.testing.assert_array_equal(loaded.__dict__[name], port.__dict__[name])
    S, U = _counts()
    want = analysis._scaled_pair(
        S if name[0] == "S" else U,
        port.norm_factor if name[0] == "S" else port.Unorm_factor, 1, True,
        clean_nonfinite=name[0] == "U")
    np.testing.assert_array_equal(loaded.__dict__[name],
                                  want[0 if name.endswith("_sz") else 1])
