"""The port's filter / score / normalize family, every fit_gammas branch,
the phase-portrait filter, the sparse-weight smoothings and the heuristic
defaults (velocyto_tpu_torch.VelocytoLoom on the CPU) against the JAX
package and the reference goldens.

Inputs: tests/golden/golden.npz, fed to both packages with the same
calls (test_golden.py's for the goldens).  Tolerances: host float64
stages (scores, masks, filters, the raw-count normalizations) are
bit-equal, since both packages run the same numpy; what the SVR noise
models feed (cv_mean_score, the adjusted U_sz) agrees to SVR_TOL, since
the port's SVR follows libsvm's solver to the same dual coefficients and
differs only in the order of the float64 prediction sums; device stages
(the imputed normalizations, float64 sums in another order) agree to
1e-5 relative; gamma fits rtol 1e-4 / atol 1e-5 (float32 closed forms on
both sides); smoothings 1e-4 (float32 sums in another order); goldens at
test_golden.py's tolerances."""
import numpy as np
import pytest
import torch
from scipy import sparse

import velocyto_tpu as vt

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch.analysis import _Device

from test_torch_pipeline import CPU, _fresh, _front


def _device_backed(v):
    """{name: tensor} of the loom's device-backed attributes."""
    return {name: v._get_dev(name, None) for name, entry in
            v._table().items() if isinstance(entry, _Device)}


GAMMA_TOL = dict(rtol=1e-4, atol=1e-5)
DEV_TOL = dict(rtol=1e-5, atol=1e-12)
SVR_TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def golden():
    from test_torch_pipeline import GOLDEN
    return np.load(GOLDEN)


def _pair(golden, balanced=False):
    """A JAX-package object and a port object after the same front end
    (normalize, PCA, kNN smoothing)."""
    out = []
    for mod, extra in ((vt, {}), (vtt, {"device": CPU})):
        v = _fresh(mod, golden, **extra)
        _front(v, balanced=balanced)
        out.append(v)
    return out


@pytest.fixture(scope="module")
def smoothed(golden):
    return _pair(golden)


def _state(jax_v, *names):
    return vtt.state_from_numpy({n: getattr(jax_v, n) for n in names}, "cpu")


# --- goldens ----------------------------------------------------------

def _filtering_family(v):
    """test_golden.py::test_filtering_family_matches_reference's calls;
    returns each output it checks."""
    out = {}
    v.score_detection_levels(min_expr_counts=40, min_cells_express=10,
                             min_expr_counts_U=0, min_cells_express_U=0)
    out["detection_level_selected"] = v.detection_level_selected
    v.score_cv_vs_mean(N=30, min_expr_cells=2, max_expr_avg=35)
    out.update(cv_mean_score=v.cv_mean_score,
               cv_mean_selected=v.cv_mean_selected)
    v.score_cv_vs_mean(N=30, min_expr_cells=2, max_expr_avg=35,
                       sort_inverse=True, which="S")
    v.score_cv_vs_mean(N=30, min_expr_cells=2, max_expr_avg=35,
                       sort_inverse=True, which="U")
    v.robust_size_factor(pc=0.1, which="both")
    out.update(size_factor=v.size_factor, Usize_factor=v.Usize_factor)
    v.score_cv_vs_mean(N=30, min_expr_cells=2, max_expr_avg=35)
    v.normalize_by_total(min_perc_U=0.5, skip_low_U_pop=True)
    out.update(nbt_S_sz=v.S_sz, nbt_U_sz=v.U_sz)
    v.filter_genes(by_detection_levels=True, by_cv_vs_mean=True)
    out.update(filtered_genes=v.ra["Gene"], filtered_S=v.S)
    return out


@pytest.fixture(scope="module")
def family(golden):
    return {tag: _filtering_family(_fresh(mod, golden, **extra))
            for tag, mod, extra in (("jax", vt, {}),
                                    ("port", vtt, {"device": CPU}))}


FAMILY_GOLDEN = [("detection_level_selected", 0, 0),
                 ("cv_mean_score", 1e-3, 1e-5), ("cv_mean_selected", 0, 0),
                 ("size_factor", 1e-5, 0), ("Usize_factor", 1e-5, 0),
                 ("nbt_S_sz", 1e-4, 1e-4), ("nbt_U_sz", 1e-4, 1e-4),
                 ("filtered_S", 0, 0)]


@pytest.mark.parametrize("name,rtol,atol", FAMILY_GOLDEN,
                         ids=[c[0] for c in FAMILY_GOLDEN])
def test_filtering_family_matches_golden_and_jax(family, golden, name, rtol,
                                                 atol):
    got = family["port"][name]
    np.testing.assert_allclose(got, golden[name], rtol=rtol, atol=atol)
    if name == "cv_mean_score":         # the port's own SVR
        np.testing.assert_allclose(got, family["jax"][name], **SVR_TOL)
    else:
        np.testing.assert_array_equal(got, family["jax"][name])


def test_filtered_genes_match_golden_and_jax(family, golden):
    got = list(family["port"]["filtered_genes"])
    assert got == list(golden["filtered_genes"])
    assert got == list(family["jax"]["filtered_genes"])


# --- fit_gammas: every branch ------------------------------------------

SUBSET = [bool(i % 3) for i in range(120)]      # a steady-state subset
W_EXPLICIT = np.random.RandomState(9).rand(80, 120)
# (fit_offset, fixperc_q, weighted, weights, limit_gamma)
BRANCHES = {
    "weighted_offset": (True, False, True, "maxmin_diag", False),
    "weighted_offset_limit": (True, False, True, "maxmin", True),
    "offset": (True, False, False, "maxmin_diag", False),
    "weighted_fixperc": (False, True, True, "maxmin_double", False),
    "fixperc": (False, True, False, "maxmin_diag", False),
    "weighted": (False, False, True, "maxmin_weighted", False),
    "weighted_limit": (False, False, True, "sum", True),
    "nnls": (False, False, False, "maxmin_diag", False),
    "explicit_W": (True, False, True, W_EXPLICIT, False),
}
SUBSET_BRANCHES = {
    "maxmin_diag": (True, False, True, "maxmin_diag", False),
    "maxmin_double": (True, False, True, "maxmin_double", False),
    "sum": (True, False, True, "sum", False),
    "prod": (False, False, True, "prod", False),
    "maxmin": (False, True, True, "maxmin", False),
    "maxmin_weighted": (True, False, True, "maxmin_weighted", True),
    "explicit_W": (True, False, True, W_EXPLICIT, False),
    "offset": (True, False, False, "maxmin_diag", False),
    "nnls": (False, False, False, "maxmin_diag", False),
}


def _fit(v, branch, ss=None, weights=None):
    fit_offset, fixperc_q, weighted, scheme, limit_gamma = branch
    for name in ("gammas", "q", "R2"):
        v.__dict__.pop(name, None)
    v.fit_gammas(steady_state_bool=ss, fit_offset=fit_offset,
                 fixperc_q=fixperc_q, weighted=weighted,
                 weights=scheme if weights is None else weights,
                 limit_gamma=limit_gamma)
    return {n: getattr(v, n) for n in ("gammas", "q", "R2")
            if n in v.__dict__}


def _assert_fits_equal(got, want, genes=slice(None)):
    assert set(got) == set(want)
    assert np.ptp(got["gammas"]) > 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name][genes], w[genes], err_msg=name,
                                   **GAMMA_TOL)


@pytest.fixture(scope="module")
def gamma_pair(smoothed):
    """The JAX package after the front end, and a port object started
    from its smoothed state: a weight scheme's 0/1 thresholds then see
    the same values on both sides."""
    jax_v = smoothed[0]
    return jax_v, _state(jax_v, "S", "U", "Sx", "Ux", "Sx_sz", "Ux_sz")


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_fit_gammas_branch_matches_jax(gamma_pair, branch):
    jax_v, port = gamma_pair
    _assert_fits_equal(_fit(port, BRANCHES[branch]),
                       _fit(jax_v, BRANCHES[branch]))


@pytest.mark.parametrize("branch", list(SUBSET_BRANCHES))
def test_fit_gammas_steady_state_subset_matches_jax(gamma_pair, branch):
    """A steady-state subset: the host float64 weights over every cell,
    the fit over the subset.  The JAX package passes the full-width
    weights to the fit and raises, so its side takes the same weights,
    computed by its own _fit_weights_host and cut to the subset.  A gene
    whose subset keeps fewer than three weighted cells is left out: with
    one, every line through the point fits it (no unique minimizer); with
    two, the fit is exactly determined and float32 cancellation in the
    closed form sets its last digits."""
    jax_v, port = gamma_pair
    scheme = SUBSET_BRANCHES[branch][3]
    want_w = None
    genes = np.ones(80, dtype=bool)
    if SUBSET_BRANCHES[branch][2]:
        W = scheme if isinstance(scheme, np.ndarray) else \
            jax_v._fit_weights_host(scheme, jax_v.Sx_sz, jax_v.Ux_sz,
                                    [2, 98], 15)
        want_w = W[:, SUBSET]
        genes = (want_w > 0).sum(1) >= 3
        assert genes.sum() >= 70
        with pytest.raises(TypeError, match="incompatible shapes"):
            _fit(jax_v, SUBSET_BRANCHES[branch], ss=SUBSET)
    _assert_fits_equal(_fit(port, SUBSET_BRANCHES[branch], ss=SUBSET),
                       _fit(jax_v, SUBSET_BRANCHES[branch], ss=SUBSET,
                            weights=want_w), genes)


def test_fit_gammas_rejects_unknown_scheme(smoothed):
    with pytest.raises(NotImplementedError, match="not a supported"):
        smoothed[1].fit_gammas(weights="median")


# --- normalize family --------------------------------------------------

HOST_NORMALIZE = {
    "both": lambda v: v.normalize("both", size=True, log=True),
    "S": lambda v: v.normalize("S", size=False, log=True, pcount=0.5),
    "U_with_S_size": lambda v: (v.normalize("S"), v.normalize(
        "U", use_S_size_for_U=True, target_size=(None, 30.0))),
    "by_total": lambda v: v.normalize_by_total(min_perc_U=1),
    "by_total_all_U": lambda v: v.normalize_by_total(
        skip_low_U_pop=False, same_size_UnS=True),
    "by_size_factor": lambda v: (
        setattr(v, "size_factor", v.S.sum(0) / v.S.sum(0).mean()),
        v.normalize_by_size_factor(skip_low_U_pop=False)),
    "median_renormalize": lambda v: (v.normalize_by_total(),
                                     v.normalize_median("renormalize")),
    "median_renormalize_all_U": lambda v: (
        v.normalize("both"),
        v.normalize_median("renormalize", skip_low_U_pop=False)),
}
HOST_ATTRS = ("S_sz", "U_sz", "S_norm", "U_norm", "norm_factor",
              "Unorm_factor", "small_U_pop", "cell_size", "Ucell_size")


@pytest.mark.parametrize("case", list(HOST_NORMALIZE))
def test_host_normalize_bit_equal_to_jax(golden, case):
    jax_v, port = _fresh(vt, golden), _fresh(vtt, golden, device=CPU)
    for v in (jax_v, port):
        HOST_NORMALIZE[case](v)
    n_checked = 0
    for name in HOST_ATTRS:
        if name in jax_v.__dict__:
            np.testing.assert_array_equal(getattr(port, name),
                                          getattr(jax_v, name), err_msg=name)
            n_checked += 1
    assert n_checked >= 2


DEVICE_NORMALIZE = {
    "imputed": lambda v: v.normalize("imputed"),
    "imputed_Sx_size": lambda v: (setattr(v, "cell_size", 1),
                                  v.normalize("imputed",
                                              use_S_size_for_U=True)),
    "Sx_unsized": lambda v: v.normalize("Sx", size=False, pcount=2),
    "Ux_relative": lambda v: v.normalize(
        "Ux", relative_size=np.linspace(1, 2, 120), target_size=(None, 7)),
    "median_imputed": lambda v: v.normalize_median("imputed"),
    "median_imputed_small_U": lambda v: (
        setattr(v, "small_U_pop", np.arange(120) % 4 == 0),
        v.normalize_median("imputed")),
    "median_imputed_all_U": lambda v: v.normalize_median(
        "imputed", skip_low_U_pop=False),
}
DEVICE_ATTRS = ("Sx_sz", "Ux_sz", "Sx_norm", "Ux_norm", "xnorm_factor",
                "xUnorm_factor")


@pytest.mark.parametrize("case", list(DEVICE_NORMALIZE))
def test_imputed_normalize_on_device_matches_jax(golden, case):
    jax_v, port = _pair(golden)
    for v in (jax_v, port):
        DEVICE_NORMALIZE[case](v)
    ds = _device_backed(port)
    n_checked = 0
    for name in DEVICE_ATTRS:
        if name not in jax_v.__dict__:      # not set by this normalization
            continue
        n_checked += 1
        if name.startswith(("Sx_", "Ux_")):
            assert name in ds and ds[name].dtype == torch.float64, name
        np.testing.assert_allclose(getattr(port, name), getattr(jax_v, name),
                                   err_msg=name, **DEV_TOL)
    assert n_checked >= 1


# --- in-place edits reach the next stage -----------------------------

def test_edit_after_adjust_totS_totU_reaches_knn_imputation(golden):
    """adjust_totS_totU and normalize_median("renormalize") edit U_sz in
    place, and so does the caller here; knn_imputation's Ux must see all
    of it, as it does in the JAX package."""
    outs = {}
    for tag, mod, extra in (("jax", vt, {}), ("port", vtt, {"device": CPU}),
                            ("unedited", vtt, {"device": CPU})):
        v = _fresh(mod, golden, **extra)
        v.normalize_by_total()
        v.adjust_totS_totU(skip_low_U_pop=True, normalize_total=True)
        if tag != "unedited":
            v.U_sz[:, 3] *= 5.0
        v.perform_PCA(which="S_norm", n_components=10)
        v.knn_imputation(k=10, balanced=False)
        outs[tag] = v.Ux
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-4,
                               atol=1e-4)
    assert not np.allclose(outs["port"], outs["unedited"], rtol=1e-3)


# --- smoothing with sparse weights -------------------------------------

@pytest.mark.parametrize("maximum", [False, True])
def test_knn_imputation_precomputed_matches_jax(smoothed, maximum):
    jax_v, port = smoothed
    w = sparse.csr_matrix(jax_v.knn_smoothing_w)
    for v in (jax_v, port):
        v.knn_imputation_precomputed(w, maximum=maximum)
    ds = _device_backed(port)
    assert ds["Sx_sz"] is ds["Sx"]
    for name in ("Sx", "Ux", "Sx_sz", "Ux_sz"):
        np.testing.assert_allclose(getattr(port, name), getattr(jax_v, name),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def _gene_pair(golden):
    """A JAX-package object after the front end, and a port object
    started from its imputed state (the gene kNN ranks genes by float64
    correlation distances of Sx_sz)."""
    jax_v = _pair(golden)[0]
    return jax_v, _state(jax_v, "S", "U", "Sx_sz", "Ux_sz")


@pytest.mark.parametrize("balanced", [True, False])
def test_gene_knn_imputation_matches_jax(golden, balanced):
    jax_v, port = _gene_pair(golden)
    for v in (jax_v, port):
        v.gene_knn_imputation(k=5, balanced=balanced, b_sight=20, b_maxl=8,
                              scale_weights=False)
    np.testing.assert_array_equal(port.gknn.indptr, jax_v.gknn.indptr)
    np.testing.assert_array_equal(port.gknn.indices, jax_v.gknn.indices)
    np.testing.assert_allclose(port.gknn.data, jax_v.gknn.data, rtol=1e-12,
                               atol=1e-12)
    for name in ("Sx_sz", "Ux_sz"):
        np.testing.assert_allclose(getattr(port, name), getattr(jax_v, name),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_gene_knn_scaled_weights_match_jax(golden):
    """scale_weights=True: the median-scaled weights no longer sum to one,
    and both packages refuse them in the smoothing."""
    jax_v, port = _gene_pair(golden)
    with pytest.raises(AssertionError):
        jax_v.gene_knn_imputation(k=5, b_sight=20, b_maxl=8)
    with pytest.raises(ValueError, match="sum to one"):
        port.gene_knn_imputation(k=5, b_sight=20, b_maxl=8)
    a, b = port.gknn_smoothing_w, jax_v.gknn_smoothing_w
    assert a.format == b.format == "csc"
    np.testing.assert_allclose(a.toarray(), b.toarray(), rtol=1e-10)


def test_convolve_helpers_match_jax():
    from velocyto_tpu.ops import smoothing as jsm
    from velocyto_tpu_torch.ops import smoothing as tsm
    rng = np.random.RandomState(1)
    w = sparse.random(50, 50, density=0.1, random_state=rng, format="csr")
    w = sparse.csr_matrix(w + sparse.eye(50))
    w = sparse.csr_matrix(w.multiply(1.0 / w.sum(1)))
    for a, b in zip(tsm.csr_to_compact(w), jsm.csr_to_compact(w)):
        np.testing.assert_array_equal(a, b)
    data = rng.rand(7, 50)
    np.testing.assert_allclose(tsm.convolve_by_sparse_weights(data, w, "cpu"),
                               jsm.convolve_by_sparse_weights(data, w),
                               rtol=1e-5, atol=1e-6)
    idx, wgt = jsm.csr_to_compact(w)
    np.testing.assert_allclose(
        tsm.convolve_compact(data.T, idx, wgt, "cpu"),
        jsm.convolve_compact(data.T, idx, wgt), rtol=1e-5, atol=1e-6)


# --- phase-portrait filter ---------------------------------------------

@pytest.mark.parametrize("method,kwargs", [
    ("filter_genes_by_phase_portrait", {}),
    ("filter_genes_by_phase_portrait", {"minR2": 0.2, "minCorr": 0.3}),
    ("filter_genes_good_fit", {"minR": 0.15})])
def test_phase_portrait_filter_then_predict_U(golden, method, kwargs):
    jax_v, port = _pair(golden)
    for v in (jax_v, port):
        v.normalize("imputed", log=True)
        v.fit_gammas(fit_offset=True)
        getattr(v, method)(**kwargs)
        v.predict_U()
    assert 0 < len(port.ra["Gene"]) < 80
    assert list(port.ra["Gene"]) == list(jax_v.ra["Gene"])
    ds = _device_backed(port)
    assert all(n in ds for n in ("Sx", "Ux", "Sx_norm", "Ux_norm"))
    for name in ("S", "U", "S_sz", "U_sz", "S_norm"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(jax_v, name), err_msg=name)
    for name in ("gammas", "q", "R2"):
        np.testing.assert_allclose(getattr(port, name), getattr(jax_v, name),
                                   err_msg=name, **GAMMA_TOL)
    for name in ("Sx", "Ux", "Sx_sz", "Ux_sz", "Sx_norm", "Upred"):
        np.testing.assert_allclose(getattr(port, name), getattr(jax_v, name),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_phase_portrait_keeps_aliases_and_honours_host_edits(golden):
    jax_v, port = _pair(golden)
    for v in (jax_v, port):
        v.fit_gammas(fit_offset=True)
    ds = _device_backed(port)
    assert ds["Sx_sz"] is ds["Sx"]
    for v in (jax_v, port):
        v.Ux_sz[:, :5] = 0.0             # an edit of the handed-out view
        v.filter_genes_by_phase_portrait(minCorr=None)
    ds = _device_backed(port)
    assert ds["Sx_sz"] is ds["Sx"]       # filtered once, still one tensor
    assert ds["Sx"].shape[0] == len(port.ra["Gene"]) < 80
    for name in ("Sx", "Ux", "Sx_sz", "Ux_sz"):
        np.testing.assert_allclose(getattr(port, name), getattr(jax_v, name),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert not port.Ux_sz[:, :5].any() and port.Ux[:, :5].any()


# --- bookkeeping, cluster scores, heuristic defaults, TSNE -----------

def _clusters(n):
    return np.array([f"cl{i % 4}" for i in range(n)], dtype=object)


@pytest.mark.parametrize("with_colors", [True, False])
def test_clusters_and_cell_filters_match_jax(golden, with_colors):
    labels = _clusters(120)
    colors = {f"cl{i}": [i / 4, 0.5, 0.5] for i in range(4)} \
        if with_colors else None
    keep = np.arange(120) % 5 != 0
    vs = []
    for mod, extra in ((vt, {}), (vtt, {"device": CPU})):
        v = _fresh(mod, golden, **extra)
        v.ts = golden["ts"].copy()
        v.set_clusters(labels, cluster_colors_dict=colors)
        v.score_cluster_expression(min_avg_U=0.5, min_avg_S=1.0)
        v.score_detection_levels(min_expr_counts=30)
        v.filter_genes(by_cluster_expression=True, by_detection_levels=True,
                       keep_unfiltered=True)
        v.filter_cells(keep)
        v.custom_filter_attributes(["ca", "S.T"], np.arange(96) % 7 != 1)
        vs.append(v)
    jax_v, port = vs
    for name in ("cluster_uid", "cluster_ix", "cluster_labels", "colorandum",
                 "U_avgs", "S_avgs", "clu_avg_selected", "S", "U", "A",
                 "ts", "initial_cell_size"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(jax_v, name), err_msg=name)
    assert port.cluster_labels.dtype.kind == "S"
    assert list(port.ca["CellID"]) == list(jax_v.ca["CellID"])
    assert (port.S_prefilter != jax_v.S_prefilter).nnz == 0


def test_custom_filter_attributes_on_device_backed_state(smoothed):
    jax_v, port = _pair_from(smoothed)
    mask = np.arange(120) % 3 != 0
    for v in (jax_v, port):
        v.custom_filter_attributes(["Sx_sz.T", "pcs"], mask)
    assert port.Sx_sz.shape == (80, mask.sum())
    np.testing.assert_allclose(port.Sx_sz, jax_v.Sx_sz, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port._get_dev("Sx_sz").numpy(),
                               port.Sx_sz.astype(np.float32))
    np.testing.assert_allclose(port.pcs, jax_v.pcs, rtol=1e-4, atol=1e-5)


def _pair_from(smoothed):
    """Fresh objects carrying the smoothed fixture's state."""
    jax_v, port = smoothed
    names = ("S", "U", "Sx", "Ux", "Sx_sz", "Ux_sz", "pcs")
    j = vt.VelocytoLoom.__new__(vt.VelocytoLoom)
    for n in names:
        setattr(j, n, np.array(getattr(jax_v, n)))
    p = vtt.state_from_numpy({n: getattr(port, n) for n in names}, "cpu")
    p._set_dev("Sx_sz", p._get_dev("Sx_sz"))
    return j, p


def test_default_filter_and_fit_preparation_match_jax(golden):
    vs = []
    for mod, extra in ((vt, {}), (vtt, {"device": CPU})):
        v = _fresh(mod, golden, **extra)
        v.U = v.U + 2                         # every cell has U counts
        v.initial_Ucell_size = v.U.sum(0)
        v.set_clusters(_clusters(120),
                       {f"cl{i}": [0.1 * i, 0, 0] for i in range(4)})
        v.default_filter_and_norm(min_avg_U=0.5)
        v.default_fit_preparation(k=8, n_comps=6)
        vs.append(v)
    jax_v, port = vs
    assert list(port.ra["Gene"]) == list(jax_v.ra["Gene"])
    for name in ("S_sz", "small_U_pop"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(jax_v, name), err_msg=name)
    for name in ("U_sz", "cv_mean_score"):      # through the port's SVR
        np.testing.assert_allclose(getattr(port, name), getattr(jax_v, name),
                                   err_msg=name, **SVR_TOL)
    for name in ("Sx", "Sx_sz", "Ux_sz"):
        np.testing.assert_allclose(getattr(port, name), getattr(jax_v, name),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_perform_TSNE_matches_jax(smoothed):
    """The port's t-SNE (exact gradient) against the JAX package's
    (sklearn's Barnes-Hut, angle 0.5) from the same numpy seed: the same
    start and numpy RNG state afterwards, and a final KL (the exact
    objective of each embedding, under the port's P, which equals
    sklearn's to 1e-15) no worse than 1.02 x the JAX package's.  The
    coordinates are not compared: the JAX package's result is an
    approximate optimum of an unseeded Barnes-Hut descent."""
    from velocyto_tpu_torch.ops import tsne as tt
    jax_v, port = smoothed
    port.pcs = np.array(jax_v.pcs)
    states = []
    for v in (jax_v, port):
        np.random.seed(0)
        v.perform_TSNE(perplexity=10, n_pca_dim=5, max_iter=1000)
        states.append(np.random.get_state())
    for a, b in zip(*states):
        np.testing.assert_array_equal(a, b)
    assert port.ts.shape == jax_v.ts.shape == (120, 2)
    assert port.ts.dtype == jax_v.ts.dtype == np.float32
    P = tt.joint_probabilities_nn(torch.as_tensor(port.pcs[:, :5]), 10)
    kl = {tag: tt._tsne_grad_plain(torch.as_tensor(v.ts), P, P.data.float(),
                                   1, True)[1]
          for tag, v in (("jax", jax_v), ("port", port))}
    assert np.isfinite(kl["port"]) and kl["port"] <= 1.02 * kl["jax"], kl
