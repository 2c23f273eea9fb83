"""VelocytoLoom's table of lazy attributes on the CPU, one case per kind
of entry, against the JAX package's eager attribute.

Each case takes a fresh port session that holds the attribute as a table
entry, reads it on the device (_get_dev, which builds no host value),
snapshots the session (to_hdf5 builds the host value from the entry, and
the loaded snapshot holds it exactly), holds the host value to the JAX
package's (dtype and values), then assigns a new value and checks that
every reader takes it: the attribute, _get_dev and a second snapshot.

Sessions: on the golden counts, normalize, PCA and the kNN smoothing for
the device output, normalize's pending view and the kNN csr; on the
golden stage outputs (test_torch_sampled.py's _state), the transition
and the shift in each mode for the rest.  Tolerances: the smoothing's 1e-4
(test_torch_normalize_device.py), the kNN weights' 1e-12
(test_torch_pipeline.py), correlations rtol 1e-3 / atol 1e-4 and
transition probabilities rtol 1e-3 / atol 1e-6 (test_torch_sampled.py);
normalize's view, the control and embedding_knn exact."""
import numpy as np
import pytest
import torch
from scipy import sparse

import velocyto_tpu as vt

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch import analysis

from test_torch_pipeline import CPU, GOLDEN, _fresh
from test_torch_sampled import _state


def _front(mod, golden):
    v = _fresh(mod, golden, **({"device": CPU} if mod is vtt else {}))
    v.normalize("both")
    v.perform_PCA(which="S_norm", n_components=20)
    v.knn_imputation(k=10, balanced=False, n_jobs=1)
    return v


def _transition(knn_random):
    def run(mod, golden):
        v = _state(mod, golden)
        v.estimate_transition_prob(hidim="Sx_sz", embed="ts",
                                   knn_random=knn_random, n_neighbors=20,
                                   sampled_fraction=0.5,
                                   calculate_randomized=True)
        v.calculate_embedding_shift(sigma_corr=0.05,
                                    expression_scaling=False)
        return v
    return run


SESSIONS = {"front": _front, "sampled": _transition(True),
            "full": _transition(False)}

# case: (session, attribute, entry class, rtol, atol); None: exact
CASES = {
    "device_output": ("front", "Ux", analysis._Device, 1e-4, 1e-4),
    "normalize_view": ("front", "U_norm", analysis._NormView, None, None),
    "knn_csr": ("front", "knn_smoothing_w", analysis._Built, 1e-12, 0),
    "control_plan": ("full", "delta_S_rndm", analysis._Permuted, None,
                     None),
    "probability_rows_sampled": ("sampled", "transition_prob",
                                 analysis._Rows, 1e-3, 1e-6),
    "probability_rows_full": ("full", "transition_prob",
                              analysis._ProbRows, 1e-3, 1e-6),
    "compact_dense_view": ("sampled", "corrcoef", analysis._Rows, 1e-3,
                           1e-4),
    "embedding_knn": ("full", "embedding_knn", analysis._Built, None, None),
}


@pytest.fixture(scope="module")
def jax_sessions():
    golden = np.load(GOLDEN)
    return {kind: run(vt, golden) for kind, run in SESSIONS.items()}


def _dense(x):
    return x.toarray() if sparse.issparse(x) else np.asarray(x)


def _held_to(got, want, rtol, atol):
    assert sparse.issparse(got) == sparse.issparse(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if sparse.issparse(want):
        np.testing.assert_array_equal(got.toarray() != 0,
                                      want.toarray() != 0)
    if rtol is None:
        np.testing.assert_array_equal(_dense(got), _dense(want))
    else:
        np.testing.assert_allclose(_dense(got), _dense(want), rtol=rtol,
                                   atol=atol)


def _snapshot(v, path):
    v.to_hdf5(str(path))
    return vtt.load_velocyto_hdf5(str(path), device="cpu")


def _same(a, b):
    assert type(a) is type(b) and a.dtype == b.dtype
    np.testing.assert_array_equal(_dense(a), _dense(b))


@pytest.mark.parametrize("case", list(CASES))
def test_lazy_attribute_reads_assigns_and_snapshots(case, jax_sessions,
                                                    tmp_path):
    kind, name, cls, rtol, atol = CASES[case]
    v = SESSIONS[kind](vtt, np.load(GOLDEN))
    want = getattr(jax_sessions[kind], name)
    assert type(v._table()[name]) is cls and name not in v.__dict__
    array = not sparse.issparse(want)
    if array:
        # on the device from the entry, building no host value
        dev = v._get_dev(name, torch.float64)
        assert dev.dtype == torch.float64 and name not in v.__dict__
        tol = dict(rtol=rtol or 0, atol=atol or 0)
        if cls is analysis._NormView:    # the device log2's rounding
            tol = dict.fromkeys(tol, 2 * np.finfo(want.dtype).eps)
        np.testing.assert_allclose(dev.numpy(), want, **tol)
    # to_hdf5 builds the host value from the entry; it loads exactly
    loaded = _snapshot(v, tmp_path / "read.hdf5")
    got = getattr(v, name)
    _same(loaded.__dict__[name], got)
    _held_to(got, want, rtol, atol)
    assert getattr(v, name) is got
    assert (name in v._table()) == (cls is analysis._Device)
    # an assigned value replaces the entry for every reader
    new = got * 2
    setattr(v, name, new)
    assert name not in v._table() and getattr(v, name) is new
    if array:
        np.testing.assert_array_equal(v._get_dev(name, torch.float64)
                                      .numpy(), np.asarray(new, np.float64))
    _same(_snapshot(v, tmp_path / "assigned.hdf5").__dict__[name], new)
