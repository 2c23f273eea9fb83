"""The port's t-SNE (velocyto_tpu_torch.ops.tsne, plain version on the
CPU) against sklearn's TSNE, which the JAX package calls, and
perform_TSNE against the JAX package.

Inputs: numpy-seeded Gaussian clusters (n <= 400).  Tolerances:

  - P against sklearn's _joint_probabilities_nn: rtol 1e-6, the same
    neighbour lists and csr layout (the binary search sums in another
    order; the result agrees to ~1e-15);
  - the plain gradient and KL error against sklearn's _kl_divergence_bh
    at angle 0 (every node a leaf: the exact sums) on the same P and
    positions: rtol 1e-5, and for the gradient an atol of 1e-5 x its
    largest component, since sklearn sums the forces in float32 and a
    component where attraction and repulsion cancel keeps the float32
    rounding of the summed magnitude;
  - the initial positions and numpy's RNG state afterwards: bit-equal;
  - the objective: the final KL (the exact objective of the embedding
    under the same P) of the port's perform_TSNE at most 1.02 x that of
    the JAX package's (sklearn's Barnes-Hut at angle 0.5) from the same
    seed.  Coordinates are not compared: sklearn's optimum is
    approximate and its descent takes other steps."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from sklearn.manifold import TSNE
from sklearn.manifold import _t_sne as sk_tsne
from sklearn.neighbors import NearestNeighbors

import velocyto_tpu as vt

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch import kernels
from velocyto_tpu_torch.ops import tsne as tt

from test_torch_pipeline import CPU
from test_torch_svr import _constants


def _clusters(n, d, seed):
    rng = np.random.RandomState(seed)
    centers = 3.0 * rng.randn(4, d)
    return centers[np.arange(n) % 4] + rng.randn(n, d)


def _sk_P(X, perplexity):
    k = min(X.shape[0] - 1, int(3.0 * perplexity + 1))
    dist = NearestNeighbors(n_neighbors=k).fit(X).kneighbors_graph(
        mode="distance")
    dist.data **= 2
    P = sp.csr_matrix(sk_tsne._joint_probabilities_nn(dist, perplexity, 0))
    P.sort_indices()
    return P


# (n, features, perplexity): kd-tree and brute-force searches in sklearn
P_CASES = [(300, 5, 20.0), (240, 20, 30.0), (90, 3, 10.0)]


@pytest.mark.parametrize("n,d,perplexity", P_CASES)
def test_joint_probabilities_match_sklearn(n, d, perplexity):
    X = _clusters(n, d, seed=n)
    want = _sk_P(X, perplexity)
    got = tt.joint_probabilities_nn(torch.as_tensor(X), perplexity)
    np.testing.assert_array_equal(got.indptr.numpy(), want.indptr)
    np.testing.assert_array_equal(got.indices.numpy(), want.indices)
    np.testing.assert_allclose(got.data.numpy(), want.data, rtol=1e-6)
    assert abs(float(got.data.sum()) - 1.0) < 1e-12


@pytest.mark.parametrize("n_components,scale", [(2, 1e-2), (2, 5.0),
                                                (3, 2.0), (1, 1.0)])
def test_gradient_and_error_match_sklearn_exact(n_components, scale):
    n, perplexity = 200, 15.0
    X = _clusters(n, 6, seed=3)
    P = _sk_P(X, perplexity)
    mine = tt.joint_probabilities_nn(torch.as_tensor(X), perplexity)
    y = (scale * np.random.RandomState(4).randn(n, n_components)).astype(
        np.float32)
    dof = max(n_components - 1, 1)
    err, grad = sk_tsne._kl_divergence_bh(
        y.ravel().copy(), P, dof, n, n_components, angle=0.0, num_threads=1)
    got, got_err = tt._tsne_grad_plain(torch.as_tensor(y), mine,
                                       mine.data.to(torch.float32), dof, True)
    grad = grad.reshape(n, n_components)
    np.testing.assert_allclose(got.numpy(), grad, rtol=1e-5,
                               atol=1e-5 * np.abs(grad).max())
    np.testing.assert_allclose(got_err, err, rtol=1e-5)
    g2, none = tt.kl_gradient(torch.as_tensor(y), mine,
                              mine.data.to(torch.float32), dof, False)
    assert none is None and torch.equal(g2, got)
    assert kernels.tsne_launches == 0       # CPU tensors: the plain version


def test_initial_positions_and_rng_state_match_sklearn(monkeypatch):
    X = _clusters(150, 5, seed=8)
    seen = {}

    def stop_sklearn(self, P, dof, n, X_embedded, **kw):
        seen["sklearn"] = X_embedded.copy()
        return X_embedded

    def stop_port(objective, p0, *args, **kw):
        seen["port"] = p0.numpy().copy()
        return p0, 0.0, 10 ** 6            # returns at once

    monkeypatch.setattr(sk_tsne.TSNE, "_tsne", stop_sklearn)
    monkeypatch.setattr(tt, "gradient_descent", stop_port)
    states = []
    np.random.seed(11)
    TSNE(perplexity=20, init="random").fit_transform(X)
    states.append(np.random.get_state())
    np.random.seed(11)
    tt.tsne(X, perplexity=20, device=CPU)
    states.append(np.random.get_state())
    assert seen["port"].dtype == seen["sklearn"].dtype == np.float32
    np.testing.assert_array_equal(seen["port"], seen["sklearn"].ravel())
    for a, b in zip(*states):
        np.testing.assert_array_equal(a, b)


def test_perform_TSNE_objective_not_worse_than_jax():
    n, perplexity = 400, 30
    pcs = _clusters(n, 10, seed=21)
    vs = []
    for mod, extra in ((vt, {}), (vtt, {"device": CPU})):
        v = mod.VelocytoLoom.__new__(mod.VelocytoLoom)
        for name, value in extra.items():
            setattr(v, name, value)
        v.pcs = pcs.copy()
        np.random.seed(5)
        v.perform_TSNE(perplexity=perplexity, n_pca_dim=8)
        vs.append(v)
    jax_v, port = vs
    assert port.ts.shape == (n, 2) and np.isfinite(port.ts).all()
    P = tt.joint_probabilities_nn(torch.as_tensor(pcs[:, :8]), perplexity)
    kl = [tt._tsne_grad_plain(torch.as_tensor(v.ts), P, P.data.float(), 1,
                              True)[1] for v in (jax_v, port)]
    assert kl[1] <= 1.02 * kl[0], kl


@pytest.mark.parametrize("n_dims,n", [(1, 300), (3, 200)])
def test_perform_TSNE_1d_3d_objective_not_worse_than_jax(n_dims, n):
    """perform_TSNE in one and three output dimensions (sklearn's dof =
    max(d - 1, 1)): the final exact KL at most 1.02 x the JAX package's.
    The clusters are the 2-D test's (seed 21), at sizes where sklearn's
    Barnes-Hut runs in seconds.  The ratio depends on the start: exact and
    Barnes-Hut descents land in different local minima, and sklearn's own
    exact method shows the same spread (ROADMAP, C5)."""
    pcs = _clusters(n, 10, seed=21)
    vs = []
    for mod, extra in ((vt, {}), (vtt, {"device": CPU})):
        v = mod.VelocytoLoom.__new__(mod.VelocytoLoom)
        for name, value in extra.items():
            setattr(v, name, value)
        v.pcs = pcs.copy()
        np.random.seed(5)
        v.perform_TSNE(n_dims=n_dims, perplexity=30, n_pca_dim=8)
        vs.append(v)
    jax_v, port = vs
    assert port.ts.shape == (n, n_dims) and np.isfinite(port.ts).all()
    P = tt.joint_probabilities_nn(torch.as_tensor(pcs[:, :8]), 30)
    dof = max(n_dims - 1, 1)
    kl = [tt._tsne_grad_plain(torch.as_tensor(v.ts), P, P.data.float(), dof,
                              True)[1] for v in (jax_v, port)]
    assert kl[1] <= 1.02 * kl[0], kl
    assert kernels.tsne_launches == 0       # CPU tensors: the plain version


class _OnCard:
    """A CPU tensor that reports a CUDA device, so a wrapper's checks run
    past the device test on a machine without a card."""

    def __init__(self, t):
        self._t = t

    is_cuda = True
    device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def _kt_inputs(n=5, d=2, nnz=7, **override):
    t = dict(y=torch.zeros(n, d), indptr=torch.zeros(n + 1, dtype=torch.int64),
             indices=torch.zeros(nnz, dtype=torch.int32),
             pval=torch.zeros(nnz))
    t.update(override)
    return {k: _OnCard(v) for k, v in t.items()}


@pytest.mark.parametrize("d", [1, 2, 3])
def test_kernel_checks_take_one_to_three_dims(d):
    assert kernels._tsne_check(**_kt_inputs(d=d)) == (5, d)


@pytest.mark.parametrize("name, value", [
    ("kBlockRows", kernels._TSNE_BLOCK_ROWS),
    ("kWarpsAttract", kernels._TSNE_WARPS)])
def test_scratch_sizes_match_kernel(name, value):
    """The wrapper sizes the passes' partials with the kernel's rows per
    block, read from its source."""
    assert _constants("tsne_grad.cu")[name] == value


@pytest.mark.parametrize("bad", [
    dict(d=4), dict(n=1), dict(y=torch.zeros(5, 2, dtype=torch.float64)),
    dict(y=torch.zeros(10)), dict(indptr=torch.zeros(5, dtype=torch.int64)),
    dict(indices=torch.zeros(7, dtype=torch.int64)),
    dict(pval=torch.zeros(6)), dict(y=torch.zeros(2, 5).t())])
def test_kernel_refuses_before_building(bad):
    """tsne_grad refuses four dimensions, a lone point, wrong dtypes, ranks,
    lengths and layouts, and CPU tensors, before any build."""
    shape = {k: bad.pop(k) for k in ("n", "d") if k in bad}
    with pytest.raises((ValueError, TypeError)):
        kernels.tsne_grad(**_kt_inputs(**shape, **bad))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.tsne_grad(torch.zeros(5, 2),
                          torch.zeros(6, dtype=torch.int64),
                          torch.zeros(7, dtype=torch.int32), torch.zeros(7))
    assert kernels._lib is None and kernels.tsne_launches == 0


def test_tsne_history_and_exploration_stop():
    """The error checks every 50 iterations: the exaggerated stage's KL is
    reported at its end, the last check is the final error, and it falls
    from the end of the exploration stage on."""
    hist = []
    np.random.seed(2)
    y, kl, last = tt.tsne(_clusters(160, 5, seed=2), perplexity=15,
                          max_iter=600, device=CPU, history=hist)
    assert y.shape == (160, 2) and y.dtype == np.float32
    assert last == 599 and len(hist) == 12 and hist[-1] == kl
    assert np.isfinite(hist).all() and kl < hist[4]
    with pytest.raises(ValueError, match="perplexity"):
        tt.tsne(np.zeros((10, 2)), perplexity=10, device=CPU)
