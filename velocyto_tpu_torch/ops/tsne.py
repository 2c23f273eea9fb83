"""t-SNE with sklearn's semantics and the exact gradient.

The JAX package embeds with sklearn's Barnes-Hut ``TSNE``
(velocyto_tpu/analysis.py:1070; line numbers below are those of
sklearn/manifold/_t_sne.py in sklearn 1.9).  This module repeats it on a
torch device:

  - neighbours: k = min(n - 1, int(3 perplexity + 1)) (:954) from the
    port's exact device kNN (sklearn's tie-breaks), each point's own row
    dropped as ``kneighbors(None)`` drops it, distances squared;
  - joint probabilities: ``_joint_probabilities_nn`` (:71-119), the
    per-row perplexity binary search (100 steps, tolerance 1e-5, natural
    log entropy) vectorised over rows in float64, then P + P^T over
    max(sum, eps);
  - initial positions: ``init="random"`` draws 1e-4 x a float32 standard
    normal from numpy's global RNG, as sklearn does with
    ``random_state=None`` (:1016), so the positions and numpy's RNG state
    afterwards are those of the JAX package;
  - the optimizer ``_gradient_descent`` (:301-410): early exaggeration 12
    for 250 iterations at momentum 0.5, then 0.8; learning rate
    max(n / 12 / 4, 50); gains +0.2 / x0.8, at least 0.01; the error
    checked every 50 iterations with ``n_iter_without_progress`` (250,
    then 300) and ``min_grad_norm`` 1e-7; dof = max(dims - 1, 1).  The
    parameters, gains and update are float32 (sklearn keeps the update
    in float64).

The gradient is exact, not Barnes-Hut: the theta -> 0 limit of the same
objective, with the KL error sklearn's ``_kl_divergence_bh`` reports.
``kl_gradient`` launches the hand CUDA kernel (kernels/tsne_grad.cu, one
to three dimensions) for CUDA tensors and runs ``_tsne_grad_plain``, the dense
formula in float64 torch over row blocks, for CPU tensors.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .knn_device import knn_search_dev

_F32, _F64 = torch.float32, torch.float64
_EXPLORATION_ITER, _N_ITER_CHECK, _EXAGGERATION = 250, 50, 12.0
# sklearn's defaults: iterations without progress after the exploration
# stage, the least gradient norm and the least gain
_N_ITER_WITHOUT_PROGRESS, _MIN_GRAD_NORM, _MIN_GAIN = 300, 1e-7, 0.01
_MACHINE_EPS = float(np.finfo(np.double).eps)
_FLOAT32_TINY = float(np.finfo(np.float32).tiny)


class CSR:
    """A sparse (n, n) matrix as device tensors: indptr (n+1,) int64,
    indices (nnz,) int64, data (nnz,) float64, rows sorted by column."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor,
                 data: torch.Tensor, n: int) -> None:
        self.indptr, self.indices, self.data, self.n = indptr, indices, \
            data, n
        self.indices32 = indices.to(torch.int32)    # the kernel's form

    def rows(self) -> torch.Tensor:
        counts = self.indptr[1:] - self.indptr[:-1]
        return torch.repeat_interleave(
            torch.arange(self.n, device=self.indptr.device), counts)


def neighbors_sq(X: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The k nearest other points of each row of X: (squared distances
    (n, k) float64, indices (n, k) int64), as sklearn's
    ``kneighbors_graph(mode="distance")`` holds them before squaring."""
    n = X.shape[0]
    dist, idx = knn_search_dev(X, k + 1, device=X.device)
    keep = idx != torch.arange(n, device=idx.device)[:, None]
    # a row whose own index fell out of its k+1 (exact duplicates) loses
    # its first column instead, as sklearn's kneighbors(None) does
    keep[:, 0] &= ~keep.all(dim=1)
    idx = idx[keep].reshape(n, k)
    dist = dist[keep].reshape(n, k)
    return dist * dist, idx


def binary_search_perplexity(sqd: torch.Tensor, perplexity: float
                             ) -> torch.Tensor:
    """sklearn's _utils._binary_search_perplexity over all rows at once:
    (n, k) float32 squared distances -> conditional P (n, k) float64."""
    d = sqd.to(_F32).to(_F64)
    n = d.shape[0]
    dev = d.device
    desired = math.log(float(np.float32(perplexity)))
    tol = float(np.float32(1e-5))
    eps_dbl = float(np.float32(1e-8))
    beta = torch.ones(n, dtype=_F64, device=dev)
    beta_min = torch.full((n,), -math.inf, dtype=_F64, device=dev)
    beta_max = torch.full((n,), math.inf, dtype=_F64, device=dev)
    running = torch.ones(n, dtype=torch.bool, device=dev)
    out = torch.zeros_like(d)
    for _ in range(100):
        P = torch.exp(-d * beta[:, None])
        sum_p = P.sum(dim=1)
        sum_p = torch.where(sum_p == 0.0, eps_dbl, sum_p)
        P = P / sum_p[:, None]
        entropy = torch.log(sum_p) + beta * (d * P).sum(dim=1)
        diff = entropy - desired
        out = torch.where(running[:, None], P, out)
        step = running & ~(diff.abs() <= tol)
        up = step & (diff > 0.0)
        down = step & ~(diff > 0.0)
        beta_min = torch.where(up, beta, beta_min)
        beta_max = torch.where(down, beta, beta_max)
        beta = torch.where(
            up, torch.where(torch.isinf(beta_max), beta * 2.0,
                            (beta + beta_max) / 2.0),
            torch.where(down, torch.where(torch.isinf(beta_min), beta / 2.0,
                                          (beta + beta_min) / 2.0), beta))
        running = step
        if not bool(running.any()):
            break
    return out


def joint_probabilities_nn(X: torch.Tensor, perplexity: float) -> CSR:
    """sklearn's P over the k nearest neighbours of X (n, d): the
    symmetrised, normalised joint probabilities, float64."""
    n = X.shape[0]
    k = min(n - 1, int(3.0 * perplexity + 1))
    sqd, idx = neighbors_sq(X, k)
    # sklearn sorts each row of the distance csr by column first
    order = torch.argsort(idx, dim=1)
    sqd, idx = sqd.gather(1, order), idx.gather(1, order)
    cond = binary_search_perplexity(sqd.to(_F32), perplexity)
    rows = torch.arange(n, device=X.device).repeat_interleave(k)
    cols = idx.reshape(-1)
    # P + P^T: entries keyed by row * n + col, in sorted (csr) order; a
    # key holds at most the two terms p_j|i and p_i|j
    keys, inv = torch.unique(torch.cat([rows * n + cols, cols * n + rows]),
                             return_inverse=True)
    data = torch.zeros(keys.numel(), dtype=_F64, device=X.device).index_add_(
        0, inv, torch.cat([cond.reshape(-1), cond.reshape(-1)]))
    data = data / max(float(data.sum()), _MACHINE_EPS)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=X.device)
    indptr[1:] = torch.cumsum(torch.bincount(keys // n, minlength=n), 0)
    return CSR(indptr, (keys % n).contiguous(), data, n)


def _tsne_grad_plain(y: torch.Tensor, P: CSR, pval: torch.Tensor, dof: int,
                     compute_error: bool) -> Tuple[torch.Tensor,
                                                   Optional[float]]:
    """The exact KL gradient of positions y (n, d) and its error, dense in
    float64 over row blocks (the repulsive term needs every pair)."""
    y64 = y.to(_F64)
    n = y64.shape[0]
    exponent = (dof + 1.0) / 2.0
    block = max(1, min(n, (1 << 24) // max(1, n * y64.shape[1])))
    rep = torch.empty_like(y64)
    z = 0.0
    for r0 in range(0, n, block):
        diff = y64[r0:r0 + block, None, :] - y64[None, :, :]
        q = dof / (dof + (diff * diff).sum(dim=-1))
        if dof != 1:
            q = q ** exponent
        rows = torch.arange(r0, min(n, r0 + block), device=y.device)
        q[rows - r0, rows] = 0.0
        z += float(q.sum())
        rep[r0:r0 + block] = ((q * q)[..., None] * diff).sum(dim=1)
    z = max(z, _MACHINE_EPS)
    rows, cols = P.rows(), P.indices
    d = y64[rows] - y64[cols]
    q = dof / (dof + (d * d).sum(dim=1))
    if dof != 1:
        q = q ** exponent
    p = pval.to(_F64)
    attr = torch.zeros_like(y64).index_add_(0, rows, (p * q)[:, None] * d)
    grad = (2.0 * (dof + 1.0) / dof) * (attr - rep / z)
    err = None
    if compute_error:
        err = float((p * torch.log(p.clamp_min(_FLOAT32_TINY)
                                   / (q / z).clamp_min(_FLOAT32_TINY))).sum())
    return grad.to(_F32), err


def kl_gradient(y: torch.Tensor, P: CSR, pval: torch.Tensor, dof: int,
                compute_error: bool) -> Tuple[torch.Tensor, Optional[float]]:
    """(gradient (n, d) float32, KL error or None) of positions y (n, d)
    float32 under P with values pval (float32): the hand kernel for CUDA
    tensors (d = 1, 2 or 3 with sklearn's dof = max(d - 1, 1)), the plain
    version for CPU tensors."""
    if not y.is_cuda:
        return _tsne_grad_plain(y, P, pval, dof, compute_error)
    if dof != max(y.shape[1] - 1, 1):
        raise ValueError(f"the t-SNE kernel takes dof = max(d - 1, 1), got "
                         f"dof {dof} for d = {y.shape[1]}")
    grad, err = kernels.tsne_grad(y.contiguous(), P.indptr, P.indices32,
                                  pval, compute_error)
    return grad, (float(err) if err is not None else None)


def initial_positions(n: int, n_components: int) -> np.ndarray:
    """sklearn's init="random" with random_state=None: numpy's global
    RNG, so the draw and the RNG state afterwards match sklearn's."""
    return 1e-4 * np.random.standard_normal(
        size=(n, n_components)).astype(np.float32)


def gradient_descent(objective: Callable, p0: torch.Tensor, it: int,
                     max_iter: int, n_iter_without_progress: int,
                     momentum: float, learning_rate: float
                     ) -> Tuple[torch.Tensor, float, int]:
    """sklearn's _gradient_descent with n_iter_check=50: returns (params,
    the last error, the last iteration)."""
    p = p0.clone()
    update = torch.zeros_like(p)
    gains = torch.ones_like(p)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % _N_ITER_CHECK == 0
        error, grad = objective(p, check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min(
            _MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        p = p + update
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= _MIN_GRAD_NORM:
                break
    return p, error, i


def tsne(X, n_components: int = 2, perplexity: float = 30.0,
         init: Optional[np.ndarray] = None, max_iter: int = 1000,
         device="cuda", history: Optional[list] = None
         ) -> Tuple[np.ndarray, float, int]:
    """Embed the rows of X (n, d): returns (positions (n, n_components)
    float32, the final KL error, the last iteration), as sklearn's
    ``TSNE(n_components, perplexity, init, max_iter).fit_transform(X)``
    with its other defaults.  ``history``, when given, receives the KL
    error of each check (every 50 iterations, and the last)."""
    x = X.to(_F64) if isinstance(X, torch.Tensor) else \
        torch.as_tensor(np.asarray(X), dtype=_F64, device=device)
    n = x.shape[0]
    if perplexity >= n:
        raise ValueError(f"perplexity ({perplexity}) must be less than "
                         f"n_samples ({n})")
    learning_rate = max(n / _EXAGGERATION / 4, 50)
    P = joint_probabilities_nn(x, perplexity)
    y0 = initial_positions(n, n_components) if init is None else \
        np.asarray(init, dtype=np.float32)
    dof = max(n_components - 1, 1)
    p_exag = P.data * _EXAGGERATION

    def objective(pval: torch.Tensor) -> Callable:
        def f(params, compute_error):
            grad, err = kl_gradient(params.reshape(n, n_components), P, pval,
                                    dof, compute_error)
            if compute_error and history is not None:
                history.append(err)
            return (err if compute_error else float("nan")), grad.reshape(-1)
        return f

    params = torch.as_tensor(y0.ravel(), device=x.device)
    params, kl, it = gradient_descent(
        objective(p_exag.to(_F32)), params, 0, _EXPLORATION_ITER,
        _EXPLORATION_ITER, 0.5, learning_rate)
    if it < _EXPLORATION_ITER or max_iter - _EXPLORATION_ITER > 0:
        params, kl, it = gradient_descent(
            objective((p_exag / _EXAGGERATION).to(_F32)), params, it + 1,
            max_iter, _N_ITER_WITHOUT_PROGRESS, 0.8, learning_rate)
    return params.reshape(n, n_components).cpu().numpy(), kl, it
