"""PCA matching sklearn's sign convention, its (samples, features)
arithmetic in torch on the input's device.

Replaces reference perform_PCA (velocyto/analysis.py:678-702), which uses
sklearn.decomposition.PCA: center features, SVD, then sklearn's
``svd_flip`` (v-based, sklearn >= 1.5) so component signs agree with the
reference to numerical tolerance.  Two exact paths:
  - wide/square data: full LAPACK SVD on the host (numpy), as the JAX
    package's ops/pca.py
  - tall data (cells >> genes, the production regime): Gram-matrix
    eigendecomposition -- the float64 per-feature mean (kept as
    ``mean_``), a centered copy and one matmul Xc'Xc on the input's
    device (TF32 pinned off), the (features, features) Gram copied to the
    host for LAPACK dsyevr restricted to the top n_components
    eigenpairs, then one (N, G) x (G, k) projection on the device.  The
    total variance for explained-ratio normalization is trace(Gram)/(n-1),
    so no full spectrum is needed.  Above ~1e10 multiply-adds the Gram is
    formed in f32 (VELOCYTO_PCA_F32=0/1 forces either precision).
A numpy input runs as a CPU tensor over its memory, so the CPU and the
card run one implementation.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import span
from .knn import full_f32

pca_torch_grams = 0     # Gram matrices formed by the torch route


def _svd_flip_vt(u: Optional[np.ndarray], vt: np.ndarray
                 ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """sklearn svd_flip (v-based): each row of Vt gets a positive
    max-abs entry."""
    max_abs_cols = np.argmax(np.abs(vt), axis=1)
    signs = np.sign(vt[np.arange(vt.shape[0]), max_abs_cols])
    signs[signs == 0] = 1.0
    if u is not None:
        u = u * signs[None, :]
    return u, vt * signs[:, None]


_GRAM_RATIO = 1.5   # use the Gram path when samples > ratio * features


def _as_tensor(X) -> torch.Tensor:
    """X as a tensor: a tensor as it is, an array as a CPU tensor over its
    memory (copied only where torch cannot view it: negative strides).
    Nothing here writes to it."""
    if isinstance(X, torch.Tensor):
        return X
    a = np.asarray(X)
    if any(s < 0 for s in a.strides):
        a = a.copy()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        return torch.from_numpy(a)


def _gram_f32(n: int, g: int) -> bool:
    # single-precision Gram above ~1e10 multiply-adds: its rounding
    # perturbs well-separated eigenpairs by ~sqrt(n)*eps32 ~ 1e-5
    # relative; eigenvectors inside near-degenerate (noise-floor)
    # clusters may rotate, as under any f32-level perturbation
    env = os.environ.get("VELOCYTO_PCA_F32", "").strip()
    if env in ("0", "1"):
        return env == "1"
    return n * g * g >= 1e10


def _pca_impl(x: torch.Tensor, k: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float,
                         np.ndarray]:
    """x: (samples, features) on any device; k: components to
    materialize (None = all).  Returns host arrays (pcs (n, k) float64,
    components (k, features), explained_var (k,), total_var, mean
    (features,) float64) with total_var = sum of ALL eigenvalues /
    (n - 1)."""
    global pca_torch_grams
    n, g = x.shape
    k = min(k or g, g, n)
    if n > _GRAM_RATIO * g:
        from scipy.linalg import eigh as _eigh
        wdt = torch.float32 if _gram_f32(n, g) else torch.float64
        with span("pca.mean"):
            mu = x.mean(0, dtype=torch.float64)
        with span("pca.center"):
            xc = x.to(wdt) - mu.to(wdt)
        with span("pca.gram"):          # Xc'Xc, its copy to the host
            with full_f32():
                c = xc.T @ xc
            c = c.cpu().numpy().astype(np.float64)
            pca_torch_grams += 1
            total_var = float(np.trace(c)) / (n - 1)
        with span("pca.eigh"):
            if k < g:
                evals, evecs = _eigh(c, lower=False,
                                     subset_by_index=[g - k, g - 1])
            else:
                evals, evecs = _eigh(c, lower=False)
            order = np.argsort(evals)[::-1]
            evals = np.maximum(evals[order], 0.0)
            vt = evecs[:, order].T              # rows = components
            _, vt = _svd_flip_vt(None, vt)
        with span("pca.project"):
            with full_f32():
                pcs = xc @ torch.as_tensor(vt.T, dtype=wdt, device=xc.device)
            pcs = pcs.cpu().numpy().astype(np.float64)
        return pcs, vt, evals / (n - 1), total_var, mu.cpu().numpy()
    x = np.asarray(x.cpu().numpy(), dtype=np.float64)
    mu = np.mean(x, axis=0, keepdims=True)
    xc = x - mu
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    u, vt = _svd_flip_vt(u, vt)
    expl = (s ** 2) / (n - 1)
    total_var = float(expl.sum())
    return (u[:, :k] * s[None, :k], vt[:k], expl[:k], total_var, mu[0])


class PCA:
    """Minimal sklearn-compatible PCA facade used by the analysis layer."""

    def __init__(self, n_components: Optional[int] = None) -> None:
        self.n_components = n_components

    def fit_transform(self, X) -> np.ndarray:
        """X: (samples, features), an array or a tensor on any device (the
        arithmetic runs there; a strided transpose view of (G, N) data is
        read as it is).  Returns the scores as a float64 host array."""
        x = _as_tensor(X)
        k = self.n_components or min(x.shape)
        pcs, comps, expl, total_var, mean = _pca_impl(x, k)
        self.components_ = comps
        self.explained_variance_ = expl
        self.explained_variance_ratio_ = expl / total_var
        self.mean_ = mean
        return pcs

    def fit(self, X) -> "PCA":
        self.fit_transform(X)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X) - self.mean_) @ self.components_.T
