"""PCA matching sklearn's sign convention (host LAPACK, numpy/scipy).

Copied from velocyto_tpu/ops/pca.py so that both packages produce
identical PCs; the JAX package cannot be imported here, because its
package import loads jax.

Replaces reference perform_PCA (velocyto/analysis.py:678-702), which uses
sklearn.decomposition.PCA: center features, SVD, then sklearn's
``svd_flip`` (v-based, sklearn >= 1.5) so component signs agree with the
reference to numerical tolerance.  Two exact paths:
  - wide/square data: full LAPACK SVD
  - tall data (cells >> genes, the production regime): Gram-matrix
    eigendecomposition -- one BLAS *syrk* + LAPACK dsyevr restricted to
    the top n_components eigenpairs + one (N, G) x (G, k) projection.
    The total variance for explained-ratio normalization is
    trace(Gram)/(n-1), so no full spectrum is needed.  Above ~1e10
    multiply-adds the Gram is formed in f32 (VELOCYTO_PCA_F32=0/1 forces
    either precision).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils.profiling import span


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


def _pca_impl(x, k: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """x: (samples, features); k: components to materialize (None = all).
    Returns (pcs (n, k), components (k, features), explained_var (k,),
    total_var) with total_var = sum of ALL eigenvalues / (n - 1)."""
    x_in = np.asarray(x)
    n, g = x_in.shape
    k = min(k or g, g, n)
    if n > _GRAM_RATIO * g:
        from scipy.linalg import blas as _blas, eigh as _eigh
        # single-precision Gram above ~1e10 multiply-adds: its rounding
        # perturbs well-separated eigenpairs by ~sqrt(n)*eps32 ~ 1e-5
        # relative; eigenvectors inside near-degenerate (noise-floor)
        # clusters may rotate, as under any f32-level perturbation
        import os
        _env = os.environ.get("VELOCYTO_PCA_F32", "").strip()
        if _env in ("0", "1"):
            use_f32 = _env == "1"
        else:
            use_f32 = n * g * g >= 1e10
        with span("pca.center"):
            mu = np.mean(x_in, axis=0, keepdims=True, dtype=np.float64)
            xc = (np.asarray(x_in, np.float32) - mu.astype(np.float32)
                  if use_f32 else np.asarray(x_in, np.float64) - mu)
        with span("pca.gram"):          # upper triangle Xc'Xc
            c = np.asarray(_blas.ssyrk(1.0, xc, trans=1), np.float64) \
                if use_f32 else _blas.dsyrk(1.0, xc, trans=1)
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
            pcs = np.asarray(
                xc @ (vt.T.astype(xc.dtype)), np.float64)
        return pcs, vt, evals / (n - 1), total_var
    x = np.asarray(x_in, dtype=np.float64)
    mu = np.mean(x, axis=0, keepdims=True)
    xc = x - mu
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    u, vt = _svd_flip_vt(u, vt)
    expl = (s ** 2) / (n - 1)
    total_var = float(expl.sum())
    return (u[:, :k] * s[None, :k], vt[:k], expl[:k], total_var)


class PCA:
    """Minimal sklearn-compatible PCA facade used by the analysis layer."""

    def __init__(self, n_components: Optional[int] = None) -> None:
        self.n_components = n_components

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        # no eager f64 copy: _pca_impl picks its own working dtype, and
        # the input is typically a strided transpose view of (G, N) data
        X = np.asarray(X)
        k = self.n_components or min(X.shape)
        pcs, comps, expl, total_var = _pca_impl(X, k)
        self.components_ = comps
        self.explained_variance_ = expl
        self.explained_variance_ratio_ = expl / total_var
        with span("pca.mean"):
            self.mean_ = np.mean(X, axis=0, dtype=np.float64)
        return pcs

    def fit(self, X: np.ndarray) -> "PCA":
        self.fit_transform(X)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X) - self.mean_) @ self.components_.T
