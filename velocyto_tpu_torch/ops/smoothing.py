"""Smoothing-weight helper on the host (scipy.sparse).

Copied from velocyto_tpu/ops/smoothing.py::connectivity_to_weights; the
JAX package cannot be imported here, because its package import loads
jax.  The device smoothing itself is ops/knn_device.py::smooth_dev_multi.
"""
from __future__ import annotations

import numpy as np
from scipy import sparse


def connectivity_to_weights(mknn: sparse.spmatrix, axis: int = 1) -> sparse.spmatrix:
    """Row-normalize a binary connectivity matrix
    (reference: velocyto/neighbors.py:385-390)."""
    if not sparse.issparse(mknn) or mknn.format != "csr":
        mknn = sparse.csr_matrix(mknn)
    return mknn.multiply(1.0 / np.array(mknn.sum(axis=axis)))
