"""kNN smoothing (imputation) of count matrices with sparse weights.

Port of velocyto_tpu/ops/smoothing.py.  The reference smooths with a
sparse weight-matrix product (reference: velocyto/neighbors.py:385-423,
analysis.py:1006-1016); here the weights are padded to a compact (N, K)
index/weight form and the product runs on the device through
ops/knn_device.py::smooth_dev_multi, the same convolution the balanced
kNN smoothing uses.  The scipy.sparse helpers stay on the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy import sparse

from .knn_device import smooth_dev_multi


def connectivity_to_weights(mknn: sparse.spmatrix, axis: int = 1) -> sparse.spmatrix:
    """Row-normalize a binary connectivity matrix
    (reference: velocyto/neighbors.py:385-390)."""
    if not sparse.issparse(mknn) or mknn.format != "csr":
        mknn = sparse.csr_matrix(mknn)
    return mknn.multiply(1.0 / np.array(mknn.sum(axis=axis)))


def csr_to_compact(w: sparse.spmatrix) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a sparse row-stochastic weight matrix to (N, Kmax) index/weight
    arrays, each row's entries in csr order.  Padding entries have weight
    0 (index 0, harmless)."""
    w = sparse.csr_matrix(w)
    n = w.shape[0]
    counts = np.diff(w.indptr)
    kmax = int(counts.max()) if n else 0
    rows = np.repeat(np.arange(n), counts)
    cols = np.arange(w.nnz) - np.repeat(w.indptr[:-1], counts)
    idx = np.zeros((n, kmax), dtype=np.int32)
    wgt = np.zeros((n, kmax), dtype=np.float32)
    idx[rows, cols] = w.indices
    wgt[rows, cols] = w.data
    return idx, wgt


def convolve_compact_dev(data_rows: torch.Tensor, nbr_idx: torch.Tensor,
                         nbr_w: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k w[i, k] * data_rows[idx[i, k]] on data_rows' device:
    data_rows (N, G), nbr_idx / nbr_w (N, K) -> (N, G) float32."""
    (out,) = smooth_dev_multi((data_rows.to(torch.float32).T,),
                              nbr_idx.to(torch.int64),
                              nbr_w.to(torch.float32))
    return out.T


def convolve_by_sparse_weights_dev(data: torch.Tensor, w: sparse.spmatrix
                                   ) -> torch.Tensor:
    """data (genes, cells) tensor smoothed with weights w (cells, cells),
    out[:, i] = sum_j w[i, j] data[:, j]; float32 on data's device.  The
    columns of w.T must sum to one, as the reference requires."""
    colsums = np.asarray(w.T.sum(0)).ravel()
    if not np.allclose(colsums, 1):
        raise ValueError("weight matrix need to sum to one over the columns")
    idx, wgt = csr_to_compact(sparse.csr_matrix(w))
    dev = data.device
    return convolve_compact_dev(data.T, torch.as_tensor(idx, device=dev),
                                torch.as_tensor(wgt, device=dev)).T


def convolve_by_sparse_weights(data: np.ndarray, w: sparse.spmatrix,
                               device="cuda") -> np.ndarray:
    """Host form of convolve_by_sparse_weights_dev (reference expects w.T
    applied on the right: velocyto/neighbors.py:416-423): (genes, cells)
    in, float64 (genes, cells) out, computed on `device`."""
    dev = torch.as_tensor(np.asarray(data), dtype=torch.float32,
                          device=device)
    return convolve_by_sparse_weights_dev(dev, w).cpu().numpy().astype(
        np.float64)


def convolve_compact(data_rows: np.ndarray, nbr_idx: np.ndarray,
                     nbr_w: np.ndarray, device="cuda") -> np.ndarray:
    """Direct compact-form smoothing (cells as rows), float32 on the
    host, computed on `device`."""
    out = convolve_compact_dev(
        torch.as_tensor(np.asarray(data_rows), dtype=torch.float32,
                        device=device),
        torch.as_tensor(np.asarray(nbr_idx), dtype=torch.int64,
                        device=device),
        torch.as_tensor(np.asarray(nbr_w), dtype=torch.float32,
                        device=device))
    return out.cpu().numpy()
