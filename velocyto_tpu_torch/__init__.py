"""velocyto_tpu_torch: the estimation pipeline of velocyto_tpu on PyTorch.

A port of velocyto_tpu (JAX/Pallas on TPU) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.  It keeps the JAX package's module names
(analysis, ops.coldeltacor, ops.knn, ops.knn_device, ops.gamma, ops.pca,
io.loom) and never imports jax.  Every object and function works on an
explicit torch device; kernels build on first use (see ``kernels``).
"""
from . import kernels
from .analysis import (VelocytoLoom, numba_random_seed, permute_rows_nsign,
                       state_from_numpy)
from .ops.coldeltacor import col_delta_cor
from .ops.gamma import compute_fit_weights, fit_slope_weighted_offset
from .ops.knn import balance_knn_loop, knn_balance
from .ops.knn_device import knn_search_dev
from .ops.pca import PCA

__all__ = ["kernels", "VelocytoLoom", "numba_random_seed",
           "permute_rows_nsign", "state_from_numpy", "col_delta_cor",
           "compute_fit_weights", "fit_slope_weighted_offset",
           "balance_knn_loop", "knn_balance", "knn_search_dev", "PCA"]
