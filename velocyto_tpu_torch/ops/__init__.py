"""Numerical stages of the port (device tensors and host numpy).

Exports the JAX package's list (velocyto_tpu/ops/__init__.py)."""
from .coldeltacor import (col_delta_cor, col_delta_cor_partial,
                          col_delta_cor_partial_compact,
                          col_delta_cor_partial_sharded,
                          col_delta_cor_dense_sharded)
from .knn import (knn_search, knn_search_sharded, knn_balance,
                  balance_knn_loop, BalancedKNN,
                  knn_distance_matrix, make_mutual, take_top, min_n,
                  knn_smooth_weights)
from .smoothing import (connectivity_to_weights, convolve_by_sparse_weights,
                        convolve_compact, csr_to_compact)
from .gamma import (fit_slope, fit_slope_offset, fit_slope_weighted,
                    fit_slope_weighted_offset, clusters_stats)
from .pca import PCA

__all__ = [
    "col_delta_cor", "col_delta_cor_partial", "col_delta_cor_partial_compact",
    "col_delta_cor_partial_sharded", "col_delta_cor_dense_sharded",
    "knn_search", "knn_search_sharded", "knn_balance", "balance_knn_loop",
    "BalancedKNN",
    "knn_distance_matrix", "make_mutual", "take_top", "min_n",
    "knn_smooth_weights",
    "connectivity_to_weights", "convolve_by_sparse_weights",
    "convolve_compact", "csr_to_compact",
    "fit_slope", "fit_slope_offset", "fit_slope_weighted",
    "fit_slope_weighted_offset", "clusters_stats",
    "PCA",
]
