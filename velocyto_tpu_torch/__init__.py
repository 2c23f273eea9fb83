"""velocyto_tpu_torch: velocyto_tpu on PyTorch.

A port of velocyto_tpu (JAX/Pallas on TPU) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.  It keeps the JAX package's module names
(analysis, estimation, diffusion, models.velocity, ops.coldeltacor,
ops.knn, ops.knn_device, ops.gamma, ops.pca, ops.smoothing, io.loom,
io.checkpoint, serialization, utils.profiling, parallel, and the
counting half: counting, commands, metadata, native) and never imports
jax.  Every
object and function of the analysis surface works on an explicit torch
device; kernels build on first use (see ``kernels``).  Counting (BAM +
GTF -> loom) is host code, as in the JAX package; its native BAM engine
also builds on first use (see ``native``).  Importing the package
imports neither click nor h5py nor matplotlib (the plots import it
when they draw).
"""
from ._version import __version__
from .constants import *  # noqa: F401,F403
from . import kernels
from .analysis import (VelocytoLoom, colormap_fun, gaussian_kernel,
                       ixs_thatsort_a2b, load_velocyto_hdf5,
                       numba_random_seed, permute_rows_nsign,
                       scale_to_match_median, scatter_viz, state_from_numpy)
from .diffusion import Diffusion
from .estimation import (colDeltaCor, colDeltaCorLog10, colDeltaCorLog10partial,
                         colDeltaCorpartial, colDeltaCorSqrt,
                         colDeltaCorSqrtpartial)
from .ops.coldeltacor import (col_delta_cor, col_delta_cor_partial,
                              col_delta_cor_partial_compact,
                              col_delta_cor_partial_sharded)
from .ops.gamma import (clusters_stats, compute_fit_weights, fit_slope,
                        fit_slope_offset, fit_slope_weighted,
                        fit_slope_weighted_offset)
from .ops.knn import (BalancedKNN, balance_knn_loop, knn_balance,
                      knn_distance_matrix, knn_search, knn_smooth_weights,
                      make_mutual, min_n, take_top)
from .ops.knn_device import knn_search_dev
from .ops.pca import PCA
from .ops.smoothing import connectivity_to_weights, convolve_by_sparse_weights
from .parallel import (CELLS, GENES, make_mesh, single_device_mesh,
                       initialize_distributed)
from .serialization import dump_hdf5, load_hdf5
from .metadata import Metadata, MetadataCollection
from . import io
from .counting import (Logic, Permissive10X, Intermediate10X,
                       ValidatedIntrons10X, Stricter10X, ObservedSpanning10X,
                       Discordant10X, SmartSeq2, Default, LOGICS,
                       Feature, TranscriptModel, GeneInfo, Read,
                       Molitem, SegmentMatch, ExInCounter)

__all__ = ["kernels", "VelocytoLoom", "colormap_fun", "gaussian_kernel",
           "scatter_viz", "ixs_thatsort_a2b", "knn_search",
           "col_delta_cor_partial_compact",
           "load_velocyto_hdf5", "dump_hdf5", "load_hdf5", "numba_random_seed", "permute_rows_nsign", "scale_to_match_median",
           "state_from_numpy", "Diffusion", "colDeltaCor", "colDeltaCorLog10",
           "colDeltaCorLog10partial", "colDeltaCorpartial", "colDeltaCorSqrt",
           "colDeltaCorSqrtpartial", "col_delta_cor", "col_delta_cor_partial",
           "col_delta_cor_partial_sharded", "CELLS", "GENES", "make_mesh",
           "single_device_mesh", "initialize_distributed",
           "clusters_stats", "compute_fit_weights", "fit_slope",
           "fit_slope_offset", "fit_slope_weighted",
           "fit_slope_weighted_offset", "BalancedKNN", "balance_knn_loop",
           "knn_balance", "knn_distance_matrix", "knn_smooth_weights",
           "make_mutual", "min_n", "take_top", "knn_search_dev", "PCA",
           "connectivity_to_weights", "convolve_by_sparse_weights",
           "__version__", "Metadata", "MetadataCollection", "io", "Logic",
           "Permissive10X", "Intermediate10X", "ValidatedIntrons10X",
           "Stricter10X", "ObservedSpanning10X", "Discordant10X",
           "SmartSeq2", "Default", "LOGICS", "Feature", "TranscriptModel",
           "GeneInfo", "Read", "Molitem", "SegmentMatch", "ExInCounter"]
