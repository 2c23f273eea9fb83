"""VelocytoLoom: the analysis object of velocyto_tpu on PyTorch.

Port of velocyto_tpu/analysis.py (itself an API-parity re-implementation
of the reference's analysis object, velocyto/analysis.py:26-2470):

  filter / score genes and cells -> normalize family -> perform_PCA ->
  knn_imputation (or its precomputed / gene-axis forms) -> fit_gammas ->
  filter_genes_by_phase_portrait -> predict_U / calculate_velocity /
  calculate_shift / extrapolate_cell_at_t -> estimate_transition_prob
  (sampled or full) -> calculate_embedding_shift -> calculate_grid_arrows
  -> prepare_markov / run_markov

Every object works on one explicit torch device (``device=``; the default
is "cuda"), or over a mesh of shards (``mesh=``, parallel.make_mesh): the
kNN candidate pass, the colDeltaCor kernels and the embedding shift then
split cells over the mesh's shards with expression replicated, and every
stage gives the mesh-free result; the rest runs on the mesh's first
device.  The heavy (genes, cells) stage outputs, the correlation
state and the Markov matrix stay on that device between stages, and
normalize's four views stay the plan that builds them (the raw counts,
the cell factors, the pseudocount); stages read them there, and the
numpy (or csr) attributes the reference exposes are built on first
read, in both transition modes.  One table of lazy attributes holds all
of these forms (see "lazy attributes" below).  Both colDeltaCor variants
run through hand-written CUDA kernels on a CUDA device
(ops/coldeltacor.py), and so does the balanced kNN's greedy balance
(ops/knn_device.py), which keeps the whole kNN chain on the device.
Host stages (the filter/score
family, the normalizations' cell sizes and factors, PCA's eigensolver of
the (genes, genes) Gram matrix, the gene-axis kNN balance, the
randomized control's permutation plan, the neighbour-sampling replay and
the grid field) stay numpy/scipy/C++, as in the JAX package.  The two
SVR noise models (score_cv_vs_mean, adjust_totS_totU) and perform_TSNE
run on the object's device through the port's own ops/svr.py and
ops/tsne.py (hand CUDA kernels for the SMO loop and the t-SNE
gradient), without sklearn.
The plots (plot_*, scatter_viz, score_cv_vs_mean(plot=True)) are the
JAX package's; they and set_clusters without colours import matplotlib
when they run, never at import.
"""
from __future__ import annotations

import io
import logging
import pickle
import queue
import threading
import warnings
from copy import deepcopy
from functools import partial
from operator import methodcaller
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from scipy import sparse
from scipy.stats import norm as normal

from . import native
from .diffusion import Diffusion
from .io import loom as loomio
from .ops import knn_device as kd
from .ops.coldeltacor import (chunk_order, col_delta_cor,
                              col_delta_cor_partial_sharded_dev,
                              locality_order, make_partial_compact_chunked)
from .ops.gamma import (clusters_stats, compute_fit_weights, fit_slope,
                        fit_slope_offset, fit_slope_weighted,
                        fit_slope_weighted_offset)
from .ops.knn import (BalancedKNN, _knn_query_impl, full_f32,
                      knn_distance_matrix)
from .ops.pca import PCA, _as_tensor
from .ops.smoothing import (connectivity_to_weights,
                            convolve_by_sparse_weights_dev)
from .ops.svr import SVR
from .parallel.mesh import map_rows
from .ops.tsne import tsne
from .serialization import dump_hdf5, load_hdf5
from .utils.profiling import span, spanned

_F32, _F64 = torch.float32, torch.float64



class _Default(str):
    """A default argument value that an explicit equal value is told
    apart from (by identity)."""


_CUDA = _Default("cuda")

# row chunks of the neighbour-sampling replay in the sampled path (the
# JAX package's n_chunks); one sampled colDeltaCor launch each on a card
SAMPLER_CHUNKS = 4

normalize_host_views = 0    # host views of normalize's plan built on read


# Copied from velocyto_tpu/analysis.py::_scaled_pair (bit-exact to the
# naive expressions).
def _scaled_pair(M: np.ndarray, factor: Any, pcount: float, want_log: bool,
                 clean_nonfinite: bool = False
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """``factor * M`` and optionally ``log2(factor * M + pcount)`` with
    out= ufuncs into freshly-requested buffers (no broadcast temporaries).

    Bit-exact to the naive expressions: dtypes come from 1-element
    probes of the actual operands, and per-element op order is
    unchanged (multiply; optional nonfinite-to-zero; add; log2)."""
    f_probe = factor if np.isscalar(factor) else np.ravel(factor)[:1]
    m_probe = np.ravel(M)[:1]
    with np.errstate(divide="ignore", invalid="ignore"):
        sz_probe = f_probe * m_probe
        sz = np.empty(M.shape, sz_probe.dtype)
        np.multiply(factor, M, out=sz, casting="unsafe")
        if clean_nonfinite and sz.dtype.kind == "f":
            np.nan_to_num(sz, copy=False, nan=0.0, posinf=0.0, neginf=0.0)
        norm = None
        if want_log:
            log_probe = np.log2(sz_probe + pcount)
            norm = np.empty(M.shape, log_probe.dtype)
            np.add(sz, pcount, out=norm, casting="unsafe")
            np.log2(norm, out=norm)
    return sz, norm


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype; unsigned integers wider than a
    byte as int64, which torch computes with on every device."""
    if dt.kind == "u" and dt.itemsize > 1:
        return torch.int64
    return torch.from_numpy(np.empty(0, dt)).dtype


# ----------------------------------------------------------------------
# lazy attributes: VelocytoLoom.__dict__ holds the plain host attributes
# and the device tensors the transition state is built from
# (_compact_ixs_dev, the embedding neighbour ids of both modes; _corr_dev,
# _corr_rndm_dev; _knn_graph_dev).  Every other value an attribute can
# have is an entry of one table, __dict__["_lazy"], keyed by name, of one
# of the classes below.  The dispatch methods (__getattr__, __setattr__,
# _drop, _set_dev, _get_dev, _stage_input, to_hdf5,
# io.checkpoint.save_vlm) ask the entry and name no attribute, so a new
# lazy form is a new entry class and edits none of them.
# ----------------------------------------------------------------------


class _Lazy:
    """One attribute held in another form than its host value.

    host(v, name) builds the host value; when ``keep``, __getattr__ then
    stores it as the plain attribute and drops the entry.  dev(v, name,
    dtype) is the value on v.device in dtype (the host value's own when
    None), and keeps nothing.  stage(v, name, dtype) is what a stage
    reads: a tensor, or a host value to upload.  saved(v, name) is what
    io.checkpoint.save_vlm writes (None: nothing).  ``sources`` names the
    attributes the entry was planned from: before one of them changes,
    source_changed(v, name) acts, by default by dropping the entry.  An
    entry is runtime state: to_hdf5 writes what snapshot(v, name) gives,
    its host value."""
    keep = True
    sources: Tuple[str, ...] = ()

    def host(self, v, name):
        raise NotImplementedError

    def dev(self, v, name, dtype):
        return v._upload(name, getattr(v, name), dtype)

    def stage(self, v, name, dtype):
        return self.dev(v, name, dtype)

    def saved(self, v, name):
        return None

    def snapshot(self, v, name):
        return {name: getattr(v, name)}

    def source_changed(self, v, name):
        v._table().pop(name, None)


class _Device(_Lazy):
    """A stage output held as a tensor on the device; downstream stages
    take the tensor (aliases allowed: Sx_sz may be Sx; nothing updates
    one in place).  The host value (``form`` of the tensor's numpy copy)
    is built on first read and kept here, not as the attribute: _get_dev
    still gives the tensor, while stage() gives the handed-out view, so
    the stages that read one (_stage_input, the shift's corrcoef,
    prepare_markov's transition_prob, run_markov's tr) take its edits,
    as the JAX package would."""
    keep = False

    def __init__(self, t: torch.Tensor, form: Callable) -> None:
        self.t, self.form, self.view = t, form, None

    def host(self, v, name):
        if self.view is None:
            self.view = self.form(self.t.cpu().numpy())
        return self.view

    def dev(self, v, name, dtype):
        return self.t.to(dtype)

    def stage(self, v, name, dtype):
        return self.t if self.view is None else self.view

    def saved(self, v, name):
        return self.t


class _NormView(_Lazy):
    """normalize's <src>_sz = factor * <src> and <src>_norm =
    log2(<src>_sz + pcount), held as the plan that builds them: the raw
    counts (by reference: an in-place edit of S or U reaches the views
    still pending), the factor, the pseudocount; one entry for a source's
    views.  A host view is built on first read by _scaled_pair, bitwise
    the eager value, with the size-normalized view it passes through
    where that is pending from the same entry; a device consumer builds
    its own copy from the uploaded raw counts.  A write to the source
    builds the views still pending first."""

    def __init__(self, src: str, M: Any, factor: Any, pcount: float,
                 clean: bool) -> None:
        self.src, self.M, self.factor, self.pcount, self.clean = \
            src, M, factor, pcount, clean
        self.sources = (src,)

    def host(self, v, name):
        global normalize_host_views
        log = name.endswith("_norm")
        sz, norm = _scaled_pair(self.M, self.factor, self.pcount, log,
                                clean_nonfinite=self.clean)
        normalize_host_views += 1
        if log and v._table().get(self.src + "_sz") is self:
            v._keep(self.src + "_sz", sz)
            normalize_host_views += 1
        return norm if log else sz

    def dev(self, v, name, dtype):
        """The view built on v.device from the uploaded raw counts, in the
        host's order of operations and in the dtypes its 1-element probes
        give (multiply; for U nonfinite to zero; add pcount; log2): the
        size-normalized view is bitwise the host one, the log2 view
        within the device log2's rounding.  One (genes, cells) buffer
        where the dtypes agree, the upload's own."""
        M, factor, pcount = self.M, self.factor, self.pcount
        f_probe = factor if np.isscalar(factor) else np.ravel(factor)[:1]
        with np.errstate(divide="ignore", invalid="ignore"):
            sz_probe = f_probe * np.ravel(M)[:1]
            add_probe = sz_probe + pcount
            log_probe = np.log2(add_probe)
        sz_dt, add_dt, log_dt = (_torch_dtype(p.dtype) for p in
                                 (sz_probe, add_probe, log_probe))
        with span("normalize." + self.src):
            with span("upload." + self.src):
                x = torch.empty(np.shape(M), dtype=sz_dt, device=v.device)
                x.copy_(_as_tensor(M))
            x.mul_(torch.as_tensor(np.asarray(factor),
                                   device=v.device).to(sz_dt))
            if self.clean and x.is_floating_point():
                x.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
            if name.endswith("_norm"):
                if isinstance(pcount, np.generic):
                    pcount = pcount.item()
                x = x.to(add_dt).add_(pcount).to(log_dt).log2_()
            return x.to(dtype)

    def saved(self, v, name):
        return getattr(v, name)

    def source_changed(self, v, name):
        getattr(v, name)

    def take(self, rows: np.ndarray) -> "_NormView":
        """The plan over the rows (genes) `rows` of the raw counts."""
        return _NormView(self.src, self.M[rows], self.factor, self.pcount,
                         self.clean)


class _Permuted(_Lazy):
    """The full mode's delta_S_rndm held as the plan that draws it: the
    call's delta_S (the device tensor, or a float64 host copy), the
    permutations and the sign bits (host arrays).  _permute_apply_dev
    builds it, bitwise permute_rows_nsign: on the host in float64 on
    first read, on the device for a stage."""

    def __init__(self, src: Any, perms: np.ndarray,
                 sign_bits: np.ndarray) -> None:
        self.src, self.perms, self.sign_bits = src, perms, sign_bits

    def _apply(self, device: Any) -> torch.Tensor:
        return _permute_apply_dev(
            torch.as_tensor(self.src, device=device),
            torch.from_numpy(self.perms).to(device),
            torch.from_numpy(self.sign_bits).to(device))

    def host(self, v, name):
        return self._apply("cpu").numpy().astype(np.float64)

    def dev(self, v, name, dtype):
        return self._apply(v.device).to(_F64 if dtype is None else dtype)

    def saved(self, v, name):
        return getattr(v, name)


class _Rows(_Lazy):
    """A dense (N, N) attribute held as (N, nn) rows at neighbour ids,
    both tensors: the sampled mode's corrcoef / corrcoef_random (its
    compact correlations) and, given sigma, transition_prob /
    transition_prob_random (their row softmax at sigma_corr), dense
    float64 as the JAX package builds them, in numpy on the host and in
    torch on the device."""
    dtype = np.float64

    def __init__(self, ixs: torch.Tensor, rows: torch.Tensor,
                 sigma: Optional[float] = None,
                 sources: Tuple[str, ...] = ()) -> None:
        self.ixs, self.rows, self.sigma, self.sources = \
            ixs, rows, sigma, sources

    def host(self, v, name):
        x = self.rows.cpu().numpy().astype(self.dtype)
        if self.sigma is not None:
            x = np.exp(x / self.sigma)
            x = x / x.sum(1)[:, None]
        ixs = self.ixs.cpu().numpy()
        n = ixs.shape[0]
        dense = np.zeros((n, n), dtype=self.dtype)
        dense[np.arange(n)[:, None], ixs] = x
        return dense

    def dev(self, v, name, dtype):
        x = self.rows
        if self.sigma is not None:
            x = torch.exp(x.to(_F64) / self.sigma)
            x = x / x.sum(dim=1, keepdim=True)
        if dtype is None:
            dtype = _torch_dtype(np.dtype(self.dtype))
        n = self.ixs.shape[0]
        return torch.zeros((n, n), dtype=dtype, device=x.device).scatter_(
            1, self.ixs.to(torch.int64), x.to(dtype))

    def snapshot(self, v, name):
        # the JAX package keeps sigma_corr beside its lazy views, and its
        # snapshots carry it: so do this package's
        out = super().snapshot(v, name)
        if self.sigma is not None:
            out["_tp_sigma"] = self.sigma
        return out


class _ProbRows(_Rows):
    """transition_prob / transition_prob_random held as the float32
    probability rows the shift computed on gathered correlations, at the
    embedding neighbour ids: dense float32 on read, and in a
    checkpoint."""
    dtype = np.float32

    def saved(self, v, name):
        return self.dev(v, name, _F32)


class _Built(_Lazy):
    """A host attribute that build() makes from device tensors on first
    read: knn and knn_smoothing_w from the kNN graph, embedding_knn from
    the neighbour ids, the sampled mode's _compact_ixs, _compact_corr
    and _compact_corr_random; dropped when a source changes."""

    def __init__(self, build: Callable[[], Any],
                 sources: Tuple[str, ...]) -> None:
        self.build, self.sources = build, sources

    def host(self, v, name):
        return self.build()


def _host_copy(t: torch.Tensor, dtype: Any) -> np.ndarray:
    return t.cpu().numpy().astype(dtype)


def _neighbour_csr(ixs: torch.Tensor) -> sparse.csr_matrix:
    """The (N, N) unit connectivity csr of (N, nn) neighbour ids."""
    n, nn = ixs.shape
    return sparse.csr_matrix(
        (np.ones(n * nn), _host_copy(ixs, np.int64).ravel(),
         np.arange(0, n * nn + 1, nn)), shape=(n, n))


class VelocytoLoom:
    """In-memory analysis object for a velocyto loom file.

    Attribute-accretion API matching the reference (analysis.py:26-94):
    methods return None and create attributes (S, U, A, S_sz, Sx, gammas,
    velocity, delta_embedding, ...).
    """

    def __init__(self, loom_filepath: str, device=_CUDA, mesh=None) -> None:
        """device: the torch device of the object's tensors.  mesh: an
        optional parallel.Mesh; the kNN search, the colDeltaCor kernels
        and the embedding shift then split cells over its shards, with
        the mesh-free results, and self.device is its first device (an
        explicit, different device raises ValueError)."""
        self.loom_filepath = loom_filepath
        if mesh is not None:
            if device is not _CUDA and torch.device(device) != \
                    mesh.first_device:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh.first_device}")
            device = mesh.first_device
        self.device = torch.device(device)
        self.mesh = mesh
        ds = loomio.connect(self.loom_filepath)
        try:
            self.S = ds.layer["spliced"][:, :]
            self.U = ds.layer["unspliced"][:, :]
            self.A = ds.layer["ambiguous"][:, :]
            self.ca = dict(ds.col_attrs.items())
            self.ra = dict(ds.row_attrs.items())
        finally:
            ds.close()

        self.initial_cell_size = self.S.sum(0)
        self.initial_Ucell_size = self.U.sum(0)

        if "_Valid" in self.ca and np.mean(self.ca["_Valid"]) < 1:
            logging.warning(
                f"fraction of _Valid cells is {np.mean(self.ca['_Valid'])} "
                "but all will be taken in consideration")

    # ------------------------------------------------------------------
    # lazy attributes (the table: see the module's "lazy attributes")
    # ------------------------------------------------------------------

    # the host form of a device-backed attribute: float64, as the JAX
    # package's host arrays, but float32 for the (cells, cells)
    # correlations and probabilities, as its full mode keeps them, and the
    # reference's csr for the Markov matrix
    _HOST_FORM = {**dict.fromkeys(
        ("corrcoef", "corrcoef_random", "transition_prob",
         "transition_prob_random"), methodcaller("astype", np.float32)),
        "tr": sparse.csr_matrix}

    def _table(self) -> Dict[str, _Lazy]:
        """The lazy attributes by name (a new empty dict when none was
        planned)."""
        return self.__dict__.get("_lazy") or {}

    def _plan(self, name: str, entry: _Lazy) -> None:
        """Hold `name` as `entry` in place of a value."""
        self._drop(name)
        self.__dict__.setdefault("_lazy", {})[name] = entry

    def _keep(self, name: str, value: Any) -> None:
        """Store a built host value as the plain attribute `name`."""
        self._table().pop(name, None)
        self.__dict__[name] = value

    def _has(self, name: str) -> bool:
        """hasattr(self, name), building nothing."""
        return name in self.__dict__ or name in self._table()

    def __setattr__(self, name: str, value: Any) -> None:
        self._drop(name)
        object.__setattr__(self, name, value)

    def __getattr__(self, name: str):
        # only reached when normal lookup fails: build a lazy attribute
        entry = self._table().get(name)
        if entry is None:
            raise AttributeError(
                f"'{type(self).__name__}' object has no attribute '{name}'")
        value = entry.host(self, name)
        if entry.keep:
            self._keep(name, value)
        return value

    def _drop(self, *names: str) -> None:
        """Forget attributes, plain values and table entries alike; the
        entries planned from one of them act first (source_changed)."""
        table = self._table()
        for name in names:
            for other, entry in list(table.items()):
                if name in entry.sources and table.get(other) is entry:
                    entry.source_changed(self, other)
            table.pop(name, None)
            self.__dict__.pop(name, None)

    def _set_dev(self, name: str, dev: torch.Tensor) -> None:
        """Store a device tensor as the authoritative value of `name`."""
        self._plan(name, _Device(dev, self._HOST_FORM.get(
            name, methodcaller("astype", np.float64))))

    def _upload(self, name: str, x: Any,
                dtype: Optional[torch.dtype]) -> torch.Tensor:
        with span("upload." + name):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

    def _get_dev(self, name: str,
                 dtype: Optional[torch.dtype] = _F32) -> torch.Tensor:
        """`name` as a tensor on self.device in `dtype` (its own when
        None): a lazy attribute's entry gives it (a device-backed
        attribute its tensor, with no copy; the others build it there and
        keep nothing); a host value is uploaded."""
        entry = self._table().get(name)
        if entry is None:
            return self._upload(name, getattr(self, name), dtype)
        return entry.dev(self, name, dtype)

    def _stage_value(self, name: str,
                     dtype: Optional[torch.dtype] = None) -> Any:
        """`name` as a stage reads it: a lazy attribute's stage value (a
        device-backed attribute's tensor, or its host view once handed
        out, edits included; the others built on the device), else the
        attribute."""
        entry = self._table().get(name)
        if entry is None:
            return getattr(self, name)
        return entry.stage(self, name, dtype)

    def _stage_input(self, name: str,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """_stage_value on self.device in `dtype` (its own when None),
        uploaded where it is a host value."""
        x = self._stage_value(name, dtype)
        if isinstance(x, torch.Tensor):
            return x.to(dtype)
        return self._upload(name, x, dtype)

    def _plan_norm(self, src: str, factor: Any, pcount: float, log: bool,
                   clean: bool) -> None:
        """Plan <src>_sz = factor * <src> (and, with log, <src>_norm =
        log2(<src>_sz + pcount)) in place of building them; factor is
        copied, the raw counts are not.  The log view is planned first: a
        write to the source builds its pending views in the table's order,
        and the log view carries the size-normalized one."""
        if isinstance(factor, np.ndarray):
            factor = factor.copy()
        entry = _NormView(src, getattr(self, src), factor, pcount, clean)
        for view in ((src + "_norm",) if log else ()) + (src + "_sz",):
            self._plan(view, entry)

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------

    # runtime state, not data: the device, the mesh, the table and the
    # device tensors its entries are built from
    _RUNTIME = ("device", "mesh", "_lazy", "_compact_ixs_dev", "_corr_dev",
                "_corr_rndm_dev", "_knn_graph_dev")

    def to_hdf5(self, filename: str, **kwargs: Any) -> None:
        """Snapshot every attribute to hdf5 (resume with
        load_velocyto_hdf5, in this package or the JAX package).  A lazy
        attribute goes in as its host value, built here (and kept where
        its entry keeps it), so the snapshot carries the reference's
        attribute set; the runtime state (_RUNTIME) is left out and stays
        attached.  Raises TypeError, writing nothing, if any other
        attribute holds a torch object."""
        lazy = {}
        for name, entry in list(self._table().items()):
            if self._table().get(name) is entry:
                lazy.update(entry.snapshot(self, name))
        attrs = {k: a for k, a in self.__dict__.items()
                 if k not in self._RUNTIME}
        attrs.update(lazy)
        _check_no_torch(attrs)
        dump_hdf5(SimpleNamespace(**attrs), filename, **kwargs)

    # ------------------------------------------------------------------
    # cell/gene bookkeeping (reference :137-201), host numpy
    # ------------------------------------------------------------------

    def filter_cells(self, bool_array: np.ndarray) -> None:
        """Keep only cells where bool_array is True (reference :137-165)."""
        self.S, self.U, self.A = (X[:, bool_array]
                                  for X in (self.S, self.U, self.A))
        self.initial_cell_size = self.initial_cell_size[bool_array]
        self.initial_Ucell_size = self.initial_Ucell_size[bool_array]
        for attr in ("ts", "size_factor"):
            try:
                setattr(self, attr, getattr(self, attr)[bool_array])
            except AttributeError:
                pass
        self.ca = {k: v[bool_array] for k, v in self.ca.items()}
        try:
            self.cluster_labels = self.cluster_labels[bool_array]
            self.colorandum = self.colorandum[bool_array, :]
        except AttributeError:
            pass

    def set_clusters(self, cluster_labels: np.ndarray,
                     cluster_colors_dict: Optional[Dict[str, List[float]]] = None,
                     colormap: Any = None) -> None:
        """Set cluster labels + colors (reference :167-201).  Without a
        colour dict or a colormap, the default palette needs
        matplotlib."""
        self.cluster_labels = np.array(cluster_labels)
        if self.cluster_labels.dtype == "O":
            self.cluster_labels = self.cluster_labels.astype(np.bytes_)
        if cluster_colors_dict:
            self.colorandum = np.array([cluster_colors_dict[i]
                                        for i in cluster_labels])
            self.cluster_colors_dict = cluster_colors_dict
            self.colormap = None
        else:
            if colormap is None:
                self.colorandum = colormap_fun(self.cluster_ix)
                cluster_uid = self.cluster_uid
                self.cluster_colors_dict = {
                    cluster_uid[i]: colormap_fun(np.array([i]))[0]
                    for i in range(len(cluster_uid))}
            else:
                self.colormap = colormap
                self.colorandum = self.colormap(self.cluster_ix)
                cluster_uid = self.cluster_uid
                self.cluster_colors_dict = {
                    cluster_uid[i]: self.colormap(i)
                    for i in range(len(cluster_uid))}

    @property
    def cluster_uid(self) -> np.ndarray:
        return np.unique(self.cluster_labels)

    @property
    def cluster_ix(self) -> np.ndarray:
        _, cluster_ix = np.unique(self.cluster_labels, return_inverse=True)
        return cluster_ix

    # ------------------------------------------------------------------
    # gene scoring / filtering (reference :213-533), host numpy
    # ------------------------------------------------------------------

    def score_cv_vs_mean(self, N: int = 3000, min_expr_cells: int = 2,
                         max_expr_avg: float = 20, min_expr_avg: int = 0,
                         svr_gamma: Optional[float] = None,
                         winsorize: bool = False,
                         winsor_perc: Tuple[float, float] = (1, 99.5),
                         sort_inverse: bool = False, which: str = "S",
                         plot: bool = False) -> None:
        """CV-vs-mean SVR noise model ranking (reference :213-342).

        The moments are host numpy; the SVR (ops/svr.py, libsvm's solver)
        fits on self.device.  plot=True draws the JAX package's figure
        (needs matplotlib): both gene sets and the fitted curve, from
        the fitted model's predict."""
        M = self.S if which == "S" else self.U
        if winsorize:
            if min_expr_cells <= ((100 - winsor_perc[1]) * M.shape[1] * 0.01):
                min_expr_cells = int(np.ceil(
                    (100 - winsor_perc[1]) * M.shape[0] * 0.01)) + 2

        detected_bool = ((M > 0).sum(1) > min_expr_cells) & \
                        (M.mean(1) < max_expr_avg) & (M.mean(1) > min_expr_avg)
        Mf = M[detected_bool, :]
        if winsorize:
            down, up = np.percentile(Mf, winsor_perc, 1)
            Mfw = np.clip(Mf, down[:, None], up[:, None])
            mu = Mfw.mean(1)
            sigma = Mfw.std(1, ddof=1)
        else:
            mu = Mf.mean(1)
            sigma = Mf.std(1, ddof=1)

        cv = sigma / mu
        log_m = np.log2(mu)
        log_cv = np.log2(cv)

        if svr_gamma is None:
            svr_gamma = 150.0 / len(mu)
        x = torch.as_tensor(log_m, dtype=_F64, device=self.device)
        clf = SVR(gamma=svr_gamma, device=self.device)
        clf.fit(x, torch.as_tensor(log_cv, dtype=_F64, device=self.device))
        ff = clf.predict(x).cpu().numpy()
        score = log_cv - ff
        if sort_inverse:
            score = -score
        nth_score = np.sort(score)[::-1][N] if N < len(score) \
            else np.min(score) - 1e-16
        if plot:
            plt = _plt()
            scatter_viz(log_m[score > nth_score], log_cv[score > nth_score],
                        s=3, alpha=0.4, c="tab:red")
            scatter_viz(log_m[score <= nth_score], log_cv[score <= nth_score],
                        s=3, alpha=0.4, c="tab:blue")
            mu_linspace = np.linspace(np.min(log_m), np.max(log_m))
            plt.plot(mu_linspace,
                     clf.predict(mu_linspace[:, None]).cpu().numpy(), c="k")
            plt.xlabel(f"log2 mean {which}")
            plt.ylabel(f"log2 CV {which}")
        full_score = np.zeros(detected_bool.shape)
        full_score[~detected_bool] = np.min(score) - 1e-16
        full_score[detected_bool] = score
        if which == "S":
            self.cv_mean_score = full_score
            self.cv_mean_selected = self.cv_mean_score >= nth_score
        else:
            self.Ucv_mean_score = full_score
            self.Ucv_mean_selected = self.Ucv_mean_score >= nth_score

    def robust_size_factor(self, pc: float = 0.1, which: str = "both") -> None:
        """Anders-Huber style size factors (reference :344-382)."""
        def _sf(M, sel):
            Y = np.log2(M[sel, :] + pc)
            Y_avg = Y.mean(1)
            sf = np.median(2 ** (Y - Y_avg[:, None]), axis=0)
            return sf / np.mean(sf)
        if which in ("both", "S"):
            self.size_factor = _sf(self.S, self.cv_mean_selected)
        if which in ("both", "U"):
            self.Usize_factor = _sf(self.U, self.Ucv_mean_selected)

    def score_cluster_expression(self, min_avg_U: float = 0.02,
                                 min_avg_S: float = 0.08) -> None:
        """Cluster-wise expression threshold (reference :384-403)."""
        self.U_avgs, self.S_avgs = clusters_stats(
            self.U, self.S, self.cluster_uid, self.cluster_ix, size_limit=40)
        self.clu_avg_selected = (self.U_avgs.max(1) > min_avg_U) & \
                                (self.S_avgs.max(1) > min_avg_S)

    def score_detection_levels(self, min_expr_counts: int = 50,
                               min_cells_express: int = 20,
                               min_expr_counts_U: int = 0,
                               min_cells_express_U: int = 0) -> None:
        """Detection-level gene filter scores (reference :405-432)."""
        S_sum = self.S.sum(1)
        S_ncells = (self.S > 0).sum(1)
        U_sum = self.U.sum(1)
        U_ncells = (self.U > 0).sum(1)
        self.detection_level_selected = (
            (S_sum >= min_expr_counts) & (S_ncells >= min_cells_express) &
            (U_sum >= min_expr_counts_U) & (U_ncells >= min_cells_express_U))

    def filter_genes(self, by_detection_levels: bool = False,
                     by_cluster_expression: bool = False,
                     by_cv_vs_mean: bool = False,
                     by_custom_array: Any = None,
                     keep_unfiltered: bool = False) -> None:
        """Apply gene filters to S/U/ra (reference :434-496)."""
        if not np.any([by_detection_levels, by_cluster_expression,
                       by_cv_vs_mean, type(by_custom_array) is np.ndarray]):
            raise ValueError("At least one of the filtering methods needs "
                             "to be True")
        tmp_filter = np.ones(self.S.shape[0], dtype=bool)
        if by_cluster_expression:
            tmp_filter = tmp_filter & self.clu_avg_selected
        if by_cv_vs_mean:
            tmp_filter = tmp_filter & self.cv_mean_selected
        if by_detection_levels:
            tmp_filter = tmp_filter & self.detection_level_selected
        if type(by_custom_array) is np.ndarray:
            if by_custom_array.dtype == bool:
                tmp_filter = tmp_filter & by_custom_array
            else:
                bool_negative = ~np.isin(np.arange(len(tmp_filter)),
                                         by_custom_array)
                tmp_filter[bool_negative] = False
        if keep_unfiltered:
            self.U_prefilter = sparse.csr_matrix(self.U)
            self.S_prefilter = sparse.csr_matrix(self.S)
            self.ra_prefilter = deepcopy(self.ra)
        self.U = self.U[tmp_filter, :]
        self.S = self.S[tmp_filter, :]
        self.ra = {k: v[tmp_filter] for k, v in self.ra.items()}

    def custom_filter_attributes(self, attr_names: List[str],
                                 bool_filter: np.ndarray) -> None:
        """Filter arbitrary attributes (reference :498-533).  A ".T"
        suffix filters a 2-D array along its LAST axis instead of the
        first; dicts are filtered value-wise.  A device-backed attribute
        is read through its host view, and the filtered host value
        becomes authoritative."""
        for spec in attr_names:
            last_axis = spec.endswith(".T")
            name = spec[:-2] if last_axis else spec
            obj = getattr(self, name)
            if type(obj) is dict:
                kept = {k: v[bool_filter] for k, v in obj.items()}
            elif type(obj) is np.ndarray:
                if obj.ndim > 1 and last_axis:
                    kept = obj[..., bool_filter]
                elif obj.ndim > 1:
                    kept = obj[bool_filter, :]
                else:
                    kept = obj[bool_filter]
            else:
                raise NotImplementedError(
                    f"The filtering of an object of type {type(obj)} "
                    "is not defined")
            setattr(self, name, kept)

    # ------------------------------------------------------------------
    # normalization (reference :535-904)
    # ------------------------------------------------------------------

    @spanned("normalize.S")
    def _normalize_S(self, size: bool = True, log: bool = True,
                     pcount: float = 1, relative_size: Any = None,
                     target_size: Any = None) -> None:
        if size:
            if type(relative_size) is np.ndarray:
                self.cell_size = relative_size
            else:
                self.cell_size = self.S.sum(0)
            self.avg_size = (self.cell_size.mean()
                             if target_size is None else target_size)
            self.norm_factor = self.avg_size / self.cell_size
        else:
            self.norm_factor = 1
        self._plan_norm("S", self.norm_factor, pcount, log, clean=False)

    @spanned("normalize.U")
    def _normalize_U(self, size: bool = True, log: bool = True,
                     pcount: float = 1, use_S_size: bool = False,
                     relative_size: Any = None, target_size: Any = None) -> None:
        if size:
            if use_S_size:
                cell_size = (self.cell_size if hasattr(self, "cell_size")
                             else self.S.sum(0))
            elif type(relative_size) is np.ndarray:
                cell_size = relative_size
            else:
                cell_size = self.U.sum(0)
            self.Ucell_size = cell_size
            avg_size = cell_size.mean() if target_size is None else target_size
            self.Uavg_size = avg_size
            with np.errstate(divide="ignore", invalid="ignore"):
                norm_factor = avg_size / cell_size
        else:
            norm_factor = 1
        self.Unorm_factor = norm_factor
        self._plan_norm("U", norm_factor, pcount, log, clean=True)

    # The imputed matrices live on the device, so their normalizations run
    # there, in float64 like the JAX package's host arithmetic on them;
    # Sx_sz / Ux_sz / Sx_norm / Ux_norm stay device-backed.

    def _scale_cols_dev(self, M: torch.Tensor, factor: Any) -> torch.Tensor:
        """factor * M on M's device in float64; factor is a scalar or one
        value per cell (column)."""
        return M * torch.as_tensor(np.asarray(factor, np.float64),
                                   device=M.device)

    def _set_scaled_dev(self, prefix: str, M: torch.Tensor, factor: Any,
                        pcount: float, log: bool, clean: bool) -> None:
        sz = self._scale_cols_dev(M, factor)
        if clean:
            sz = torch.nan_to_num(sz, nan=0.0, posinf=0.0, neginf=0.0)
        self._set_dev(prefix + "_sz", sz)
        if log:
            self._set_dev(prefix + "_norm", torch.log2(sz + pcount))

    def _normalize_Sx(self, size: bool = True, log: bool = True,
                      pcount: float = 1, relative_size: Any = None,
                      target_size: Any = None) -> None:
        Sx = self._get_dev("Sx", _F64)
        if size:
            if relative_size is not None and np.any(relative_size):
                self.xcell_size = relative_size
            else:
                self.xcell_size = Sx.sum(0).cpu().numpy()
            self.xavg_size = (self.xcell_size.mean()
                              if target_size is None else target_size)
            self.xnorm_factor = self.xavg_size / self.xcell_size
        else:
            self.xnorm_factor = 1
        self._set_scaled_dev("Sx", Sx, self.xnorm_factor, pcount, log,
                             clean=False)

    def _normalize_Ux(self, size: bool = True, log: bool = True,
                      pcount: float = 1, use_Sx_size: bool = False,
                      relative_size: Any = None, target_size: Any = None) -> None:
        Ux = self._get_dev("Ux", _F64)
        if size:
            if use_Sx_size:
                # sic: the reference tests for cell_size, not xcell_size
                cell_size = (self.xcell_size if hasattr(self, "cell_size")
                             else self._get_dev("Sx", _F64).sum(0).cpu().numpy())
            elif type(relative_size) is np.ndarray:
                cell_size = relative_size
            else:
                cell_size = Ux.sum(0).cpu().numpy()
            self.xUcell_size = cell_size
            avg_size = cell_size.mean() if target_size is None else target_size
            self.xUavg_size = avg_size
            with np.errstate(divide="ignore", invalid="ignore"):
                norm_factor = avg_size / cell_size
        else:
            norm_factor = 1
        self.xUnorm_factor = norm_factor
        self._set_scaled_dev("Ux", Ux, norm_factor, pcount, log, clean=True)

    def normalize(self, which: str = "both", size: bool = True,
                  log: bool = True, pcount: float = 1,
                  relative_size: Optional[np.ndarray] = None,
                  use_S_size_for_U: bool = False,
                  target_size: Tuple[Any, Any] = (None, None)) -> None:
        """Normalization facade (reference :633-676): "both", "S", "U" on
        the host raw counts; "imputed", "Sx", "Ux" on the device."""
        if which in ("both", "S"):
            self._normalize_S(size=size, log=log, pcount=pcount,
                              relative_size=relative_size,
                              target_size=target_size[0])
        if which in ("both", "U"):
            self._normalize_U(size=size, log=log, pcount=pcount,
                              use_S_size=use_S_size_for_U,
                              relative_size=relative_size,
                              target_size=target_size[1])
        if which in ("imputed", "Sx"):
            self._normalize_Sx(size=size, log=log, pcount=pcount,
                               relative_size=relative_size,
                               target_size=target_size[0])
        if which in ("imputed", "Ux"):
            self._normalize_Ux(size=size, log=log, pcount=pcount,
                               use_Sx_size=use_S_size_for_U,
                               relative_size=relative_size,
                               target_size=target_size[1])

    def _min_Ucell_size(self, Ucell_size: np.ndarray,
                        min_perc_U: float) -> float:
        min_Ucell_size = np.percentile(Ucell_size, min_perc_U)
        if min_Ucell_size < 2:
            raise ValueError(
                f"min_perc_U={min_perc_U} corresponds to total Unspliced of "
                "1 molecule of less. Please choose higher value or filter "
                "our these cell")
        return min_Ucell_size

    def _normalize_U_by_initial(self, min_Ucell_size: float,
                                target_Ucell_size: float,
                                skip_low_U_pop: bool) -> None:
        if skip_low_U_pop:
            self._normalize_U(
                relative_size=np.clip(self.initial_Ucell_size,
                                      min_Ucell_size, None),
                target_size=target_Ucell_size)
        else:
            self._normalize_U(relative_size=self.initial_Ucell_size,
                              target_size=target_Ucell_size)

    def normalize_by_total(self, min_perc_U: float = 0.5, plot: bool = False,
                           skip_low_U_pop: bool = True,
                           same_size_UnS: bool = False) -> None:
        """Size-normalize by the initial totals (reference :704-758)."""
        target_cell_size = np.median(self.initial_cell_size)
        min_Ucell_size = self._min_Ucell_size(self.initial_Ucell_size,
                                              min_perc_U)
        self.small_U_pop = self.initial_Ucell_size < min_Ucell_size
        if same_size_UnS:
            target_Ucell_size = target_cell_size
        else:
            target_Ucell_size = np.median(
                self.initial_Ucell_size[~self.small_U_pop])
        self._normalize_S(relative_size=self.initial_cell_size,
                          target_size=target_cell_size)
        self._normalize_U_by_initial(min_Ucell_size, target_Ucell_size,
                                     skip_low_U_pop)

    def normalize_by_size_factor(self, min_perc_U: float = 0.5,
                                 plot: bool = False,
                                 skip_low_U_pop: bool = True,
                                 same_size_UnS: bool = False) -> None:
        """Size-normalize by robust size factors (reference :760-815)."""
        cell_size = self.S.sum(0)
        Ucell_size = self.U.sum(0)
        target_cell_size = np.median(cell_size)
        min_Ucell_size = self._min_Ucell_size(Ucell_size, min_perc_U)
        self.small_U_pop = Ucell_size < min_Ucell_size
        if same_size_UnS:
            target_Ucell_size = target_cell_size
        else:
            target_Ucell_size = np.median(Ucell_size[~self.small_U_pop])
        self._normalize_S(relative_size=self.size_factor,
                          target_size=target_cell_size)
        self._normalize_U_by_initial(min_Ucell_size, target_Ucell_size,
                                     skip_low_U_pop)

    def adjust_totS_totU(self, skip_low_U_pop: bool = True,
                         normalize_total: bool = False,
                         fit_with_low_U: bool = True,
                         svr_C: float = 100, svr_gamma: float = 1e-6,
                         plot: bool = False) -> None:
        """SVR-based U rescaling vs S totals (reference :817-867); the
        totals are host sums, the SVR (ops/svr.py) fits on self.device.
        U_sz is a host array, edited in place as in the JAX package; the
        next stage that reads it uploads the edited values."""
        svr = SVR(C=svr_C, gamma=svr_gamma, device=self.device)
        X, y = self.S_sz.sum(0), self.U_sz.sum(0)

        def dev(a):
            return torch.as_tensor(a, dtype=_F64, device=self.device)

        if fit_with_low_U:
            svr.fit(dev(X), dev(y))
            predicted = svr.predict(dev(X)).cpu().numpy()
        else:
            svr.fit(dev(X[~self.small_U_pop]), dev(y[~self.small_U_pop]))
            predicted = np.copy(y)
            predicted[~self.small_U_pop] = svr.predict(
                dev(X[~self.small_U_pop])).cpu().numpy()
        adj_factor = predicted / y
        adj_factor[~np.isfinite(adj_factor)] = 1
        if skip_low_U_pop:
            self.U_sz[:, ~self.small_U_pop] = \
                self.U_sz[:, ~self.small_U_pop] * adj_factor[~self.small_U_pop]
        else:
            self.U_sz = self.U_sz * adj_factor
        if normalize_total:
            self.normalize_median(which="renormalize",
                                  skip_low_U_pop=skip_low_U_pop)

    def normalize_median(self, which: str = "imputed",
                         skip_low_U_pop: bool = True) -> None:
        """Median renormalization (reference :869-904).  "renormalize"
        edits the host S_sz / U_sz (U_sz in place, as the JAX package
        does); "imputed" rescales the device Sx / Ux into device-backed
        Sx_sz / Ux_sz in float64 (the medians on the host, numpy's)."""
        if not hasattr(self, "small_U_pop") and skip_low_U_pop:
            self.small_U_pop = np.zeros(self.U_sz.shape[1], dtype=bool)
        if which == "renormalize":
            sums = self.S_sz.sum(0)
            self.S_sz, _ = _scaled_pair(self.S_sz, np.median(sums) / sums,
                                        0, False)
            if skip_low_U_pop:
                sub = self.U_sz[:, ~self.small_U_pop]
                sums = sub.sum(0)
                self.U_sz[:, ~self.small_U_pop] = sub * (
                    np.median(sums) / sums)
            else:
                sums = self.U_sz.sum(0)
                self.U_sz, _ = _scaled_pair(self.U_sz,
                                            np.median(sums) / sums, 0, False)
        elif which == "imputed":
            Sx = self._get_dev("Sx", _F64)
            sums = Sx.sum(0).cpu().numpy()
            self._set_dev("Sx_sz", self._scale_cols_dev(
                Sx, np.median(sums) / sums))
            Ux = self._get_dev("Ux", _F64)
            factor = np.ones(Ux.shape[1])
            keep = ~self.small_U_pop if skip_low_U_pop else \
                np.ones(Ux.shape[1], dtype=bool)
            sums = Ux[:, torch.as_tensor(keep, device=Ux.device)].sum(0) \
                .cpu().numpy()
            factor[keep] = np.median(sums) / sums
            self._set_dev("Ux_sz", self._scale_cols_dev(Ux, factor))

    # ------------------------------------------------------------------
    # dimensionality reduction + smoothing (reference :678-702, :933-1118)
    # ------------------------------------------------------------------

    def perform_PCA(self, which: str = "S_norm",
                    n_components: Optional[int] = None,
                    div_by_std: bool = False) -> None:
        """PCA with cells as samples (reference :678-702), ops/pca.py on
        self.device (a view normalize left pending is built there from
        the raw counts); the eigensolver runs on the host."""
        X = self._stage_input(which)
        self.pca = PCA(n_components=n_components)
        if div_by_std:
            self.pcs = self.pca.fit_transform(X.T / X.std(0, correction=0))
        else:
            self.pcs = self.pca.fit_transform(X.T)

    def _perform_PCA_imputed(self, n_components: Optional[int] = None) -> None:
        """PCA of the smoothed Sx_norm (ops/pca.py on self.device):
        pcax / pcsx."""
        self.pcax = PCA(n_components=n_components)
        self.pcsx = self.pcax.fit_transform(self._stage_input("Sx_norm").T)

    def knn_imputation(self, k: Optional[int] = None, pca_space: bool = True,
                       metric: str = "euclidean", diag: float = 1,
                       n_pca_dims: Optional[int] = None, maximum: bool = False,
                       size_norm: bool = True, balanced: bool = False,
                       b_sight: Optional[int] = None,
                       b_maxl: Optional[int] = None,
                       group_constraint: Union[str, np.ndarray, None] = None,
                       n_jobs: int = 8) -> None:
        """kNN smoothing of S_sz/U_sz -> Sx/Ux (reference :933-1023).

        Candidate search, exact f64 re-score, greedy balancing (a hand
        CUDA kernel on the card) and the smoothing convolution, all on
        the device.  Sx/Ux stay
        on the device; the .knn / .knn_smoothing_w csr views materialize
        lazily on first access.  n_jobs is accepted for API parity.
        """
        N = self.S.shape[1]
        if k is None:
            k = int(N * 0.025)
        if b_sight is None and balanced:
            b_sight = np.minimum(int(k * 8), N - 1)
        if b_maxl is None and balanced:
            b_maxl = np.minimum(int(k * 4), N - 1)
        space = self.pcs[:, :n_pca_dims] if pca_space else self.S_norm.T
        if balanced:
            constraint = None
            if group_constraint is not None:
                if isinstance(group_constraint, str) and \
                        group_constraint == "clusters":
                    _, constraint = np.unique(self.cluster_labels,
                                              return_inverse=True)
                else:
                    constraint = np.asarray(group_constraint)
            g = kd.balanced_knn_graph_dev(space, k=k, sight_k=b_sight,
                                          maxl=b_maxl, metric=metric,
                                          constraint=constraint,
                                          device=self.device,
                                          mesh=getattr(self, "mesh", None))
        else:
            if group_constraint is not None:
                raise ValueError("group_constraint is currently supported "
                                 "only if the argument balanced is set to True")
            g = kd.knn_graph_dev(space, k=k, metric=metric,
                                 device=self.device,
                                 mesh=getattr(self, "mesh", None))
        self._knn_graph_dev = g
        self._knn_diag = diag
        self._plan("knn", _Built(partial(kd.graph_to_csr, g),
                                 ("_knn_graph_dev",)))
        self._plan("knn_smoothing_w", _Built(
            partial(kd.weights_to_csr, g, diag=diag), ("_knn_graph_dev",)))
        with span("knn.smooth"):
            nbr_idx, nbr_w = kd.compact_weights_dev(g, diag=diag)
            S_src = self._get_dev("S_sz" if size_norm else "S")
            U_src = self._get_dev("U_sz" if size_norm else "U")
            Sx, Ux = kd.smooth_dev_multi((S_src, U_src), nbr_idx, nbr_w)
        if maximum:
            Sx = torch.maximum(self._get_dev("S_sz"), Sx)
            Ux = torch.maximum(self._get_dev("U_sz"), Ux)
        self._set_dev("Sx", Sx)
        self._set_dev("Ux", Ux)
        self._set_dev("Sx_sz", Sx)
        self._set_dev("Ux_sz", Ux)

    def knn_imputation_precomputed(self, knn_smoothing_w: sparse.spmatrix,
                                   maximum: bool = False) -> None:
        """Smoothing with a precomputed (cells, cells) weight matrix
        (reference :1025-1053), on the device; Sx/Ux and their _sz
        aliases are device-backed."""
        S_sz, U_sz = self._get_dev("S_sz"), self._get_dev("U_sz")
        Sx = convolve_by_sparse_weights_dev(S_sz, knn_smoothing_w)
        Ux = convolve_by_sparse_weights_dev(U_sz, knn_smoothing_w)
        if maximum:
            Sx, Ux = torch.maximum(S_sz, Sx), torch.maximum(U_sz, Ux)
        for name, dev in (("Sx", Sx), ("Ux", Ux), ("Sx_sz", Sx),
                          ("Ux_sz", Ux)):
            self._set_dev(name, dev)

    def gene_knn_imputation(self, k: int = 15, pca_space: bool = False,
                            metric: str = "correlation", diag: float = 1,
                            scale_weights: bool = True, balanced: bool = True,
                            b_sight: int = 100, b_maxl: int = 18,
                            n_jobs: int = 8) -> None:
        """Gene-axis kNN smoothing of Sx_sz / Ux_sz (reference
        :1055-1118): the gene kNN search on the device, the graph and its
        weights in scipy.sparse on the host, the smoothing on the
        device."""
        if pca_space:
            raise NotImplementedError("pca_space=True not supported here")
        space = self._get_dev("Sx_sz", _F64)
        if balanced:
            bknn = BalancedKNN(k=k, sight_k=b_sight, maxl=b_maxl,
                               mode="distance", metric=metric, n_jobs=n_jobs,
                               device=self.device)
            bknn.fit(space)
            self.gknn = bknn.kneighbors_graph(mode="distance")
        else:
            self.gknn = knn_distance_matrix(space, metric=metric, k=k,
                                            mode="distance", n_jobs=n_jobs,
                                            device=self.device)
        connectivity = (self.gknn > 0).astype(float)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            connectivity.setdiag(diag)
        self.gknn_smoothing_w = connectivity_to_weights(connectivity).tocsr()
        if scale_weights:
            genes_total = space.sum(1).cpu().numpy()
            self.gknn_smoothing_w = scale_to_match_median(
                self.gknn_smoothing_w, genes_total)
        for name in ("Sx_sz", "Ux_sz"):
            self._set_dev(name, convolve_by_sparse_weights_dev(
                self._get_dev(name).T, self.gknn_smoothing_w).T)

    # ------------------------------------------------------------------
    # gamma model (reference :1120-1260)
    # ------------------------------------------------------------------

    @spanned("gammas")
    def fit_gammas(self, steady_state_bool: Optional[np.ndarray] = None,
                   use_imputed_data: bool = True, use_size_norm: bool = True,
                   fit_offset: bool = True, fixperc_q: bool = False,
                   weighted: bool = True,
                   weights: Union[str, np.ndarray] = "maxmin_diag",
                   limit_gamma: bool = False,
                   maxmin_perc: List[float] = [2, 98],
                   maxmin_weighted_pow: float = 15) -> None:
        """Fit per-gene degradation rates (reference :1120-1260) with the
        closed-form fits of ops.gamma, on the device.

        With every cell at steady state the matrices and the weight
        scheme stay on the device; with a steady-state subset the weights
        are the JAX package's host float64 schemes and the subset is
        uploaded."""
        if steady_state_bool:
            self.steady_state = steady_state_bool
        else:
            self.steady_state = np.ones(self.S.shape[1], dtype=bool)
        all_ss = bool(np.all(self.steady_state))

        Sname = ("Sx_sz" if use_size_norm else "Sx") if use_imputed_data \
            else ("S_sz" if use_size_norm else "S")
        Uname = ("Ux_sz" if use_size_norm else "Ux") if use_imputed_data \
            else ("U_sz" if use_size_norm else "U")
        if all_ss:
            tmpS, tmpU = self._get_dev(Sname), self._get_dev(Uname)
        else:
            tmpS, tmpU = getattr(self, Sname), getattr(self, Uname)

        W = None
        if weighted:
            if type(weights) is np.ndarray:
                W = weights
            elif weights not in ("sum", "prod", "maxmin_weighted", "maxmin",
                                 "maxmin_diag", "maxmin_double"):
                raise NotImplementedError(
                    f"weights={weights!r} is not a supported scheme")
            elif all_ss:
                need_xs = weights in ("maxmin_diag", "maxmin_double")
                W = compute_fit_weights(
                    weights, tmpS, tmpU,
                    self._get_dev("Sx") if need_xs else None,
                    self._get_dev("Ux") if need_xs else None,
                    maxmin_perc, maxmin_weighted_pow)
            else:
                W = self._fit_weights_host(weights, tmpS, tmpU, maxmin_perc,
                                           maxmin_weighted_pow)

        if all_ss:
            ssU, ssS = tmpU, tmpS
        else:
            ssU = tmpU[:, self.steady_state]
            ssS = tmpS[:, self.steady_state]
            if W is not None and np.shape(W)[1] == tmpS.shape[1]:
                # weights over every cell, fit on the steady-state cells
                # (the JAX package passes the full W here and raises)
                W = np.asarray(W)[:, self.steady_state]
        dev = self.device
        if fit_offset:
            if weighted:
                self.gammas, self.q, self.R2 = fit_slope_weighted_offset(
                    ssU, ssS, W, return_R2=True, limit_gamma=limit_gamma,
                    device=dev)
            else:
                self.gammas, self.q = fit_slope_offset(ssU, ssS, device=dev)
        elif fixperc_q:
            if weighted:
                self.gammas, self.q = fit_slope_weighted_offset(
                    ssU, ssS, W, fixperc_q=True, return_R2=False,
                    limit_gamma=limit_gamma, device=dev)
            else:
                self.gammas, self.q = fit_slope_offset(
                    ssU, ssS, fixperc_q=True, device=dev)
        else:
            if weighted:
                self.gammas, self.R2 = fit_slope_weighted(
                    ssU, ssS, W, return_R2=True, limit_gamma=limit_gamma,
                    device=dev)
            else:
                self.gammas = fit_slope(ssU, ssS, device=dev)
            self.q = np.zeros_like(self.gammas)
        self.gammas[~np.isfinite(self.gammas)] = 0

    def _fit_weights_host(self, weights: str, tmpS, tmpU, maxmin_perc,
                          maxmin_weighted_pow):
        """Host float64 weight schemes (reference analysis.py:1139-1191;
        copied from the JAX package), for the steady-state subset path."""
        if weights == "sum":
            return (tmpS / np.percentile(tmpS, 99, 1)[:, None]) + \
                (tmpU / np.percentile(tmpU, 99, 1)[:, None])
        if weights == "prod":
            return (tmpS / np.percentile(tmpS, 99, 1)[:, None]) * \
                (tmpU / np.percentile(tmpU, 99, 1)[:, None])
        if weights == "maxmin_weighted":
            down, up = np.percentile(tmpS, maxmin_perc, 1)
            Srange = np.clip(tmpS, down[:, None], up[:, None])
            Srange = Srange - Srange.min(1)[:, None]
            Srange = Srange / Srange.max(1)[:, None]
            return 0.5 * (Srange ** maxmin_weighted_pow +
                          (1 - Srange) ** maxmin_weighted_pow)
        if weights == "maxmin":
            down, up = np.percentile(tmpS, maxmin_perc, 1)
            return ((tmpS <= down[:, None]) |
                    (tmpS >= up[:, None])).astype(float)
        Sx, Ux = self.Sx, self.Ux
        denom_Sx = np.percentile(Sx, 99.9, 1)
        if np.sum(denom_Sx == 0):
            denom_Sx[denom_Sx == 0] = np.maximum(
                np.max(Sx[denom_Sx == 0, :], 1), 0.001)
        denom_Ux = np.percentile(Ux, 99.9, 1)
        if np.sum(denom_Ux == 0):
            denom_Ux[denom_Ux == 0] = np.maximum(
                np.max(Ux[denom_Ux == 0, :], 1), 0.001)
        X = Sx / denom_Sx[:, None] + Ux / denom_Ux[:, None]
        down, up = np.percentile(X, maxmin_perc, axis=1)
        W = ((X <= down[:, None]) | (X >= up[:, None])).astype(float)
        if weights == "maxmin_double":
            down, up = np.percentile(Sx, maxmin_perc, 1)
            W = W + ((Sx <= down[:, None]) |
                     (Sx >= up[:, None])).astype(float)
        return W

    def filter_genes_good_fit(self, minR: float = 0.1,
                              min_gamma: float = 0.01) -> None:
        """Deprecated alias of filter_genes_by_phase_portrait without the
        correlation criterion (reference :1254-1265)."""
        return self.filter_genes_by_phase_portrait(minR2=minR,
                                                   min_gamma=min_gamma,
                                                   minCorr=None)

    def filter_genes_by_phase_portrait(self, minR2: float = 0.1,
                                       min_gamma: float = 0.01,
                                       minCorr: float = 0.1) -> None:
        """Drop genes with bad phase portraits (reference :1267-1319).

        The Sx_sz/Ux_sz correlation runs on the device in float64 (the JAX
        package's host precision).  Device-backed matrices are filtered on
        the device and stay device-backed, aliases kept (Sx_sz stays Sx);
        a host view already handed out is filtered instead, so an edit of
        it carries over, as it does in the JAX package."""
        tmp_filter = np.ones(self.gammas.shape, dtype=bool)
        if minR2 is not None:
            R2_corrected = np.sqrt(np.abs(self.R2)) * np.sign(self.R2)
            tmp_filter = tmp_filter & (R2_corrected > minR2)
        if min_gamma is not None:
            tmp_filter = tmp_filter & (self.gammas > min_gamma)
        if minCorr is not None:
            Corr = _paired_correlation_rows(
                self._get_dev("Sx_sz", _F64), self._get_dev("Ux_sz", _F64))
            tmp_filter = tmp_filter & (Corr.cpu().numpy() > minCorr)
        self.ra = {k: v[tmp_filter] for k, v in self.ra.items()}
        keep = torch.as_tensor(np.flatnonzero(tmp_filter), device=self.device)
        filtered = {}                        # id(tensor) -> (tensor, rows)
        # normalize's pending views stay pending, over the kept rows of
        # their raw counts (the factors are per cell): set aside while S
        # and U are written, which would build them
        table = self._table()
        pending = {name: table.pop(name) for name, entry in list(table.items())
                   if isinstance(entry, _NormView)}
        try:
            for name in ("U", "U_sz", "U_norm", "Ux", "Ux_sz", "Ux_norm",
                         "S", "S_sz", "S_norm", "Sx", "Sx_sz", "Sx_norm"):
                entry = self._table().get(name)
                if isinstance(entry, _Device):
                    src = entry.stage(self, name, None)
                    if isinstance(src, np.ndarray):
                        self._set_dev(name, torch.as_tensor(
                            src[tmp_filter], dtype=entry.t.dtype,
                            device=self.device))
                        continue
                    if id(src) not in filtered:
                        filtered[id(src)] = (src, src.index_select(0, keep))
                    self._set_dev(name, filtered[id(src)][1])
                elif name in self.__dict__:
                    setattr(self, name, self.__dict__[name][tmp_filter, :])
        finally:
            if pending:
                self.__dict__.setdefault("_lazy", {}).update(pending)
        kept = {}                            # id(entry) -> kept entry
        for view, entry in pending.items():
            if id(entry) not in kept:
                kept[id(entry)] = entry.take(tmp_filter)
            self._plan(view, kept[id(entry)])
        for name in ("gammas", "q", "R2"):
            if name in self.__dict__:
                setattr(self, name, self.__dict__[name][tmp_filter])

    # ------------------------------------------------------------------
    # velocity chain (reference :1321-1439), on the device
    # ------------------------------------------------------------------

    def _gene_vector(self, name: str) -> torch.Tensor:
        return torch.as_tensor(np.asarray(getattr(self, name)), dtype=_F32,
                               device=self.device)

    @spanned("velocity")
    def predict_U(self, which_gamma: str = "gammas", which_S: str = "Sx_sz",
                  which_offset: str = "q") -> None:
        """Upred = gamma * S (+ q) (reference :1321-1346)."""
        self.which_S_for_pred = which_S
        gam = self._gene_vector(which_gamma)
        q = (torch.zeros_like(gam) if which_offset is None
             else self._gene_vector(which_offset))
        self._set_dev("Upred",
                      gam[:, None] * self._get_dev(which_S) + q[:, None])

    @spanned("velocity")
    def calculate_velocity(self, kind: str = "residual",
                           eps: Optional[float] = None) -> None:
        """velocity = U - Upred (reference :1348-1379)."""
        if kind != "residual":
            raise NotImplementedError(
                f"Velocity calculation kind={kind} is not implemented")
        if self.which_S_for_pred == "Sx_sz":
            vel = self._get_dev("Ux_sz") - self._get_dev("Upred")
        elif self.which_S_for_pred == "Sx":
            vel = self._get_dev("Ux") - self._get_dev("Upred")
        else:
            raise NotImplementedError(
                f"Not implemented with which_S = {self.which_S_for_pred}")
        if eps:
            vel = _eps_clip_dev(vel, self._get_dev("Upred"), eps)
        self._set_dev("velocity", vel)

    @spanned("velocity")
    def calculate_shift(self, assumption: str = "constant_velocity",
                        delta_t: float = 1) -> None:
        """delta_S extrapolation (Model I / Model II, reference
        :1381-1408)."""
        if assumption == "constant_velocity":
            vel = self._get_dev("velocity")
            self._set_dev("delta_S", vel if delta_t == 1 else
                          torch.tensor(delta_t, dtype=_F32) * vel)
        elif assumption == "constant_unspliced":
            self._set_dev("delta_S", _shift_model2_dev(
                self._get_dev("Sx_sz"), self._get_dev("Ux_sz"),
                self._gene_vector("gammas"), self._gene_vector("q"),
                delta_t))
        else:
            raise NotImplementedError(
                f"Assumption {assumption} is not implemented")

    @spanned("velocity")
    def extrapolate_cell_at_t(self, delta_t: float = 1,
                              clip: bool = True) -> None:
        """Extrapolated expression (reference :1410-1439)."""
        if self.which_S_for_pred == "Sx_sz":
            Sname, tname = "Sx_sz", "Sx_sz_t"
        elif self.which_S_for_pred == "Sx":
            Sname, tname = "Sx", "Sx_t"
        else:
            raise NotImplementedError(
                "not implemented for other situations other than Sx or Sx_sz")
        out = self._get_dev(Sname) + \
            torch.tensor(delta_t, dtype=_F32) * self._get_dev("delta_S")
        self._set_dev(tname, torch.clamp_min(out, 0.0) if clip else out)
        if clip:
            self.used_delta_t = delta_t

    def perform_TSNE(self, n_dims: int = 2, perplexity: float = 30,
                     initial_pos: Optional[np.ndarray] = None,
                     theta: float = 0.5, n_pca_dim: Optional[int] = None,
                     max_iter: int = 1000) -> None:
        """t-SNE of the PCA space (reference :1441-1450) on self.device
        (ops/tsne.py): sklearn's TSNE as the JAX package calls it, with
        the exact gradient in place of Barnes-Hut, so ``theta`` is not
        used.  Without initial_pos the start is drawn from numpy's global
        RNG as sklearn draws it.  Sets ``ts``, (cells, n_dims) float32."""
        self.ts = tsne(self.pcs[:, :n_pca_dim], n_components=n_dims,
                       perplexity=perplexity, init=initial_pos,
                       max_iter=max_iter, device=self.device)[0]

    # ------------------------------------------------------------------
    # velocity -> embedding projection (reference :1452-1816)
    # ------------------------------------------------------------------

    def estimate_transition_prob(self, hidim: str = "Sx_sz",
                                 embed: str = "ts", transform: str = "sqrt",
                                 ndims: Optional[int] = None,
                                 n_sight: Optional[int] = None,
                                 psc: Optional[float] = None,
                                 knn_random: bool = True,
                                 sampled_fraction: float = 0.3,
                                 sampling_probs: Tuple[float, float] = (0.5, 0.1),
                                 max_dist_embed: Optional[float] = None,
                                 n_jobs: int = 4,
                                 threads: Optional[int] = None,
                                 calculate_randomized: bool = True,
                                 random_seed: int = 15071990,
                                 **kwargs: Any) -> None:
        """Correlation-based transition probabilities to the embedding
        neighborhood (reference :1452-1668).

        knn_random=True (the reference default): each cell is correlated
        with a random sample of its embedding neighbours, drawn from
        numpy's stream exactly as the reference draws them (a C++ replay
        of its per-cell np.random.choice loop, ``native``, consumed in
        row chunks as it runs).  The sampled colDeltaCor (hand CUDA kernel
        on a CUDA device; the main field and the randomized control in
        one pass per chunk) keeps the compact (N, nn) correlations on the
        device; the dense (N, N) attributes are built only when read; the
        randomized control is permuted on the device (see
        _estimate_sampled).  A failed call raises and leaves the object
        and numpy's stream as they were.  knn_random=False: the dense
        colDeltaCor (hand CUDA kernel on a CUDA device; both fields in one
        launch), the randomized control permuted on the device from a
        plan drawn on a worker as the sampled mode draws it, numpy's
        stream left where the JAX package's host permutation leaves it,
        and delta_S_rndm built on first read (see _estimate_full)."""
        rng_before = np.random.get_state()
        numba_random_seed(random_seed)
        self.which_hidim = hidim

        if "n_neighbors" in kwargs:
            n_neighbors = kwargs.pop("n_neighbors")
            if len(kwargs) > 0:
                logging.warning(f"keyword arguments were passed but could "
                                f"not be interpreted {kwargs}")
        else:
            n_neighbors = None
        if n_sight is None and n_neighbors is None:
            n_neighbors = int(self.S.shape[1] / 5)
        if (n_sight is not None) and (n_neighbors is not None) and \
                n_neighbors != n_sight:
            raise ValueError("n_sight and n_neighbors are different names "
                             "for the same parameter, they cannot be set "
                             "differently")
        if n_sight is not None and n_neighbors is None:
            n_neighbors = n_sight

        if psc is None:
            if transform in ("log", "logratio"):
                psc = 1.0
            elif transform == "sqrt":
                psc = 1e-10
            else:
                psc = 0.0
        if transform not in ("log", "logratio", "linear", "sqrt"):
            raise NotImplementedError(
                f"transform={transform} is not a valid parameter")
        if "pcs" not in hidim and ndims is not None:
            raise ValueError(
                f"ndims was set to {ndims} but hidim != 'pcs'. "
                f"Set ndims = None for hidim='{hidim}'")
        if "pcs" in hidim and calculate_randomized:
            raise ValueError("calculate_randomized=True needs a gene-space "
                             "hidim (the reference has no randomized "
                             "control for hidim='pcs')")

        embedding = getattr(self, embed)
        self.embedding = embedding
        # sklearn semantics (reference :1547-1549, :1631-1635): the query
        # point is NOT its own neighbor, so the graph holds n_neighbors+1
        # non-self neighbors per row and an empty diagonal
        N = embedding.shape[0]
        nn_k = min(n_neighbors + 1, N - 1)

        if not knn_random:
            self._estimate_full(hidim, ndims, transform, psc,
                                calculate_randomized, embedding, nn_k)
            return
        try:
            self._estimate_sampled(hidim, ndims, transform, psc,
                                   calculate_randomized, embedding, nn_k,
                                   sampled_fraction, sampling_probs,
                                   random_seed)
        except BaseException:
            # nothing of a failed call survives, numpy's stream included
            np.random.set_state(rng_before)
            raise

    def _estimate_sampled(self, hidim: str, ndims: Optional[int],
                          transform: str, psc: float,
                          calculate_randomized: bool, embedding: np.ndarray,
                          nn_k: int, sampled_fraction: float,
                          sampling_probs: Tuple[float, float],
                          random_seed: int) -> None:
        """estimate_transition_prob(knn_random=True) as the JAX package
        runs it (velocyto_tpu/analysis.py:1152-1413).

        The neighbour-sampling replay starts first, on a worker thread,
        and hands over its rows in SAMPLER_CHUNKS chunks (uploaded on a
        side stream on a card).  The randomized control's plan is drawn
        on a second worker from a snapshot of numpy's stream and applied
        on the device.  Meanwhile this thread computes the transforms,
        the embedding kNN and the locality order; then it gathers each
        chunk's neighbours and runs the sampled colDeltaCor on them (one
        dual launch a chunk on a card) while later chunks are sampled.
        Every attribute is set only once the whole call has succeeded
        (reference fault R2 is not inherited: no chunk result of a failed
        replay is kept).  With a mesh the chunks are not consumed as they
        arrive: once the replay has ended, one sharded call
        (col_delta_cor_partial_sharded_dev, one dual launch per shard)
        takes every row, as in the JAX package.

        Spans (utils.profiling.span): on this thread transition.inputs,
        .embedding_knn, .locality_order, .chunk (gather and launch) and
        its waits for the workers, transition.wait.control, .wait.chunk
        and .wait.replay; on the workers transition.replay,
        .replay.upload and .control.plan."""
        N = embedding.shape[0]
        dev = torch.device(self.device)
        mesh = getattr(self, "mesh", None)
        p_samp = np.linspace(sampling_probs[0], sampling_probs[1], nn_k)
        p_samp = p_samp / p_samp.sum()
        n_samp = int(sampled_fraction * nn_k)
        samp_dt = np.uint16 if nn_k <= 65536 else np.int32
        chunks: "queue.Queue" = queue.Queue()
        # a copy from pageable memory is synchronous: on the current
        # stream it would wait for this thread's queued work
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def on_chunk(lo, hi, rows):
            host = torch.from_numpy(rows.astype(samp_dt))
            if side is None:
                chunks.put((lo, hi, host, None))
                return
            with span("transition.replay.upload"), torch.cuda.stream(side):
                samp = host.to(dev)
                ready = torch.cuda.Event()
                ready.record(side)
            chunks.put((lo, hi, samp, ready))

        def replay():
            try:
                with span("transition.replay"):
                    return native.choice_noreplace_rows_chunked(
                        random_seed, N, nn_k, n_samp, p_samp,
                        n_chunks=SAMPLER_CHUNKS, on_chunk=on_chunk)
            finally:
                chunks.put(None)

        sampler = _Worker(replay)
        control = None
        try:
            if calculate_randomized:
                # the plan draws from numpy's stream at the reference's
                # point (between numba_random_seed and np.random.seed);
                # this thread draws nothing until the seed below
                control = _Worker(_permute_rows_nsign_dev,
                                  self._get_dev("delta_S"),
                                  np.random.get_state())
            with span("transition.inputs"):
                if "pcs" in hidim:  # sic (reference :1531)
                    tf, emat, d_main = self._pcs_inputs(hidim, ndims,
                                                        transform, psc)
                else:
                    tf = _KERNEL_TRANSFORM[transform]
                    hi = self._get_dev(hidim)
                    emat = torch.log2(hi + psc) if transform == "logratio" \
                        else hi

                    def d_of(shift):
                        return _corr_transform_dev(hi, shift,
                                                   self.used_delta_t, psc,
                                                   transform)
                    d_main = d_of(self._get_dev("delta_S"))
            with span("transition.embedding_knn"):
                _dists, idx = kd.knn_search_dev(embedding, min(nn_k + 1, N),
                                                device=dev, mesh=mesh)
            # the kernel takes each chunk's cells in embedding-locality
            # order, so the rows it gathers for neighbouring cells are
            # served by L2
            with span("transition.locality_order"):
                order = locality_order(torch.as_tensor(embedding,
                                                       device=idx.device))
            d_rndm = delta_rndm = None
            if control is not None:
                with span("transition.wait.control"):
                    delta_rndm = control.join()
            with span("transition.inputs"):
                if delta_rndm is not None:
                    d_rndm = d_of(delta_rndm)
                if mesh is None:
                    prep_d, run = make_partial_compact_chunked(emat, tf, psc)
                    d_rows = prep_d(d_main)
                    d_rndm_rows = None if d_rndm is None else prep_d(d_rndm)
            neigh, outs = [], []
            while True:
                with span("transition.wait.chunk"):
                    item = chunks.get()
                if item is None:
                    break
                with span("transition.chunk"):
                    lo, hi, samp, ready = item
                    if ready is not None:
                        stream = torch.cuda.current_stream(dev)
                        stream.wait_event(ready)
                        samp.record_stream(stream)
                    neigh.append(_sample_neighbors_dev(idx[lo:hi], samp,
                                                       row_offset=lo))
                    if mesh is None:
                        outs.append(run(d_rows, lo, hi, neigh[-1],
                                        d_rndm_rows,
                                        order=chunk_order(order, lo, hi)))
            with span("transition.wait.replay"):
                sampling_ixs, _draws, mt_state = sampler.join()
            if mesh is not None:
                outs.append(col_delta_cor_partial_sharded_dev(
                    mesh, emat, d_main, torch.cat(neigh), tf, psc, d_rndm,
                    order=order))
            if d_rndm is None:
                corr_m, corr_r = torch.cat(outs), None
            else:
                corr_m = torch.cat([o[0] for o in outs])
                corr_r, _ = _fix_nans(torch.cat([o[1] for o in outs]))
            corr_m, had_nan = _fix_nans(corr_m)
        except BaseException:
            for worker in (sampler, control):
                if worker is not None:
                    worker.wait()
            raise

        # the reference seeds here, then calls np.random.choice once per
        # cell; the replay leaves numpy's stream where they would
        np.random.seed(random_seed)
        np.random.set_state(mt_state)
        if had_nan:
            logging.warning(
                "Nans encountered in corrcoef and corrected to 1s. If not "
                "identical cells were present it is probably a small "
                "isolated cluster converging after imputation.")
        self.sampling_ixs = sampling_ixs
        self.corr_calc = "knn_random"
        # the compact (N, nn) state stays on the device and its host views
        # are built on read.  The reference overwrites corrcoef here but
        # leaves an old transition_prob stale until the next shift; a
        # lazy one goes with the state it was planned from
        ixs = torch.cat(neigh)
        self._keep_neighbours(ixs)
        self._plan("_compact_ixs", _Built(partial(_host_copy, ixs, np.int64),
                                          ("_compact_ixs_dev",)))
        fields = [("_corr_dev", "_compact_corr", "corrcoef", corr_m)]
        if corr_r is not None:
            self._set_dev("delta_S_rndm", delta_rndm)
            fields.append(("_corr_rndm_dev", "_compact_corr_random",
                           "corrcoef_random", corr_r))
        for key, compact, dense, corr in fields:
            setattr(self, key, corr)
            self._plan(compact, _Built(partial(_host_copy, corr, np.float64),
                                       (key,)))
            self._plan(dense, _Rows(ixs, corr,
                                    sources=(key, "_compact_ixs_dev")))

    def _keep_neighbours(self, ixs: torch.Tensor) -> None:
        """Keep each cell's (N, nn) embedding neighbour ids on the device
        (both modes); embedding_knn is built from them on read."""
        self._compact_ixs_dev = ixs
        self._plan("embedding_knn", _Built(partial(_neighbour_csr, ixs),
                                           ("_compact_ixs_dev",)))

    def _estimate_full(self, hidim: str, ndims: Optional[int],
                       transform: str, psc: float, calculate_randomized: bool,
                       embedding: np.ndarray, nn_k: int) -> None:
        """estimate_transition_prob(knn_random=False): dense (N, N)
        correlations against every cell, the two fields of one dual
        colDeltaCor launch, kept on the device (corrcoef and
        corrcoef_random read them), and the embedding neighbours, kept
        on the device as (N, nn_k) ids, as the sampled mode keeps its own
        (embedding_knn is built from them on read):
        calculate_embedding_shift gathers the correlations at those ids
        and works on the compact (N, nn_k) form, with no other (N, N)
        tensor.

        With calculate_randomized the control's plan is drawn first, on a
        worker, from a snapshot of numpy's stream (the reference's point:
        right after numba_random_seed), and applied on the device to
        delta_S as its authoritative value holds it (the device tensor
        itself, or the host array in float64), as the sampled mode does.
        Meanwhile this thread computes the transforms and the embedding
        kNN; then it joins the worker, sets numpy's stream where
        permute_rows_nsign leaves it, transforms the permuted rows and
        frees them, and makes one dual colDeltaCor launch (one a shard
        with a mesh).  The plan stays on the host with the call's delta_S,
        and delta_S_rndm is built from them on first read.  A call that
        fails waits for the worker and keeps nothing of the control.

        Spans (utils.profiling.span): on this thread transition.inputs,
        .embedding_knn, .control (the join and the control's
        transform) and .cor; on the worker transition.control.plan."""
        self.corr_calc = "full"
        self._drop("_corr_dev", "_corr_rndm_dev", "_compact_corr",
                   "_compact_corr_random", "_compact_ixs", "_compact_ixs_dev")
        control = delta = dev_delta = None
        if calculate_randomized:
            self._drop("delta_S_rndm")
            if isinstance(self._table().get("delta_S"), _Device):
                delta = dev_delta = self._get_dev("delta_S", None)
            else:
                # a private copy: the plan keeps it for delta_S_rndm
                delta = np.array(self.delta_S, dtype=np.float64)
                dev_delta = self._upload("delta_S", delta, None)
            # this thread draws nothing from numpy until the join
            control = _Worker(_permute_rows_nsign_drawn, dev_delta,
                              np.random.get_state())
        try:
            tf, emat, d_main, d_of = self._corr_inputs(
                hidim, ndims, transform, psc, dev_delta)
            del dev_delta
            N = embedding.shape[0]
            # embedding neighbors: device f32 candidate pass + f64 re-score
            # (sklearn's exact ordering and tie-breaks)
            mesh = getattr(self, "mesh", None)
            with span("transition.embedding_knn"):
                _dists, idx = kd.knn_search_dev(embedding, min(nn_k + 1, N),
                                                device=self.device, mesh=mesh)
                rows = torch.arange(N, device=idx.device)
                is_self = idx == rows[:, None]
                first_self = torch.where(is_self.any(1),
                                         is_self.to(torch.uint8).argmax(1),
                                         idx.shape[1] - 1)
                keep = torch.ones_like(idx, dtype=torch.bool)
                keep[rows, first_self] = False
                neigh_full = idx[keep].reshape(N, idx.shape[1] - 1)[:, :nn_k]
                # K1's two (N, N) fields come next: free the search's rows
                del _dists, idx, rows, is_self, first_self, keep
            self._keep_neighbours(neigh_full)
            d_rndm = None
            if control is not None:
                with span("transition.control"):
                    rndm, perms, sign_bits, rng_state = control.join()
                    np.random.set_state(rng_state)
                    d_rndm = d_of(rndm)
                    del rndm
        except BaseException:
            if control is not None:
                control.wait()
            raise

        # the main field and the randomized control in one kernel launch
        # (one a shard with a mesh); d_of holds hidim in float64
        del d_of
        with span("transition.cor"):
            corr = col_delta_cor(emat, d_main, tf, psc, dmat_random=d_rndm,
                                 mesh=mesh)
            corr, corr_r = corr if d_rndm is not None else (corr, None)
            corr.fill_diagonal_(0.0)
            self._set_dev("corrcoef", corr)
            if corr_r is not None:
                corr_r.fill_diagonal_(0.0)
                self._set_dev("corrcoef_random", corr_r)
                self._plan("delta_S_rndm", _Permuted(delta, perms, sign_bits))

    def _pcs_inputs(self, hidim: str, ndims: Optional[int], transform: str,
                    psc: float):
        """(kernel transform name, emat, dmat) for hidim="pcs": the first
        ndims components of hidim and hidim + "_t", transformed in f64
        (reference :1531, :1575-1601)."""
        hi_dim, hi_dim_t = (torch.as_tensor(
            np.array(getattr(self, name).T[:, :ndims], order="C"),
            dtype=_F64, device=self.device)
            for name in (hidim, hidim + "_t"))
        tf, emat, d_of = _transform_for_corr(transform, psc, hi_dim)
        return tf, emat, d_of(hi_dim_t)

    def _corr_inputs(self, hidim: str, ndims: Optional[int], transform: str,
                     psc: float, delta: Optional[torch.Tensor]):
        """(kernel transform name, emat, dmat, dmat_of) for the full mode's
        colDeltaCor call (reference :1575-1601): f32 (G, N) tensors,
        transformed in f64.  delta: delta_S on the device (None: read it
        through _get_dev); dmat_of(shift) makes the randomized control's
        dmat from its permuted delta_S in the same way (None for
        hidim="pcs", which has no control)."""
        with span("transition.inputs"):
            if "pcs" in hidim:  # sic (reference :1531)
                tf, emat, d_main = self._pcs_inputs(hidim, ndims, transform,
                                                    psc)
                return (tf, emat.to(_F32).contiguous(),
                        d_main.to(_F32).contiguous(), None)
            dt = self.used_delta_t
            hi = self._get_dev(hidim, _F64)
            tf, emat, d_of = _transform_for_corr(transform, psc, hi)

            def dmat_of(shift: torch.Tensor) -> torch.Tensor:
                return d_of(hi + dt * shift.to(_F64)).to(_F32).contiguous()
            if delta is None:
                delta = self._get_dev("delta_S", _F64)
            return tf, emat.to(_F32).contiguous(), dmat_of(delta), dmat_of

    def _compact_state_valid(self) -> bool:
        """Whether the sampled mode's compact (N, nn) correlation state
        still corresponds to self.corrcoef.  If the dense view was built
        (and perhaps edited by the caller), it is spot-checked on a random
        sample of entries."""
        d = self.__dict__
        ixs_any = d.get("_compact_ixs_dev")
        if ixs_any is None:
            ixs_any = d.get("_compact_ixs")
        if ixs_any is None or getattr(self, "corr_calc", None) != "knn_random":
            return False
        if d.get("_corr_dev") is None and d.get("_compact_corr") is None:
            return False
        dense = d.get("corrcoef")
        if dense is None:
            return True                      # never built => pristine
        n = ixs_any.shape[0]
        if dense.shape[0] != n:
            return False
        ixs, cm = self._compact_ixs, self._compact_corr
        if ixs.shape != cm.shape:
            return False
        rng = np.random.RandomState(0)
        r = rng.randint(0, n, size=min(256, n))
        c = rng.randint(0, ixs.shape[1], size=len(r))
        return bool(np.array_equal(dense[r, ixs[r, c]], cm[r, c]))

    def _embedding_neighbours(self) -> torch.Tensor:
        """The (N, nn) ids of each cell's embedding neighbours, the kNN
        mask of the embedding shift, on the device: the ids the transition
        kept while embedding_knn is still built from them, else the rows
        of embedding_knn, which has to hold the same number of unit
        entries in every row, as every kNN graph of this package and of
        the reference does (ValueError otherwise)."""
        if "embedding_knn" in self._table():
            return self._compact_ixs_dev
        m = sparse.csr_matrix(self.embedding_knn)
        counts = np.diff(m.indptr)
        if not len(counts) or np.any(counts != counts[0]) or \
                np.any(m.data != 1):
            raise ValueError("the embedding shift needs an embedding_knn "
                             "with the same number of unit entries in "
                             "every row")
        return torch.as_tensor(
            m.indices.astype(np.int64).reshape(len(counts), counts[0]),
            device=self.device)

    def calculate_embedding_shift(self, sigma_corr: float = 0.05,
                                  expression_scaling: bool = True,
                                  scaling_penalty: float = 1.0) -> None:
        """Project velocity onto the embedding (reference :1670-1733).

        Both modes run on the compact (N, nn) form, each cell over its
        embedding neighbours (the reference's kNN mask): row softmax,
        unit-vector contraction and expression scaling, with a mesh one
        call a cells shard.  knn_random mode takes its sampled
        correlations as they are, and its dense transition_prob /
        transition_prob_random are float64 host arrays built from them on
        first read.  Full mode, and a corrcoef the caller replaced or
        edited in either mode, gathers the correlations at the neighbour
        ids (_embedding_neighbours) first; the probabilities are kept as
        rows, and the dense views are built on read as float32 (N, N)
        tensors (_get_dev) or host arrays (the attributes), so the call
        makes no (N, N) tensor.  An embedding_knn the caller assigns has
        to be a connectivity graph with the same number of unit entries
        in every row, as every kNN graph of this package and of the
        reference is (ValueError otherwise).  Expression scaling is
        float32 on the sampled form and float64 on the gathered one, as
        the JAX package computes each: its compact route in float32 on
        the device, its dense route in numpy on the float64 hidim."""
        if self.corr_calc not in ("full", "knn_random"):
            raise NotImplementedError(
                f"Weird value self.corr_calc={self.corr_calc}")
        d = self.__dict__
        have_rndm = self._has("corrcoef_random")
        names = ("transition_prob", "transition_prob_random") if have_rndm \
            else ("transition_prob",)
        gathered = not self._compact_state_valid()
        if gathered:
            ixs = self._embedding_neighbours()

            def corr_of(i):
                with span("shift.gather"):
                    return torch.gather(
                        self._stage_input(("corrcoef", "corrcoef_random")[i],
                                          _F32), 1, ixs.to(torch.int64))
        else:
            ixs = d.get("_compact_ixs_dev")
            if ixs is None:
                ixs = self._stage_input("_compact_ixs")

            def corr_of(i):
                corr = d.get(("_corr_dev", "_corr_rndm_dev")[i])
                return corr if corr is not None else self._stage_input(
                    ("_compact_corr", "_compact_corr_random")[i], _F32)
        dt = _F64 if gathered else _F32

        # the probabilities stay as rows at the neighbour ids: the sampled
        # form as its correlations and sigma_corr, the gathered one as the
        # float32 probabilities; the dense views are built on read
        probs = []
        for i, name in enumerate(names):
            corr = corr_of(i)
            with span("shift.softmax"):
                probs.append(_compact_softmax(corr, float(sigma_corr)))
            self._plan(name, _ProbRows(ixs, probs[-1]) if gathered else
                       _Rows(ixs, corr, float(sigma_corr),
                             (("_corr_dev", "_corr_rndm_dev")[i],
                              "_compact_ixs_dev")))
            del corr
        if not have_rndm and isinstance(
                self._table().get("transition_prob_random"), _Rows):
            self._table().pop("transition_prob_random")

        emb = torch.as_tensor(np.asarray(self.embedding, np.float32),
                              device=self.device)
        mesh = getattr(self, "mesh", None)

        def _shift(P):
            with span("shift.project"):
                if mesh is not None:
                    out = map_rows(mesh, _embedding_shift_compact_rows, [emb],
                                   [emb, ixs, P])
                else:
                    out = _embedding_shift_compact(emb, ixs, P)
                return out.cpu().numpy().astype(np.float64)

        def _scaling(P, d_name):
            with span("shift.scaling"):
                d_rows = self._get_dev(d_name, dt).T.contiguous()
                if mesh is not None:
                    num, den = map_rows(mesh, _expr_scaling_compact,
                                        [hi_rows], [d_rows, ixs, P])
                else:
                    num, den = _expr_scaling_compact(hi_rows, d_rows, ixs, P)
                return np.clip((num / den).cpu().numpy() / scaling_penalty,
                               0, 1)

        self.delta_embedding = _shift(probs[0])
        if expression_scaling:
            hi_rows = self._get_dev(self.which_hidim, dt).T.contiguous()
            self.scaling = _scaling(probs[0], "delta_S")
            self.delta_embedding = \
                self.delta_embedding * self.scaling[:, None]

        if have_rndm:
            self.delta_embedding_random = _shift(probs[1])
            if expression_scaling:
                self.scaling_rndm = _scaling(probs[1], "delta_S_rndm")
                self.delta_embedding_random = \
                    self.delta_embedding_random * self.scaling_rndm[:, None]

    @spanned("grid")
    def calculate_grid_arrows(self, embed: str = "embedding",
                              smooth: float = 0.5,
                              steps: Tuple = (40, 40),
                              n_neighbors: int = 100,
                              n_jobs: int = 4) -> None:
        """Gaussian-kernel grid vector field (reference :1735-1816).

        A regular grid is laid over the embedding (each axis padded by
        2.5% of its span -- the second pad intentionally uses the
        already-padded lower bound, like the reference); each grid
        point kernel-averages the velocity shift of its n_neighbors
        nearest cells with a gaussian of width smooth * grid spacing.
        """
        emb = getattr(self, embed)
        try:
            shift = getattr(self, f"delta_{embed}")
        except AttributeError:
            raise KeyError("This embedding does not have a delta_*")

        def padded_axis(vals, n):
            lo, hi = float(vals.min()), float(vals.max())
            lo -= 0.025 * abs(hi - lo)
            hi += 0.025 * abs(hi - lo)
            return np.linspace(lo, hi, n)

        axes = [padded_axis(emb[:, d], steps[d])
                for d in range(emb.shape[1])]
        grid = np.stack([a.ravel() for a in np.meshgrid(*axes)], axis=1)

        dists, neigh = knn_query(emb, grid, min(n_neighbors, emb.shape[0]),
                                 self.device)
        kernel_sd = smooth * np.mean([a[1] - a[0] for a in axes])
        w = normal.pdf(x=dists, loc=0, scale=kernel_sd)
        self.total_p_mass = w.sum(1)
        denom = np.maximum(1, self.total_p_mass)[:, None]

        def kernel_average(field):
            return np.einsum("gk,gkd->gd", w, field[neigh]) / denom

        flow = kernel_average(shift)
        self.flow_embedding = emb
        self.flow_grid = grid
        self.flow = flow
        # scale shared with the randomized control: both normalize by
        # the 99.5th-percentile magnitude of the MAIN field (reference
        # :1800-1807 computes magnitude_rndm from UZ, not UZ_rndm)
        scale = np.percentile(np.linalg.norm(flow, axis=1), 99.5)
        self.flow_norm = flow / scale
        self.flow_norm_magnitude = np.linalg.norm(self.flow_norm, axis=1)

        if self._has("corrcoef_random"):
            flow_rndm = kernel_average(
                getattr(self, f"delta_{embed}_random"))
            self.flow_rndm = flow_rndm
            self.flow_norm_rndm = flow_rndm / scale
            self.flow_norm_magnitude_rndm = np.linalg.norm(
                self.flow_norm_rndm, axis=1)

    # ------------------------------------------------------------------
    # markov diffusion (reference :1818-1887), on the device
    # ------------------------------------------------------------------

    def prepare_markov(self, sigma_D: float, sigma_W: float,
                       direction: str = "forward",
                       cells_ixs: Optional[np.ndarray] = None) -> None:
        """Build the Markov transition matrix (reference :1818-1863) in
        float64 on the device, from transition_prob as a stage reads it
        (_stage_input; span markov.tp).  tr stays device-resident; the
        reference's csr form is built only when .tr is read."""
        if direction not in ("forward", "backwards"):
            raise NotImplementedError(
                f"{direction} is not an implemented direction")
        with span("markov.tp"):
            p = self._stage_input("transition_prob", _F64)
        emb = np.asarray(self.embedding)
        if cells_ixs is not None:
            ix = torch.as_tensor(np.ascontiguousarray(cells_ixs),
                                 dtype=torch.int64, device=self.device)
            p = p.index_select(0, ix).index_select(1, ix)
            emb = emb[cells_ixs, :]
        if direction == "backwards":
            p = p.T
        self._set_dev("tr", _markov_matrix(
            p, torch.as_tensor(emb, dtype=_F64, device=self.device),
            sigma_D, sigma_W))

    def run_markov(self, starting_p: Optional[np.ndarray] = None,
                   n_steps: int = 2500,
                   mode: str = "time_evolution") -> None:
        """Run the diffusion (reference :1865-1887) on the device tr (or
        the host tr when one was assigned or its csr view handed out).
        Span markov.steps: tr's float32 copy, the steps and the result's
        copy to the host, which waits for them."""
        tr = self._stage_value("tr")
        if starting_p is None:
            starting_p = np.ones(tr.shape[0]) / tr.shape[0]
        with span("markov.steps"):
            self.diffused = Diffusion(self.device).diffuse(
                starting_p, tr, n_steps=n_steps, mode=mode)[0]

    # ------------------------------------------------------------------
    # deprecated one-shot defaults (reference :1889-1964)
    # ------------------------------------------------------------------

    def default_filter_and_norm(self, min_expr_counts: Optional[int] = None,
                                min_cells_express: Optional[int] = None,
                                N: Optional[int] = None,
                                min_avg_U: Optional[float] = None,
                                min_avg_S: Optional[float] = None) -> None:
        """Heuristic filtering + normalization (reference :1889-1940);
        its two SVR fits (score_cv_vs_mean, adjust_totS_totU) run on
        self.device."""
        if min_expr_counts is None:
            min_expr_counts = max(20, min(100, self.S.shape[1] * 2.25e-3))
        if min_cells_express is None:
            min_cells_express = max(10, min(50, self.S.shape[1] * 1.5e-3))
        if N is None:
            N = max(1000, min(int((self.S.shape[1] / 1000) ** (1 / 3) / 0.0008),
                              5000))
        if min_avg_U is None:
            min_avg_U = 0.01
        if min_avg_S is None:
            min_avg_S = 0.08
        self.normalize("S", size=True, log=False)
        self.normalize("U", size=True, log=False)
        self.score_detection_levels(min_expr_counts=min_expr_counts,
                                    min_cells_express=min_cells_express)
        self.filter_genes(by_detection_levels=True)
        self.score_cv_vs_mean(N=N, max_expr_avg=40)
        self.filter_genes(by_cv_vs_mean=True)
        self.score_detection_levels(
            min_expr_counts=0, min_cells_express=0,
            min_expr_counts_U=int(min_expr_counts / 2) + 1,
            min_cells_express_U=int(min_cells_express / 2) + 1)
        if hasattr(self, "cluster_labels"):
            self.score_cluster_expression(min_avg_U=min_avg_U,
                                          min_avg_S=min_avg_S)
            self.filter_genes(by_detection_levels=True,
                              by_cluster_expression=True)
        else:
            self.filter_genes(by_detection_levels=True)
        self.normalize_by_total()
        self.adjust_totS_totU(normalize_total=True)

    def default_fit_preparation(self, k: Optional[int] = None,
                                n_comps: Optional[int] = None) -> None:
        """Heuristic PCA + kNN smoothing (reference :1942-1964)."""
        self.perform_PCA()
        if n_comps is None:
            n_comps = int(np.where(np.diff(np.diff(np.cumsum(
                self.pca.explained_variance_ratio_)) > 0.002))[0][0])
        if k is None:
            k = int(min(1000, max(10, np.ceil(self.S.shape[1] * 0.02))))
        self.knn_imputation(n_pca_dims=n_comps, k=k, balanced=True,
                            b_sight=int(min(k * 8, self.S.shape[1] - 1)),
                            b_maxl=int(min(k * 4, self.S.shape[1] - 1)))
        self.normalize_median()

    # ------------------------------------------------------------------
    # plotting (host-side matplotlib; reference :96-135, :1966-2312).
    # Copied from velocyto_tpu/analysis.py:1917-2202: the same artists
    # from the same data in the same order.  Device-backed attributes
    # (Sx_sz, Ux_sz, Sx_sz_t, ...) are read through __getattr__, one
    # cached host copy each.
    # ------------------------------------------------------------------

    def plot_fractions(self, save2file: Optional[str] = None) -> None:
        """Per-sample barplot of the spliced/ambiguous/unspliced molecule
        fractions (same figure contract as reference plot_fractions
        :96-135: grouped bars per sample with std error bars)."""
        plt = _plt()
        if "SampleID" in self.ca:
            labels = np.asarray(self.ca["SampleID"])
        else:
            # sample prefix of the "sample:barcode" CellID convention
            labels = np.array([c.split(":")[0] for c in self.ca["CellID"]])
        samples, sample_ix = np.unique(labels, return_inverse=True)
        per_cell = np.stack([m.sum(0) for m in (self.S, self.A, self.U)])
        frac = per_cell / per_cell.sum(0, keepdims=True)     # (3, N)

        plt.figure(figsize=(3.2, 5))
        ax = plt.gca()
        xs = np.arange(3)
        offsets = np.linspace(-0.2, 0.2, len(samples))
        width = 0.5 / (len(samples) * 1.05)
        for i, name in enumerate(samples):
            sel = frac[:, sample_ix == i]
            ax.bar(xs + offsets[i], sel.mean(1), width, label=name)
            ax.errorbar(xs + offsets[i], sel.mean(1), sel.std(1), c="k",
                        fmt="none", lw=1, capsize=2)
        ax.set_ylabel("Fraction")
        ax.set_xticks(xs)
        ax.set_xticklabels(["spliced", "ambiguous", "unspliced"])
        for side in ("right", "top"):
            ax.spines[side].set_visible(False)
        ax.yaxis.set_ticks_position("left")
        ax.xaxis.set_ticks_position("bottom")
        ax.spines["left"].set_bounds(0, 0.8)
        ax.legend()
        plt.tight_layout()
        if save2file:
            plt.savefig(save2file, bbox_inches="tight")

    def plot_pca(self, dim: List[int] = [0, 1, 2], elev: float = 60,
                 azim: float = -140) -> None:
        """3D PCA scatter (reference :906-915)."""
        plt = _plt()
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(self.pcs[:, dim[0]], self.pcs[:, dim[1]],
                   self.pcs[:, dim[2]], c=self.colorandum)
        ax.view_init(elev=elev, azim=azim)

    def _plot_pca_imputed(self, dim: List[int] = [0, 1, 2], elev: float = 60,
                          azim: float = -140) -> None:
        """3D PCA scatter of the smoothed data (reference :922-931)."""
        plt = _plt()
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(self.pcsx[:, dim[0]], self.pcsx[:, dim[1]],
                   self.pcsx[:, dim[2]], c=self.colorandum)
        ax.view_init(elev=elev, azim=azim)

    def _plot_phase_portrait(self, gene: Optional[str], gs_i: Any = None) -> None:
        plt = _plt()
        if gene is None:
            plt.subplot(111)
        else:
            plt.subplot(gs_i)
        ix = np.where(self.ra["Gene"] == gene)[0][0]
        scatter_viz(self.Sx_sz[ix, :], self.Ux_sz[ix, :], c=self.colorandum,
                    s=5, alpha=0.4)
        plt.title(gene)
        xnew = np.linspace(0, self.Sx_sz[ix, :].max())
        plt.plot(xnew, self.gammas[ix] * xnew + self.q[ix], c="k")

    def plot_phase_portraits(self, genes: List[str]) -> None:
        """Phase portrait grid (reference :1979-1991)."""
        plt = _plt()
        n = len(genes)
        sqrtn = int(np.ceil(np.sqrt(n)))
        gs = plt.GridSpec(sqrtn, int(np.ceil(n / sqrtn)))
        for i, gn in enumerate(genes):
            self._plot_phase_portrait(gn, gs[i])

    def plot_grid_arrows(self, quiver_scale: Union[str, float] = "auto",
                         scale_type: str = "relative", min_mass: float = 1,
                         min_magnitude: Optional[float] = None,
                         scatter_kwargs_dict: Optional[Dict] = None,
                         plot_dots: bool = False, plot_random: bool = False,
                         **quiver_kwargs: Any) -> None:
        """Grid vector-field plot (reference :1993-2093).

        Hidden grid points are either dropped or zeroed (plot_dots):
        below-min_mass points always, below-min_magnitude points when a
        magnitude floor is given (then the normalized field is drawn).
        The quiver scale is calibrated against the randomized control's
        90th-percentile arrow length, like the reference.
        """
        plt = _plt()
        arrow_style = dict({"angles": "xy", "scale_units": "xy",
                            "minlength": 1.5}, **quiver_kwargs)
        dot_style = dict({"s": 20, "zorder": -1, "alpha": 0.2, "lw": 0,
                          "c": self.colorandum},
                         **(scatter_kwargs_dict or {}))

        if scale_type == "relative":
            if not hasattr(self, "flow_rndm"):
                raise ValueError(
                    "`scale_type` was set to 'relative' but the randomized "
                    "control was not computed when running "
                    "estimate_transition_prob")
            span = np.linalg.norm(np.ptp(self.flow_grid, 0), 2)
            typical = np.percentile(np.linalg.norm(
                self.flow_rndm[self.total_p_mass >= min_mass, :], 2, 1), 90)
            base = typical / (span * 0.0025)
            quiver_scale = base if quiver_scale == "auto" \
                else quiver_scale * base

        hidden = self.total_p_mass < min_mass

        def field(which):
            if min_magnitude is None:
                vec, hide = getattr(self, which), hidden
            else:
                vec = getattr(self, which.replace("flow", "flow_norm"))
                mag = self.flow_norm_magnitude if which == "flow" \
                    else self.flow_norm_magnitude_rndm
                hide = hidden | (mag < min_magnitude)
            pts, vec = np.copy(self.flow_grid), np.copy(vec)
            if plot_dots:
                vec[hide, :] = 0
            else:
                pts, vec = pts[~hide, :], vec[~hide, :]
            return pts, vec

        def panel(which):
            pts, vec = field(which)
            plt.scatter(self.flow_embedding[:, 0],
                        self.flow_embedding[:, 1], **dot_style)
            plt.quiver(pts[:, 0], pts[:, 1], vec[:, 0], vec[:, 1],
                       scale=quiver_scale, zorder=20000, **arrow_style)
            plt.axis("off")

        if plot_random:
            plt.subplot(122)
            plt.title("Randomized")
            panel("flow_rndm")
            plt.subplot(121)
            plt.title("Data")
        panel("flow")

    def plot_arrows_embedding(self, choice: Union[str, int] = "auto",
                              quiver_scale: Union[str, float] = "auto",
                              scale_type: str = "relative",
                              plot_scatter: bool = False,
                              scatter_kwargs: Dict = {},
                              color_arrow: str = "cluster",
                              new_fig: bool = False,
                              plot_random: bool = True,
                              **quiver_kwargs: Any) -> None:
        """Cell-wise arrow plot (reference :2095-2190): a random subset
        of cells gets an arrow for its embedding shift, optionally next
        to the randomized-control panel; the quiver scale is calibrated
        against the control's 80th-percentile arrow length."""
        plt = _plt()
        if choice == "auto":
            choice = int(self.S.shape[1] / 3)
        have_rndm = hasattr(self, "delta_embedding_random")
        dot_style = dict(dict(c="0.8", alpha=0.4, s=10,
                              edgecolor=(0, 0, 0, 1), lw=0.3),
                         **scatter_kwargs)
        if new_fig:
            plt.figure(figsize=(22, 12) if plot_random and have_rndm
                       else (14, 14))
        subset = np.random.choice(self.embedding.shape[0], size=choice,
                                  replace=False)
        if scale_type == "relative":
            if not have_rndm:
                raise ValueError(
                    "`scale_type` was set to 'relative' but the randomized "
                    "control was not computed when running "
                    "estimate_transition_prob")
            span = np.linalg.norm(np.ptp(self.flow_grid, 0), 2)
            typical = np.percentile(np.linalg.norm(
                self.delta_embedding_random, 2, 1), 80)
            base = typical / (span * 0.005)
            quiver_scale = base if quiver_scale == "auto" \
                else quiver_scale * base
        arrow_style = dict({"angles": "xy", "scale_units": "xy",
                            "minlength": 1.5,
                            "color": (self.colorandum[subset, :]
                                      if color_arrow == "cluster"
                                      else color_arrow)},
                           **quiver_kwargs)

        def panel(shift):
            if plot_scatter:
                plt.scatter(self.embedding[:, 0], self.embedding[:, 1],
                            **dot_style)
            plt.quiver(self.embedding[subset, 0], self.embedding[subset, 1],
                       shift[subset, 0], shift[subset, 1],
                       scale=quiver_scale, **arrow_style)
            plt.axis("off")

        if plot_random and have_rndm:
            plt.subplot(122)
            plt.title("Randomized")
            panel(self.delta_embedding_random)
            plt.subplot(121)
            plt.title("Data")
        panel(self.delta_embedding)

    def plot_cell_transitions(self, cell_ix: int = 0, alpha: float = 0.1,
                              alpha_neigh: float = 0.2,
                              cmap_name: str = "RdBu_r",
                              plot_arrow: bool = True,
                              mark_cell: bool = True,
                              head_width: int = 3) -> None:
        """Transition probabilities from one cell (reference :2192-2212)."""
        plt = _plt()
        colorandum = np.ones((self.embedding.shape[0], 4))
        colorandum *= 0.3
        colorandum[:, -1] = alpha
        plt.scatter(self.embedding[:, 0], self.embedding[:, 1],
                    c=colorandum, s=50, edgecolor="none")
        if mark_cell:
            plt.scatter(self.embedding[cell_ix, 0], self.embedding[cell_ix, 1],
                        facecolor="none", s=100, edgecolor="k")
        if plot_arrow:
            plt.arrow(self.embedding[cell_ix, 0], self.embedding[cell_ix, 1],
                      self.delta_embedding[cell_ix, 0],
                      self.delta_embedding[cell_ix, 1],
                      head_width=head_width, length_includes_head=True)

    def _embedding_gene_scatter(self, unit_values: np.ndarray, cmap: Any,
                                gs: Any, which_tsne: str, title: str,
                                **kwargs: Any) -> None:
        """One styled embedding scatter colored by per-cell values in
        [0, 1] (shared body of the *_as_color plots)."""
        plt = _plt()
        opts = {"alpha": 0.5, "s": 8, "edgecolor": "0.8", "lw": 0.15}
        opts.update(kwargs)
        if gs is None:
            plt.figure(figsize=(10, 10))
            plt.subplot(111)
        else:
            plt.subplot(gs)
        emb = getattr(self, which_tsne)
        scatter_viz(emb[:, 0], emb[:, 1], c=cmap(unit_values), **opts)
        plt.axis("off")
        plt.title(title)

    def plot_velocity_as_color(self, gene_name: Optional[str] = None,
                               cmap: Any = None, gs: Any = None,
                               which_tsne: str = "ts", **kwargs: Any) -> None:
        """One gene's extrapolated shift on the embedding, as a
        diverging color map centered on zero and clipped at the 1/99th
        percentiles (same figure contract as reference :2214-2262,
        including the flat-velocity early-out)."""
        plt = _plt()
        ix = np.where(self.ra["Gene"] == gene_name)[0][0]
        if self.which_S_for_pred == "Sx_sz":
            shift = self.Sx_sz_t[ix, :] - self.Sx_sz[ix, :]
        else:
            shift = self.Sx_t[ix, :] - self.Sx[ix, :]
        if (np.abs(shift) > 5e-5).sum() < 10:
            print("S vs U scatterplot it is flat")
            return
        limit = np.max(np.abs(np.percentile(shift, [1, 99])))
        vals = np.clip((shift + limit) / (2 * limit), 0, 1)
        self._embedding_gene_scatter(vals, cmap or plt.cm.RdBu_r, gs,
                                     which_tsne, f"{gene_name}", **kwargs)

    def plot_expression_as_color(self, gene_name: Optional[str] = None,
                                 imputed: bool = True, cmap: Any = None,
                                 gs: Any = None, which_tsne: str = "ts",
                                 **kwargs: Any) -> None:
        """One gene's (smoothed or raw size-normalized) expression on
        the embedding, as a sequential map normalized to its 99th
        percentile (same figure contract as reference :2264-2312)."""
        plt = _plt()
        ix = np.where(self.ra["Gene"] == gene_name)[0][0]
        if not imputed:
            expr = self.S_sz[ix, :]
        elif self.which_S_for_pred == "Sx_sz":
            expr = self.Sx_sz[ix, :]
        else:
            expr = self.Sx[ix, :]
        vals = np.clip(expr / np.percentile(expr, 99), 0, 1)
        self._embedding_gene_scatter(vals, cmap or plt.cm.Greens, gs,
                                     which_tsne, f"{gene_name}", **kwargs)

    def reload_raw(self, substitute: bool = False) -> None:
        """Reload pristine matrices from the loom (reference :2314-2342):
        into S/U/A when substitute, else as raw_* copies."""
        prefix = "" if substitute else "raw_"
        ds = loomio.connect(self.loom_filepath)
        try:
            loaded = {}
            for name in ("spliced", "unspliced", "ambiguous"):
                loaded[name] = ds.layer[name][:, :]
                setattr(self, prefix + name[0].upper(), loaded[name])
            setattr(self, prefix + "initial_cell_size",
                    loaded["spliced"].sum(0))
            setattr(self, prefix + "initial_Ucell_size",
                    loaded["unspliced"].sum(0))
            setattr(self, prefix + "ca", dict(ds.col_attrs.items()))
            setattr(self, prefix + "ra", dict(ds.row_attrs.items()))
        finally:
            ds.close()


def load_velocyto_hdf5(filename: str, device="cuda") -> VelocytoLoom:
    """Reload a VelocytoLoom snapshot written by to_hdf5 of this package
    or of the JAX package (reference :2454-2470), on `device`.  Host
    values are authoritative; stages upload what they read."""
    v = load_hdf5(filename, obj_class=VelocytoLoom)
    v.device = torch.device(device)
    return v


class _NoTorchPickler(pickle.Pickler):
    """Pickles to nowhere; raises TypeError on any torch object."""

    def persistent_id(self, obj: Any) -> None:
        if type(obj).__module__.split(".")[0] == "torch":
            raise TypeError(f"a torch object ({type(obj).__name__}) would "
                            f"reach the snapshot")


def _check_no_torch(attrs: Dict[str, Any]) -> None:
    """Raise TypeError if any value of attrs holds a torch object."""
    for name, value in attrs.items():
        if type(value) is np.ndarray and value.dtype.kind not in ("U", "O"):
            continue                         # an hdf5 dataset, no pickle
        try:
            _NoTorchPickler(io.BytesIO(), protocol=2).dump(value)
        except TypeError as err:
            raise TypeError(f"attribute {name!r}: {err}") from None


def state_from_numpy(attrs: dict, device) -> VelocytoLoom:
    """A VelocytoLoom on `device` whose attributes are `attrs` (numpy
    arrays and scalars, as read from a JAX-package VelocytoLoom: S, U, ca,
    ra, cluster_labels, steady_state, small_U_pop and any stage output
    such as Sx_sz, gammas, q, delta_S, ts).  Host values are
    authoritative and stages upload what they read, except the Markov
    matrix tr (a csr or dense array), which goes to the device as the
    float64 tensor prepare_markov leaves there."""
    v = VelocytoLoom.__new__(VelocytoLoom)
    v.device = torch.device(device)
    for name, value in attrs.items():
        if name == "tr":
            dense = value.toarray() if sparse.issparse(value) else value
            v._set_dev("tr", torch.as_tensor(np.asarray(dense), dtype=_F64,
                                             device=v.device))
        else:
            setattr(v, name, value)
    return v


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

def _paired_correlation_rows(A: torch.Tensor, B: torch.Tensor
                             ) -> torch.Tensor:
    """Pearson correlation of row i of A with row i of B."""
    A_m = A - A.mean(dim=1, keepdim=True)
    B_m = B - B.mean(dim=1, keepdim=True)
    return (A_m * B_m).sum(1) / (torch.linalg.norm(A_m, dim=1) *
                                 torch.linalg.norm(B_m, dim=1))


@spanned("markov.matrix")
def _markov_matrix(p: torch.Tensor, emb: torch.Tensor, sigma_D: float,
                   sigma_W: float) -> torch.Tensor:
    """prepare_markov's transition matrix (reference :1835-1845), float64,
    in row blocks (every step is row-wise): velocity transitions limited
    to a gaussian neighbourhood of width sigma_D, the self-transition
    pinned to the row max, blended 80/20 with a gaussian diffusion kernel
    of width sigma_W, each term row-stochastic.  Distances are the
    difference form of scipy's pdist."""
    n = p.shape[0]
    out = torch.empty((n, n), dtype=_F64, device=p.device)
    block = max(1, min(n, (1 << 24) // max(1, n * emb.shape[1])))
    for r0 in range(0, n, block):
        rows = torch.arange(r0, min(n, r0 + block), device=p.device)
        diff = emb[None, :, :] - emb[rows, None, :]
        pair_d = torch.sqrt((diff * diff).sum(-1))                 # (B, N)
        local = p[rows] * gaussian_kernel(pair_d, sigma=sigma_D)
        local[torch.arange(len(rows), device=p.device), rows] = \
            local.max(dim=1).values
        noise = gaussian_kernel(pair_d, sigma=sigma_W)
        blend = 0.8 * (local / local.sum(1, keepdim=True)) + \
            0.2 * (noise / noise.sum(1, keepdim=True))
        out[rows] = blend / blend.sum(1, keepdim=True)
    return out


def _eps_clip_dev(vel, upred, eps: float):
    msr = upred.max(dim=1).values * eps
    return torch.where(vel.abs() < msr[:, None], 0.0, vel)


def _shift_model2_dev(Sx_sz, Ux_sz, gammas, q, dt: float):
    Ux_szo = torch.clamp_min(Ux_sz - q[:, None], 0.0)
    egt = torch.exp(-gammas * dt)[:, None]
    return Sx_sz * egt + (1 - egt) * Ux_szo / gammas[:, None] - Sx_sz


# estimate_transition_prob's transform -> the colDeltaCor kernels' transform
_KERNEL_TRANSFORM = {"log": "log10", "logratio": "linear", "linear": "linear",
                     "sqrt": "sqrt"}


def _transform_for_corr(transform: str, psc: float, hi_dim: torch.Tensor):
    """(kernel transform name, emat, d_of) for the colDeltaCor call, where
    d_of(hi_dim_t) is the displacement matrix, replicating reference
    :1575-1601 (f64)."""
    if transform == "logratio":
        log2hidim = torch.log2(hi_dim + psc)

        def _d(t):
            return torch.log2(t.abs() + psc) - log2hidim
        tf, emat = "linear", log2hidim
    else:
        def _d(t):
            delta = t - hi_dim
            if transform == "log":
                return torch.log10(delta.abs() + psc) * torch.sign(delta)
            if transform == "sqrt":
                return torch.sqrt(delta.abs() + psc) * torch.sign(delta)
            return delta                                    # linear
        tf, emat = _KERNEL_TRANSFORM[transform], hi_dim
    return tf, emat, _d


def _corr_transform_dev(hi32: torch.Tensor, d32: torch.Tensor, dt: float,
                        psc: float, kind: str) -> torch.Tensor:
    """The displacement transform of estimate_transition_prob (reference
    :1575-1601) in f32 on the device, for the sampled gene-space path.
    delta is dt * delta_S directly: the f64 (hi + dt*dS) - hi equals it to
    one f64 ulp, below f32 resolution."""
    delta = torch.tensor(dt, dtype=_F32) * d32
    if kind == "log":
        return torch.log10(delta.abs() + psc) * torch.sign(delta)
    if kind == "sqrt":
        return torch.sqrt(delta.abs() + psc) * torch.sign(delta)
    if kind == "linear":
        return delta
    # logratio: log2(|hi_dim_t| + psc) - log2(hi_dim + psc)
    return torch.log2((hi32 + delta).abs() + psc) - torch.log2(hi32 + psc)


def _sample_neighbors_dev(idx: torch.Tensor, samp: torch.Tensor,
                          row_offset: int = 0) -> torch.Tensor:
    """The sampled neighbours: drop each row's own cell from the kNN
    index rows idx (N, nn+1), then take the sampled column positions samp
    (N, n_samp) of what is left, in one gather.  row_offset: global id of
    idx's first row, for row-chunked calls (the self test compares global
    ids).  Returns int32 ids (cell counts stay below 2**31), the dtype the
    sampled kernel reads."""
    n, cols = idx.shape
    rows = torch.arange(n, dtype=idx.dtype, device=idx.device)[:, None] + \
        row_offset
    is_self = idx == rows
    first_self = torch.where(is_self.any(1), is_self.to(torch.uint8).argmax(1),
                             cols - 1)
    # column j of the self-dropped rows is column j + (j >= first_self)
    s = samp.to(torch.int64)
    return idx.gather(1, s + (s >= first_self[:, None]).to(torch.int64)
                      ).to(torch.int32)


def _fix_nans(corr: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """The reference's NaN handling (analysis.py:1604-1614): NaN -> 1.0.
    The diagonal is never sampled, so fill_diagonal(0) is implicit.
    Only the flag crosses to the host."""
    nan = torch.isnan(corr)
    if not bool(nan.any()):
        return corr, False
    return torch.where(nan, 1.0, corr), True


def _compact_softmax(corr: torch.Tensor, sigma: float) -> torch.Tensor:
    """Row softmax of the compact (N, nn) correlations at temperature
    sigma, f32."""
    p = torch.exp(corr.to(_F32) / sigma)
    return p / p.sum(dim=1, keepdim=True)


def _embedding_shift_compact(emb: torch.Tensor, ixs: torch.Tensor,
                             P: torch.Tensor) -> torch.Tensor:
    """Compact embedding shift: per row i the kNN mask is the sampled
    candidate set, so delta_i = sum_k P_ik unit(x_{ixs_ik} - x_i) -
    mean_k unit(x_{ixs_ik} - x_i), in O(N * nn * D); row i of ixs and P
    is cell i of emb."""
    return _embedding_shift_compact_rows(emb, emb[:ixs.shape[0]], ixs, P)


def _unit_sums(diff: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_l w[f, b, l] * unit(diff[:, b, l]) for f = 0, 1: diff (D, B, L)
    from each row b to its L candidates, w (2, B, L) -> (2, D, B).

    A row's result does not depend on the rows beside it in the call, as
    long as B is the same: every operation is elementwise but the one
    sum, which runs over an axis zero-padded to a multiple of 4 entries,
    so every row's reduction has the same length and alignment."""
    d, b, n = diff.shape
    sq = diff[0] * diff[0]
    for j in range(1, d):
        sq = sq + diff[j] * diff[j]
    nrm = torch.sqrt(sq)
    unit = torch.where(nrm > 0, diff / torch.where(nrm == 0, 1.0, nrm), 0.0)
    terms = diff.new_zeros((2, d, b, -(-n // 4) * 4))
    terms[..., :n] = w[:, None] * unit[None]
    return terms.sum(-1)


def _row_blocks(m: int, block: int):
    """(i0, b) of the blocks of `block` rows covering m rows; the last
    block's b < block rows are padded to block by the callers, so every
    block is the same shape."""
    return [(i0, min(block, m - i0)) for i0 in range(0, m, block)]


def _embedding_shift_compact_rows(emb: torch.Tensor, rows: torch.Tensor,
                                  ixs: torch.Tensor, P: torch.Tensor
                                  ) -> torch.Tensor:
    """_embedding_shift_compact for the cells at `rows` (M, D) with
    neighbours ixs (M, nn) in emb (N, D) and weights P (M, nn): the part
    of the rows one shard of a mesh holds.  Rows go in zero-filled blocks
    of a fixed size through _unit_sums, so each output row is the same
    whatever rows share the call; the (2, D, B, nn) terms stay near
    32 MB."""
    m, k = ixs.shape
    d = emb.shape[1]
    block = max(1, (1 << 22) // (-(-k // 4) * 4 * d))
    emb_t = emb.to(_F32).T.contiguous()                       # (D, N)
    rows_t = rows.to(_F32).T                                  # (D, M)
    out = torch.empty((m, d), dtype=_F32, device=emb.device)
    for i0, b in _row_blocks(m, block):
        ix = torch.zeros((block, k), dtype=torch.int64, device=emb.device)
        ix[:b] = ixs[i0:i0 + b]
        ctr = torch.zeros((d, block, 1), dtype=_F32, device=emb.device)
        ctr[:, :b, 0] = rows_t[:, i0:i0 + b]
        w = torch.zeros((2, block, k), dtype=_F32, device=emb.device)
        w[0, :b] = P[i0:i0 + b]
        w[1] = 1.0
        sums = _unit_sums(emb_t[:, ix] - ctr, w)              # (2, D, B)
        out[i0:i0 + b] = (sums[0] - sums[1] / k).T[:b]
    return out


def _expr_scaling_compact(hi_rows: torch.Tensor, d_rows: torch.Tensor,
                          ixs: torch.Tensor, P: torch.Tensor, nt: int = 128
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Numerator and denominator of the expression-scaling cos-projection
    (reference analysis.py:1714-1719) on the compact form:
    estim_i = sum_k P_ik hi[ixs_ik] - mean_k hi[ixs_ik];
    returns (<delta_S_i, estim_i>, ||estim_i||) per row, in the dtype of
    hi_rows (float32 with no TF32, or float64).

    hi_rows / d_rows: (N, G) rows.  The neighbour axis is tiled (nt) so
    the gathered (B, nt, G) tensor stays near 32 MB in float32."""
    m, k = ixs.shape
    g = hi_rows.shape[1]
    nt = min(nt, k)
    block = max(1, (1 << 23) // (nt * g))
    dt = hi_rows.dtype
    num = torch.empty(m, dtype=dt, device=hi_rows.device)
    den = torch.empty_like(num)
    with full_f32():
        for i0 in range(0, m, block):
            ix, Pb = ixs[i0:i0 + block], P[i0:i0 + block].to(dt)
            est = torch.zeros((ix.shape[0], g), dtype=dt,
                              device=hi_rows.device)
            total = torch.zeros_like(est)
            for k0 in range(0, k, nt):
                nb = hi_rows[ix[:, k0:k0 + nt]]                  # (B, nt, G)
                est += torch.bmm(Pb[:, None, k0:k0 + nt], nb)[:, 0]
                total += nb.sum(dim=1)
            est -= total / k
            num[i0:i0 + block] = (d_rows[i0:i0 + block] * est).sum(-1)
            den[i0:i0 + block] = torch.sqrt((est * est).sum(-1))
    return num, den


def knn_query(data: np.ndarray, query: np.ndarray, k: int, device):
    """kNN of query points against data on `device` (used by the grid
    field); host (dist, idx)."""
    return _knn_query_impl(data, query, k, device)


# ---------------------------------------------------------------------------
# module-level helpers (reference :2345-2470), host numpy
# ---------------------------------------------------------------------------

def _plt():
    """matplotlib.pyplot, imported on first use: importing the port
    never loads matplotlib."""
    import matplotlib.pyplot as plt
    return plt


# Copied from velocyto_tpu/analysis.py:2620-2647.
def scatter_viz(x: np.ndarray, y: np.ndarray, *args: Any, **kwargs: Any) -> Any:
    """Scatter ordered so every point stays visible (reference :2345-2376)."""
    plt = _plt()
    ix_x_sort = np.argsort(x, kind="mergesort")
    ix_yx_sort = np.argsort(y[ix_x_sort], kind="mergesort")
    args_new = []
    kwargs_new = {}
    for arg in args:
        if type(arg) is np.ndarray:
            args_new.append(arg[ix_x_sort][ix_yx_sort])
        else:
            args_new.append(arg)
    for karg, varg in kwargs.items():
        if type(varg) is np.ndarray:
            kwargs_new[karg] = varg[ix_x_sort][ix_yx_sort]
        else:
            kwargs_new[karg] = varg
    return plt.scatter(x[ix_x_sort][ix_yx_sort], y[ix_x_sort][ix_yx_sort],
                       *args_new, **kwargs_new)


def ixs_thatsort_a2b(a: np.ndarray, b: np.ndarray,
                     check_content: bool = True) -> np.ndarray:
    """Indexes that reorder array a to match array b (reference :2379-2383)."""
    if check_content:
        assert len(np.intersect1d(a, b)) == len(a), \
            "The two arrays are not matching"
    return np.argsort(a)[np.argsort(np.argsort(b))]


def _colors20():
    plt = _plt()
    return np.vstack((plt.cm.tab20b(np.linspace(0., 1, 20))[::2],
                      plt.cm.tab20c(np.linspace(0, 1, 20))[1::2]))


def colormap_fun(x: np.ndarray) -> np.ndarray:
    """The default cluster palette (needs matplotlib)."""
    return _colors20()[np.mod(x, 20)]


# Copied from velocyto_tpu/analysis.py::scale_to_match_median.
def scale_to_match_median(sparse_matrix: sparse.csr_matrix,
                          genes_total: np.ndarray) -> sparse.csc_matrix:
    """Scale neighbor-gene weights to match median totals
    (reference :2392-2404, :2423-2446; numba loop -> vectorized numpy)."""
    data, indices, indptr = (sparse_matrix.data, sparse_matrix.indices,
                             sparse_matrix.indptr)
    new_data = np.zeros(data.shape)
    for i in range(genes_total.shape[0]):
        nz = genes_total[indices[indptr[i]:indptr[i + 1]]]
        if len(nz) == 0:
            continue
        w = np.minimum(1, np.median(nz) / nz)
        new_data[indptr[i]:indptr[i + 1]] = w * data[indptr[i]:indptr[i + 1]]
    return sparse.csc_matrix((new_data, indices, indptr),
                             shape=sparse_matrix.shape, copy=True)


def gaussian_kernel(X, mu: float = 0, sigma: float = 1):
    """Gaussian kernel (reference :2449-2451), on numpy arrays or
    tensors."""
    exp = torch.exp if isinstance(X, torch.Tensor) else np.exp
    return exp(-(X - mu) ** 2 / (2 * sigma ** 2)) / \
        np.sqrt(2 * np.pi * sigma ** 2)


def numba_random_seed(value: int) -> None:
    """Seed the host RNG used by permute_rows_nsign (the reference seeds
    numba's RNG, reference :2407-2410; like the JAX package this uses
    numpy's)."""
    np.random.seed(value)


def permute_rows_nsign(A: np.ndarray) -> None:
    """In-place row permutation with random sign flips (reference
    :2413-2420), drawing from numpy's global stream exactly as
    velocyto_tpu.analysis.permute_rows_nsign does."""
    plmi = np.array([+1, -1])
    for i in range(A.shape[0]):
        np.random.shuffle(A[i, :])
        A[i, :] = A[i, :] * np.random.choice(plmi, size=A.shape[1])


def _permute_rows_nsign_plan(g: int, n: int, rng=np.random):
    """The row permutations and sign flips permute_rows_nsign would
    apply to a (g, n) matrix, drawn from the same np.random sequence
    without touching the data: (g, n) uint16 (int32 past 65,536 columns)
    permutations and the signs bit-packed, (g, ceil(n / 8)) uint8 with
    the first column in the top bit and 1 for +1.  rng: the global
    np.random module or a RandomState, left at the state the draws
    leave.  The draws are replayed in C++ (native.permute_rows_nsign_plan)
    from rng's state, bitwise _permute_rows_nsign_plan_plain."""
    perms, sign_bits, end = native.permute_rows_nsign_plan(
        g, n, rng.get_state())
    rng.set_state(end)
    return perms, sign_bits


# Copied from velocyto_tpu/analysis.py::_permute_rows_nsign_plan.
def _permute_rows_nsign_plan_plain(g: int, n: int, rng=np.random):
    """_permute_rows_nsign_plan as numpy's loop draws it, one shuffle
    and one choice a row (the same draws whether it shuffles an int row
    or a float row): the plain version the native replay is held to."""
    perms = np.empty((g, n), np.uint16 if n <= 65536 else np.int32)
    signs = np.empty((g, n), np.int8)
    plmi = np.array([+1, -1])
    base = np.arange(n)
    for i in range(g):
        p = base.copy()
        rng.shuffle(p)
        perms[i] = p
        signs[i] = rng.choice(plmi, size=n)
    return perms, np.packbits(signs > 0, axis=1)


def _permute_apply_dev(delta: torch.Tensor, perms: torch.Tensor,
                       sign_bits: torch.Tensor) -> torch.Tensor:
    """out[i, j] = delta[i, perms[i, j]] * sign[i, j] on delta's device
    (plain torch: a gather along the columns, the sign bits unpacked, a
    multiply by +-1), with perms and sign_bits from
    _permute_rows_nsign_plan.  The floats are moved and their sign
    flipped, never rounded, so the result equals permute_rows_nsign on
    the same rows bitwise.  The JAX package applies the inverse
    permutations with a sort (velocyto_tpu/analysis.py::
    _permute_apply_dev), a TPU workaround not carried over."""
    n = delta.shape[1]
    shift = torch.arange(7, -1, -1, dtype=torch.uint8, device=delta.device)
    bits = (sign_bits[:, :, None] >> shift) & 1
    sign = bits.reshape(sign_bits.shape[0], -1)[:, :n].to(delta.dtype) * 2 - 1
    return delta.gather(1, perms.to(torch.int64)) * sign


def _permute_rows_nsign_dev(delta: torch.Tensor,
                            rng_state: tuple) -> torch.Tensor:
    """permute_rows_nsign of the (G, N) device tensor delta, drawn from a
    RandomState set to rng_state (numpy's global stream is not touched):
    the plan on the host, its upload, the apply on the device."""
    return _permute_rows_nsign_drawn(delta, rng_state)[0]


def _permute_rows_nsign_drawn(delta: torch.Tensor, rng_state: tuple):
    """_permute_rows_nsign_dev's work, and what it drew: (the permuted
    tensor, the plan's permutations and sign bits as host arrays, the
    RandomState's state after the draws, which is numpy's global state
    after permute_rows_nsign from rng_state)."""
    with span("transition.control.plan"):
        rng = np.random.RandomState()
        rng.set_state(rng_state)
        perms, sign_bits = _permute_rows_nsign_plan(*delta.shape, rng=rng)
        out = _permute_apply_dev(
            delta, torch.from_numpy(perms).to(delta.device),
            torch.from_numpy(sign_bits).to(delta.device))
        return out, perms, sign_bits, rng.get_state()


class _Worker:
    """fn(*args) on a daemon thread.  join() returns its result or raises
    its error; wait() only waits."""

    def __init__(self, fn, *args) -> None:
        self._out: Dict[str, Any] = {}

        def run():
            try:
                self._out["result"] = fn(*args)
            except BaseException as exc:       # re-raised by join()
                self._out["error"] = exc
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        self._thread.join()

    def join(self) -> Any:
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["result"]
