"""VelocytoLoom: the estimation pipeline of velocyto_tpu on PyTorch.

Port of the estimation main path of velocyto_tpu/analysis.py (itself an
API-parity re-implementation of the reference's analysis object,
velocyto/analysis.py:26-2470):

  normalize -> perform_PCA -> knn_imputation -> fit_gammas -> predict_U /
  calculate_velocity / calculate_shift / extrapolate_cell_at_t ->
  estimate_transition_prob (sampled or full) -> calculate_embedding_shift
  -> calculate_grid_arrows

Every object works on one explicit torch device (``device=``; the default
is "cuda").  The heavy (genes, cells) stage outputs and the correlation
state stay on that device between stages; the numpy attributes the
reference exposes are materialized lazily on first read.  Both
colDeltaCor variants run through hand-written CUDA kernels on a CUDA
device (ops/coldeltacor.py).  Host stages (normalization, PCA, the greedy
kNN balance, the randomized-control permutation, the neighbour-sampling
replay and the grid field) stay numpy/scipy/C++, as in the JAX package.
"""
from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch
from scipy import sparse
from scipy.stats import norm as normal

from . import native
from .io import loom as loomio
from .ops import knn_device as kd
from .ops.coldeltacor import col_delta_cor, col_delta_cor_partial_compact
from .ops.gamma import compute_fit_weights, fit_slope_weighted_offset
from .ops.knn import _knn_query_impl, full_f32
from .ops.pca import PCA

_F32, _F64 = torch.float32, torch.float64


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


class VelocytoLoom:
    """In-memory analysis object for a velocyto loom file.

    Attribute-accretion API matching the reference (analysis.py:26-94):
    methods return None and create attributes (S, U, A, S_sz, Sx, gammas,
    velocity, delta_embedding, ...).
    """

    def __init__(self, loom_filepath: str, device="cuda") -> None:
        self.loom_filepath = loom_filepath
        self.device = torch.device(device)
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
    # device-resident pipeline state
    # ------------------------------------------------------------------
    #
    # Stage outputs (Sx, Ux, Upred, velocity, delta_S, corrcoef,
    # transition_prob, ...) live on self.device as tensors in
    # self._dev_state; downstream stages consume them directly, and the
    # public numpy attribute is materialized on first read (cached in
    # _dev_host_cache).  Assigning the attribute makes the host value
    # authoritative again (the device entry is dropped).  Stage tensors
    # may alias each other (Sx_sz is Sx): nothing updates them in place.

    # the (cells, cells) state.  Full mode keeps it on the device and
    # exposes it as float32, like the JAX package's host arrays (every
    # other device-backed attribute as float64); knn_random mode builds
    # it from the compact (cells, nn) state on first read
    _LAZY_DENSE = ("corrcoef", "corrcoef_random",
                   "transition_prob", "transition_prob_random")

    def __setattr__(self, name: str, value: Any) -> None:
        ds = self.__dict__.get("_dev_state")
        if ds is not None and name in ds:
            del ds[name]
            self.__dict__.get("_dev_host_cache", {}).pop(name, None)
        object.__setattr__(self, name, value)

    def __getattr__(self, name: str):
        # only reached when normal lookup fails: materialize lazy views
        d = self.__dict__
        if name in (d.get("_dev_state") or ()):
            return self._materialize_dev(name)
        if name in self._LAZY_DENSE:
            return self._materialize_dense(name)
        if name in ("knn", "knn_smoothing_w") and \
                d.get("_knn_graph_dev") is not None:
            g = d["_knn_graph_dev"]
            out = (kd.graph_to_csr(g) if name == "knn" else
                   kd.weights_to_csr(g, diag=d.get("_knn_diag", 1)))
            d[name] = out
            return out
        if name == "_compact_ixs" and d.get("_compact_ixs_dev") is not None:
            d[name] = d["_compact_ixs_dev"].cpu().numpy().astype(np.int64)
            return d[name]
        if name == "embedding_knn" and d.get("_compact_ixs_dev") is not None:
            ixs = self._compact_ixs
            n, nn = ixs.shape
            d[name] = sparse.csr_matrix(
                (np.ones(n * nn), ixs.ravel(), np.arange(0, n * nn + 1, nn)),
                shape=(n, n))
            return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def _set_dev(self, name: str, dev: torch.Tensor) -> None:
        """Store a device tensor as the authoritative value of `name`."""
        self.__dict__.pop(name, None)
        self.__dict__.setdefault("_dev_state", {})[name] = dev
        self.__dict__.setdefault("_dev_host_cache", {}).pop(name, None)

    def _drop(self, *names: str) -> None:
        """Forget attributes: host values, device tensors and cached host
        views alike."""
        d = self.__dict__
        for name in names:
            d.pop(name, None)
            (d.get("_dev_state") or {}).pop(name, None)
            (d.get("_dev_host_cache") or {}).pop(name, None)

    def _get_dev(self, name: str, dtype: torch.dtype = _F32) -> torch.Tensor:
        """`name` as a tensor on self.device (no transfer when the
        attribute is device-backed; uploaded from the host otherwise)."""
        ds = self.__dict__.get("_dev_state")
        if ds is not None and name in ds:
            return ds[name].to(dtype)
        return torch.as_tensor(np.asarray(getattr(self, name)), dtype=dtype,
                               device=self.device)

    def _materialize_dev(self, name: str) -> np.ndarray:
        dev = self.__dict__["_dev_state"][name]
        cache = self.__dict__.setdefault("_dev_host_cache", {})
        if name not in cache:
            dt = np.float32 if name in self._LAZY_DENSE else np.float64
            cache[name] = dev.cpu().numpy().astype(dt)
        return cache[name]

    # ------------------------------------------------------------------
    # normalization (reference :535-904)
    # ------------------------------------------------------------------

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
        self.S_sz, s_norm = _scaled_pair(self.S, self.norm_factor,
                                         pcount, log)
        if log:
            self.S_norm = s_norm

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
        self.U_sz, u_norm = _scaled_pair(self.U, norm_factor, pcount, log,
                                         clean_nonfinite=True)
        if log:
            self.U_norm = u_norm

    # ------------------------------------------------------------------
    # dimensionality reduction + smoothing (reference :678-702, :933-1023)
    # ------------------------------------------------------------------

    def perform_PCA(self, which: str = "S_norm",
                    n_components: Optional[int] = None,
                    div_by_std: bool = False) -> None:
        """PCA with cells as samples, host LAPACK (reference :678-702)."""
        X = getattr(self, which)
        self.pca = PCA(n_components=n_components)
        if div_by_std:
            self.pcs = self.pca.fit_transform(X.T / X.std(0))
        else:
            self.pcs = self.pca.fit_transform(X.T)

    def knn_imputation(self, k: Optional[int] = None, pca_space: bool = True,
                       metric: str = "euclidean", diag: float = 1,
                       n_pca_dims: Optional[int] = None, maximum: bool = False,
                       size_norm: bool = True, balanced: bool = False,
                       b_sight: Optional[int] = None,
                       b_maxl: Optional[int] = None,
                       group_constraint: Union[str, np.ndarray, None] = None,
                       n_jobs: int = 8) -> None:
        """kNN smoothing of S_sz/U_sz -> Sx/Ux (reference :933-1023).

        Device candidate search, exact f64 re-score, greedy balancing on
        the host, and the smoothing convolution on the device.  Sx/Ux stay
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
                                          device=self.device)
        else:
            if group_constraint is not None:
                raise ValueError("group_constraint is currently supported "
                                 "only if the argument balanced is set to True")
            g = kd.knn_graph_dev(space, k=k, metric=metric,
                                 device=self.device)
        for stale in ("knn", "knn_smoothing_w"):
            self.__dict__.pop(stale, None)
        self._knn_graph_dev = g
        self._knn_diag = diag
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

    # ------------------------------------------------------------------
    # gamma model (reference :1120-1260)
    # ------------------------------------------------------------------

    def fit_gammas(self, steady_state_bool: Optional[np.ndarray] = None,
                   use_imputed_data: bool = True, use_size_norm: bool = True,
                   fit_offset: bool = True, fixperc_q: bool = False,
                   weighted: bool = True,
                   weights: Union[str, np.ndarray] = "maxmin_diag",
                   limit_gamma: bool = False,
                   maxmin_perc: List[float] = [2, 98],
                   maxmin_weighted_pow: float = 15) -> None:
        """Fit per-gene degradation rates (reference :1120-1260) with the
        closed-form weighted fit with offset (ops.gamma), on the device.

        Ported: all cells at steady state, weighted=True, fit_offset=True
        (the reference defaults).  The other branches raise
        NotImplementedError (ROADMAP.md A3)."""
        if steady_state_bool:
            self.steady_state = steady_state_bool
        else:
            self.steady_state = np.ones(self.S.shape[1], dtype=bool)
        if not (np.all(self.steady_state) and weighted and fit_offset):
            raise NotImplementedError(
                "fit_gammas is ported for all-steady-state weighted fits "
                "with offset only (ROADMAP.md A3)")
        Sname = ("Sx_sz" if use_size_norm else "Sx") if use_imputed_data \
            else ("S_sz" if use_size_norm else "S")
        Uname = ("Ux_sz" if use_size_norm else "Ux") if use_imputed_data \
            else ("U_sz" if use_size_norm else "U")
        tmpS = self._get_dev(Sname)
        tmpU = self._get_dev(Uname)
        if type(weights) is np.ndarray:
            W = torch.as_tensor(weights, dtype=_F32, device=self.device)
        else:
            need_xs = weights in ("maxmin_diag", "maxmin_double")
            W = compute_fit_weights(
                weights, tmpS, tmpU,
                self._get_dev("Sx") if need_xs else None,
                self._get_dev("Ux") if need_xs else None,
                maxmin_perc, maxmin_weighted_pow)
        self.gammas, self.q, self.R2 = fit_slope_weighted_offset(
            tmpU, tmpS, W, return_R2=True, limit_gamma=limit_gamma)
        self.gammas[~np.isfinite(self.gammas)] = 0

    # ------------------------------------------------------------------
    # velocity chain (reference :1321-1439), on the device
    # ------------------------------------------------------------------

    def _gene_vector(self, name: str) -> torch.Tensor:
        return torch.as_tensor(np.asarray(getattr(self, name)), dtype=_F32,
                               device=self.device)

    def predict_U(self, which_gamma: str = "gammas", which_S: str = "Sx_sz",
                  which_offset: str = "q") -> None:
        """Upred = gamma * S (+ q) (reference :1321-1346)."""
        self.which_S_for_pred = which_S
        gam = self._gene_vector(which_gamma)
        q = (torch.zeros_like(gam) if which_offset is None
             else self._gene_vector(which_offset))
        self._set_dev("Upred",
                      gam[:, None] * self._get_dev(which_S) + q[:, None])

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
        of its per-cell np.random.choice loop, ``native``).  The sampled
        colDeltaCor (hand CUDA kernel on a CUDA device; the main field and
        the randomized control in one pass) keeps the compact (N, nn)
        correlations on the device; the dense (N, N) attributes are built
        only when read.  knn_random=False: the dense colDeltaCor (hand
        CUDA kernel on a CUDA device).  The randomized control permutes
        delta_S with numpy's global stream, like the JAX package."""
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
        p_samp = np.linspace(sampling_probs[0], sampling_probs[1], nn_k)
        p_samp = p_samp / p_samp.sum()
        n_samp = int(sampled_fraction * nn_k)
        # the C++ replay releases the GIL: it samples while the
        # permutation, the transform and the embedding kNN run here
        with ThreadPoolExecutor(max_workers=1) as pool:
            sampling = pool.submit(native.choice_noreplace_rows, random_seed,
                                   N, nn_k, n_samp, p_samp)
            tf, emat, d_main, d_rndm = self._corr_inputs(
                hidim, ndims, transform, psc, calculate_randomized,
                sampled=True)
            _dists, idx = kd.knn_search_dev(embedding, min(nn_k + 1, N),
                                            device=self.device)
            # the reference seeds here, then calls np.random.choice once
            # per cell; the replay leaves numpy's stream where they would
            np.random.seed(random_seed)
            sampling_ixs, _draws, mt_state = sampling.result()
        np.random.set_state(mt_state)
        self.sampling_ixs = sampling_ixs
        self.corr_calc = "knn_random"
        neigh = _sample_neighbors_dev(
            idx, torch.as_tensor(sampling_ixs, device=idx.device))
        # embedding_knn materializes lazily from the sampled indices
        self._drop("embedding_knn", "_compact_ixs")
        self._compact_ixs_dev = neigh

        corr = col_delta_cor_partial_compact(emat, d_main, neigh, tf, psc,
                                             dmat_random=d_rndm)
        corr_m, corr_r = corr if d_rndm is not None else (corr, None)
        corr_m, had_nan = _fix_nans(corr_m)
        if had_nan:
            logging.warning(
                "Nans encountered in corrcoef and corrected to 1s. If not "
                "identical cells were present it is probably a small "
                "isolated cluster converging after imputation.")
        self._corr_dev = corr_m
        # the reference overwrites corrcoef here but leaves any old
        # transition_prob stale until the next embedding-shift call
        self._drop("_compact_corr", "corrcoef", "_tp_sigma")
        if corr_r is not None:
            self._corr_rndm_dev, _ = _fix_nans(corr_r)
            self._drop("_compact_corr_random", "corrcoef_random")

    def _estimate_full(self, hidim: str, ndims: Optional[int],
                       transform: str, psc: float, calculate_randomized: bool,
                       embedding: np.ndarray, nn_k: int) -> None:
        """estimate_transition_prob(knn_random=False): dense (N, N)
        correlations against every cell, masked later by embedding_knn."""
        self.corr_calc = "full"
        self._drop("_corr_dev", "_corr_rndm_dev", "_compact_corr",
                   "_compact_corr_random", "_compact_ixs", "_compact_ixs_dev",
                   "_tp_sigma")
        tf, emat, d_main, d_rndm = self._corr_inputs(
            hidim, ndims, transform, psc, calculate_randomized, sampled=False)
        N = embedding.shape[0]
        # embedding neighbors: device f32 candidate pass + f64 re-score
        # (sklearn's exact ordering and tie-breaks)
        _dists, idx = kd.knn_search_dev(embedding, min(nn_k + 1, N),
                                        device=self.device)
        rows = torch.arange(N, device=idx.device)
        is_self = idx == rows[:, None]
        first_self = torch.where(is_self.any(1),
                                 is_self.to(torch.uint8).argmax(1),
                                 idx.shape[1] - 1)
        keep = torch.ones_like(idx, dtype=torch.bool)
        keep[rows, first_self] = False
        neigh_full = idx[keep].reshape(N, idx.shape[1] - 1)[:, :nn_k]
        self.embedding_knn = sparse.csr_matrix(
            (np.ones(N * nn_k), neigh_full.cpu().numpy().ravel(),
             np.arange(0, N * nn_k + 1, nn_k)), shape=(N, N))

        corr = col_delta_cor(emat, d_main, tf, psc)
        corr.fill_diagonal_(0.0)
        self._set_dev("corrcoef", corr)
        if d_rndm is not None:
            corr_r = col_delta_cor(emat, d_rndm, tf, psc)
            corr_r.fill_diagonal_(0.0)
            self._set_dev("corrcoef_random", corr_r)

    def _corr_inputs(self, hidim: str, ndims: Optional[int], transform: str,
                     psc: float, calculate_randomized: bool, sampled: bool):
        """(kernel transform name, emat, dmat, dmat_random or None) as f32
        (G, N) tensors for the colDeltaCor call (reference :1575-1601).

        With calculate_randomized, first permutes delta_S into
        delta_S_rndm with numpy's global stream at the reference's point
        in the sequence (bit-identical to the JAX package's control).
        The sampled gene-space path transforms on the device in f32 from
        delta_S directly, as the JAX package does; the full path and the
        "pcs" hidim transform in f64."""
        if calculate_randomized:
            # the sampled path permutes the f32 device delta_S, as the
            # JAX package does; the full path the host delta_S
            self.delta_S_rndm = (
                self._get_dev("delta_S").cpu().numpy().astype(np.float64)
                if sampled and "pcs" not in hidim else np.copy(self.delta_S))
            permute_rows_nsign(self.delta_S_rndm)
        if "pcs" in hidim:  # sic (reference :1531)
            hi_dim, hi_dim_t = (torch.as_tensor(
                np.array(getattr(self, name).T[:, :ndims], order="C"),
                dtype=_F64, device=self.device)
                for name in (hidim, hidim + "_t"))
            tf, emat, d_of = _transform_for_corr(transform, psc, hi_dim)
            d_main, d_rndm = d_of(hi_dim_t), None
        else:
            dt = self.used_delta_t
            if sampled:
                tf = _KERNEL_TRANSFORM[transform]
                hi = self._get_dev(hidim)
                emat = torch.log2(hi + psc) if transform == "logratio" else hi

                def d_of_shift(name):
                    return _corr_transform_dev(hi, self._get_dev(name), dt,
                                               psc, transform)
            else:
                hi = self._get_dev(hidim, _F64)
                tf, emat, d_of = _transform_for_corr(transform, psc, hi)

                def d_of_shift(name):
                    return d_of(hi + dt * self._get_dev(name, _F64))
            d_main = d_of_shift("delta_S")
            d_rndm = (d_of_shift("delta_S_rndm") if calculate_randomized
                      else None)
        return (tf, emat.to(_F32).contiguous(), d_main.to(_F32).contiguous(),
                None if d_rndm is None else d_rndm.to(_F32).contiguous())

    # ------------------------------------------------------------------
    # lazy dense views of the compact correlation state
    # ------------------------------------------------------------------
    #
    # estimate_transition_prob(knn_random=True) keeps only the compact
    # (N, nn) sampled correlations, as device tensors.  The dense (N, N)
    # corrcoef / transition_prob the reference API exposes
    # (analysis.py:1604-1683) are f64 host arrays built on first read, so
    # a pipeline that never reads them never pays for them.

    def _compact_corr_host(self, which: str = "main") -> np.ndarray:
        """Host f64 copy of the compact correlations, pulled from the
        device on first use and cached."""
        key = "_compact_corr" if which == "main" else "_compact_corr_random"
        d = self.__dict__
        if d.get(key) is None:
            dev = d.get("_corr_dev" if which == "main" else "_corr_rndm_dev")
            if dev is None:
                raise AttributeError(key)
            d[key] = dev.cpu().numpy().astype(np.float64)
        return d[key]

    def _compact_ixs_or_none(self) -> Optional[np.ndarray]:
        ixs = self.__dict__.get("_compact_ixs")
        if ixs is None and self.__dict__.get("_compact_ixs_dev") is not None:
            ixs = self._compact_ixs          # lazy pull + cache
        return ixs

    def _materialize_dense(self, name: str) -> np.ndarray:
        ixs = self._compact_ixs_or_none()
        if ixs is None:
            raise AttributeError(name)
        cm = self._compact_corr_host(
            "rndm" if name.endswith("_random") else "main")
        if name.startswith("transition_prob"):
            sig = self.__dict__.get("_tp_sigma")
            if sig is None:                      # no embedding-shift call yet
                raise AttributeError(name)
            cm = np.exp(cm / sig)
            cm = cm / cm.sum(1)[:, None]
        n = ixs.shape[0]
        dense = np.zeros((n, n), dtype=np.float64)
        dense[np.arange(n)[:, None], ixs] = cm
        self.__dict__[name] = dense
        return dense

    def _has_rndm_state(self) -> bool:
        """hasattr(self, 'corrcoef_random') without building a dense
        view."""
        d = self.__dict__
        return ("corrcoef_random" in d or "_compact_corr_random" in d
                or "corrcoef_random" in (d.get("_dev_state") or ())
                or d.get("_corr_rndm_dev") is not None)

    def _compact_state_valid(self) -> bool:
        """Whether the compact (N, nn) correlation state stored by
        estimate_transition_prob still corresponds to self.corrcoef.  If
        the dense view was built (and perhaps edited by the caller), it
        is spot-checked on a random sample of entries."""
        d = self.__dict__
        ixs_any = d.get("_compact_ixs")
        if ixs_any is None:
            ixs_any = d.get("_compact_ixs_dev")
        if ixs_any is None or getattr(self, "corr_calc", None) != "knn_random":
            return False
        if d.get("_corr_dev") is None and d.get("_compact_corr") is None:
            return False
        dense = d.get("corrcoef")
        if dense is None:
            return True                      # never materialized => pristine
        n = ixs_any.shape[0]
        if dense.shape[0] != n:
            return False
        ixs = self._compact_ixs_or_none()
        cm = self._compact_corr_host("main")
        if ixs.shape != cm.shape:
            return False
        rng = np.random.RandomState(0)
        r = rng.randint(0, n, size=min(256, n))
        c = rng.randint(0, ixs.shape[1], size=len(r))
        return bool(np.array_equal(dense[r, ixs[r, c]], cm[r, c]))

    def _corr_dev_view(self, name: str) -> torch.Tensor:
        """corrcoef / corrcoef_random on the device as the JAX package
        reads them: it keeps the full mode's as host arrays, so an
        in-place edit of the host view is honoured.  The view is uploaded
        only if __getattr__ handed it out."""
        cached = (self.__dict__.get("_dev_host_cache") or {}).get(name)
        if cached is not None:
            return torch.as_tensor(cached, dtype=_F32, device=self.device)
        return self._get_dev(name)

    def calculate_embedding_shift(self, sigma_corr: float = 0.05,
                                  expression_scaling: bool = True,
                                  scaling_penalty: float = 1.0) -> None:
        """Project velocity onto the embedding (reference :1670-1733).

        knn_random mode runs on the compact (N, nn) sampled form
        (softmax, unit-vector contraction, expression scaling); the dense
        transition_prob is built only when read.  Full mode, and a
        corrcoef the caller replaced or edited, take the dense form,
        blocked over cells so the reference's (2, N, N) unitary-vector
        tensor never exists."""
        if self.corr_calc not in ("full", "knn_random"):
            raise NotImplementedError(
                f"Weird value self.corr_calc={self.corr_calc}")
        if self._compact_state_valid():
            return self._calculate_embedding_shift_compact(
                sigma_corr, expression_scaling, scaling_penalty)
        K = _dense_from_csr(self.embedding_knn, self.device)
        K_rowsum = K.sum(dim=1)
        have_rndm = self._has_rndm_state()

        def _softmax(name):
            tp = torch.exp(self._corr_dev_view(name) / sigma_corr) * K
            return tp / tp.sum(dim=1, keepdim=True)

        tp = _softmax("corrcoef")
        self._set_dev("transition_prob", tp)
        if have_rndm:
            tp_r = _softmax("corrcoef_random")
            self._set_dev("transition_prob_random", tp_r)

        emb = torch.as_tensor(np.asarray(self.embedding, np.float32),
                              device=self.device)
        self.delta_embedding = _embedding_shift_blocked(
            emb, tp, K, K_rowsum).cpu().numpy().astype(np.float64)

        if expression_scaling:
            hi_dim = self._get_dev(self.which_hidim, _F64)
            k_term = hi_dim @ (K / K_rowsum[:, None]).to(_F64).T

            def _scaling(P, d_name):
                estim = hi_dim @ P.to(_F64).T - k_term
                cos_proj = (self._get_dev(d_name, _F64) * estim).sum(0) / \
                    torch.sqrt((estim ** 2).sum(0))
                return np.clip(cos_proj.cpu().numpy() / scaling_penalty,
                               0, 1)

            self.scaling = _scaling(tp, "delta_S")
            self.delta_embedding = self.delta_embedding * \
                self.scaling[:, None]

        if have_rndm:
            self.delta_embedding_random = _embedding_shift_blocked(
                emb, tp_r, K, K_rowsum).cpu().numpy().astype(np.float64)
            if expression_scaling:
                self.scaling_rndm = _scaling(tp_r, "delta_S_rndm")
                self.delta_embedding_random = \
                    self.delta_embedding_random * self.scaling_rndm[:, None]

    def _calculate_embedding_shift_compact(self, sigma_corr: float,
                                           expression_scaling: bool,
                                           scaling_penalty: float) -> None:
        """knn_random-mode embedding shift on the compact (N, nn) form:
        the same math as the dense form (the kNN mask IS the sampled
        candidate set) in O(N * nn)."""
        d = self.__dict__
        ixs = d.get("_compact_ixs_dev")
        if ixs is None:
            ixs = torch.as_tensor(self._compact_ixs, device=self.device)

        def _p_dev(which):
            # softmax over the sampled candidates; the dense
            # transition_prob stays a lazy __getattr__ view
            dev = d.get("_corr_dev" if which == "main" else "_corr_rndm_dev")
            if dev is None:
                dev = torch.as_tensor(self._compact_corr_host(which),
                                      dtype=_F32, device=self.device)
            return _compact_softmax(dev, float(sigma_corr))

        self._drop("transition_prob")
        self._tp_sigma = float(sigma_corr)
        p_main = _p_dev("main")
        have_rndm = self._has_rndm_state()
        if have_rndm:
            self._drop("transition_prob_random")
            p_rndm = _p_dev("rndm")

        emb = torch.as_tensor(np.asarray(self.embedding, np.float32),
                              device=self.device)
        self.delta_embedding = _embedding_shift_compact(
            emb, ixs, p_main).cpu().numpy().astype(np.float64)

        def _scaling(P, d_name):
            num, den = _expr_scaling_compact(
                hi_rows, self._get_dev(d_name).T.contiguous(), ixs, P)
            return np.clip((num / den).cpu().numpy() / scaling_penalty, 0, 1)

        if expression_scaling:
            hi_rows = self._get_dev(self.which_hidim).T.contiguous()
            self.scaling = _scaling(p_main, "delta_S")
            self.delta_embedding = \
                self.delta_embedding * self.scaling[:, None]

        if have_rndm:
            self.delta_embedding_random = _embedding_shift_compact(
                emb, ixs, p_rndm).cpu().numpy().astype(np.float64)
            if expression_scaling:
                self.scaling_rndm = _scaling(p_rndm, "delta_S_rndm")
                self.delta_embedding_random = \
                    self.delta_embedding_random * self.scaling_rndm[:, None]

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

        if self._has_rndm_state():
            flow_rndm = kernel_average(
                getattr(self, f"delta_{embed}_random"))
            self.flow_rndm = flow_rndm
            self.flow_norm_rndm = flow_rndm / scale
            self.flow_norm_magnitude_rndm = np.linalg.norm(
                self.flow_norm_rndm, axis=1)


def state_from_numpy(attrs: dict, device) -> VelocytoLoom:
    """A VelocytoLoom on `device` whose attributes are `attrs` (numpy
    arrays and scalars, as read from a JAX-package VelocytoLoom: S, U, ca,
    ra and any stage output such as Sx_sz, gammas, q, delta_S, ts).
    Host values are authoritative; stages upload what they read."""
    v = VelocytoLoom.__new__(VelocytoLoom)
    v.device = torch.device(device)
    for name, value in attrs.items():
        setattr(v, name, value)
    return v


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

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
    ids)."""
    n, cols = idx.shape
    rows = torch.arange(n, dtype=idx.dtype, device=idx.device)[:, None] + \
        row_offset
    is_self = idx == rows
    first_self = torch.where(is_self.any(1), is_self.to(torch.uint8).argmax(1),
                             cols - 1)
    # column j of the self-dropped rows is column j + (j >= first_self)
    s = samp.to(torch.int64)
    return idx.gather(1, s + (s >= first_self[:, None]).to(torch.int64))


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
    mean_k unit(x_{ixs_ik} - x_i), in O(N * nn * D).  Blocked over rows,
    with the (B, nn, D) gather near 32 MB."""
    m, k = ixs.shape
    d = emb.shape[1]
    block = max(1, (1 << 23) // (k * d))
    out = torch.empty((m, d), dtype=_F32, device=emb.device)
    with full_f32():
        for i0 in range(0, m, block):
            diff = emb[ixs[i0:i0 + block]] - emb[i0:i0 + block, None, :]
            nrm = torch.linalg.norm(diff, dim=-1, keepdim=True)
            unit = torch.where(nrm > 0,
                               diff / torch.where(nrm == 0, 1.0, nrm), 0.0)
            out[i0:i0 + block] = torch.einsum(
                "bk,bkd->bd", P[i0:i0 + block], unit) - unit.mean(dim=1)
    return out


def _expr_scaling_compact(hi_rows: torch.Tensor, d_rows: torch.Tensor,
                          ixs: torch.Tensor, P: torch.Tensor, nt: int = 128
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Numerator and denominator of the expression-scaling cos-projection
    (reference analysis.py:1714-1719) on the compact form:
    estim_i = sum_k P_ik hi[ixs_ik] - mean_k hi[ixs_ik];
    returns (<delta_S_i, estim_i>, ||estim_i||) per row, f32.

    hi_rows / d_rows: (N, G) rows.  The neighbour axis is tiled (nt) so
    the gathered (B, nt, G) tensor stays near 32 MB."""
    m, k = ixs.shape
    g = hi_rows.shape[1]
    nt = min(nt, k)
    block = max(1, (1 << 23) // (nt * g))
    num = torch.empty(m, dtype=_F32, device=hi_rows.device)
    den = torch.empty_like(num)
    with full_f32():
        for i0 in range(0, m, block):
            ix, Pb = ixs[i0:i0 + block], P[i0:i0 + block]
            est = torch.zeros((ix.shape[0], g), dtype=_F32,
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


def _dense_from_csr(m, device) -> torch.Tensor:
    """m.toarray() as a float32 tensor on `device` (duplicates summed)."""
    m = sparse.csr_matrix(m)
    rows = np.repeat(np.arange(m.shape[0], dtype=np.int64), np.diff(m.indptr))
    out = torch.zeros(m.shape, dtype=_F32, device=device)
    out.index_put_((torch.as_tensor(rows, device=device),
                    torch.as_tensor(m.indices.astype(np.int64),
                                    device=device)),
                   torch.as_tensor(m.data, dtype=_F32, device=device),
                   accumulate=True)
    return out


def _embedding_shift_blocked(emb: torch.Tensor, P: torch.Tensor,
                             K: torch.Tensor, K_rowsum: torch.Tensor
                             ) -> torch.Tensor:
    """delta_i = sum_j P_ij unit(x_j - x_i) - sum_j K_ij unit(..) / sum_j K_ij

    emb: (N, D); P/K: (N, N).  Blocked over i, so the reference's dense
    (D, N, N) unitary-vector tensor (analysis.py:1704-1712) never
    exists."""
    n, d = emb.shape
    block = 128
    out = torch.empty((n, d), dtype=_F32, device=emb.device)
    with full_f32():
        for i0 in range(0, n, block):
            diff = emb[None, :, :] - emb[i0:i0 + block, None, :]  # (B, N, D)
            nrm = torch.linalg.norm(diff, dim=-1, keepdim=True)
            unit = torch.where(nrm > 0,
                               diff / torch.where(nrm == 0, 1.0, nrm), 0.0)
            de = torch.einsum("bn,bnd->bd", P[i0:i0 + block], unit)
            out[i0:i0 + block] = de - torch.einsum(
                "bn,bnd->bd", K[i0:i0 + block], unit) / \
                K_rowsum[i0:i0 + block, None]
    return out


def knn_query(data: np.ndarray, query: np.ndarray, k: int, device):
    """kNN of query points against data on `device` (used by the grid
    field); host (dist, idx)."""
    return _knn_query_impl(data, query, k, device)


# ---------------------------------------------------------------------------
# module-level helpers (reference :2345-2470), host numpy
# ---------------------------------------------------------------------------

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
