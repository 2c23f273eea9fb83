"""k-nearest-neighbor candidate search and the greedy kNN balance.

Port of velocyto_tpu/ops/knn.py.  The candidate pass computes blocked
squared distances (||x||^2 + ||y||^2 - 2 x.y) with a true-f32 matmul and
keeps, per row, the first k of a stable row sort (ties break by index,
like sklearn).  The exact f64 re-score and the (distance, index)
ordering live in ops/knn_device.py.

The balance (reference velocyto/neighbors.py:11-140) is a greedy,
order-dependent loop over the nodes in hub order; balance_knn_loop runs
it on the host in C++ (native/balance.cpp, as the JAX package runs its
own) for knn_balance and BalancedKNN, balance_knn_loop_plain in numpy,
one vectorised step per node; the balanced kNN of VelocytoLoom runs it
on the device (ops/knn_device.py::balance_knn_dev, the hand kernel
kernels/knn_balance.cu on the card).  BalancedKNN and
the mutual-kNN
utilities (reference neighbors.py:186-451) run their search on a torch
device and build scipy.sparse graphs on the host.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from .. import native


@contextlib.contextmanager
def full_f32():
    """Pin float32 matmuls to full precision (no TF32) for ranking- and
    correlation-critical contractions, whatever the caller configured."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _normalize_for_metric(x: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "correlation":
        x = x - x.mean(dim=1, keepdim=True)
        x = x / torch.linalg.norm(x, dim=1, keepdim=True)
        # correlation distance = 1 - corr; monotone in squared euclidean of
        # the normalized rows: ||u-v||^2 = 2 (1 - corr)
    return x


def _candidate_block_fn(rows: torch.Tensor, rsq: torch.Tensor,
                        x: torch.Tensor, sq: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest candidates of one row block against all of x:
    (d2 (B, k), idx (B, k)), from a full stable row sort."""
    with full_f32():
        d2 = rsq[:, None] + sq[None, :] - 2.0 * (rows @ x.T)     # (B, N)
    d2 = d2.clamp_min(0.0)
    d2_s, idx_s = torch.sort(d2, dim=1, stable=True)
    return d2_s[:, :k], idx_s[:, :k]


def _knn_search_impl(data: torch.Tensor, k: int, block: int,
                     metric: str = "euclidean"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs kNN candidates of data (N, D) against itself: (dist, idx)
    each (N, k), ascending by f32 distance, self included."""
    n = data.shape[0]
    x = _normalize_for_metric(data.to(torch.float32), metric)
    sq = (x * x).sum(dim=1)
    d2 = torch.empty((n, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((n, k), dtype=torch.int64, device=x.device)
    for r0 in range(0, n, block):
        d2[r0:r0 + block], idx[r0:r0 + block] = _candidate_block_fn(
            x[r0:r0 + block], sq[r0:r0 + block], x, sq, k)
    dist = d2 / 2.0 if metric == "correlation" else torch.sqrt(d2)
    return dist, idx


def make_knn_search_sharded(mesh, k: int, block: int = 256,
                            metric: str = "euclidean"):
    """The kNN candidate pass with its query rows split over the mesh's
    cells shards, data replicated: fn(data (N, D)) -> this process's
    (d2, idx) blocks, (rows, k) each, one pair per shard on its device.
    Each shard runs the single-device blocked distance and stable sort
    (_candidate_block_fn) on its rows against all of data.  Port of the
    JAX package's make_knn_search_sharded."""
    from ..parallel.mesh import CELLS, bounds, join, on_shard, replicas
    shards = mesh.cell_shards()

    def fn(data: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        x = _normalize_for_metric(data.to(torch.float32), metric)
        sq = (x * x).sum(dim=1)
        spans = bounds(x.shape[0], mesh.shape[CELLS])
        xs, sqs = replicas(shards, x), replicas(shards, sq)
        outs = []
        for i, s in enumerate(shards):
            lo, hi = spans[s.index]
            with on_shard(s, xs[i], sqs[i]):
                d2 = torch.empty((hi - lo, k), dtype=torch.float32,
                                 device=s.device)
                idx = torch.empty((hi - lo, k), dtype=torch.int64,
                                  device=s.device)
                for r0 in range(lo, hi, block):
                    r1 = min(hi, r0 + block)
                    d2[r0 - lo:r1 - lo], idx[r0 - lo:r1 - lo] = \
                        _candidate_block_fn(xs[i][r0:r1], sqs[i][r0:r1],
                                            xs[i], sqs[i], k)
            outs.append((d2, idx))
        join(shards, outs)
        return outs

    return fn


def knn_search_sharded(mesh, data: np.ndarray, k: int,
                       metric: str = "euclidean"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-shard kNN search: query rows split over the mesh's cells
    shards, data replicated; the same exact f64 re-score and tie-breaks
    as the single-device search, so the result equals it.  Returns host
    (dist, idx) (the whole result on every process)."""
    return knn_search(data, k, metric=metric, mesh=mesh)


def _candidate_plan(n: int, k: int) -> Tuple[int, int]:
    """(k2, block) for the candidate pass: a +8 margin absorbs f32
    rounding at the k boundary; the row block (512 at most) shrinks with
    n to bound the (B, N) distance and sort buffers."""
    k2 = min(n, k + 8)
    block = 128 if n > 32768 else 256 if n > 16384 else 512
    return k2, max(8, min(block, n))


def _knn_query_impl(data: np.ndarray, query: np.ndarray, k: int,
                    device) -> Tuple[np.ndarray, np.ndarray]:
    """kNN of `query` rows against `data` rows (euclidean): f32 candidate
    pass, then the exact f64 diff-form re-score and (distance, index)
    ordering.  Returns host (dist, idx)."""
    from .knn_device import _rescore_f64_impl, _reorder_truncate_impl
    n = data.shape[0]
    k2 = min(n, k + 8)
    x = torch.as_tensor(np.asarray(data, np.float32), device=device)
    q = torch.as_tensor(np.asarray(query, np.float32), device=device)
    sq = (x * x).sum(dim=1)
    m = q.shape[0]
    block = min(512, max(8, m))
    cand = torch.empty((m, k2), dtype=torch.int64, device=x.device)
    for r0 in range(0, m, block):
        rows = q[r0:r0 + block]
        _d2, cand[r0:r0 + block] = _candidate_block_fn(
            rows, (rows * rows).sum(dim=1), x, sq, k2)
    x64 = torch.as_tensor(np.asarray(data, np.float64), device=device)
    q64 = torch.as_tensor(np.asarray(query, np.float64), device=device)
    d2 = _rescore_f64_impl(x64, cand, block=256, rows64=q64)
    d2, idx = _reorder_truncate_impl(d2, cand, k)
    return (torch.sqrt(d2.clamp_min(0.0)).cpu().numpy(),
            idx.cpu().numpy())


# ---------------------------------------------------------------------------
# Greedy balancing (host; reference-exact semantics)
# ---------------------------------------------------------------------------

def balance_knn_loop(dsi: np.ndarray, dist: np.ndarray, lsi: np.ndarray,
                     maxl: int, k: int, return_distance: bool,
                     constraint: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy cap on in-degree of the kNN graph, in C++
    (native/balance.cpp, built on first use), as the JAX package runs
    it (velocyto_tpu/ops/knn.py:360-361).  Returns (dist_new, dsi_new,
    l), bitwise equal to balance_knn_loop_plain."""
    return native.balance_knn_loop(dsi, dist, lsi, maxl, k,
                                   return_distance, constraint)


def balance_knn_loop_constrained(dsi: np.ndarray, dist: np.ndarray,
                                 lsi: np.ndarray, groups: np.ndarray,
                                 maxl: int, k: int, return_distance: bool
                                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference-name alias (velocyto/neighbors.py:77-140): the constrained
    variant is balance_knn_loop with ``constraint``.  Copy of
    velocyto_tpu/ops/knn.py:399-406."""
    return balance_knn_loop(dsi, dist, lsi, maxl, k, return_distance,
                            constraint=groups)


def balance_knn_loop_plain(dsi: np.ndarray, dist: np.ndarray,
                           lsi: np.ndarray, maxl: int, k: int,
                           return_distance: bool,
                           constraint: Optional[np.ndarray] = None
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plain version of balance_knn_loop, in numpy.

    Same result as the reference loop (velocyto/neighbors.py:11-140, both
    the plain and the group-constrained variant): nodes are visited
    hub-first (lsi); each keeps its first k admissible neighbors, where a
    neighbor is admissible if it is not the node itself, its in-degree is
    still < maxl and, if constrained, it shares the node's group;
    exhausted sights self-fill.

    One vectorised step per node: a row's candidates are distinct and
    only the in-degree vector l changes between nodes, so a node takes
    the first k admissible candidates of its row (against l as it stands)
    and then bumps l for them.  Slot 0 holds the node itself when it
    appears among the examined candidates (those up to the k-th
    acceptance), else -1."""
    n, sight = dsi.shape
    if sight < k:
        raise ValueError("sight needs to be bigger than k")
    dsi_new = np.full((n, k + 1), -1, np.int64)
    l = np.zeros(n, np.int64)
    dist_new = np.zeros((n, k + 1), np.float64)
    for el in np.asarray(lsi):
        row = dsi[el]
        ok = (row != el) & (l[row] < maxl)
        if constraint is not None:
            ok &= constraint[row] == constraint[el]
        acc = np.flatnonzero(ok)[:k]                 # accepted positions
        p = len(acc)
        # positions the reference loop reads before it stops at the k-th
        # acceptance (none at all when k == 0)
        examined = (acc[-1] + 1 if p else 0) if p == k else sight
        if np.any(row[:examined] == el):
            dsi_new[el, 0] = el
        picked = row[acc]
        dsi_new[el, 1:p + 1] = picked
        l[picked] += 1
        if return_distance:
            dist_new[el, 1:p + 1] = dist[el, acc]
        if p < k:                                    # sight exhausted
            dsi_new[el, p + 1:] = el
            dist_new[el, p + 1:] = dist[el, 0]
    if not return_distance:
        dist_new = np.ones_like(dsi_new, np.float64)
    return dist_new, dsi_new, l


def knn_balance(dsi: np.ndarray, dist: Optional[np.ndarray] = None,
                maxl: int = 200, k: int = 60,
                constraint: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference-parity wrapper (velocyto/neighbors.py:143-183)."""
    l = np.bincount(dsi.flat[:], minlength=dsi.shape[0])
    lsi = np.argsort(l, kind="mergesort")[::-1]
    cst = None if constraint is None else constraint.astype("int64")
    if dist is None:
        dist = np.ones(dsi.shape, dtype="float64")
        dist[:, 0] = 0
        return balance_knn_loop(dsi, dist, lsi, maxl, k,
                                return_distance=False, constraint=cst)
    return balance_knn_loop(dsi, dist, lsi, maxl, k,
                            return_distance=True, constraint=cst)


def knn_search(data: np.ndarray, k: int, metric: str = "euclidean",
               device="cuda", mesh=None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """kNN search (self included as the first neighbor), returned on the
    host as (dist (N, k) f64, idx (N, k) int64).

    The JAX package's contract (velocyto_tpu/ops/knn.py:187): an f32
    candidate pass on `device` (or with its query rows split over
    `mesh`), then the exact f64 re-score and (distance, index) order, so
    the result matches sklearn's brute force, tie-breaks included;
    ``metric="correlation"`` gives 1 - corr = d2 / 2."""
    from .knn_device import knn_search_dev
    dist, idx = knn_search_dev(data, k, metric=metric, device=device,
                               mesh=mesh)
    return dist.cpu().numpy(), idx.cpu().numpy()


class BalancedKNN:
    """sklearn-like estimator for the balanced kNN graph.

    API parity with reference velocyto/neighbors.py:186-357; the initial
    kNN search runs on `device` (ops/knn_device.py::knn_search_dev), or
    with its query rows split over `mesh`, the balance on the host."""

    def __init__(self, k: int = 50, sight_k: int = 100, maxl: int = 200,
                 constraint: Optional[np.ndarray] = None,
                 mode: str = "distance", metric: str = "euclidean",
                 n_jobs: int = 4, device="cuda", mesh=None) -> None:
        self.k = k
        self.sight_k = sight_k
        self.maxl = maxl
        self.mode = mode
        self.metric = metric
        self.n_jobs = n_jobs
        self.device = torch.device(device)
        self.mesh = mesh
        self.dist_new = self.dsi_new = self.l = None
        self.bknn: Optional[sparse.csr_matrix] = None
        self.constraint = constraint

    @property
    def n_samples(self) -> int:
        return self.data.shape[0]

    def fit(self, data: np.ndarray, sight_k: Optional[int] = None
            ) -> "BalancedKNN":
        self.data = data
        self.fitdata = data
        if sight_k is not None:
            self.sight_k = sight_k
        return self

    def kneighbors(self, X: Optional[np.ndarray] = None,
                   maxl: Optional[int] = None, mode: str = "distance"):
        if X is not None:
            self.data = X
        if maxl is not None:
            self.maxl = maxl
        kk = min(self.sight_k + 1, self.fitdata.shape[0])
        self.dist, self.dsi = knn_search(self.fitdata, kk, self.metric,
                                         device=self.device, mesh=self.mesh)
        self.dist_new, self.dsi_new, self.l = knn_balance(
            self.dsi, self.dist, maxl=self.maxl, k=self.k,
            constraint=self.constraint)
        if mode == "connectivity":
            self.dist = np.ones_like(self.dsi)
            self.dist[:, 0] = 0
        return self.dist_new, self.dsi_new, self.l

    def kneighbors_graph(self, X: Optional[np.ndarray] = None,
                         maxl: Optional[int] = None,
                         mode: str = "distance") -> sparse.csr_matrix:
        dist_new, dsi_new, _l = self.kneighbors(X=X, maxl=maxl, mode=mode)
        self.bknn = sparse.csr_matrix(
            (np.ravel(dist_new), np.ravel(dsi_new),
             np.arange(0, dist_new.shape[0] * dist_new.shape[1] + 1,
                       dist_new.shape[1])),
            (self.n_samples, self.n_samples))
        return self.bknn

    def smooth_data(self, data_to_smooth: np.ndarray,
                    X: Optional[np.ndarray] = None,
                    maxl: Optional[int] = None,
                    mutual: bool = False,
                    only_increase: bool = True) -> np.ndarray:
        from .smoothing import connectivity_to_weights
        if self.bknn is None:
            if X is not None or maxl is not None:
                raise ValueError("graph was already fit with different "
                                 "parameters")
            self.kneighbors_graph(X=X, maxl=maxl, mode=self.mode)
        if mutual:
            connectivity = make_mutual(self.bknn > 0)
        else:
            connectivity = self.bknn.T > 0
        connectivity = connectivity.tolil()
        connectivity.setdiag(1)
        w = connectivity_to_weights(connectivity).T
        if not np.allclose(w.sum(0), 1):
            raise ValueError("weight matrix need to sum to one over the "
                             "columns")
        if data_to_smooth.shape[1] == w.shape[0]:
            result = sparse.csr_matrix.dot(data_to_smooth, w)
        elif data_to_smooth.shape[0] == w.shape[0]:
            result = sparse.csr_matrix.dot(data_to_smooth.T, w).T
        else:
            raise ValueError(
                f"Incorrect size of matrix, none of the axis correspond "
                f"to the one of graph. {w.shape}")
        if only_increase:
            return np.maximum(result, data_to_smooth)
        return result


# ---------------------------------------------------------------------------
# Mutual kNN utilities (reference velocyto/neighbors.py:363-451)
# ---------------------------------------------------------------------------

def knn_distance_matrix(data: np.ndarray, metric: Optional[str] = None,
                        k: int = 40, mode: str = "connectivity",
                        n_jobs: int = 4, device="cuda",
                        mesh=None) -> sparse.csr_matrix:
    """kNN graph of data (samples, features) *excluding* self, like
    sklearn kneighbors_graph(X=None); the search runs on `device`, or
    with its query rows split over `mesh`."""
    kk = min(k + 1, data.shape[0])
    dist, idx = knn_search(data, kk, metric or "euclidean", device=device,
                           mesh=mesh)
    dist, idx = dist[:, 1:], idx[:, 1:]
    n, kk = idx.shape
    data_vals = np.ones(n * kk) if mode == "connectivity" else dist.ravel()
    return sparse.csr_matrix(
        (data_vals, idx.ravel(), np.arange(0, n * kk + 1, kk)), (n, n))


def make_mutual(knn: sparse.spmatrix) -> sparse.coo_matrix:
    """Keep only mutual edges (reference neighbors.py:379-382)."""
    return knn.minimum(knn.T)


def min_n(row_data: np.ndarray, row_indices: np.ndarray, n: int):
    i = row_data.argsort()[:n]
    return row_data[i], row_indices[i]


def take_top(matrix: sparse.spmatrix, n: int) -> sparse.lil_matrix:
    """Keep the n smallest entries of each row (reference :403-411)."""
    arr_ll = matrix.tolil(copy=True)
    for i in range(arr_ll.shape[0]):
        d, r = min_n(np.array(arr_ll.data[i]), np.array(arr_ll.rows[i]), n)
        arr_ll.data[i] = d.tolist()
        arr_ll.rows[i] = r.tolist()
    return arr_ll


def knn_smooth_weights(matrix: np.ndarray, metric: str = "euclidean",
                       k_search: int = 20, k_mutual: int = 10,
                       n_jobs: int = 10, device="cuda"
                       ) -> Tuple[sparse.spmatrix, sparse.csr_matrix]:
    """Mutual-kNN smoothing weights for a (genes, cells) expression matrix
    (reference velocyto/neighbors.py:426-451): kNN search on `device` ->
    mutualize -> keep k_mutual smallest per row -> row-normalize."""
    if k_search < k_mutual:
        raise ValueError("k_search needs to be bigger than k_mutual")
    from .smoothing import connectivity_to_weights
    knn = knn_distance_matrix(matrix.T, metric=metric, k=k_search,
                              mode="distance", n_jobs=n_jobs, device=device)
    mknn = make_mutual(knn)
    top_mknn = take_top(mknn, k_mutual)
    top_mknn.setdiag(1)
    connectivity = top_mknn > 0
    w = connectivity_to_weights(connectivity)
    return w, knn
