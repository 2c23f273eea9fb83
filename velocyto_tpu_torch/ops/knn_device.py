"""Device kNN graph: search, exact re-score, balance and smoothing.

Port of velocyto_tpu/ops/knn_device.py.  The whole balanced-kNN chain
stays on the device:

  candidate pass (f32 blocked distances, ops/knn.py)
    -> exact re-score in f64 (diff-form, elementwise)
    -> lexicographic (distance, index) ordering  [sklearn tie-breaks]
    -> hub order and the greedy degree-capped balance (reference
       velocyto/neighbors.py:11-140): the hand CUDA kernel
       kernels/knn_balance.cu on the card (a walk in one block that
       writes acceptance bits, then a decode over every SM),
       _balance_scan_plain (one torch step per node) on the CPU
    -> compact (N, K) neighbor-index/weight arrays and the smoothing
       convolution (reference velocyto/analysis.py:1006-1016)

The host-facing csr views (graph_to_csr / weights_to_csr) are built on
demand by VelocytoLoom's lazy ``.knn`` / ``.knn_smoothing_w``.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..utils.profiling import span
from .knn import (_candidate_plan, _knn_search_impl, full_f32,
                  make_knn_search_sharded)


class KnnGraphDev(NamedTuple):
    """Device kNN graph state.

    For the balanced graph: ``idx``/``dist`` are the (N, k+1) balanced
    rows (slot 0 = self, -1 = unset) in the reference's dsi_new/dist_new
    layout.  For the plain graph: (N, k) non-self neighbors, ascending.
    ``indeg`` is the final in-degree vector (balanced only).
    """
    idx: torch.Tensor          # int64
    dist: torch.Tensor         # float64
    indeg: Optional[torch.Tensor]   # int64
    n: int


def _as_tensor(data, dtype: torch.dtype, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(dtype)
    return torch.as_tensor(np.asarray(data), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# exact f64 re-score + ordering
# ---------------------------------------------------------------------------

def _rescore_f64_impl(x64: torch.Tensor, idx: torch.Tensor, block: int,
                      rows64: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact f64 squared distances sum((x_j - r_i)^2) of the gathered
    candidates j = idx[i, :] from row i of rows64 (default: x64 itself),
    blocked over rows.  Diff-form, so duplicates score exactly 0 and keep
    sklearn-style tie groups."""
    rows64 = x64 if rows64 is None else rows64
    out = torch.empty(idx.shape, dtype=torch.float64, device=x64.device)
    for r0 in range(0, idx.shape[0], block):
        diff = x64[idx[r0:r0 + block]] - rows64[r0:r0 + block, None, :]
        out[r0:r0 + block] = (diff * diff).sum(dim=-1)
    return out


def _reorder_truncate_impl(d2: torch.Tensor, idx: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic (distance, index) ascending order, truncated to k:
    sort by index, then stable-sort by distance (sklearn exact brute
    force tie-breaking)."""
    by_idx = torch.argsort(idx, dim=1, stable=True)
    idx = idx.gather(1, by_idx)
    d2 = d2.gather(1, by_idx)
    order = torch.argsort(d2, dim=1, stable=True)[:, :k]
    return d2.gather(1, order), idx.gather(1, order)


def knn_search_dev(data, k: int, metric: str = "euclidean", device="cuda",
                   mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs kNN (self included first) on `device` (the card unless
    the caller asks for another; a tensor stays on its own device).

    Returns (dist (N, k) f64, idx (N, k) int64), ordered exactly like an
    exact brute-force search (f64 re-score, (distance, index) order).
    With `mesh`, the candidate pass runs with its query rows split over
    the mesh's cells shards (make_knn_search_sharded) and is gathered on
    the mesh's first device, where the re-score and the ordering run
    unchanged; so the result equals the single-device one."""
    n = data.shape[0]
    k = min(k, n)
    if mesh is not None:
        device = mesh.first_device
        if isinstance(data, torch.Tensor):
            data = data.to(device)
    with span("knn.candidates"):
        x64 = _as_tensor(data, torch.float64, device)
        if metric == "correlation":
            x64 = x64 - x64.mean(dim=1, keepdim=True)
            x64 = x64 / torch.linalg.norm(x64, dim=1, keepdim=True)
        k2, blk = _candidate_plan(n, k)
        x32 = _as_tensor(data, torch.float32, device)
        if mesh is None:
            _dc, cand = _knn_search_impl(x32, k2, blk, metric)
        else:
            from ..parallel.mesh import CELLS, bounds, gather_rows
            parts = make_knn_search_sharded(mesh, k2, blk, metric)(x32)
            counts = [hi - lo for lo, hi in bounds(n, mesh.shape[CELLS])]
            cand = gather_rows(mesh, [p[1] for p in parts], counts)
    with span("knn.rescore"):
        # bound the (block, k2, D) f64 gather scratch to ~256 MB
        rb = max(8, min(256, (1 << 25) // max(1, k2 * x64.shape[1])))
        d2 = _rescore_f64_impl(x64, cand, rb)
        d2, idx = _reorder_truncate_impl(d2, cand, k)
        if metric == "correlation":
            dist = d2 / 2.0
        else:
            dist = torch.sqrt(d2.clamp_min(0.0))
    return dist, idx


# ---------------------------------------------------------------------------
# greedy balancing (reference velocyto/neighbors.py:11-140)
# ---------------------------------------------------------------------------

def _hub_order_impl(dsi: torch.Tensor) -> torch.Tensor:
    """Visit order: descending in-degree of the raw candidate graph,
    ties broken like np.argsort(l, kind='mergesort')[::-1] (stable
    ascending, reversed -> larger index first among equals)."""
    counts = torch.bincount(dsi.reshape(-1), minlength=dsi.shape[0])
    return torch.argsort(counts, stable=True).flip(0)


def _balance_scan_plain(dsi: torch.Tensor, dist: torch.Tensor,
                        lsi: torch.Tensor, constraint: Optional[torch.Tensor],
                        maxl: int, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Degree-capped greedy balancing, one torch step per node, with the
    semantics of ops/knn.py::balance_knn_loop (the reference loop,
    velocyto/neighbors.py:11-140): nodes are visited in the order lsi; a
    candidate is admissible if it is not the node itself, its in-degree l
    is < maxl and, with a constraint, it shares the node's group; the node
    takes the first k admissible candidates of its row (distinct indices)
    into slots 1..p in acceptance order, with their distances, and bumps
    l for each.  Slot 0 holds the node (distance 0) when it appears among
    the examined positions (up to and including the k-th acceptance, the
    whole row when fewer are accepted), else -1; slots p+1..k self-fill
    with the node and dist[el, 0].  An index outside [0, n) is never
    accepted.  Returns (dist_new (N, k+1) float64,
    dsi_new (N, k+1) int64, l (N,) int64) on dsi's device."""
    n, sight = dsi.shape
    if sight < k:
        raise ValueError("sight needs to be bigger than k")
    dev = dsi.device
    # rows of k + 2 slots: 0 the node, 1..k the neighbours, k + 1 a sink
    # for the candidates that are not accepted
    dsi_new = torch.full((n, k + 2), -1, dtype=torch.int64, device=dev)
    dist_new = torch.zeros((n, k + 2), dtype=torch.float64, device=dev)
    l = torch.zeros(n, dtype=torch.int64, device=dev)
    for el in lsi.tolist():
        row = dsi[el]
        cell = (row >= 0) & (row < n)     # an index outside [0, n) never is
        rowc = row.clamp(0, n - 1)
        ok = cell & (l[rowc] < maxl) & (row != el)
        if constraint is not None:
            ok &= constraint[rowc] == constraint[el]
        cs = torch.cumsum(ok, 0)                  # acceptances up to here
        acc = ok & (cs <= k)
        # the node itself is never accepted, so it is examined when fewer
        # than k candidates before it were
        dsi_new[el, :1].masked_fill_(((row == el) & (cs < k)).any(), el)
        if k:                   # self-fill, then the accepted overwrite it
            dsi_new[el, 1:k + 1] = el
            dist_new[el, 1:k + 1] = dist[el, 0]
        target = torch.where(acc, cs, k + 1)
        dsi_new[el].scatter_(0, target, row)
        dist_new[el].scatter_(0, target, dist[el])
        l.index_add_(0, rowc, acc.to(torch.int64))
    return (dist_new[:, :k + 1].contiguous(), dsi_new[:, :k + 1].contiguous(),
            l)


def _balance_decode_plain(bits: torch.Tensor, meta: torch.Tensor,
                          dsi: torch.Tensor, dist: torch.Tensor, k: int,
                          block: int = 4096
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of the balance walk's decode
    (kernels.balance_decode): bits (n, ceil(sight / 32)) int32, each row's
    accepted positions (bit j % 32 of word j // 32), and meta (n, 2) int32,
    (accepted count p, examined its own node), with the candidates dsi
    (n, sight) int64 and dist (n, sight) float64 -> (dist_new (n, k+1)
    float64, dsi_new (n, k+1) int64).  Slot 0 is the node (distance 0)
    when it examined itself, else -1; slots 1..q hold the candidates at
    the first q set bits in position order, q = min(p, k, the row's set
    bits), so bits past them (words the walk never wrote) are never read;
    slots q+1..k hold the node with dist[el, 0]; a row with p < 0 (never
    visited) is -1 with distance 0.  Blocked over rows."""
    n, sight = dsi.shape
    dev = dsi.device
    words = bits.shape[1]
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    dsi_new = torch.empty((n, k + 1), dtype=torch.int64, device=dev)
    dist_new = torch.empty((n, k + 1), dtype=torch.float64, device=dev)
    for r0 in range(0, n, block):
        b = bits[r0:r0 + block].to(torch.int64) & 0xFFFFFFFF
        m = meta[r0:r0 + block].to(torch.int64)
        rows = b.shape[0]
        el = torch.arange(r0, r0 + rows, dtype=torch.int64, device=dev)
        on = ((b[:, :, None] >> shifts) & 1).reshape(rows, words * 32) > 0
        rank = torch.cumsum(on, 1) - 1                 # of each set bit
        p = m[:, 0].clamp(max=k)
        take = on & (rank < p[:, None])
        q = take.sum(1)
        slot = torch.arange(k + 2, dtype=torch.int64, device=dev)
        out_i = torch.where(slot[:k + 1] <= q[:, None], -1, el[:, None])
        out_d = torch.zeros((rows, k + 1), dtype=torch.float64, device=dev)
        if k:
            out_d = torch.where(slot[:k + 1] <= q[:, None], out_d,
                                dist[r0:r0 + rows, :1])
        out_i = torch.cat([out_i, out_i[:, :1]], 1)      # k + 1: a sink
        out_d = torch.cat([out_d, out_d[:, :1]], 1)
        pos = torch.arange(words * 32, dtype=torch.int64, device=dev)
        pos = pos.clamp(max=max(sight - 1, 0)).expand(rows, -1)
        target = torch.where(take, rank + 1, k + 1)
        if sight:
            out_i.scatter_(1, target, dsi[r0:r0 + rows].gather(1, pos))
            out_d.scatter_(1, target, dist[r0:r0 + rows].gather(1, pos))
        out_i[:, 0] = torch.where(m[:, 1] != 0, el, -1)
        out_d[:, 0] = 0.0
        unvisited = m[:, 0] < 0
        out_i[unvisited] = -1
        out_d[unvisited] = 0.0
        dsi_new[r0:r0 + rows] = out_i[:, :k + 1]
        dist_new[r0:r0 + rows] = out_d[:, :k + 1]
    return dist_new, dsi_new


def _balance_scan_impl(dsi: torch.Tensor, dist: torch.Tensor,
                       lsi: torch.Tensor, constraint: Optional[torch.Tensor],
                       maxl: int, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The greedy balance of (dsi, dist) in the visit order lsi: the hand
    kernels (kernels.knn_balance: the walk, then its decode) for CUDA
    tensors, _balance_scan_plain for CPU tensors.  Returns (dist_new,
    dsi_new, l), the reference layout."""
    if dsi.is_cuda:
        return kernels.knn_balance(dsi, dist, lsi, constraint, maxl, k)
    return _balance_scan_plain(dsi, dist, lsi, constraint, maxl, k)


def balance_knn_dev(dsi: torch.Tensor, dist: torch.Tensor, maxl: int, k: int,
                    constraint=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device equivalent of ops.knn.knn_balance: the hub order, then the
    greedy scan, on dsi's device.  constraint: group labels (numpy of any
    dtype, or a tensor), or None; only their equality matters, so they go
    to the scan as dense int32 labels (the np.unique / torch.unique
    inverse).  Returns (dist_new, dsi_new, l)."""
    with span("knn.hub_order"):
        lsi = _hub_order_impl(dsi)
    with span("knn.balance"):
        cst = None
        if isinstance(constraint, torch.Tensor):
            cst = torch.unique(constraint.reshape(-1),
                               return_inverse=True)[1]
        elif constraint is not None:
            cst = torch.as_tensor(np.unique(
                np.asarray(constraint).reshape(-1), return_inverse=True)[1])
        if cst is not None:
            cst = cst.to(device=dsi.device, dtype=torch.int32)
        return _balance_scan_impl(dsi, dist, lsi, cst, int(maxl), int(k))


def balanced_knn_graph_dev(space, k: int, sight_k: int, maxl: int,
                           metric: str = "euclidean",
                           constraint: Optional[np.ndarray] = None,
                           device="cuda", mesh=None) -> KnnGraphDev:
    """Balanced kNN graph (BalancedKNN.kneighbors_graph semantics,
    reference velocyto/neighbors.py:226-322), search and balance on
    `device`: nothing of the (N, sight) candidates leaves it.  With
    `mesh`, the candidate pass is split over its cells shards and the
    rest runs on its first device."""
    n = space.shape[0]
    kk = min(sight_k + 1, n)
    dist, dsi = knn_search_dev(space, kk, metric=metric, device=device,
                               mesh=mesh)
    dist_new, dsi_new, l = balance_knn_dev(dsi, dist, maxl=maxl, k=k,
                                           constraint=constraint)
    return KnnGraphDev(idx=dsi_new, dist=dist_new, indeg=l, n=n)


def knn_graph_dev(space, k: int, metric: str = "euclidean",
                  device="cuda", mesh=None) -> KnnGraphDev:
    """Plain kNN graph excluding self (knn_distance_matrix semantics);
    `mesh` as in knn_search_dev."""
    n = space.shape[0]
    kk = min(k + 1, n)
    dist, idx = knn_search_dev(space, kk, metric=metric, device=device,
                               mesh=mesh)
    return KnnGraphDev(idx=idx[:, 1:], dist=dist[:, 1:], indeg=None, n=n)


# ---------------------------------------------------------------------------
# smoothing weights and convolution (reference analysis.py:1001-1016)
# ---------------------------------------------------------------------------

def _compact_weights_impl(idx: torch.Tensor, dist: torch.Tensor,
                          diag: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-normalized smoothing weights in compact (N, K+1) form.

    Replicates connectivity = (knn > 0); setdiag(diag);
    w = row-normalize(connectivity): zero-distance entries (self slot,
    self-fill, exact duplicates) drop out of the connectivity as they do
    in the reference's csr construction, and the diagonal carries `diag`.
    Entries are in ascending-index order per row, like the csr.
    """
    n = idx.shape[0]
    present = (dist > 0).to(torch.float32)
    self_col = torch.arange(n, dtype=torch.int64, device=idx.device)[:, None]
    nbr_idx = torch.cat([self_col, idx.to(torch.int64)], dim=1)
    vals = torch.cat([torch.full((n, 1), float(diag), dtype=torch.float32,
                                 device=idx.device), present], dim=1)
    w = vals / vals.sum(dim=1, keepdim=True)
    key = torch.where(w > 0, nbr_idx, torch.iinfo(torch.int64).max)
    order = torch.argsort(key, dim=1, stable=True)
    return nbr_idx.gather(1, order), w.gather(1, order)


def compact_weights_dev(g: KnnGraphDev, diag: float = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nbr_idx, nbr_w) (N, K+1) device tensors; nbr_w rows sum to 1."""
    return _compact_weights_impl(g.idx, g.dist, diag)


def smooth_dev(data_cols_dev: torch.Tensor, nbr_idx: torch.Tensor,
               nbr_w: torch.Tensor) -> torch.Tensor:
    """Smooth one (G, N) matrix over cells: returns (G, N) on its device,
    through the same rows path as smooth_dev_multi."""
    return smooth_dev_multi((data_cols_dev,), nbr_idx, nbr_w)[0]


def smooth_dev_multi(data_cols_list: Sequence[torch.Tensor],
                     nbr_idx: torch.Tensor, nbr_w: torch.Tensor) -> list:
    """Smooth several (G, N) matrices over cells in one pass:
    out[:, i] = sum_k w[i, k] * data[:, idx[i, k]].

    Each row block scatters its (B, K) weights into a dense (B, N) slab
    and one f32 matmul contracts it with the gene-concatenated data.
    Unset slots (index -1) carry weight 0 and are pointed at cell 0."""
    gs = [d.shape[0] for d in data_cols_list]
    data_rows = torch.cat([d.T for d in data_cols_list], dim=1)   # (N, ΣG)
    n = data_rows.shape[0]
    idx = nbr_idx.clamp_min(0)
    # row blocks of up to 2048, with the (block, N) slab near 256 MB
    block = min(2048, max(8, (1 << 26) // max(1, n)), max(8, n))
    out = torch.empty_like(data_rows)
    with full_f32():
        for r0 in range(0, n, block):
            ib = idx[r0:r0 + block]
            slab = torch.zeros((ib.shape[0], n), dtype=torch.float32,
                               device=data_rows.device)
            slab.scatter_add_(1, ib, nbr_w[r0:r0 + block])
            out[r0:r0 + block] = slab @ data_rows
    outs, off = [], 0
    for g in gs:
        outs.append(out[:, off:off + g].T.contiguous())
        off += g
    return outs


# ---------------------------------------------------------------------------
# host materialization (lazy .knn / .knn_smoothing_w views)
# ---------------------------------------------------------------------------

def graph_to_csr(g: KnnGraphDev):
    """The reference csr form of the graph on the host
    (BalancedKNN.kneighbors_graph / knn_distance_matrix layout)."""
    from scipy import sparse
    idx = g.idx.cpu().numpy().astype(np.int64)
    dist = g.dist.cpu().numpy().astype(np.float64)
    n, kw = idx.shape
    return sparse.csr_matrix(
        (dist.ravel(), idx.ravel(), np.arange(0, n * kw + 1, kw)),
        shape=(g.n, g.n))


def weights_to_csr(g: KnnGraphDev, diag: float = 1.0):
    """The row-normalized smoothing-weight csr
    (connectivity_to_weights((knn > 0) with setdiag(diag)))."""
    from .smoothing import connectivity_to_weights
    connectivity = (graph_to_csr(g) > 0).astype(float)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        connectivity.setdiag(diag)
    return connectivity_to_weights(connectivity)
