"""k-nearest-neighbor candidate search and the greedy kNN balance.

Port of velocyto_tpu/ops/knn.py.  The candidate pass computes blocked
squared distances (||x||^2 + ||y||^2 - 2 x.y) with a true-f32 matmul and
keeps, per row, the first k of a stable row sort (ties break by index,
like sklearn).  The exact f64 re-score and the (distance, index)
ordering live in ops/knn_device.py.

The balance (reference velocyto/neighbors.py:11-140) is a greedy,
order-dependent loop over the nodes in hub order; it runs on the host,
one numpy-vectorised step per node.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch


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
    """Greedy cap on in-degree of the kNN graph.

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
