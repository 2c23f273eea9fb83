"""Markov diffusion on the embedding (reference velocyto/diffusion.py).

Port of velocyto_tpu/diffusion.py.  The transition-matrix constructions
keep the reference's scipy.sparse contract on the host (above 4,096
cells, the neighbour search of compute_transition_matrix2 runs on the
device).  ``diffuse`` takes the matrix as a scipy.sparse matrix, a numpy
array or a tensor, densifies it on the device in float32 (as the JAX
package does), and runs path_integral / time_evolution there as a
matrix-vector loop; map_trajectory, frontier and trajectory walk on the
host with numpy (trajectory draws from numpy's global stream).

``power_steps`` counts the matrix-vector loops of path_integral /
time_evolution (``_power_steps``): the calls, the steps, and the bytes
of the float32 tr the steps read (its rows padded to the block, times N,
times 4, a step).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from scipy import sparse
from scipy.stats import norm

from .ops.knn import _knn_query_impl, full_f32

# _power_steps' calls, steps, and bytes of tr read by the steps
power_steps = {"calls": 0, "steps": 0, "bytes": 0}


def _l1_normalize_rows(m: sparse.spmatrix) -> sparse.csr_matrix:
    m = sparse.csr_matrix(m)
    sums = np.asarray(np.abs(m).sum(axis=1)).ravel()
    sums[sums == 0] = 1.0
    d = sparse.diags(1.0 / sums)
    return sparse.csr_matrix(d @ m)


def _power_steps(x: torch.Tensor, tr: torch.Tensor, n_steps: int,
                 accumulate: bool = False, rows: int = 64) -> torch.Tensor:
    """x @ tr applied n_steps times in float32 (no TF32); with
    accumulate, the sum of the n_steps iterates instead of the last one.

    Each product sums its N terms in float32 over blocks of `rows` rows
    of tr (one batched matrix-vector product) and adds the block partials
    in float64.  A plain float32 product loses mass systematically
    (2.0e-4 of it over 2,500 steps at 20,000 cells on an H100); 64-row
    blocks keep the loss at 3.1e-5 there, for 1.6% more bytes per
    step."""
    n = tr.shape[0]
    blocks = -(-n // rows)
    pad = blocks * rows - n
    tr_b = torch.nn.functional.pad(tr, (0, 0, 0, pad)).view(
        blocks, rows, tr.shape[1])
    power_steps["calls"] += 1
    power_steps["steps"] += n_steps
    power_steps["bytes"] += n_steps * tr_b.numel() * tr_b.element_size()
    total = torch.zeros_like(x) if accumulate else None
    with full_f32():
        for _ in range(n_steps):
            part = torch.bmm(torch.nn.functional.pad(x, (0, pad)).view(
                blocks, 1, rows), tr_b)
            x = part[:, 0].sum(0, dtype=torch.float64).to(torch.float32)
            if accumulate:
                total += x
    return total if accumulate else x


class Diffusion:
    """Markov diffusion over a cell embedding (reference
    diffusion.py:10-135) on one torch device."""

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)

    def compute_transition_matrix2(self, x0: np.ndarray, v: np.ndarray,
                                   sigma: float = 0.0,
                                   reverse: bool = False) -> sparse.csr_matrix:
        """Gaussian-kernel transitions from extrapolated positions
        (reference diffusion.py:14-53)."""
        n_cells = x0.shape[0]
        n_neighbors = min(20, n_cells)
        x1 = x0 - v if reverse else x0 + v
        # kNN of the *extrapolated* positions against the current ones
        # (the reference fits sklearn NN on x0 and queries x1): a dense
        # host argsort for small N, the device query with the exact f64
        # re-score above 4,096 cells -- the same neighbour sets
        if n_cells <= 4096:
            dists = np.linalg.norm(
                x1[:, None, :] - x0[None, :, :], axis=-1)
            nearest = np.argsort(dists, axis=1)[:, :n_neighbors]
            dvals = np.take_along_axis(dists, nearest, axis=1)
        else:
            dvals, nearest = _knn_query_impl(x0, x1, n_neighbors,
                                             self.device)
        probs = norm.pdf(dvals.ravel(), 0, sigma)
        cells = np.repeat(np.arange(n_cells), n_neighbors)
        tr = sparse.coo_matrix((probs, (cells, nearest.ravel())),
                               shape=(n_cells, n_cells))
        return _l1_normalize_rows(tr)

    def compute_transition_matrix(self, knn: sparse.spmatrix, x: np.ndarray,
                                  v: np.ndarray, epsilon: float = 0.0,
                                  reverse: bool = False) -> sparse.csr_matrix:
        """Velocity-projected transitions on a kNN graph
        (reference diffusion.py:55-91): p(edge) ~ clip(<v, unit(edge)>, 0)
        / |edge|, row-normalized."""
        knn = knn.tocoo()
        v0, v1 = knn.row, knn.col
        uv = x[v1] - x[v0]
        norms = np.linalg.norm(uv, axis=1)
        uv = uv / norms[:, None]
        scalar_projection = np.einsum("ed,ed->e", v[v0], uv)
        if reverse:
            scalar_projection = -scalar_projection
        scalar_projection = scalar_projection + epsilon
        np.clip(scalar_projection, a_min=0, a_max=None, out=scalar_projection)
        p = scalar_projection * (1.0 / norms)
        tr = sparse.coo_matrix((p, (v0, v1)), shape=knn.shape).tocsr()
        return _l1_normalize_rows(tr)

    def diffuse(self, x: np.ndarray, tr: Any, n_steps: int = 10,
                mode: str = "path_integral") -> Any:
        """Run the diffusion (reference diffusion.py:93-135).

        path_integral / time_evolution return a host (1, N) array, the
        other modes a list of cell indices."""
        if isinstance(tr, torch.Tensor):
            tr_d = tr.to(device=self.device, dtype=torch.float32)
        else:
            tr_d = torch.as_tensor(
                tr.toarray() if sparse.issparse(tr) else np.asarray(tr),
                dtype=torch.float32, device=self.device)
        x0 = np.asarray(x, dtype=np.float64)
        if mode in ("path_integral", "time_evolution"):
            xt = torch.as_tensor(x0 / x0.sum(), dtype=torch.float32,
                                 device=self.device)
            out = _power_steps(xt, tr_d, n_steps,
                               accumulate=mode == "path_integral")
            return out.cpu().numpy()[None, :]
        trn = tr_d.cpu().numpy()
        if mode == "map_trajectory":
            xt = x0 / x0.sum()
            result = [int(np.argmax(xt))]
            for _ in range(n_steps):
                xt = xt @ trn
                result.append(int(np.argmax(xt)))
            return result
        if mode == "frontier":
            xt = x0 / x0.sum()
            result = [int(np.argmax(xt))]
            for _ in range(n_steps):
                x_next = xt @ trn
                result.append(int(np.argmax((x_next + 1) / (xt + 1))))
                xt = x_next
            return result
        if mode == "trajectory":
            trn = trn.astype(np.float64)
            node = np.random.choice(np.arange(x0.shape[0]), p=x0)
            trajectories = [node]
            for _ in range(n_steps):
                x_next = trn[node].copy()
                s = x_next.sum()
                if s == 0:
                    x_next = np.zeros_like(x_next)
                    x_next[node] = 1.0
                else:
                    x_next = x_next / s
                node = np.random.choice(np.arange(x_next.shape[0]), p=x_next)
                trajectories.append(node)
            return trajectories
        raise NotImplementedError(f"mode {mode} not implemented")
