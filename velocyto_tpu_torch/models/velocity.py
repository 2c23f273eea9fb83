"""The RNA-velocity model as one torch function on one device.

Port of velocyto_tpu/models/velocity.py::velocity_step: the whole
estimation hot path -- kNN smoothing, steady-state gamma fit, velocity
extrapolation, neighbour-sampled colDeltaCor and the embedding
projection -- as a single function over fixed-shape tensors.

Mathematical semantics follow the reference pipeline
(velocyto/analysis.py:933-1739 happy path with default arguments:
knn_imputation -> fit_gammas(weights="maxmin") -> predict_U ->
calculate_velocity -> calculate_shift(constant_velocity) ->
extrapolate_cell_at_t -> estimate_transition_prob(transform="sqrt") ->
calculate_embedding_shift), restricted to the compact sampled-neighbour
representation throughout.  The sampled colDeltaCor is the hand CUDA
kernel (kernels.coldeltacor_partial) on a CUDA device; its plain version
gathers an (N, nn, G) tensor and serves CPU test sizes only.

make_sharded_velocity_step runs the same step over a mesh: genes split
over the shards for the per-gene stages, one all-to-all regrouping the
results by cells, then each shard's cells through the sampled kernel
(against the smoothed expression gathered whole), the softmax and the
embedding shift.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..analysis import _embedding_shift_compact, _embedding_shift_compact_rows
from ..ops.coldeltacor import (_SQRT, _sampled_rows, chunk_order,
                               col_delta_cor_partial_compact, locality_order)
from ..ops.gamma import _row_percentiles, _slope_weighted_offset_row
from ..ops.knn_device import smooth_dev_multi
from ..parallel.mesh import (CELLS, Mesh, bounds, gather_rows, join,
                             on_shard, replicas)


class VelocityOutputs(NamedTuple):
    gammas: torch.Tensor            # (G,)
    q: torch.Tensor                 # (G,)
    velocity: torch.Tensor          # (G, N)
    corr: torch.Tensor              # (N, nn) sampled-neighbour correlations
    transition_prob: torch.Tensor   # (N, nn)
    delta_embedding: torch.Tensor   # (N, D)


def velocity_step(S_sz: torch.Tensor, U_sz: torch.Tensor,
                  nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                  embedding: torch.Tensor, sample_ixs: torch.Tensor,
                  sigma_corr: float = 0.05,
                  psc: float = 1e-10) -> VelocityOutputs:
    """One full velocity-estimation step, float32, on the inputs' device.

    S_sz, U_sz:   (G, N) size-normalized spliced/unspliced
    nbr_idx/w:    (N, K) smoothing neighbours + weights (row-stochastic)
    embedding:    (N, D) low-dim embedding
    sample_ixs:   (N, nn) sampled transition-candidate cells (int32)
    """
    g, n = S_sz.shape
    f32 = torch.float32

    # --- kNN smoothing (ops.knn_device, one pass for both matrices) ----
    Sx, Ux = smooth_dev_multi((S_sz.to(f32), U_sz.to(f32)),
                              nbr_idx.to(torch.int64), nbr_w.to(f32))

    # --- steady-state gamma fit (maxmin extreme-quantile weights, with
    #     offset; the solver of VelocytoLoom.fit_gammas) ---------------
    down, up = _row_percentiles(Sx, (2.0, 98.0))
    W = ((Sx <= down[:, None]) | (Sx >= up[:, None])).to(f32)
    gammas, q = _slope_weighted_offset_row(Ux, Sx, W, fixperc_q=False,
                                           limit_gamma=False)
    gammas = torch.where(torch.isfinite(gammas), gammas, 0.0)
    q = torch.where(torch.isfinite(q), q, 0.0)

    # --- velocity + extrapolation (used_delta_t = 1) --------------------
    # hi_dim_t - hi_dim is the velocity itself: the chain takes that
    # difference in float64, where the JAX function rounds hi_dim_t
    # through float32 first (an error of eps * |Sx| on every delta)
    velocity = Ux - (gammas[:, None] * Sx + q[:, None])
    delta = velocity

    # --- sampled-neighbour colDeltaCor (sqrt transform) -----------------
    d_sqrt = torch.sqrt(delta.abs() + psc) * torch.sign(delta)
    corr = col_delta_cor_partial_compact(Sx, d_sqrt, sample_ixs.contiguous(),
                                         "sqrt", psc,
                                         order=locality_order(embedding))
    corr = torch.where(torch.isfinite(corr), corr, 0.0)
    rows = torch.arange(n, device=corr.device)[:, None]
    corr = torch.where(sample_ixs == rows, 0.0, corr)

    # --- transition probabilities + embedding shift (full f32) ----------
    p = torch.exp(corr / sigma_corr)
    p = p / p.sum(dim=1, keepdim=True)
    delta_embedding = _embedding_shift_compact(
        embedding.to(f32), sample_ixs.to(torch.int64), p)
    return VelocityOutputs(gammas, q, velocity, corr, p, delta_embedding)


def _gene_stages(S: torch.Tensor, U: torch.Tensor, nbr_idx: torch.Tensor,
                 nbr_w: torch.Tensor, psc: float):
    """The per-gene stages of velocity_step on a block of gene rows (S, U
    (g, N)): smoothing, the gamma fit, the velocity and the sqrt-transformed
    displacement.  Returns (Sx, gammas, q, velocity, d_sqrt)."""
    f32 = torch.float32
    Sx, Ux = smooth_dev_multi((S.to(f32), U.to(f32)), nbr_idx.to(torch.int64),
                              nbr_w.to(f32))
    down, up = _row_percentiles(Sx, (2.0, 98.0))
    W = ((Sx <= down[:, None]) | (Sx >= up[:, None])).to(f32)
    gammas, q = _slope_weighted_offset_row(Ux, Sx, W, fixperc_q=False,
                                           limit_gamma=False)
    gammas = torch.where(torch.isfinite(gammas), gammas, 0.0)
    q = torch.where(torch.isfinite(q), q, 0.0)
    velocity = Ux - (gammas[:, None] * Sx + q[:, None])
    d_sqrt = torch.sqrt(velocity.abs() + psc) * torch.sign(velocity)
    return Sx, gammas, q, velocity, d_sqrt


def _all_to_all(mesh: Mesh, shards, blocks, shape_of):
    """Regroup blocks[i][j], the block local shard i sends to global shard
    j, so that entry [i][k] of the result is the block global shard k sent
    to local shard i, on its device.  shape_of(k, j): the shape of the
    block shard k sends shard j.  One process: device copies; across
    processes one all_to_all_single of the flattened blocks."""
    n_loc, n_all = len(shards), mesh.shape[CELLS]
    if mesh.world == 1:
        return [[blocks[k][i].to(s.device) for k in range(n_all)]
                for i, s in enumerate(shards)]
    import torch.distributed as dist
    rank, world = mesh.rank, mesh.world

    def numel(k, j):
        return int(np.prod(shape_of(k, j)))

    send = torch.cat([blocks[i][r * n_loc + jj].reshape(-1)
                      for r in range(world) for i in range(n_loc)
                      for jj in range(n_loc)])
    in_splits = [sum(numel(rank * n_loc + i, r * n_loc + jj)
                     for i in range(n_loc) for jj in range(n_loc))
                 for r in range(world)]
    out_splits = [sum(numel(r * n_loc + i, rank * n_loc + jj)
                      for i in range(n_loc) for jj in range(n_loc))
                  for r in range(world)]
    recv = send.new_empty(sum(out_splits))
    dist.all_to_all_single(recv, send, out_splits, in_splits)
    got = [[None] * n_all for _ in range(n_loc)]
    at = 0
    for r in range(world):
        for i in range(n_loc):
            for jj in range(n_loc):
                k = r * n_loc + i
                size = numel(k, rank * n_loc + jj)
                got[jj][k] = recv[at:at + size].reshape(
                    shape_of(k, rank * n_loc + jj)).to(shards[jj].device)
                at += size
    return got


# the JAX package's jitted alias (velocyto_tpu/models/velocity.py:112);
# the port has no tracing step, so it is the same callable
velocity_step_jit = velocity_step


def make_sharded_velocity_step(mesh: Mesh):
    """velocity_step over a mesh, with velocity_step's signature and
    outputs (gathered on the mesh's first device; the whole result on
    every process).  Every shard of the mesh takes part (the genes axis
    counts as more shards):

      - genes are split over the shards for the smoothing, the
        percentile weights, the gamma fit and the velocity (per gene,
        they need every cell);
      - one all-to-all of (genes / P, cells / P) blocks regroups the
        smoothed expression and the displacement by cells;
      - each shard correlates its own cells with their sampled
        neighbours (one launch of the sampled kernel on a card, its
        cells in their locality order) against the smoothed expression
        gathered whole, as the replicated layout of the sharded
        colDeltaCor does, then takes their softmax and embedding shift.

    Outputs agree with velocity_step's to f32 accumulation tolerance: a
    shard's smoothing contracts fewer genes at once, so its sums round
    differently (the JAX test's rtol 5e-3 / atol 5e-5 at its example
    inputs)."""
    flat = Mesh(mesh.devices.reshape(-1, 1))   # every shard on the cells axis
    shards = flat.cell_shards()
    P = flat.shape[CELLS]

    def step(S_sz: torch.Tensor, U_sz: torch.Tensor, nbr_idx: torch.Tensor,
             nbr_w: torch.Tensor, embedding: torch.Tensor,
             sample_ixs: torch.Tensor, sigma_corr: float = 0.05,
             psc: float = 1e-10) -> VelocityOutputs:
        g, n = S_sz.shape
        gspans, cspans = bounds(g, P), bounds(n, P)
        # per-gene stages on each shard's genes
        idx_r, w_r = replicas(shards, nbr_idx), replicas(shards, nbr_w)
        gene_out = []
        for i, s in enumerate(shards):
            lo, hi = gspans[s.index]
            S_p = S_sz[lo:hi].to(s.device)
            U_p = U_sz[lo:hi].to(s.device)
            with on_shard(s, S_p, U_p, idx_r[i], w_r[i]):
                gene_out.append(_gene_stages(S_p, U_p, idx_r[i], w_r[i],
                                             psc))
        join(shards, gene_out)

        # regroup Sx and d_sqrt by cells: shard k sends shard j the
        # (genes of k, cells of j) block of both, stacked
        def block_shape(k, j):
            return (2, gspans[k][1] - gspans[k][0],
                    cspans[j][1] - cspans[j][0])
        blocks = [[torch.stack([o[0][:, a:b], o[4][:, a:b]]).contiguous()
                   for a, b in cspans] for o in gene_out]
        got = _all_to_all(flat, shards, blocks, block_shape)
        rows = [torch.cat(got[i], dim=1).transpose(1, 2).contiguous()
                for i in range(len(shards))]       # (2, cells of i, G)
        counts_c = [hi - lo for lo, hi in cspans]
        e_full = gather_rows(flat, [r[0] for r in rows], counts_c)

        # the per-cell stages on each shard's cells
        e_r = replicas(shards, e_full)
        emb_r = replicas(shards, embedding.to(torch.float32))
        order = locality_order(embedding)
        cell_out = []
        for i, s in enumerate(shards):
            lo, hi = cspans[s.index]
            ixs = sample_ixs[lo:hi].to(s.device)
            sub = chunk_order(order, lo, hi).to(s.device)
            with on_shard(s, e_r[i], emb_r[i], rows[i], ixs, sub):
                corr = _sampled_rows(e_r[i], e_r[i][lo:hi], rows[i][1], ixs,
                                     _SQRT, psc, order=sub)
                corr = torch.where(torch.isfinite(corr), corr, 0.0)
                here = torch.arange(lo, hi, device=s.device)[:, None]
                corr = torch.where(ixs == here, 0.0, corr)
                p = torch.exp(corr / sigma_corr)
                p = p / p.sum(dim=1, keepdim=True)
                de = _embedding_shift_compact_rows(
                    emb_r[i], emb_r[i][lo:hi], ixs.to(torch.int64), p)
                cell_out.append((corr, p, de))
        join(shards, cell_out)

        counts_g = [hi - lo for lo, hi in gspans]
        gammas, q, velocity = (
            gather_rows(flat, [o[k] for o in gene_out], counts_g)
            for k in (1, 2, 3))
        corr, p, de = (gather_rows(flat, [o[k] for o in cell_out], counts_c)
                       for k in (0, 1, 2))
        return VelocityOutputs(gammas, q, velocity, corr, p, de)

    return step


def example_inputs(g: int = 256, n: int = 512, k: int = 8, nn: int = 32,
                   d: int = 2, seed: int = 0, device="cuda"):
    """Small random-but-well-conditioned inputs on `device`, drawn as the
    JAX package draws them (same seed, same arrays)."""
    rng = np.random.RandomState(seed)
    S = rng.gamma(2.0, 2.0, size=(g, n)).astype(np.float32)
    U = (0.3 * S + 0.1 * rng.rand(g, n)).astype(np.float32)
    nbr_idx = np.stack([rng.choice(n, k, replace=False)
                        for _ in range(n)]).astype(np.int32)
    nbr_w = np.full((n, k), 1.0 / k, dtype=np.float32)
    emb = rng.randn(n, d).astype(np.float32)
    sample_ixs = np.stack([rng.choice(n, nn, replace=False)
                           for _ in range(n)]).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (S, U, nbr_idx, nbr_w, emb, sample_ixs))
