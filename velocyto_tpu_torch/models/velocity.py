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
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..analysis import _embedding_shift_compact
from ..ops.coldeltacor import col_delta_cor_partial_compact, locality_order
from ..ops.gamma import _row_percentiles, _slope_weighted_offset_row
from ..ops.knn_device import smooth_dev_multi


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
