"""Batched steady-state gamma (degradation-rate) fits over genes.

Port of velocyto_tpu/ops/gamma.py: the four slope fits and the weight
schemes.  The reference loops genes in Python and calls scipy optimizers
per gene (reference: velocyto/estimation.py:173-366); every one of those
problems is a box-constrained quadratic in 1 or 2 variables, solved here
in closed form for all genes at once, one gene per row of a (genes,
cells) tensor, in float32.  The public fits take tensors (computed on
their device) or numpy arrays (uploaded to ``device``) and return host
float32 arrays; ``clusters_stats`` stays host numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _rows_f32(M, device) -> torch.Tensor:
    """M as a float32 tensor: a tensor stays on its device, anything else
    is uploaded to `device`."""
    if isinstance(M, torch.Tensor):
        return M.to(torch.float32)
    return torch.as_tensor(np.asarray(M), dtype=torch.float32, device=device)


def _host_f32(*ts: torch.Tensor) -> tuple:
    return tuple(t.cpu().numpy().astype(np.float32) for t in ts)


def _masked_percentile(v: torch.Tensor, mask: torch.Tensor, q: float
                       ) -> torch.Tensor:
    """np.percentile over v[i][mask[i]] for every row i (NaN when a row's
    mask is empty)."""
    s = torch.sort(torch.where(mask, v, torch.inf), dim=1).values
    cnt = mask.sum(dim=1)
    h = (cnt - 1) * (q / 100.0)
    last = v.shape[1] - 1
    lo = torch.clamp(torch.floor(h).to(torch.int64), 0, last)
    hi = torch.clamp(torch.ceil(h).to(torch.int64), 0, last)
    frac = h - torch.floor(h)
    val = s.gather(1, lo[:, None])[:, 0] * (1.0 - frac) + \
        s.gather(1, hi[:, None])[:, 0] * frac
    return torch.where(cnt > 0, val, torch.nan)


def _up_gamma_rows(Y: torch.Tensor, X: torch.Tensor, limit_gamma: bool
                   ) -> torch.Tensor:
    """The limit_gamma heuristic (reference estimation.py:199-205,228-236):
    cap gamma when unspliced is systematically above spliced."""
    if not limit_gamma:
        return torch.full(Y.shape[:1], 20.0, dtype=Y.dtype, device=Y.device)
    every = torch.ones_like(Y, dtype=torch.bool)
    med_y = _masked_percentile(Y, every, 50.0)
    med_x = _masked_percentile(X, every, 50.0)
    p90_x = _masked_percentile(X, every, 90.0)
    high_x = X > p90_x[:, None]
    up = _masked_percentile(Y, high_x, 10.0) / \
        _masked_percentile(X, high_x, 50.0)
    up = torch.clamp_min(up, 1.5)
    return torch.where(med_y > med_x, up, 1.5)


def _mask_degenerate(m: torch.Tensor, any_x: torch.Tensor,
                     any_y: torch.Tensor, empty: float) -> torch.Tensor:
    """A row without spliced signal gets `empty`, one without unspliced
    signal 0 (the reference's per-gene guards)."""
    return torch.where(~any_x, empty, torch.where(~any_y, 0.0, m))


def _fixperc_rows(Y: torch.Tensor, X: torch.Tensor, W: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fixperc_q: the offset is the median of Y over the cells whose X is
    at or below the row's 1st percentile; the slope is the (weighted) fit
    through it, clipped to [0, 20]."""
    every = torch.ones_like(X, dtype=torch.bool)
    p1 = _masked_percentile(X, every, 1.0)
    m1 = _masked_percentile(Y, X <= p1[:, None], 50.0)
    m0 = torch.clamp((W * X * (Y - m1[:, None])).sum(1) /
                     (W * X * X).sum(1), 0.0, 20.0)
    return m0, m1


def _slope_nnls_rows(Y: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """m = argmin_{m>=0} ||x m - y||^2 per row (reference _fit1_slope,
    estimation.py:173-188: scipy nnls on one column)."""
    m = torch.clamp_min((X * Y).sum(1) / (X * X).sum(1), 0.0)
    return _mask_degenerate(m, (X != 0).any(1), (Y != 0).any(1), torch.nan)


def _slope_weighted_rows(Y: torch.Tensor, X: torch.Tensor, W: torch.Tensor,
                         limit_gamma: bool, lo: float, hi: float
                         ) -> torch.Tensor:
    """argmin_m sum w (x m - y)^2 over [lo, hi], or over [1e-8, the
    limit_gamma cap] (reference _fit1_slope_weighted,
    estimation.py:191-209)."""
    m_free = (W * X * Y).sum(1) / (W * X * X).sum(1)
    if limit_gamma:
        m = torch.minimum(torch.clamp_min(m_free, 1e-8),
                          _up_gamma_rows(Y, X, True))
    else:
        m = torch.clamp(m_free, lo, hi)
    return _mask_degenerate(m, (X != 0).any(1), (Y != 0).any(1), torch.nan)


def _slope_offset_rows(Y: torch.Tensor, X: torch.Tensor, fixperc_q: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OLS with intercept per row (reference _fit1_slope_offset,
    estimation.py:244-264; leastsq on a linear residual is OLS)."""
    any_x, any_y = (X != 0).any(1), (Y != 0).any(1)
    if fixperc_q:
        m, q = _fixperc_rows(Y, X, torch.ones_like(X))
    else:
        n = X.shape[1]
        sx, sy = X.sum(1), Y.sum(1)
        sxx, sxy = (X * X).sum(1), (X * Y).sum(1)
        m = (n * sxy - sx * sy) / (n * sxx - sx * sx)
        q = (sy - m * sx) / n
    return (_mask_degenerate(m, any_x, any_y, torch.nan),
            _mask_degenerate(q, any_x, any_y, 0.0))


def _slope_weighted_offset_row(Y: torch.Tensor, X: torch.Tensor,
                               W: torch.Tensor, fixperc_q: bool,
                               limit_gamma: bool
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Box-constrained weighted linear fit with intercept, for every gene
    row (reference _fit1_slope_weighted_offset, estimation.py:212-241).

    minimize  sum w (x m + q - y)^2
    s.t.      m in [1e-8, up_gamma],  q in [0, up_q],  up_q = 2 sum(yw)/sum(w)

    Solved exactly: interior stationary point if feasible, else the best of
    the four clipped edge minimizers (the objective is convex quadratic).
    """
    any_x = (X != 0).any(dim=1)
    any_y = (Y != 0).any(dim=1)

    if fixperc_q:
        m0, m1 = _fixperc_rows(Y, X, W)
        return (_mask_degenerate(m0, any_x, any_y, torch.nan),
                _mask_degenerate(m1, any_x, any_y, 0.0))

    mlo = torch.full_like(any_x, 1e-8, dtype=Y.dtype)
    mhi = _up_gamma_rows(Y, X, limit_gamma)
    sw = W.sum(1)
    swx = (W * X).sum(1)
    swy = (W * Y).sum(1)
    swxx = (W * X * X).sum(1)
    swxy = (W * X * Y).sum(1)
    swyy = (W * Y * Y).sum(1)
    up_q = 2.0 * swy / sw

    def obj(m, q):
        return (m * m * swxx[:, None] + q * q * sw[:, None]
                + 2 * m * q * swx[:, None] - 2 * m * swxy[:, None]
                - 2 * q * swy[:, None] + swyy[:, None])

    det = swxx * sw - swx * swx
    m_int = (swxy * sw - swx * swy) / det
    q_int = (swy * swxx - swx * swxy) / det
    interior_ok = (det > 0) & (m_int >= mlo) & (m_int <= mhi) & \
                  (q_int >= 0) & (q_int <= up_q)

    # edge minimizers (1-D closed forms, clipped to their segment)
    def q_at(m):
        return torch.minimum(torch.clamp_min((swy - m * swx) / sw, 0.0),
                             up_q)

    def m_at(q):
        return torch.minimum(torch.maximum((swxy - q * swx) / swxx, mlo),
                             mhi)

    zero = torch.zeros_like(sw)
    cand_m = torch.stack([mlo, mhi, m_at(zero), m_at(up_q)], dim=1)
    cand_q = torch.stack([q_at(mlo), q_at(mhi), zero, up_q], dim=1)
    best = torch.argmin(obj(cand_m, cand_q), dim=1, keepdim=True)
    m_edge = cand_m.gather(1, best)[:, 0]
    q_edge = cand_q.gather(1, best)[:, 0]

    m = torch.where(interior_ok, m_int, m_edge)
    q = torch.where(interior_ok, q_int, q_edge)
    return (_mask_degenerate(m, any_x, any_y, torch.nan),
            _mask_degenerate(q, any_x, any_y, 0.0))


def _r2_rows(Y, X, m, q):
    """Unweighted coefficient of determination of the (weighted) fit
    (reference estimation.py:323-331,354-363)."""
    ss_res = ((m[:, None] * X + q[:, None] - Y) ** 2).sum(dim=1)
    ss_tot = ((Y - Y.mean(dim=1, keepdim=True)) ** 2).sum(dim=1)
    r2 = 1.0 - ss_res / ss_tot
    return torch.where(torch.isfinite(r2), r2, -1e16)


# Public batched API (reference fit_slope*, estimation.py:267-366).  Y, X
# (and W): (genes, cells) tensors, or numpy arrays uploaded to `device`.

def fit_slope(Y, X, device="cuda") -> np.ndarray:
    """Non-negative slope through the origin per gene; host float32."""
    (m,) = _host_f32(_slope_nnls_rows(_rows_f32(Y, device),
                                      _rows_f32(X, device)))
    return m


def fit_slope_weighted(Y, X, W, return_R2: bool = False,
                       limit_gamma: bool = False,
                       bounds: Tuple[float, float] = (0, 20),
                       device="cuda"):
    """Weighted slope through the origin per gene, clipped to `bounds`;
    host float32 m (and R2)."""
    Y, X, W = (_rows_f32(M, device) for M in (Y, X, W))
    m = _slope_weighted_rows(Y, X, W, limit_gamma, float(bounds[0]),
                             float(bounds[1]))
    if return_R2:
        return _host_f32(m, _r2_rows(Y, X, m, torch.zeros_like(m)))
    return _host_f32(m)[0]


def fit_slope_weighted_offset(Y, X, W, fixperc_q: bool = False,
                              return_R2: bool = True,
                              limit_gamma: bool = False, device="cuda"):
    """Weighted slope with offset per gene; host float32 (m, q[, R2])."""
    Y, X, W = (_rows_f32(M, device) for M in (Y, X, W))
    m, q = _slope_weighted_offset_row(Y, X, W, fixperc_q, limit_gamma)
    return _host_f32(m, q, *([_r2_rows(Y, X, m, q)] if return_R2 else []))


def fit_slope_offset(Y, X, fixperc_q: bool = False, device="cuda"):
    """Unweighted slope with offset per gene; host float32 (m, q)."""
    return _host_f32(*_slope_offset_rows(_rows_f32(Y, device),
                                         _rows_f32(X, device), fixperc_q))


# The fit_gammas weighting schemes (reference analysis.py:1139-1191) over
# the (genes, cells) tensors.


def _row_percentiles(M: torch.Tensor, qs) -> list:
    """np.percentile(M, qs, axis=1) (linear interpolation): one row sort
    serves every requested percentile (torch.quantile differs in its
    size limits and edge handling)."""
    s = torch.sort(M, dim=1).values
    n = M.shape[1]
    out = []
    for q in qs:
        h = (n - 1) * (float(q) / 100.0)
        lo_i = int(np.floor(h))
        hi_i = int(np.ceil(h))
        frac = torch.tensor(h - lo_i, dtype=M.dtype, device=M.device)
        out.append(s[:, lo_i] * (1 - frac) + s[:, hi_i] * frac)
    return out


def _fit_weights_tmp_impl(tmpS, tmpU, scheme: str, lo: float, hi: float,
                          wpow: float) -> torch.Tensor:
    if scheme in ("sum", "prod"):
        (p99S,) = _row_percentiles(tmpS, (99.0,))
        (p99U,) = _row_percentiles(tmpU, (99.0,))
        if scheme == "sum":
            return tmpS / p99S[:, None] + tmpU / p99U[:, None]
        return (tmpS / p99S[:, None]) * (tmpU / p99U[:, None])
    down, up = _row_percentiles(tmpS, (lo, hi))
    if scheme == "maxmin_weighted":
        Srange = torch.minimum(torch.maximum(tmpS, down[:, None]),
                               up[:, None])
        Srange = Srange - Srange.min(dim=1, keepdim=True).values
        Srange = Srange / Srange.max(dim=1, keepdim=True).values
        return 0.5 * (Srange ** wpow + (1 - Srange) ** wpow)
    return ((tmpS <= down[:, None])                          # "maxmin"
            | (tmpS >= up[:, None])).to(torch.float32)


def _fit_weights_xs_impl(Sx, Ux, scheme: str, lo: float, hi: float
                         ) -> torch.Tensor:
    # maxmin_diag / maxmin_double operate on the unsized imputed data
    def _denom(M):
        (d,) = _row_percentiles(M, (99.9,))
        repl = torch.clamp_min(M.max(dim=1).values, 0.001)
        return torch.where(d == 0, repl, d)

    X = Sx / _denom(Sx)[:, None] + Ux / _denom(Ux)[:, None]
    down, up = _row_percentiles(X, (lo, hi))
    W = ((X <= down[:, None]) | (X >= up[:, None])).to(torch.float32)
    if scheme == "maxmin_double":
        down, up = _row_percentiles(Sx, (lo, hi))
        W = W + ((Sx <= down[:, None])
                 | (Sx >= up[:, None])).to(torch.float32)
    return W


def compute_fit_weights(scheme: str, tmpS, tmpU, Sx, Ux,
                        maxmin_perc=(2.0, 98.0),
                        maxmin_weighted_pow: float = 15.0) -> torch.Tensor:
    """fit_gammas weights from (genes, cells) f32 tensors, on their
    device.  Sx/Ux are read only by maxmin_diag and maxmin_double."""
    lo, hi = float(maxmin_perc[0]), float(maxmin_perc[1])
    if scheme in ("sum", "prod", "maxmin_weighted", "maxmin"):
        return _fit_weights_tmp_impl(tmpS, tmpU, scheme, lo, hi,
                                     float(maxmin_weighted_pow))
    if scheme in ("maxmin_diag", "maxmin_double"):
        return _fit_weights_xs_impl(Sx, Ux, scheme, lo, hi)
    raise NotImplementedError(f"weights={scheme!r} is not a supported scheme")


# Copied from velocyto_tpu/ops/gamma.py::clusters_stats (host numpy).
def clusters_stats(U: np.ndarray, S: np.ndarray, clusters_uid: np.ndarray,
                   cluster_ix: np.ndarray, size_limit: int = 40
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cluster averages with a small-cluster fallback to the global
    average (reference estimation.py:369-389)."""
    U_avgs = np.zeros((S.shape[0], len(clusters_uid)))
    S_avgs = np.zeros((S.shape[0], len(clusters_uid)))
    for i, _uid in enumerate(clusters_uid):
        cluster_filter = cluster_ix == i
        n_cells = np.sum(cluster_filter)
        if n_cells > size_limit:
            U_avgs[:, i] = U[:, cluster_filter].mean(1)
            S_avgs[:, i] = S[:, cluster_filter].mean(1)
        else:
            U_avgs[:, i] = U.mean(1)
            S_avgs[:, i] = S.mean(1)
    return U_avgs, S_avgs
