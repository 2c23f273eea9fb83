"""colDeltaCor: per-cell correlation between expression deltas and velocity.

Port of velocyto_tpu/ops/coldeltacor.py (dense and neighbour-sampled
variants).  For every cell ``c`` and candidate cell ``i``::

    A[:, i] = transform(e[:, i] - e[:, c])          # over genes
    corr[c, i] = pearson(A[:, i], d[:, c])

computed from the streamed moments S1 = sum A, S2 = sum A^2,
S3 = sum A * b, sum b and sum b^2 (b = d[:, c]).  The dense variant
takes every candidate (``col_delta_cor``), the sampled one the nn
candidates ixs[c, :] of each cell (``col_delta_cor_partial_compact``;
``col_delta_cor_partial`` scatters that into the reference's dense form).
Each launches its hand-written CUDA kernel (kernels/coldeltacor_dense.cu,
kernels/coldeltacor_partial.cu) for CUDA tensors and runs the plain
PyTorch version below for CPU tensors.

Transforms keep the reference sign conventions of the JAX package:
  - "linear":  A = delta
  - "sqrt":    A = sign(delta) * sqrt(|delta| + psc); the *partial*
               variant maps |delta| < 1e-16 to exactly 0
  - "log10":   A = sign(delta) * log10(|delta| + psc); full variant maps
               delta == 0 to -log10(psc), partial maps it to +log10(psc)

All computation is float32.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .. import kernels
from .knn import full_f32

_LINEAR, _SQRT, _LOG10 = 0, 1, 2
_TRANSFORMS = {"linear": _LINEAR, "sqrt": _SQRT, "log10": _LOG10}


def _apply_transform(delta: torch.Tensor, transform: int, psc: float,
                     partial: bool) -> torch.Tensor:
    if transform == _LINEAR:
        return delta
    if transform == _SQRT:
        mag = torch.sqrt(delta.abs() + psc)
        if partial:
            # |delta| < 1e-16 -> exactly 0 (speedboosted.pyx:373-374)
            return torch.where(delta.abs() < 1e-16, 0.0,
                               torch.where(delta > 0, mag, -mag))
        # full variant: delta <= 0 goes to the negative branch
        return torch.where(delta > 0, mag, -mag)
    if transform == _LOG10:
        mag = torch.log10(delta.abs() + psc)
        if partial:
            # `tmp >= 0` test (speedboosted.pyx:470)
            return torch.where(delta >= 0, mag, -mag)
        return torch.where(delta > 0, mag, -mag)
    raise ValueError(f"unknown transform code {transform}")


def _corr_from_moments(s1, s2, s3, sb1, sb2, n_genes: float):
    num = s3 - s1 * (sb1 / n_genes)
    var_a = s2 - s1 * s1 / n_genes
    var_b = sb2 - sb1 * sb1 / n_genes
    return num / (torch.sqrt(var_a) * torch.sqrt(var_b))


def _col_delta_cor_dense_plain(emat: torch.Tensor, dmat: torch.Tensor,
                               transform: int = _LINEAR, psc: float = 0.0,
                               partial_semantics: bool = False
                               ) -> torch.Tensor:
    """Plain PyTorch dense colDeltaCor: (G, N) -> (N, N) f32, on the
    inputs' device.  Blocked over center cells so the (G, B, N) delta
    tensor stays near 128 MB (transcribes _dense_xla_rows, plus the
    partial_semantics flag the Pallas kernel carries)."""
    g, n = emat.shape
    e = emat.to(torch.float32)
    d = dmat.to(torch.float32)
    block = max(1, min(n, (1 << 25) // max(1, g * n)))
    out = torch.empty((n, n), dtype=torch.float32, device=e.device)
    for c0 in range(0, n, block):
        e_c = e[:, c0:c0 + block]                        # (G, B)
        b = d[:, c0:c0 + block]                          # (G, B)
        delta = e[:, None, :] - e_c[:, :, None]          # (G, B, N)
        a = _apply_transform(delta, transform, psc, partial_semantics)
        s1 = a.sum(0)                                    # (B, N)
        s2 = (a * a).sum(0)
        s3 = (a * b[:, :, None]).sum(0)
        sb1 = b.sum(0)[:, None]
        sb2 = (b * b).sum(0)[:, None]
        out[c0:c0 + block] = _corr_from_moments(s1, s2, s3, sb1, sb2,
                                                float(g))
    return out


def col_delta_cor(emat: torch.Tensor, dmat: torch.Tensor,
                  transform: str = "linear", psc: float = 0.0,
                  partial_semantics: bool = False,
                  dmat_random: Optional[torch.Tensor] = None
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Dense colDeltaCor. emat/dmat: (genes, cells) tensors on one device.
    Returns the (cells, cells) float32 correlations on that device, or,
    with ``dmat_random``, the pair for dmat and dmat_random.

    Replaces reference colDeltaCor / colDeltaCorSqrt / colDeltaCorLog10
    (velocyto/estimation.py:11-141) via the ``transform`` argument.  A
    CUDA tensor goes through the hand-written kernel (the pair in one
    launch, each output bitwise equal to a single call), a CPU tensor
    through the plain version (one call per output)."""
    tcode = _TRANSFORMS[transform]
    if emat.is_cuda:
        f32 = [m.to(torch.float32).contiguous()
               for m in (emat, dmat, dmat_random) if m is not None]
        return kernels.coldeltacor_dense(f32[0], f32[1], tcode, psc,
                                         partial_semantics, *f32[2:])
    if emat.device.type == "cpu":
        outs = tuple(_col_delta_cor_dense_plain(emat, d, tcode, psc,
                                                partial_semantics)
                     for d in (dmat, dmat_random) if d is not None)
        return outs[0] if dmat_random is None else outs
    raise ValueError(f"unsupported device {emat.device}")


def _hilbert_index(x: torch.Tensor, y: torch.Tensor, bits: int
                   ) -> torch.Tensor:
    """Position along the Hilbert curve of order ``bits`` of the integer
    grid points (x, y) in [0, 2**bits), elementwise (the classic xy2d
    walk from the top bit down, int64)."""
    d = torch.zeros_like(x)
    top = (1 << bits) - 1
    s = 1 << (bits - 1)
    while s > 0:
        rx = (x & s) > 0
        ry = (y & s) > 0
        d += s * s * ((3 * rx.to(x.dtype)) ^ ry.to(x.dtype))
        # rotate the quadrant so the sub-curve starts where the last ended
        flip = ~ry & rx
        x = torch.where(flip, top - x, x)
        y = torch.where(flip, top - y, y)
        x, y = torch.where(ry, x, y), torch.where(ry, y, x)
        s >>= 1
    return d


_HILBERT_BITS = 10     # locality_order's grid: 1024 x 1024 cells


def locality_order(points: torch.Tensor) -> torch.Tensor:
    """An ordering of the rows of ``points`` (N, D >= 2) in which rows
    close in the first two coordinates sit close together: the Hilbert
    curve index of the points quantized to a 1024 x 1024 grid over their
    bounding box, then a stable argsort.  Returns an (N,) int32
    permutation on the points' device (plain torch).

    The sampled colDeltaCor kernel takes its centers in this order, so
    the blocks in flight share kNN candidates and the L2 serves the
    gathered rows; the order never changes its output."""
    xy = points[:, :2].to(torch.float64)
    lo = xy.min(dim=0).values
    span = (xy.max(dim=0).values - lo).clamp_min(1e-300)
    cells = (1 << _HILBERT_BITS) - 1
    q = ((xy - lo) / span * cells).round().to(torch.int64).clamp(0, cells)
    code = _hilbert_index(q[:, 0], q[:, 1], _HILBERT_BITS)
    return torch.argsort(code, stable=True).to(torch.int32)


def _check_permutation(order: torch.Tensor, m: int) -> None:
    """Raise ValueError unless ``order`` is an (m,) integer permutation of
    range(m): a center left out would leave its output row unwritten."""
    if order.shape != (m,) or order.is_floating_point() or \
            order.dtype == torch.bool:
        raise ValueError(f"order must be an ({m},) integer permutation, got "
                         f"{order.dtype} {tuple(order.shape)}")
    # m entries that hit each of the m in-range values once leave none out
    # of range; out-of-range ones land in the bins at -1 and m
    counts = torch.bincount(order.to(torch.int64).clamp(-1, m) + 1,
                            minlength=m + 2)[1:m + 1]
    if not bool(counts.eq(1).all()):
        raise ValueError(f"order is not a permutation of range({m})")


def _col_delta_cor_partial_plain(e_full: torch.Tensor, e_ctr: torch.Tensor,
                                 d_ctr: torch.Tensor, ixs: torch.Tensor,
                                 transform: int = _LINEAR, psc: float = 0.0
                                 ) -> torch.Tensor:
    """Plain PyTorch sampled colDeltaCor with the partial transform
    semantics (transcribes _partial_impl): e_full (N, G) gather source,
    e_ctr / d_ctr (M, G) center rows, ixs (M, nn) global neighbour ids ->
    (M, nn) f32 on the inputs' device.  Blocked over (center rows,
    128-neighbour tiles) so the gathered (B, nt, G) tensor stays near
    64 MB."""
    m, g = e_ctr.shape
    nn = ixs.shape[1]
    nt = min(128, nn)
    block = max(1, (1 << 24) // (nt * g))
    e_full = e_full.to(torch.float32)
    e_ctr = e_ctr.to(torch.float32)
    d_ctr = d_ctr.to(torch.float32)
    sb1 = d_ctr.sum(1)[:, None]
    sb2 = (d_ctr * d_ctr).sum(1)[:, None]
    out = torch.empty((m, nn), dtype=torch.float32, device=e_full.device)
    with full_f32():
        for r0 in range(0, m, block):
            rows = e_ctr[r0:r0 + block]                           # (B, G)
            b = d_ctr[r0:r0 + block, :, None]                     # (B, G, 1)
            for k0 in range(0, nn, nt):
                e_nb = e_full[ixs[r0:r0 + block, k0:k0 + nt]]     # (B, nt, G)
                a = _apply_transform(e_nb - rows[:, None, :], transform,
                                     psc, partial=True)
                out[r0:r0 + block, k0:k0 + nt] = _corr_from_moments(
                    a.sum(-1), (a * a).sum(-1), torch.bmm(a, b)[..., 0],
                    sb1[r0:r0 + block], sb2[r0:r0 + block], float(g))
    return out


def chunk_order(order: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The center order of the rows [lo, hi) taken from ``order``, a
    permutation of range(N): those rows in the order ``order`` lists
    them, minus lo, so a permutation of range(hi - lo).  Computed from
    the ranks (an argsort of the rows' positions in ``order``), with no
    host synchronisation."""
    rank = torch.empty_like(order)
    rank[order.to(torch.int64)] = torch.arange(
        order.shape[0], dtype=order.dtype, device=order.device)
    return torch.argsort(rank[lo:hi]).to(torch.int32)


def make_partial_compact_chunked(emat: torch.Tensor,
                                 transform: str = "linear", psc: float = 0.0):
    """Row-chunked sampled colDeltaCor, to run behind the neighbour
    sampler: the correlations of center rows [lo, hi) depend only on that
    chunk's sampled neighbours, so each chunk runs as soon as the sampler
    hands it over (estimate_transition_prob).  Port of the JAX package's
    ``velocyto_tpu/ops/coldeltacor.py::make_partial_compact_chunked``.

    emat: (genes, cells).  Returns (prep_d, run): ``prep_d(dmat)`` turns a
    (genes, cells) displacement matrix into the (cells, genes) f32 rows
    the kernel reads, once per call; ``run(d_rows, lo, hi, ixs_chunk,
    d_rows_random=None, order=None)`` gives the compact (hi - lo, nn)
    correlations of rows [lo, hi) (the pair for d_rows and d_rows_random
    with the second).  ``order``: an optional permutation of
    range(hi - lo), the chunk's own center order (``chunk_order``);
    anything else raises ValueError.  A CUDA tensor makes one launch of
    the hand kernel per chunk, both fields in it; a CPU tensor runs the
    plain version on the same rows.  Concatenated row-wise, the chunks
    equal one run over all rows bitwise (the rows are independent, and
    the order changes no output)."""
    tcode = _TRANSFORMS[transform]
    e_rows = emat.to(torch.float32).T.contiguous()

    def prep_d(dmat: torch.Tensor) -> torch.Tensor:
        return dmat.to(torch.float32).T.contiguous()

    def run(d_rows: torch.Tensor, lo: int, hi: int, ixs_chunk: torch.Tensor,
            d_rows_random: Optional[torch.Tensor] = None,
            order: Optional[torch.Tensor] = None):
        if order is not None:
            _check_permutation(order, hi - lo)
        ds = [d[lo:hi] for d in (d_rows, d_rows_random) if d is not None]
        if e_rows.is_cuda:
            return kernels.coldeltacor_partial(
                e_rows, e_rows[lo:hi], ds[0], ixs_chunk.contiguous(), tcode,
                psc, *ds[1:],
                order=None if order is None else order.to(torch.int32))
        if e_rows.device.type == "cpu":
            outs = tuple(_col_delta_cor_partial_plain(
                e_rows, e_rows[lo:hi], d, ixs_chunk, tcode, psc) for d in ds)
            return outs[0] if d_rows_random is None else outs
        raise ValueError(f"unsupported device {e_rows.device}")

    return prep_d, run


def col_delta_cor_partial_compact(
        emat: torch.Tensor, dmat: torch.Tensor, ixs: torch.Tensor,
        transform: str = "linear", psc: float = 0.0,
        dmat_random: Optional[torch.Tensor] = None,
        order: Optional[torch.Tensor] = None
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Sampled-neighbourhood colDeltaCor in the compact form.
    emat/dmat: (genes, cells) tensors on one device; ixs: (cells, nn)
    neighbour ids.  Returns the (cells, nn) float32 correlations on that
    device, or, with ``dmat_random``, the pair for dmat and dmat_random
    (the CUDA kernel gathers the neighbour rows once for both).
    ``order``: an optional (cells,) permutation of range(cells) in which
    the CUDA kernel takes the cells (``locality_order`` of the embedding);
    it changes no output, and the plain version ignores it.  Anything
    that is not such a permutation raises ValueError on either device.

    Replaces reference colDeltaCorpartial / colDeltaCorSqrtpartial /
    colDeltaCorLog10partial (velocyto/estimation.py:36-62, 144-170).  A
    CUDA tensor goes through the hand-written kernel, a CPU tensor
    through the plain version: one chunk of
    ``make_partial_compact_chunked`` over all rows."""
    prep_d, run = make_partial_compact_chunked(emat, transform, psc)
    return run(prep_d(dmat), 0, emat.shape[1], ixs,
               None if dmat_random is None else prep_d(dmat_random),
               order=order)


def col_delta_cor_partial(emat: torch.Tensor, dmat: torch.Tensor,
                          ixs: torch.Tensor, transform: str = "linear",
                          psc: float = 0.0) -> torch.Tensor:
    """Sampled-neighbourhood colDeltaCor scattered into a dense (cells,
    cells) float64 tensor (zero off the sampled positions, repeated
    positions summed), for API parity with the reference
    (velocyto/estimation.py:36-62, 144-170).  emat/dmat: (genes, cells),
    ixs: (cells, nn), on one device."""
    compact = col_delta_cor_partial_compact(emat, dmat, ixs, transform, psc)
    n = emat.shape[1]
    rows = torch.arange(n, device=compact.device).repeat_interleave(
        ixs.shape[1])
    out = torch.zeros((n, n), dtype=torch.float64, device=compact.device)
    out.index_put_((rows, ixs.reshape(-1).to(torch.int64)),
                   compact.reshape(-1).to(torch.float64), accumulate=True)
    return out
