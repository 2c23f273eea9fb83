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

With a mesh (parallel.make_mesh) the centers are split over the mesh's
cells shards: the dense form launches the dense kernel once per shard on
its center range, the sampled form once per shard on its rows, each
against expression replicated on the shard's device.  Above
_REPLICATION_BYTES of expression the sampled form takes the ring
schedule instead: expression is split too, and each chunk of cells
visits every shard in turn (the flat block-table kernel, one launch per
shard and step).  Every path gives the mesh-free result.

Transforms keep the reference sign conventions of the JAX package:
  - "linear":  A = delta
  - "sqrt":    A = sign(delta) * sqrt(|delta| + psc); the *partial*
               variant maps |delta| < 1e-16 to exactly 0
  - "log10":   A = sign(delta) * log10(|delta| + psc); full variant maps
               delta == 0 to -log10(psc), partial maps it to +log10(psc)

All computation is float32.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .. import kernels
from ..parallel.mesh import (CELLS, Mesh, bounds, gather_rows, join,
                             on_shard, replicas)
from ..utils.profiling import span
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
                               partial_semantics: bool = False,
                               c0: int = 0, m: Optional[int] = None
                               ) -> torch.Tensor:
    """Plain PyTorch dense colDeltaCor: (G, N) -> (m, N) f32 for the
    centers [c0, c0 + m) (default every center), on the inputs' device.
    Blocked over center cells so the (G, B, N) delta tensor stays near
    128 MB (transcribes _dense_xla_rows, plus the partial_semantics flag
    the Pallas kernel carries)."""
    g, n = emat.shape
    m = n - c0 if m is None else m
    if c0 < 0 or m < 1 or c0 + m > n:
        raise ValueError(f"center range c0={c0}, m={m} outside the {n} "
                         f"centers")
    e = emat.to(torch.float32)
    d = dmat.to(torch.float32)
    block = max(1, min(n, (1 << 25) // max(1, g * n)))
    out = torch.empty((m, n), dtype=torch.float32, device=e.device)
    for r0 in range(0, m, block):
        hi = min(m, r0 + block)
        e_c = e[:, c0 + r0:c0 + hi]                      # (G, B)
        b = d[:, c0 + r0:c0 + hi]                        # (G, B)
        delta = e[:, None, :] - e_c[:, :, None]          # (G, B, N)
        a = _apply_transform(delta, transform, psc, partial_semantics)
        s1 = a.sum(0)                                    # (B, N)
        s2 = (a * a).sum(0)
        s3 = (a * b[:, :, None]).sum(0)
        sb1 = b.sum(0)[:, None]
        sb2 = (b * b).sum(0)[:, None]
        out[r0:hi] = _corr_from_moments(s1, s2, s3, sb1, sb2, float(g))
    return out


def _dense_rows(emat: torch.Tensor, dmat: torch.Tensor,
                dmat_random: Optional[torch.Tensor], tcode: int, psc: float,
                partial_semantics: bool, c0: int = 0,
                m: Optional[int] = None):
    """The dense rows [c0, c0 + m) on one device: one launch of the
    dense kernel (both fields in it) for a CUDA tensor, the plain version
    for a CPU tensor; the pair with dmat_random."""
    if emat.is_cuda:
        f32 = [t.to(torch.float32).contiguous()
               for t in (emat, dmat, dmat_random) if t is not None]
        return kernels.coldeltacor_dense(f32[0], f32[1], tcode, psc,
                                         partial_semantics, *f32[2:], c0=c0,
                                         m=m)
    if emat.device.type == "cpu":
        outs = tuple(_col_delta_cor_dense_plain(emat, d, tcode, psc,
                                                partial_semantics, c0, m)
                     for d in (dmat, dmat_random) if d is not None)
        return outs[0] if dmat_random is None else outs
    raise ValueError(f"unsupported device {emat.device}")


def col_delta_cor(emat: torch.Tensor, dmat: torch.Tensor,
                  transform: str = "linear", psc: float = 0.0,
                  partial_semantics: bool = False,
                  dmat_random: Optional[torch.Tensor] = None,
                  mesh: Optional[Mesh] = None
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Dense colDeltaCor. emat/dmat: (genes, cells) tensors on one device.
    Returns the (cells, cells) float32 correlations on that device, or,
    with ``dmat_random``, the pair for dmat and dmat_random.

    Replaces reference colDeltaCor / colDeltaCorSqrt / colDeltaCorLog10
    (velocyto/estimation.py:11-141) via the ``transform`` argument.  A
    CUDA tensor goes through the hand-written kernel (the pair in one
    launch, each output bitwise equal to a single call), a CPU tensor
    through the plain version (one call per output).  With ``mesh``, the
    centers are split over the mesh's cells shards
    (col_delta_cor_dense_sharded) and the result lands on the mesh's
    first device."""
    if mesh is not None:
        return col_delta_cor_dense_sharded(mesh, emat, dmat, transform, psc,
                                           partial_semantics, dmat_random)
    return _dense_rows(emat, dmat, dmat_random, _TRANSFORMS[transform], psc,
                       partial_semantics)


def _as_f32(x, device) -> torch.Tensor:
    """x (numpy or a tensor) as a float32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def make_dense_sharded(mesh: Mesh, transform: str = "linear",
                       psc: float = 0.0, partial_semantics: bool = False):
    """The dense colDeltaCor with its centers split over the mesh's
    cells shards (expression replicated): fn(emat (G, N), dmat (G, N),
    dmat_random=None) -> this process's (rows, N) blocks, one per shard
    on its device (pairs with dmat_random), each one launch of the dense
    kernel on its center range (its plain version on the CPU).  Port of
    the JAX package's make_dense_sharded."""
    tcode = _TRANSFORMS[transform]
    shards = mesh.cell_shards()

    def fn(emat: torch.Tensor, dmat: torch.Tensor,
           dmat_random: Optional[torch.Tensor] = None) -> List:
        n = emat.shape[1]
        spans = bounds(n, mesh.shape[CELLS])
        mats = [replicas(shards, t) for t in (emat, dmat, dmat_random)
                if t is not None]
        outs = []
        for i, s in enumerate(shards):
            lo, hi = spans[s.index]
            mine = [m[i] for m in mats]
            if hi == lo:
                empty = mine[0].new_empty((0, n))
                outs.append(empty if dmat_random is None else (empty, empty))
                continue
            with on_shard(s, *mine):
                outs.append(_dense_rows(
                    mine[0], mine[1], mine[2] if len(mine) > 2 else None,
                    tcode, psc, partial_semantics, lo, hi - lo))
        join(shards, outs)
        return outs

    return fn


def col_delta_cor_dense_sharded(mesh: Mesh, emat, dmat,
                                transform: str = "linear", psc: float = 0.0,
                                partial_semantics: bool = False,
                                dmat_random=None):
    """Multi-shard dense colDeltaCor: rows of the (N, N) output split
    over the mesh's cells shards, gathered on the mesh's first device (the
    whole result on every process); the pair with dmat_random.  emat /
    dmat: (G, N) numpy or tensors.  Each row is bitwise the mesh-free
    call's."""
    first = mesh.first_device
    e, d = _as_f32(emat, first), _as_f32(dmat, first)
    d2 = None if dmat_random is None else _as_f32(dmat_random, first)
    parts = make_dense_sharded(mesh, transform, psc, partial_semantics)(
        e, d, d2)
    counts = [hi - lo for lo, hi in bounds(e.shape[1], mesh.shape[CELLS])]
    if d2 is None:
        return gather_rows(mesh, parts, counts)
    return (gather_rows(mesh, [p[0] for p in parts], counts),
            gather_rows(mesh, [p[1] for p in parts], counts))


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
    def prep_d(dmat: torch.Tensor) -> torch.Tensor:
        return dmat.to(torch.float32).T.contiguous()

    return prep_d, _partial_rows(prep_d(emat), _TRANSFORMS[transform], psc)


def _partial_rows(e_rows: torch.Tensor, tcode: int, psc: float):
    """run(d_rows, lo, hi, ixs_chunk, d_rows_random=None, order=None) of
    make_partial_compact_chunked over the (cells, genes) rows e_rows on
    one device (_sampled_rows on rows [lo, hi))."""
    def run(d_rows: torch.Tensor, lo: int, hi: int, ixs_chunk: torch.Tensor,
            d_rows_random: Optional[torch.Tensor] = None,
            order: Optional[torch.Tensor] = None):
        if order is not None:
            _check_permutation(order, hi - lo)
        return _sampled_rows(
            e_rows, e_rows[lo:hi], d_rows[lo:hi], ixs_chunk, tcode, psc,
            None if d_rows_random is None else d_rows_random[lo:hi], order)

    return run


def _sampled_rows(e_full: torch.Tensor, e_ctr: torch.Tensor,
                  d_ctr: torch.Tensor, ixs: torch.Tensor, tcode: int,
                  psc: float, d_ctr2: Optional[torch.Tensor] = None,
                  order: Optional[torch.Tensor] = None):
    """The sampled correlations of the centers e_ctr / d_ctr (M, G) with
    their neighbours ixs (M, nn) in e_full (N, G), on one device: one
    launch of the sampled kernel (both fields in it) for a CUDA tensor,
    the plain version for a CPU tensor; the pair with d_ctr2.  order: a
    checked permutation of range(M), or None."""
    if e_full.is_cuda:
        return kernels.coldeltacor_partial(
            e_full, e_ctr, d_ctr, ixs.contiguous(), tcode, psc, d_ctr2,
            order=None if order is None else order.to(torch.int32))
    if e_full.device.type == "cpu":
        outs = tuple(_col_delta_cor_partial_plain(e_full, e_ctr, d, ixs,
                                                  tcode, psc)
                     for d in (d_ctr, d_ctr2) if d is not None)
        return outs[0] if d_ctr2 is None else outs
    raise ValueError(f"unsupported device {e_full.device}")


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


def col_delta_cor_partial_compact_dev(emat, dmat, ixs,
                                      transform: str = "linear",
                                      psc: float = 0.0,
                                      device="cuda") -> torch.Tensor:
    """Sampled-neighbourhood colDeltaCor in the compact form, on
    `device` (the card unless the caller asks for another): emat / dmat
    (genes, cells) and ixs (cells, nn), numpy arrays or tensors, are
    moved there; returns the (cells, nn) float32 correlations on it.  The
    JAX package's ``velocyto_tpu/ops/coldeltacor.py:383`` contract; on a
    card one single-field launch of the sampled kernel, on the CPU the
    plain version (col_delta_cor_partial_compact's single field)."""
    device = torch.device(device)
    return col_delta_cor_partial_compact(
        _as_f32(emat, device), _as_f32(dmat, device),
        torch.as_tensor(ixs, device=device), transform, psc)


def col_delta_cor_partial(emat: torch.Tensor, dmat: torch.Tensor,
                          ixs: torch.Tensor, transform: str = "linear",
                          psc: float = 0.0,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sampled-neighbourhood colDeltaCor scattered into a dense (cells,
    cells) float64 tensor (zero off the sampled positions, repeated
    positions summed), for API parity with the reference
    (velocyto/estimation.py:36-62, 144-170).  emat/dmat: (genes, cells),
    ixs: (cells, nn), on one device.  With ``mesh``, the centers are split
    over the mesh's cells shards (col_delta_cor_partial_sharded_dev) and
    the result lands on the mesh's first device."""
    if mesh is not None:
        compact = col_delta_cor_partial_sharded_dev(mesh, emat, dmat, ixs,
                                                    transform, psc)
        ixs = torch.as_tensor(ixs, device=compact.device)
    else:
        compact = col_delta_cor_partial_compact(emat, dmat, ixs, transform,
                                                psc)
    n = emat.shape[1]
    rows = torch.arange(n, device=compact.device).repeat_interleave(
        ixs.shape[1])
    out = torch.zeros((n, n), dtype=torch.float64, device=compact.device)
    out.index_put_((rows, ixs.reshape(-1).to(torch.int64)),
                   compact.reshape(-1).to(torch.float64), accumulate=True)
    return out


# ---------------------------------------------------------------------------
# Multi-shard sampled variant: centers split, expression replicated
# ---------------------------------------------------------------------------

def make_partial_sharded(mesh: Mesh, transform: str = "linear",
                         psc: float = 0.0):
    """The sampled colDeltaCor with its centers split over the mesh's
    cells shards, expression replicated: fn(e_rows (N, G), d_rows (N, G),
    ixs (N, nn), d_rows_random=None, order=None) -> this process's (rows,
    nn) blocks, one per shard on its device (pairs with d_rows_random).
    Each shard makes one launch of the sampled kernel on its rows, its
    ids and ``chunk_order(order, lo, hi)``, against e_rows on its device
    (a chunk of make_partial_compact_chunked).  Port of the JAX package's
    make_partial_sharded."""
    tcode = _TRANSFORMS[transform]
    shards = mesh.cell_shards()

    def fn(e_rows: torch.Tensor, d_rows: torch.Tensor, ixs: torch.Tensor,
           d_rows_random: Optional[torch.Tensor] = None,
           order: Optional[torch.Tensor] = None) -> List:
        n = e_rows.shape[0]
        if order is not None:
            _check_permutation(order, n)
        spans = bounds(n, mesh.shape[CELLS])
        reps = [replicas(shards, t) for t in (e_rows, d_rows, d_rows_random)
                if t is not None]
        outs = []
        for i, s in enumerate(shards):
            lo, hi = spans[s.index]
            if hi == lo:
                empty = e_rows.new_empty((0, ixs.shape[1]))
                outs.append(empty if d_rows_random is None
                            else (empty, empty))
                continue
            mine = [r[i] for r in reps]
            own = ixs[lo:hi].to(s.device)
            sub = None if order is None else \
                chunk_order(order, lo, hi).to(s.device)
            with on_shard(s, *mine, own):
                outs.append(_partial_rows(mine[0], tcode, psc)(
                    mine[1], lo, hi, own, *mine[2:], order=sub))
        join(shards, outs)
        return outs

    return fn


# Bytes of replicated expression above which the sharded sampled form
# takes the ring schedule (expression split too); read at each call
_REPLICATION_BYTES = int(os.environ.get("VELOCYTO_REPLICATION_BYTES",
                                        4 << 30))


def col_delta_cor_partial_sharded_dev(mesh: Mesh, emat, dmat, ixs,
                                      transform: str = "linear",
                                      psc: float = 0.0, dmat_random=None,
                                      order: Optional[torch.Tensor] = None):
    """Multi-shard sampled colDeltaCor: the compact (N, nn) correlations
    on the mesh's first device (the whole result on every process), the
    pair with dmat_random.  Centers (rows of ixs and of the output) are
    split over the mesh's cells shards, expression replicated on each
    shard's device; above _REPLICATION_BYTES of expression the ring
    schedule takes over (col_delta_cor_partial_ring_dev).  emat / dmat:
    (G, N) numpy or tensors; order: an optional permutation of range(N)
    (``locality_order``) each shard takes its centers in, on the ring
    too.  Each entry is bitwise the mesh-free kernel's."""
    first = mesh.first_device
    e = _as_f32(emat, first)
    if e.numel() * 4 > _REPLICATION_BYTES:
        return col_delta_cor_partial_ring_dev(mesh, e, dmat, ixs, transform,
                                              psc, dmat_random, order=order)
    e_rows = e.T.contiguous()
    d_rows = _as_f32(dmat, first).T.contiguous()
    d2_rows = None if dmat_random is None else \
        _as_f32(dmat_random, first).T.contiguous()
    ixs = torch.as_tensor(ixs, device=first)
    if ixs.dtype != torch.int32:
        ixs = ixs.to(torch.int32)
    parts = make_partial_sharded(mesh, transform, psc)(
        e_rows, d_rows, ixs, d2_rows,
        None if order is None else order.to(first))
    counts = [hi - lo for lo, hi in bounds(e_rows.shape[0],
                                           mesh.shape[CELLS])]
    if d2_rows is None:
        return gather_rows(mesh, parts, counts)
    return (gather_rows(mesh, [p[0] for p in parts], counts),
            gather_rows(mesh, [p[1] for p in parts], counts))


def col_delta_cor_partial_sharded(mesh: Mesh, emat, dmat, ixs,
                                  transform: str = "linear",
                                  psc: float = 0.0) -> np.ndarray:
    """Host-returning form of :func:`col_delta_cor_partial_sharded_dev`."""
    return col_delta_cor_partial_sharded_dev(mesh, emat, dmat, ixs,
                                             transform, psc).cpu().numpy()


# ---------------------------------------------------------------------------
# Ring variant: expression split too (no replication)
# ---------------------------------------------------------------------------
#
# Shard p holds chunk p of the cells (chunk = ceil(N / P) rows, the last
# zero-padded) and, at step s, the chunk (p + s) % P: it evaluates exactly
# its sampled pairs whose neighbour lives there, then hands the chunk to
# shard p - 1.  The neighbour ids are grouped by owning chunk on the host
# (the order of a row's neighbours does not change a pair's moments),
# packed into q-entry blocks, and the compact output is put back in order
# with one gather through inv_pos.

def _ring_plan(ixs: np.ndarray, shards: int, chunk: int, q: int = 16):
    """Copy of velocyto_tpu/ops/coldeltacor.py::_ring_plan (:526).

    Block-quantized grouping of each row's neighbor indices by owning
    chunk: each (row, owner) group is packed into ceil(cnt/q) blocks of
    q entries, and only the per-(chip, owner) block count is padded to
    the global max.

    Returns (qloc (P, P, Bmax, q) int32 chunk-local neighbor indices,
    qrow (P, P, Bmax) int32 chunk-local center row of each block,
    inv_pos (N, nn) int32 positions into the per-chip (P*Bmax*q) output
    layout, Bmax).  Dummy blocks/slots hold zeros; their outputs are
    never referenced by inv_pos.
    """
    n, nn = ixs.shape
    n_pad = chunk * shards
    owner = (ixs // chunk).astype(np.int64)
    local = (ixs - owner * chunk).astype(np.int32)
    order = np.argsort(owner, axis=1, kind="stable")
    owner_s = np.take_along_axis(owner, order, axis=1)
    local_s = np.take_along_axis(local, order, axis=1)
    rows_rep = np.repeat(np.arange(n), nn)
    counts = np.zeros((n, shards), np.int64)
    np.add.at(counts, (rows_rep, owner.ravel()), 1)
    blocks = -(-counts // q)                            # (n, P) ceil
    # exclusive cumsum of block counts over the rows of each chip
    blk_start = np.zeros((n, shards), np.int64)
    bc = np.zeros((shards, shards), np.int64)           # (chip, owner)
    for p in range(shards):
        sl = slice(p * chunk, min((p + 1) * chunk, n))
        blk_start[sl] = np.cumsum(blocks[sl], axis=0) - blocks[sl]
        bc[p] = blocks[sl].sum(axis=0)
    bmax = max(1, int(bc.max()))

    starts_in_row = np.zeros((n, shards), np.int64)
    starts_in_row[:, 1:] = np.cumsum(counts, axis=1)[:, :-1]
    t = np.arange(nn)[None, :] - np.take_along_axis(starts_in_row,
                                                    owner_s, axis=1)
    b_idx = np.take_along_axis(blk_start, owner_s, axis=1) + t // q
    slot = t % q
    chip_of = (np.arange(n) // chunk)[:, None]
    row_local = (np.arange(n) - (np.arange(n) // chunk) * chunk
                 ).astype(np.int32)

    qloc = np.zeros((shards, shards, bmax, q), np.int32)
    qrow = np.zeros((shards, shards, bmax), np.int32)
    qloc[np.broadcast_to(chip_of, owner_s.shape), owner_s, b_idx,
         slot] = local_s
    qrow[np.broadcast_to(chip_of, owner_s.shape), owner_s,
         b_idx] = np.broadcast_to(row_local[:, None], owner_s.shape)
    pos_s = owner_s * (bmax * q) + b_idx * q + slot
    inv_pos = np.zeros((n_pad, nn), np.int64)
    np.put_along_axis(inv_pos[:n], order, pos_s, axis=1)
    return qloc, qrow, inv_pos.astype(np.int32), bmax


def shard_rank(order: torch.Tensor, lo: int, hi: int,
               rows: int) -> torch.Tensor:
    """The rank of each of a shard's ``rows`` local center rows (global
    rows [lo, hi), then padding) in the locality order ``order`` (a
    permutation of range(N)): the inverse of ``chunk_order(order, lo,
    hi)``, the padding rows ranked after them.  (rows,) int64 on order's
    device, for kernels.flat_runs."""
    rank = torch.arange(rows, dtype=torch.int64, device=order.device)
    if hi > lo:
        mine = chunk_order(order, lo, hi).to(torch.int64)
        rank[mine] = torch.arange(hi - lo, dtype=torch.int64,
                                  device=order.device)
    return rank


def _col_delta_cor_flat_plain(e_visit: torch.Tensor, e_ctr: torch.Tensor,
                              d_ctr: torch.Tensor, qloc: torch.Tensor,
                              qrow: torch.Tensor, transform: int = _LINEAR,
                              psc: float = 0.0, run_start=None,
                              run_order=None) -> torch.Tensor:
    """Plain PyTorch flat block-table colDeltaCor with the partial
    transform semantics (transcribes _partial_flat_impl): e_visit (C, G)
    gather source, e_ctr / d_ctr (M, G) center rows, qloc (F, q) rows of
    e_visit, qrow (F,) rows of e_ctr -> (F, q) f32 on the inputs' device.
    Blocked over table rows so the gathered (B, q, G) tensor stays near
    64 MB.  The kernel's schedule (run_start, run_order) changes no
    output, so it is taken and not used."""
    f, q = qloc.shape
    g = e_ctr.shape[1]
    block = max(1, (1 << 24) // max(1, q * g))
    e_visit = e_visit.to(torch.float32)
    e_ctr = e_ctr.to(torch.float32)
    d_ctr = d_ctr.to(torch.float32)
    qloc = qloc.to(torch.int64)
    qrow = qrow.to(torch.int64)
    out = torch.empty((f, q), dtype=torch.float32, device=e_visit.device)
    with full_f32():
        for r0 in range(0, f, block):
            cid = qrow[r0:r0 + block]
            rows = e_ctr[cid]                                  # (B, G)
            b = d_ctr[cid]                                     # (B, G)
            e_nb = e_visit[qloc[r0:r0 + block]]                # (B, q, G)
            a = _apply_transform(e_nb - rows[:, None, :], transform, psc,
                                 partial=True)
            out[r0:r0 + block] = _corr_from_moments(
                a.sum(-1), (a * a).sum(-1),
                torch.bmm(a, b[:, :, None])[..., 0],
                b.sum(-1)[:, None], (b * b).sum(-1)[:, None], float(g))
    return out


def _flat_rows(e_visit: torch.Tensor, e_ctr: torch.Tensor,
               d_ctr: torch.Tensor, qloc: torch.Tensor, qrow: torch.Tensor,
               tcode: int, psc: float, d_ctr2: Optional[torch.Tensor] = None,
               run_start: Optional[torch.Tensor] = None,
               run_order: Optional[torch.Tensor] = None):
    """One ring step of one shard: one launch of the flat kernel (both
    fields in it) on the schedule (run_start, run_order; kernels.flat_runs
    built it, so the launch does not check it) for a CUDA tensor, the
    plain version for a CPU tensor; the pair with d_ctr2."""
    if e_visit.is_cuda:
        return kernels.coldeltacor_flat(e_visit, e_ctr, d_ctr, qloc, qrow,
                                        tcode, psc, d_ctr2,
                                        run_start=run_start,
                                        run_order=run_order, check=False)
    if e_visit.device.type == "cpu":
        outs = tuple(_col_delta_cor_flat_plain(e_visit, e_ctr, d, qloc,
                                               qrow, tcode, psc)
                     for d in (d_ctr, d_ctr2) if d is not None)
        return outs[0] if d_ctr2 is None else outs
    raise ValueError(f"unsupported device {e_visit.device}")


def _rotate(mesh: Mesh, shards, visit: List[torch.Tensor]
            ) -> Tuple[List[torch.Tensor], List]:
    """Issue the hand-over of each shard's chunk to the shard before it
    (global index p - 1): a peer copy between cards, a copy on one
    device, send/recv across processes.  Returns the next step's chunks
    and, for each receiving shard, the (event, sender) its stream must
    wait for."""
    n_loc = len(shards)
    nxt: List[Optional[torch.Tensor]] = [None] * n_loc
    ready: List = [None] * n_loc
    for i, s in enumerate(shards):
        if i == 0 and mesh.world > 1:
            continue                    # leaves this process, below
        j = i - 1 if i > 0 else n_loc - 1
        dst = shards[j].device
        with on_shard(s, visit[i]):
            nxt[j] = visit[i].clone() if dst == s.device else \
                visit[i].to(dst, non_blocking=True)
            if s.stream is not None:
                ev = torch.cuda.Event()
                ev.record(s.stream)
                ready[j] = ev
    if mesh.world > 1:
        import torch.distributed as dist
        buf = torch.empty_like(visit[n_loc - 1])
        ops = [dist.P2POp(dist.isend, visit[0].contiguous(),
                          (mesh.rank - 1) % mesh.world),
               dist.P2POp(dist.irecv, buf, (mesh.rank + 1) % mesh.world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        nxt[n_loc - 1] = buf
    return nxt, ready


def make_partial_ring(mesh: Mesh, shards: int, bmax: int, qwidth: int,
                      nn: int, transform: str = "linear", psc: float = 0.0):
    """The ring sampled colDeltaCor over the block-quantized plan.

    Returns fn(e_parts, d_parts, qloc_parts, qrow_parts, inv_parts,
    d2_parts=None, order=None) -> this process's (C, nn) blocks (pairs
    with d2_parts); each argument holds one tensor per local cells shard
    on its device: its chunk of expression and displacement rows (C, G),
    its tables qloc (P, Bmax, q), qrow (P, Bmax) and its rows of inv_pos
    (C, nn).  Each table's schedule (kernels.flat_runs) is built first:
    its runs in the locality rank of their centers under ``order`` (a
    permutation of range(N), ``locality_order``; shard_rank), in table
    order without it; the order changes no output.  At step s shard p
    runs the flat kernel on the chunk it holds, (p + s) % P, after issuing
    that chunk's hand-over to shard p - 1 (so the copy overlaps the
    launch); P launches a shard, both fields in each.  The final gather
    through inv_pos is plain torch.  Port of the JAX package's
    make_partial_ring (which has no order)."""
    tcode = _TRANSFORMS[transform]
    local = mesh.cell_shards()
    if mesh.shape[CELLS] != shards:
        raise ValueError(f"plan for {shards} shards on a mesh of "
                         f"{mesh.shape[CELLS]}")

    def fn(e_parts, d_parts, qloc_parts, qrow_parts, inv_parts,
           d2_parts=None, order=None):
        with span("ring.schedule"):
            scheds = []
            for i, s in enumerate(local):
                with on_shard(s, qrow_parts[i]):
                    rank = None
                    if order is not None:
                        rows = e_parts[i].shape[0]
                        lo = s.index * rows
                        rank = shard_rank(order.to(s.device), lo,
                                          min(order.shape[0], lo + rows),
                                          rows)
                    scheds.append([kernels.flat_runs(qrow_parts[i][v], rank)
                                   for v in range(shards)])
        dual = d2_parts is not None
        outs = [[torch.empty((shards, bmax, qwidth), dtype=torch.float32,
                             device=s.device) for _ in range(1 + dual)]
                for s in local]
        visit = list(e_parts)
        with span("ring.launches"):
            for step in range(shards):
                if step + 1 < shards:
                    nxt, ready = _rotate(mesh, local, visit)
                for i, s in enumerate(local):
                    v = (s.index + step) % shards
                    mine = [visit[i], e_parts[i], d_parts[i], *outs[i]] + \
                        ([d2_parts[i]] if dual else [])
                    with on_shard(s, *mine):
                        part = _flat_rows(visit[i], e_parts[i], d_parts[i],
                                          qloc_parts[i][v], qrow_parts[i][v],
                                          tcode, psc,
                                          d2_parts[i] if dual else None,
                                          *scheds[i][v])
                        for o, pt in zip(outs[i],
                                         part if dual else (part,)):
                            o[v].copy_(pt)
                if step + 1 < shards:
                    for i, s in enumerate(local):
                        if ready[i] is not None:
                            s.stream.wait_event(ready[i])
                            nxt[i].record_stream(s.stream)
                    visit = nxt
        with span("ring.gather"):
            res = []
            for i, s in enumerate(local):
                with on_shard(s, inv_parts[i]):
                    idx = inv_parts[i].to(torch.int64)
                    got = tuple(o.reshape(-1)[idx] for o in outs[i])
                res.append(got if dual else got[0])
            join(local, res)
        return res

    return fn


def col_delta_cor_partial_ring_dev(mesh: Mesh, emat, dmat, ixs,
                                   transform: str = "linear",
                                   psc: float = 0.0, dmat_random=None,
                                   order: Optional[torch.Tensor] = None):
    """Fully split sampled colDeltaCor (expression split over the mesh's
    cells shards, chunks handed round the ring) returning the compact (N,
    nn) correlations on the mesh's first device (the whole result on every
    process), the pair with dmat_random.  Each pair's moments accumulate
    as in the sampled kernel.  order: an optional permutation of range(N)
    (``locality_order``) the flat kernel takes each shard's centers in
    (make_partial_ring); it changes no output.  Spans (utils.profiling):
    ring.upload (the inputs as f32 rows, the chunks and tables to the
    shards), ring.plan (_ring_plan, on the host), ring.schedule (the
    ranks and kernels.flat_runs), ring.launches (the P steps: flat
    launches, hand-overs, copies into the outputs) and ring.gather
    (through inv_pos, then the rows to the first device)."""
    first = mesh.first_device
    with span("ring.upload"):
        e_rows = _as_f32(emat, first).T
        d_rows = _as_f32(dmat, first).T
        d2_rows = None if dmat_random is None else \
            _as_f32(dmat_random, first).T
        ixs = np.asarray(ixs.cpu() if isinstance(ixs, torch.Tensor)
                         else ixs)
    n, g = e_rows.shape
    nn = ixs.shape[1]
    shards = mesh.shape[CELLS]
    chunk = (n + shards - 1) // shards
    if order is not None:
        order = order.to(first)
        _check_permutation(order, n)
    qwidth = min(16, nn)
    local = mesh.cell_shards()
    with span("ring.plan"):
        qloc, qrow, inv_pos, bmax = _ring_plan(ixs, shards, chunk, q=qwidth)

    def chunks(rows):
        pad = torch.zeros((chunk * shards, g), dtype=torch.float32,
                          device=first)
        pad[:n] = rows
        return [pad[s.index * chunk:(s.index + 1) * chunk].to(s.device)
                .contiguous() for s in local]

    def tables(a):
        return [torch.as_tensor(a[s.index], device=s.device) for s in local]

    fn = make_partial_ring(mesh, shards, bmax, qwidth, nn, transform, psc)
    with span("ring.upload"):
        args = (chunks(e_rows), chunks(d_rows), tables(qloc), tables(qrow),
                [torch.as_tensor(inv_pos[s.index * chunk:
                                         (s.index + 1) * chunk],
                                 device=s.device) for s in local],
                None if d2_rows is None else chunks(d2_rows))
    parts = fn(*args, order=order)
    counts = [max(0, min(chunk, n - p * chunk)) for p in range(shards)]
    # the last shards hold the padding rows
    rows = [counts[s.index] for s in local]
    with span("ring.gather"):
        if d2_rows is None:
            out = gather_rows(mesh, [p[:r] for p, r in zip(parts, rows)],
                              counts)
        else:
            out = tuple(gather_rows(mesh, [p[k][:r] for p, r in
                                           zip(parts, rows)], counts)
                        for k in (0, 1))
    return out


def col_delta_cor_partial_ring(mesh: Mesh, emat, dmat, ixs,
                               transform: str = "linear",
                               psc: float = 0.0) -> np.ndarray:
    """Host-returning form of :func:`col_delta_cor_partial_ring_dev`."""
    return col_delta_cor_partial_ring_dev(mesh, emat, dmat, ixs, transform,
                                          psc).cpu().numpy()
