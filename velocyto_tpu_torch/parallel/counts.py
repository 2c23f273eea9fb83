"""Distributed count-matrix merge.

Port of velocyto_tpu/parallel/counts.py.  Feeders that count disjoint
read shards of the same cells give per-(gene, cell) partial counts that
must be summed.  Here the feeder axis is split over the mesh's shards:
each shard sums its slice on its own device, the partial sums are added
on the mesh's first device, and across processes ``all_reduce`` adds
those of every process.

For the complementary layout - feeders own disjoint cell ranges of a
cell-sorted BAM - no collective is needed: columns concatenate, which is
what ``ExInCounter.count`` and loom assembly already do.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, bounds, join, on_shard


def merge_feeder_counts(mesh: Mesh, stacked) -> torch.Tensor:
    """Merge an (n_feeders, genes, cells) stack of partial counts (numpy
    or a tensor, given whole on every process) into the (genes, cells)
    total on the mesh's first device.  Integer counts are summed in
    int64, so the result equals ``np.sum(stacked, 0)`` exactly."""
    a = np.asarray(stacked.cpu() if isinstance(stacked, torch.Tensor)
                   else stacked)
    if a.ndim != 3:
        raise ValueError(f"stacked must be (feeders, genes, cells), got "
                         f"{a.shape}")
    wide = np.int64 if a.dtype.kind in "biu" else a.dtype
    shards = mesh.flat_shards()
    spans = bounds(a.shape[0], mesh.size)
    parts = []
    for s in shards:
        lo, hi = spans[s.index]
        piece = torch.as_tensor(np.ascontiguousarray(a[lo:hi], dtype=wide))
        with on_shard(s):
            parts.append(piece.to(s.device).sum(0))
    join(shards, parts)
    total = parts[0].to(mesh.first_device)
    for p in parts[1:]:
        total = total + p.to(mesh.first_device)
    if mesh.world > 1:
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total


def merge_feeder_counts_np(partials: np.ndarray) -> np.ndarray:
    """Host reference implementation (sum over the feeder axis)."""
    return np.sum(partials, axis=0)
