"""Per-shard cost of the multi-shard sampled colDeltaCor on the card.

Port of the top-level bench_scaling.py.  Times the sampled colDeltaCor
split over P = 1, 2, 4 shards, in both layouts: centers split with
expression replicated (col_delta_cor_partial_sharded_dev, one launch of
the sampled kernel per shard) and the ring (col_delta_cor_partial_ring_dev,
expression split too, P launches of the flat block-table kernel per
shard).  The shards go round the visible cards; with fewer cards than
shards a card holds several shards, each on its own stream.

Each line says how many distinct cards ("devices") carried the "shards".
On one card the numbers read as the cost of splitting the work (per-shard
launches, the ring's plan padding and hand-overs), never as scaling:
every shard shares the same SMs.  True multi-card scaling needs a machine
with more than one card.

Prints one JSON line per P, then {"multichip_analysis": ...}: the ring's
padding from the plan (exact) and a model of P-card efficiency built
from the single-shard rate measured in this run and an assumed link
rate.

    python3 -m velocyto_tpu_torch.bench_scaling

Needs a CUDA device; raises without one.
"""
from __future__ import annotations

import json
import statistics
from typing import Sequence

import numpy as np
import torch

from .bench_common import card, require_card
from .ops.coldeltacor import (_ring_plan, col_delta_cor_partial_ring_dev,
                              col_delta_cor_partial_sharded_dev)
from .parallel.mesh import make_mesh

G, N, NN = 2000, 4096, 512
SHARDS = (1, 2, 4)
REPS = 3


def _ms(fn, reps: int = REPS) -> float:
    """Median ms on the card's clock (CUDA events) over reps calls, after
    one warm call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main(shards: Sequence[int] = SHARDS, g: int = G, n: int = N,
         nn: int = NN) -> dict:
    require_card()
    rng = np.random.default_rng(0)
    e = torch.as_tensor(rng.random((g, n), np.float32), device="cuda")
    d = torch.as_tensor(rng.random((g, n), np.float32), device="cuda")
    ixs = np.stack([rng.choice(n, nn, replace=False)
                    for _ in range(n)]).astype(np.int32)
    ixs_dev = torch.as_tensor(ixs, device="cuda")
    cards = torch.cuda.device_count()
    smi = card()
    points = {}
    base = None
    for p in shards:
        devices = [torch.device("cuda", i % cards) for i in range(p)]
        mesh = make_mesh(devices=devices)
        sharded_ms = _ms(lambda: col_delta_cor_partial_sharded_dev(
            mesh, e, d, ixs_dev, "sqrt", 1e-10))
        ring_ms = _ms(lambda: col_delta_cor_partial_ring_dev(
            mesh, e, d, ixs, "sqrt", 1e-10))
        if base is None:
            base = sharded_ms
        rec = {"shards": p, "devices": len(set(devices)),
               "sharded_ms": sharded_ms, "ring_ms": ring_ms,
               "cells_per_sec": n / (sharded_ms / 1e3),
               "sharded_over_one_shard": sharded_ms / base,
               "card": smi}
        if rec["devices"] < p:
            rec["note"] = ("shards share a card: per-shard overhead, not "
                           "scaling")
        points[p] = rec
        print(json.dumps(rec), flush=True)
    model = analyze_multichip(n_cells=n, n_genes=g, nn=nn,
                              shards_list=tuple(s for s in shards if s > 1),
                              kernel_cells_per_sec=points[shards[0]][
                                  "cells_per_sec"], ixs=ixs)
    print(json.dumps({"multichip_analysis": model}), flush=True)
    return {"points": points, "multichip_analysis": model}


def analyze_multichip(n_cells: int = 20000, n_genes: int = 2000,
                      nn: int = 1750, shards_list=(2, 4, 8, 16),
                      kernel_cells_per_sec: float = None,
                      link_gbps: float = 450.0, ixs=None) -> dict:
    """Model of the sampled colDeltaCor over P cards (port of the JAX
    package's bench_scaling.analyze_multichip).

    Replicated layout: no collective in the steady state; efficiency is
    bounded by the row partition's imbalance alone.  Ring layout: (P - 1)
    hand-overs of an (N / P, G) f32 chunk, issued before each step's
    launch so they can overlap it; each step's work is the plan's padded
    block table (_ring_plan, exact), so the padding inflation is measured
    here, not modeled.

      serial:     Tp = max_padded_work / rate + ring_bytes / link
      overlapped: Tp = max(max_padded_work / rate, ring_bytes / link)

    rate: kernel_cells_per_sec (the single-shard rate of a run on the
    card; required), link: link_gbps GB/s one way per card (an assumed
    figure, 450 for NVLink 4 on an H100 SXM, not measured here)."""
    if kernel_cells_per_sec is None:
        raise ValueError("kernel_cells_per_sec: the measured single-shard "
                         "rate is required")
    if ixs is None:
        rng = np.random.default_rng(1)
        ixs = np.stack([rng.choice(n_cells, nn, replace=False)
                        for _ in range(n_cells)]).astype(np.int32)
    pair_work = n_cells * nn
    t1 = n_cells / kernel_cells_per_sec
    out = {"model": {"N": n_cells, "G": n_genes, "nn": nn,
                     "single_shard_cells_per_sec": kernel_cells_per_sec,
                     "link_gbps_assumed": link_gbps},
           "replicated": {}, "ring": {}}
    for p in shards_list:
        rows = np.array_split(np.arange(n_cells), p)
        rep_work = [len(r) * nn for r in rows]
        out["replicated"][p] = {
            "collective_bytes_per_card": 0,
            "setup_broadcast_bytes": n_cells * n_genes * 4,
            "work_imbalance": max(rep_work) * p / pair_work,
            "predicted_efficiency": pair_work / (max(rep_work) * p),
            "per_card_expression_bytes": n_cells * n_genes * 4,
        }
        chunk = (n_cells + p - 1) // p
        qwidth = min(16, nn)
        _qloc, _qrow, _inv, bmax = _ring_plan(ixs, p, chunk, q=qwidth)
        per_shard_padded = p * bmax * qwidth
        ring_bytes = (p - 1) / p * n_cells * n_genes * 4
        t_comp = per_shard_padded / (pair_work / t1)
        t_comm = ring_bytes / (link_gbps * 1e9)
        out["ring"][p] = {
            "collective_bytes_per_card": int(ring_bytes),
            "padding_inflation": p * per_shard_padded / pair_work,
            "per_shard_padded_pairs": per_shard_padded,
            "block_q": qwidth,
            "per_card_expression_bytes": chunk * n_genes * 4,
            "comm_fraction_of_compute": t_comm / t_comp,
            "predicted_efficiency_serial": t1 / (p * (t_comp + t_comm)),
            "predicted_efficiency": t1 / (p * max(t_comp, t_comm)),
        }
    return out


if __name__ == "__main__":
    main()
