"""50k-cell balanced-kNN benchmark of the port (the reference's
b_sight=3000 / k=500 operating point scaled to 50,000 cells), on one CUDA
device.

    python3 -m velocyto_tpu_torch.bench_knn50k

Port of the JAX package's bench_knn50k.py: 50,000 x 50 points (seed 0),
sight 3000, k=500, maxl 1500, in the JAX script's stages, as the port's
balanced kNN runs them (ops/knn_device.py::balanced_knn_graph_dev), all
on the card: the f32 candidate pass and its row sort, the f64 re-score,
the (distance, index) reorder, the hub order and the greedy balance scan
(the hand kernel kernels/knn_balance.cu).  run_once can also time the
numpy host loop (ops/knn.py::balance_knn_loop_plain, the candidates
copied to the host) on the same candidates, beside the path.  The statistics are
bench_pipeline's: run 0 a warm-up, the headline the true median of the
clean measured runs with min/max beside it.

Prints ONE JSON line and returns the same dict; writes no file.  Raises
without a CUDA device.  VTPU_BENCH_KNN_CELLS, VTPU_BENCH_KNN_REPS and
VTPU_BENCH_PROBE_MS set the module globals when it runs as a script.
"""
import json
import os
import time

import numpy as np
import torch

from .bench_common import (DEVICE_PROBE_MS, card, device_probe, require_card,
                           summarize, sync)
from .ops import knn_device as kd
from .ops.knn import (_candidate_plan, _knn_search_impl,
                      balance_knn_loop_plain)

N = 50000
D, K, SIGHT, MAXL = 50, 500, 3000, 1500
PROBE_MS = DEVICE_PROBE_MS


def points(n, d):
    """The JAX harness's points: Gaussian, axis scales 3 .. 0.3, float32."""
    rng = np.random.RandomState(0)
    return (rng.randn(n, d) @ np.diag(np.linspace(3, 0.3, d))).astype(
        np.float32)


def run_once(x, x64, device="cuda", k=K, sight=SIGHT, maxl=MAXL,
             host_loop=False):
    """One balanced kNN of x (host float32) / x64 (float64 tensor on
    `device`), stage by stage; returns (total seconds, {stage: seconds},
    the balanced (dist, idx, in-degree) tensors).  With host_loop, the
    numpy host greedy loop then balances the same candidates again, copies to
    and from the host included, timed as "balance_loop(host)" beside the
    path and outside its total."""
    stages = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        sync(device)
        stages[name] = time.perf_counter() - t0
        return r

    n, d = x.shape
    kk = min(sight + 1, n)
    k2, blk = _candidate_plan(n, kk)
    t_all = time.perf_counter()
    cand = timed("candidate_sort", lambda: _knn_search_impl(
        torch.as_tensor(x, device=device), k2, blk)[1])
    rb = max(8, min(256, (1 << 25) // max(1, k2 * d)))
    d2 = timed("rescore_f64", lambda: kd._rescore_f64_impl(x64, cand, rb))
    dd, ii = timed("reorder_truncate", lambda: kd._reorder_truncate_impl(
        d2, cand, kk))
    dist = torch.sqrt(dd.clamp_min(0.0))
    lsi = timed("hub_order", lambda: kd._hub_order_impl(ii))
    out = timed("balance_scan", lambda: kd._balance_scan_impl(
        ii, dist, lsi, None, maxl, k))
    total = time.perf_counter() - t_all
    if host_loop:
        def _host():
            dn, di, l = balance_knn_loop_plain(
                ii.cpu().numpy(), dist.cpu().numpy(), lsi.cpu().numpy(),
                maxl, k, True)
            return [torch.as_tensor(a, device=device) for a in (dn, di, l)]
        timed("balance_loop(host)", _host)
    return total, stages, out


def main(reps=6):
    """reps balanced kNNs at N x D on the card (run 0 the warm-up);
    prints and returns the JSON record."""
    require_card()
    x = points(N, D)
    x64 = torch.as_tensor(x.astype(np.float64), device="cuda")

    runs = []
    for rep in range(reps):
        p0 = device_probe()
        total, stages, _out = run_once(x, x64)
        p1 = device_probe()
        clean = max(p0, p1) <= PROBE_MS
        runs.append({"total": total, "stages": stages,
                     "probe_ms": [p0, p1],
                     "clean": clean, "warmup": rep == 0})
        print(f"# run {rep}: {total:.3f}s probes {p0:.4f}/{p1:.4f}ms "
              f"clean={clean} stages={stages}"
              f"{' (warmup, excluded)' if rep == 0 else ''}", flush=True)

    median, totals, n_clean, run_label, med = summarize(runs)
    rec = {
        "metric": "knn_50k_balanced_seconds",
        "value": median,
        "unit": (f"s ({N} cells x {D} dims, sight={SIGHT}, k={K}; search, "
                 f"re-score, hub order and balance on the card; "
                 f"{run_label}, spread {totals[0]}-{totals[-1]})"),
        "n_clean": n_clean,
        "stages": med["stages"],
        "runs": runs,
        "device": torch.cuda.get_device_name(0),
        "card": card(),
        "probe_threshold_ms": PROBE_MS,
        "note": ("run 0 includes the first CUDA use and the kernels' "
                 "build.  The balance is the hand CUDA kernel "
                 "kernels/knn_balance.cu, one block walking the nodes in "
                 "hub order."),
        "exactness": ("matches exact f64 brute force incl. tie-breaks "
                      "(f64 re-score; the CPU tests hold the graph to the "
                      "JAX package's bit for bit)"),
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    N = int(os.environ.get("VTPU_BENCH_KNN_CELLS", N))
    PROBE_MS = float(os.environ.get("VTPU_BENCH_PROBE_MS", PROBE_MS))
    main(int(os.environ.get("VTPU_BENCH_KNN_REPS", 6)))
