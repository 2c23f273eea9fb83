"""Reference-scale end-to-end estimation benchmark of the port, on one
CUDA device.

    python3 -m velocyto_tpu_torch.bench_pipeline

Port of the JAX package's bench_pipeline.py, with its data, stages and
statistics: the full VelocytoLoom pipeline at the reference's documented
operating point (reference doc/tutorial/analysis.rst:109,163-164:
knn_imputation k=500, b_sight=3000, b_maxl=1500; estimate_transition_prob
n_neighbors=3500, sampled_fraction=0.5, randomized control on; grid
(40, 40)) on the synthetic dataset of CELLS x GENES (20000 x 2000, seed
0), with per-stage wall times on the host clock, each stage ending in
torch.cuda.synchronize().

Measurement policy (the JAX harness's, declared up front):
  - run 0 is ALWAYS a warmup and never enters the statistic: it pays
    per-process costs the steady state does not (the first CUDA context
    use and kernel builds, first-touch page faults on every large buffer
    before the allocators recycle them).
  - the headline is the TRUE median (statistics.median) of the clean
    measured runs (default reps=6 -> 1 warmup + 5 measured), with min/max
    spread alongside.
  - a run is clean when the D=50 distance-matmul probe on the card AND
    the host-BLAS probe bracketing it stay under threshold (a shared card
    runs identical work several times slower in contended phases, and
    the host cores stall too).

Prints ONE JSON line and returns the same dict; writes no file.  Raises
without a CUDA device.  The JAX harness's VTPU_BENCH_PIPE_* variables
(and VTPU_BENCH_PROBE_MS, VTPU_BENCH_HOST_PROBE_MS) set the module
globals when it runs as a script.
"""
import json
import os
import time

import numpy as np
import torch

from .analysis import VelocytoLoom
from .bench_common import (DEVICE_PROBE_MS, HOST_PROBE_MS, card,
                           device_probe, host_probe, require_card, summarize,
                           sync)

CELLS = 20000
GENES = 2000
K = 500
B_SIGHT = 3000
B_MAXL = 1500
N_NEIGHBORS = 3500
SAMPLED_FRACTION = 0.5
RANDOMIZED = True
PROBE_MS = DEVICE_PROBE_MS


def synth(rng, n, g):
    """The JAX harness's generator: U ~ Poisson(0.4 gamma * base + 0.05),
    S ~ Poisson(base) over a rank-12 cell manifold; (genes, cells)
    float32."""
    gamma_true = rng.uniform(0.2, 1.2, g)
    # low-rank structure so the PCA/kNN stages see realistic manifolds
    k_lat = 12
    zl = rng.gamma(2.0, 1.0, (n, k_lat))
    wl = rng.gamma(2.0, 1.0, (k_lat, g))
    base = (zl @ wl) * rng.uniform(0.05, 0.6, g)[None, :]
    S = rng.poisson(base).astype(np.float32).T
    U = rng.poisson(0.4 * gamma_true[:, None] * base.T + 0.05).astype(
        np.float32)
    return S, U


def run_once(S, U, device="cuda", knn_random=True, mesh=None):
    """One pass of the pipeline on `device` through the VelocytoLoom entry
    points.  Returns (total seconds, {stage: seconds}, the VelocytoLoom).
    knn_random=False runs the transition stage in full mode.  mesh: a
    parallel.Mesh the loom splits its cells over (its first device then
    stands for `device`)."""
    stages = {}
    t_all = time.perf_counter()
    v = VelocytoLoom.__new__(VelocytoLoom)
    if mesh is not None:
        device = mesh.first_device
    v.device = torch.device(device)
    v.mesh = mesh

    def stage(name, fn):
        t0 = time.perf_counter()
        # the stage's host range, for a profile taken around the run
        with torch.profiler.record_function(name):
            out = fn()
            sync(device)
        dt = time.perf_counter() - t0
        stages[name] = dt
        print(f"# {name}: {dt:.3f}s", flush=True)
        return out

    v.S, v.U, v.A = S.copy(), U.copy(), np.zeros_like(S)
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    v.ca = {"CellID": np.array([f"c{i}" for i in range(S.shape[1])])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(S.shape[0])])}

    def _norm():
        # _normalize_S(log=True) computes S_norm = log2(S_sz + 1) itself
        v._normalize_S(relative_size=v.initial_cell_size,
                       target_size=np.mean(v.initial_cell_size))
        v._normalize_U(relative_size=v.initial_Ucell_size,
                       target_size=np.mean(v.initial_Ucell_size))
    stage("normalize", _norm)
    stage("pca", lambda: v.perform_PCA(which="S_norm", n_components=50))
    stage("knn_imputation(k=%d,sight=%d)" % (K, B_SIGHT),
          lambda: v.knn_imputation(k=K, balanced=True, b_sight=B_SIGHT,
                                   b_maxl=B_MAXL, n_jobs=16))
    stage("fit_gammas", lambda: v.fit_gammas())

    def _vel():
        v.predict_U()
        v.calculate_velocity()
        v.calculate_shift(assumption="constant_velocity")
        v.extrapolate_cell_at_t(delta_t=1.)
    stage("velocity", _vel)
    v.ts = np.ascontiguousarray(v.pcs[:, :2])
    stage("transition_prob(nn=%d,frac=%.1f,rand=%s)" % (
        N_NEIGHBORS, SAMPLED_FRACTION, RANDOMIZED),
        lambda: v.estimate_transition_prob(
            hidim="Sx_sz", embed="ts", transform="sqrt",
            knn_random=knn_random, n_neighbors=N_NEIGHBORS,
            sampled_fraction=SAMPLED_FRACTION,
            calculate_randomized=RANDOMIZED))
    stage("embedding_shift",
          lambda: v.calculate_embedding_shift(sigma_corr=0.05,
                                              expression_scaling=False))
    stage("grid_arrows",
          lambda: v.calculate_grid_arrows(smooth=0.5, steps=(40, 40),
                                          n_neighbors=100))
    total = time.perf_counter() - t_all
    if not np.all(np.isfinite(v.delta_embedding)):
        raise RuntimeError("non-finite delta_embedding")
    return total, stages, v


def main(reps=6):
    """reps runs of the pipeline on the card (run 0 the warm-up); prints
    and returns the JSON record."""
    require_card()
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    S, U = synth(rng, CELLS, GENES)
    synth_s = time.perf_counter() - t0
    print(f"# synthesize: {synth_s:.3f}s", flush=True)

    runs = []
    for rep in range(reps):
        p_before, h_before = device_probe(), host_probe()
        total, stages, _v = run_once(S, U)
        del _v
        p_after, h_after = device_probe(), host_probe()
        clean = max(p_before, p_after) <= PROBE_MS and \
            max(h_before, h_after) <= HOST_PROBE_MS
        runs.append({"total": total, "stages": stages,
                     "probe_ms": [p_before, p_after],
                     "host_probe_ms": [h_before, h_after],
                     "clean": clean,
                     "warmup": rep == 0})
        print(f"# run {rep}: {total:.3f}s probes "
              f"{p_before:.4f}/{p_after:.4f}ms host "
              f"{h_before:.1f}/{h_after:.1f}ms clean={clean}"
              f"{' (warmup, excluded)' if rep == 0 else ''}", flush=True)

    median, totals, n_clean, run_label, med_run = summarize(runs)
    kind = torch.cuda.get_device_name(0)
    result = {
        "metric": "pipeline_seconds_end_to_end",
        "value": median,
        "unit": f"s ({CELLS} cells x {GENES} genes, k={K}, "
                f"b_sight={B_SIGHT}, nn={N_NEIGHBORS}; {run_label}, "
                f"spread {totals[0]}-{totals[-1]})",
        "backend": "cuda",
        "device": kind,
        "card": card(),
        "probe_thresholds_ms": {"device": PROBE_MS, "host": HOST_PROBE_MS},
        "stages": med_run["stages"],
        "synthesize_fixture_seconds": synth_s,
        "runs": runs,
        "min_total": totals[0],
        "max_total": totals[-1],
        "n_clean": n_clean,
        "cells_per_sec_end_to_end": CELLS / median,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    env = os.environ
    CELLS = int(env.get("VTPU_BENCH_PIPE_CELLS", CELLS))
    GENES = int(env.get("VTPU_BENCH_PIPE_GENES", GENES))
    K = int(env.get("VTPU_BENCH_PIPE_K", K))
    B_SIGHT = int(env.get("VTPU_BENCH_PIPE_BSIGHT", B_SIGHT))
    B_MAXL = int(env.get("VTPU_BENCH_PIPE_BMAXL", B_MAXL))
    N_NEIGHBORS = int(env.get("VTPU_BENCH_PIPE_NN", N_NEIGHBORS))
    RANDOMIZED = env.get("VTPU_BENCH_PIPE_RANDOMIZED", "1") == "1"
    PROBE_MS = float(env.get("VTPU_BENCH_PROBE_MS", PROBE_MS))
    HOST_PROBE_MS = float(env.get("VTPU_BENCH_HOST_PROBE_MS", HOST_PROBE_MS))
    main(int(env.get("VTPU_BENCH_PIPE_REPS", 6)))
