"""Smoke run of velocyto_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels from this checkout, holds each against its plain PyTorch version
on the card, times both, then drives the estimation pipeline end to end
at 20,000 cells x 2,000 genes through the VelocytoLoom entry points and
checks what comes out.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (CUDA_HOME or the default toolkit path);
imports nothing of JAX.  Exits non-zero, via an uncaught exception, on
any failed phase; the last line of stdout is a JSON verdict printed only
after every phase passed.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CELLS, GENES = 20000, 2000
K, B_SIGHT, B_MAXL, N_NEIGHBORS = 500, 3000, 1500, 3500
RTOL, ATOL = 2e-3, 2e-4          # the JAX tests' colDeltaCor tolerances
SPOT_ROWS = 256
DEVICE = "cuda"


def synth(rng, n, g):
    """bench_pipeline.py's synthetic generator, also returning the true
    degradation rates: U ~ Poisson(0.4 gamma * base), S ~ Poisson(base)
    over a rank-12 cell manifold."""
    gamma_true = rng.uniform(0.2, 1.2, g)
    k_lat = 12
    zl = rng.gamma(2.0, 1.0, (n, k_lat))
    wl = rng.gamma(2.0, 1.0, (k_lat, g))
    base = (zl @ wl) * rng.uniform(0.05, 0.6, g)[None, :]
    S = rng.poisson(base).astype(np.float32).T
    U = rng.poisson(0.4 * gamma_true[:, None] * base.T + 0.05).astype(
        np.float32)
    return S, U, gamma_true


def phase(name):
    print(f"# --- {name}", flush=True)


def device_phase():
    phase("device")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is False)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"# device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    print(f"# nvidia-smi: {smi}")
    print(f"# allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    return name, smi


def build_phase():
    from velocyto_tpu_torch import kernels
    phase("build")
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"# build: {time.perf_counter() - t0:.3f} s -> {lib.name}")
    print(kernels.build_log.strip(), flush=True)


def _inputs(g, n, seed):
    rng = np.random.RandomState(seed)
    e = torch.tensor(rng.rand(g, n) * 10, dtype=torch.float32, device="cuda")
    d = torch.tensor(rng.randn(g, n), dtype=torch.float32, device="cuda")
    return e, d


def _off_diag_err(got, want):
    """max |got - want| off the diagonal (0/0 by construction), and
    whether every off-diagonal entry is within RTOL/ATOL."""
    off = ~torch.eye(got.shape[0], dtype=torch.bool, device=got.device)
    diff = (got - want).abs()[off]
    ok = bool(torch.all(diff <= ATOL + RTOL * want.abs()[off]))
    return float(diff.max()), ok


def _time_ms(fn):
    """(milliseconds on the card, result) of one call, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def kernel_phase(smi):
    from velocyto_tpu_torch.ops.coldeltacor import (
        _TRANSFORMS, _col_delta_cor_dense_plain, col_delta_cor)
    phase("kernel against plain, on the card")
    cases = [("linear", 0.0, False), ("sqrt", 0.0, False),
             ("sqrt", 1e-10, False), ("sqrt", 1.0, False),
             ("log10", 1.0, False), ("sqrt", 1e-10, True),
             ("log10", 1.0, True)]
    for g, n in ((37, 29), (2000, 2048)):
        e, d = _inputs(g, n, seed=g)
        for tf, psc, partial in cases:
            got = col_delta_cor(e, d, tf, psc, partial_semantics=partial)
            torch.cuda.synchronize()
            want = _col_delta_cor_dense_plain(e, d, _TRANSFORMS[tf], psc,
                                              partial)
            err, ok = _off_diag_err(got, want)
            print(f"# check G={g} N={n} {tf} psc={psc} "
                  f"{'partial' if partial else 'full'}: max_abs_err={err!r}"
                  f" ok={ok}", flush=True)
            assert ok, f"kernel disagrees with plain: {tf} {psc} {partial}"

    # the main path's shape and configuration: sqrt, psc 1e-10, full
    e, d = _inputs(GENES, CELLS, seed=1)
    tcode = _TRANSFORMS["sqrt"]
    ms, got, plain_ms, want = [], None, [], None
    for _ in range(3):                  # in turns: kernel, plain, ...
        got = want = None
        t, got = _time_ms(lambda: col_delta_cor(e, d, "sqrt", 1e-10))
        ms.append(t)
        t, want = _time_ms(
            lambda: _col_delta_cor_dense_plain(e, d, tcode, 1e-10))
        plain_ms.append(t)
    err, ok = _off_diag_err(got, want)
    ms, plain_ms = statistics.median(ms), statistics.median(plain_ms)
    print(f"# time G={GENES} N={CELLS} sqrt psc=1e-10 on {smi}: kernel "
          f"{ms!r} ms, plain {plain_ms!r} ms (median of 3, CUDA events); "
          f"max_abs_err={err!r} ok={ok}", flush=True)
    assert ok, "kernel disagrees with plain at the main path's shape"
    del got, want
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}


def _brute_knn(x, rows, k):
    """Host f64 brute-force kNN of x[rows] ordered by (distance, index)."""
    out = []
    for lo in range(0, len(rows), 32):
        r = rows[lo:lo + 32]
        diff = x[None, :, :] - x[r, None, :]
        d2 = np.einsum("nkd,nkd->nk", diff, diff)
        cols = np.arange(x.shape[0])
        for row in d2:
            out.append(np.lexsort((cols, row))[:k])
    return np.stack(out)


def pipeline_phase():
    import velocyto_tpu_torch as vtt
    from scipy.stats import spearmanr
    from velocyto_tpu_torch import kernels
    from velocyto_tpu_torch.ops import knn_device as kd
    phase(f"pipeline {CELLS} cells x {GENES} genes")
    t0 = time.perf_counter()
    S, U, gamma_true = synth(np.random.RandomState(0), CELLS, GENES)
    print(f"# synthesize: {time.perf_counter() - t0:.3f} s", flush=True)

    v = vtt.VelocytoLoom.__new__(vtt.VelocytoLoom)
    v.device = torch.device(DEVICE)
    v.S, v.U, v.A = S, U, np.zeros_like(S)
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    v.ca = {"CellID": np.array([f"c{i}" for i in range(CELLS)])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(GENES)])}
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t
        print(f"# stage {name}: {stages[name]:.3f} s", flush=True)

    def _norm():
        v._normalize_S(relative_size=v.initial_cell_size,
                       target_size=np.mean(v.initial_cell_size))
        v._normalize_U(relative_size=v.initial_Ucell_size,
                       target_size=np.mean(v.initial_Ucell_size))

    def _vel():
        v.predict_U()
        v.calculate_velocity()
        v.calculate_shift(assumption="constant_velocity")
        v.extrapolate_cell_at_t(delta_t=1.)

    launches = {}

    def _transition():
        before = kernels.dense_launches
        v.estimate_transition_prob(
            hidim="Sx_sz", embed="ts", transform="sqrt", knn_random=False,
            n_neighbors=N_NEIGHBORS, calculate_randomized=True)
        launches["transition"] = kernels.dense_launches - before

    torch.cuda.reset_peak_memory_stats()
    kernels.dense_launches = 0          # count the main path's launches only
    t_all = time.perf_counter()
    stage("normalize", _norm)
    stage("pca", lambda: v.perform_PCA(which="S_norm", n_components=50))
    stage("knn_imputation", lambda: v.knn_imputation(
        k=K, balanced=True, b_sight=B_SIGHT, b_maxl=B_MAXL))
    stage("fit_gammas", lambda: v.fit_gammas())
    stage("velocity", _vel)
    v.ts = np.ascontiguousarray(v.pcs[:, :2])
    stage("transition_prob", _transition)
    stage("embedding_shift", lambda: v.calculate_embedding_shift(
        sigma_corr=0.05, expression_scaling=False))
    stage("grid_arrows", lambda: v.calculate_grid_arrows(
        smooth=0.5, steps=(40, 40), n_neighbors=100))
    total = time.perf_counter() - t_all
    main_launches = kernels.dense_launches
    peak = torch.cuda.max_memory_allocated()
    print(f"# pipeline total: {total:.3f} s; dense kernel launches "
          f"{main_launches} (transition stage {launches['transition']}); "
          f"peak device memory {peak / 2**30:.2f} GiB", flush=True)

    phase("checks")
    assert launches["transition"] == 2 and main_launches == 2, \
        f"expected 2 dense kernel launches, got {launches}, {main_launches}"
    for name in ("delta_embedding", "delta_embedding_random", "flow"):
        assert np.all(np.isfinite(getattr(v, name))), f"{name} not finite"
    corr = v._get_dev("corrcoef")           # diagonal already set to 0
    assert corr.shape == (CELLS, CELLS) and bool(torch.isfinite(corr).all())
    assert bool(torch.isfinite(v._get_dev("corrcoef_random")).all())
    rho = float(spearmanr(v.gammas, gamma_true).correlation)
    med, want = float(np.median(v.gammas)), 0.4 * float(np.median(gamma_true))
    print(f"# gammas: spearman {rho!r} vs truth; median {med!r} vs "
          f"0.4*median(truth) {want!r}", flush=True)
    assert rho > 0.9, f"gamma spearman {rho}"
    assert abs(med - want) <= 0.25 * want, f"gamma median {med} vs {want}"

    rows = np.random.RandomState(1).choice(CELLS, SPOT_ROWS, replace=False)
    kk = B_SIGHT + 1                        # the balanced search's width
    _d, idx = kd.knn_search_dev(v.pcs, kk, device=v.device)
    got = idx[torch.as_tensor(rows, device=idx.device)].cpu().numpy()
    want_idx = _brute_knn(np.asarray(v.pcs, np.float64), rows, kk)
    n_bad = int(np.sum(np.any(got != want_idx, axis=1)))
    print(f"# knn spot check: {SPOT_ROWS} rows x {kk} neighbours, "
          f"{n_bad} rows differ from host f64 brute force", flush=True)
    assert n_bad == 0, "kNN rows differ from the f64 brute force"
    return stages, total, main_launches


def main():
    _card, smi = device_phase()
    build_phase()
    timing = kernel_phase(smi)
    stages, total, launches = pipeline_phase()
    print(json.dumps({"pipeline_s": total, "stages_s": stages}))
    print(json.dumps({"kernels": [{
        "name": "coldeltacor_dense", "route": "cuda",
        "source": "velocyto_tpu_torch/kernels/coldeltacor_dense.cu",
        "replaces": "velocyto_tpu/ops/coldeltacor.py:89",
        "launches": launches, "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
