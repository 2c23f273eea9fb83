"""Smoke run of velocyto_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels and the host sampler from this checkout, holds each kernel
against its plain PyTorch version on the card and times both, checks the
neighbour sampler against numpy, then drives four paths and checks what
comes out:

  - the estimation pipeline in full-correlation mode (knn_random=False,
    one dual launch of the dense colDeltaCor kernel for the main field
    and the randomized control) at 20,000 cells x 2,000 genes, through
    velocyto_tpu_torch.bench_pipeline.run_once (the JAX harness's
    stages);
  - the pipeline in its default mode (knn_random=True), in
    bench_pipeline.py's configuration: the transition stage consumes the
    neighbour-sampling replay in 4 row chunks, one dual launch of the
    sampled colDeltaCor kernel per chunk (each chunk's cells in
    embedding-locality order), and permutes the randomized control on
    the card.  Its compact correlations must equal one unchunked dual
    launch on the same neighbours, delta_S_rndm permute_rows_nsign on
    the same float32 rows, sampling_ixs and numpy's state the numpy
    loop's, all bitwise, and no (genes, cells) tensor may be copied to
    the host in the call; the chunk launches are timed against the
    single launch, the single launch with the identity order against
    the locality order (outputs bitwise equal), the ring's flat kernel
    on the same indices planned over 2 shards (table order and locality
    order, each bitwise equal to one sampled launch), and the device
    permutation alone; the session's device
    tensors, host arrays and metadata are checkpointed (io.checkpoint)
    and reloaded on the card, bitwise; then the public surface on that
    session (knn_search at k=500 on its PCA space, bitwise
    knn_search_dev's rows and the f64 brute force on sampled rows;
    BalancedKNN(k=500, sight_k=3000, maxl=1500) on the native loop of
    native/balance.cpp, bitwise the numpy loop and the balance kernels
    on the same candidates, both loops timed;
    col_delta_cor_partial_compact_dev on the session's compact neighbour
    ids, one single-field sampled launch, bitwise the session's
    correlations; smooth_dev; every attribute the plot_* methods read,
    and the plots themselves on Agg where matplotlib imports);
  - both pipelines again under torch.profiler (utils.profiling.trace):
    the device's idle share over the pipeline and its transition stage,
    the five device kernels that took the most time, the profiled total
    beside the unprofiled one;
  - the port's bench harnesses at reduced repeats: bench_pipeline (3
    runs, one dual sampled launch per replay chunk, the JAX harness's
    stage names),
    bench_attr (the transition stage's and the 50k kNN's sub-stages, the
    idle share over one whole transition call) and bench_knn50k (2 runs
    at 50,000 cells);
  - the kernel bench, python3 -m velocyto_tpu_torch.bench (sampled and
    dense kernels, FMA-chain probe);
  - the tutorial session at 20,000 cells x 2,500 raw genes: the
    detection and cluster gene filters, normalize_by_total and the
    median renormalizations, PCA, balanced kNN imputation, the gamma fit
    without offset, the phase-portrait filter, the velocity chain, the
    sampled transition probabilities with expression scaling, the grid
    field, prepare_markov / run_markov over every cell; then the fused
    velocity_step on the session's state against the step-by-step chain,
    and the six estimation.colDeltaCor* shims against their plain
    versions (h5py and matplotlib are not called);
  - the reference's heuristic session at 20,000 cells x 12,000 raw genes
    (the tutorial generator plus 10,000 background genes):
    default_filter_and_norm (the CV-vs-mean and totals SVR fits on the
    card), default_fit_preparation, fit_gammas, the velocity chain,
    perform_TSNE on 25 principal components, the sampled transition
    probabilities on the t-SNE embedding, the embedding shift and the
    grid field.

After the default-mode pipeline, the kNN balance kernels (the walk,
which writes acceptance bits, and the decode, which turns them into the
balanced rows) are held bitwise (dsi_new, dist_new, the in-degrees l)
against the plain scan, the host greedy loop and the other l route
(shared or global memory) on the pipeline's own candidates (20,000 x
3,001, k=500, maxl 1,500) and on bench_knn50k's (50,000 x 3,001), and in
four hard regimes: at 20,000 cells 12 groups (the labels beside l and
staged through the ring), maxl == k, and a small maxl that exhausts
sights, so rows self-fill; at 50,000 cells maxl == k, where most rows
read past the staged depth T.  The decode is held against its plain
twin on the walk's bits; both walker counts and every ring length give
the same result; l never passes maxl and equals the in-degree of
dsi_new; the kernels, the plain versions and the host loop with and
without its copies are timed, and a probe of the node-to-node chain
alone gives the latency floor.  Every path that balances shows one walk
and one decode.

Each of the two pipelines runs again with a mesh (parallel.make_mesh):
two shards on the card, each on its own stream (one shard a card where
there are several), through the same entry points (run_once(...,
mesh=)).  The mesh run must equal the mesh=None run on the same inputs
bitwise: the kNN graph, the transition probabilities, delta_embedding
and its control; in the default mode the sampled neighbours, both
compact correlations, sampling_ixs and numpy's state after the call (one
dual sampled launch a shard); in full mode both dense corrcoefs (one
dual center-range launch of the dense kernel a shard).  After the tutorial
session, the sharded velocity_step (genes split, one all-to-all, one
sampled launch a shard) runs on the session's state against the
unsharded step; at the end, the dense kernel's center ranges are held
bitwise to the whole launch, the forced ring at 20,000 cells without and
with a center order (2 x P x P flat launches; the call without an
order profiled, its pieces read from its vtt.ring.* spans) bitwise
against one sampled
launch, the flat kernel against its plain twin on every table of that
ring, and bench_scaling runs the sharded and
ring calls at 1, 2 and 4 shards.  The counting phase also runs
count_distributed (4 feeders, merged over the mesh), bitwise the serial
count.

Before the paths, the counting pipeline runs on the host (no kernel):
native/bam.cpp is built from the checkout and asserted loaded, the
tracked counting fixture is held bitwise to counting_golden.npz for
every logic with and without the repeat mask, the chr UMI extension and
discovery mode, and bench_counting's fixture (250,000 reads, 400 cells,
64 genes) is written, cell-sorted by the native sorter and counted by
the SoA engine on the native reader, bitwise against object mode on the
pure-Python reader and against pcount on 4 spawned workers; its reads/s
are printed beside the card and the host CPU.

Then the SVR solver kernel (a thread-block cluster holding
its state in shared memory at the session's sizes) is held bitwise
against its plain version and against its global-memory route on a
small, a CV-vs-mean-shaped and a totals-shaped fit at full size, and a
totals fit of 50,000 cells runs on the global-memory route (the
per-iteration synchronisation timed alone gives the latency floor); the
t-SNE gradient kernel is held against the
dense plain gradient at 20,000 points in 1, 2 and 3 dimensions, two calls
bitwise equal, its pair and attractive passes timed apart; a
1,000-iteration t-SNE is timed, and a short perform_TSNE(n_dims=3) runs
through the kernel.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA_HOME or the default toolkit path) and a
host C++ compiler with zlib; imports nothing of JAX.  Exits non-zero, via an
uncaught exception, on any failed phase; the last line of stdout is a
JSON verdict printed only after every phase passed.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark.roofline import PEAK_BYTES, PEAK_FP32

CELLS, GENES = 20000, 2000
K, B_SIGHT, B_MAXL, N_NEIGHBORS = 500, 3000, 1500, 3500
# the tutorial session: GENES expressed genes plus a block of LOW_GENES
# barely detected ones, cells in N_CLUSTERS clusters of the latent factors
LOW_GENES, N_CLUSTERS, MARKOV_STEPS = 500, 12, 2500
SHIM_CELLS, SHIM_NN = 3072, 512      # bench.py's shapes, for the shims
# the heuristic session: the tutorial generator plus BG_GENES background
# genes that pass the detection filter, so the CV-vs-mean SVR fits more
# than 10,000 genes; t-SNE on TSNE_PCS principal components
BG_GENES, TSNE_PCS, TSNE_PERPLEXITY = 10000, 25, 30.0
SVR_CV_MIN = 10000                   # genes the session's CV fit must see
SVR_CV_N = 12000                     # the CV-vs-mean-shaped SVR check
SVR_RTOL = 1e-6                      # SVR predictions, kernel against plain
SVR_SYNC_REPS = 20000                # rounds of the SVR sync probe
SVR_GLOBAL_N = 50000                 # a totals fit beyond shared memory
SVR_GAP_SLACK = 1.01                 # recomputed stopping gap over tol
# the short three-dimensional perform_TSNE: points and iterations
TSNE3_CELLS, TSNE3_ITER = 3000, 300
# t-SNE gradient, kernel against plain: rtol, and an atol of TSNE_ATOL or
# TSNE_ATOL_REL of the case's largest component, whichever is smaller
TSNE_RTOL, TSNE_ATOL, TSNE_ATOL_REL = 1e-4, 1e-6, 1e-5
# H100 SXM data sheet: FP64 outside the tensor cores
PEAK_FP64 = 34e12
SAMPLED_FRACTION = 0.5
NN_SAMPLED = int(SAMPLED_FRACTION * (N_NEIGHBORS + 1))     # 1750
RTOL, ATOL = 2e-3, 2e-4          # the JAX tests' colDeltaCor tolerances
# H100 SXM data sheet (FP32 and HBM3 peaks: benchmark/roofline.py): the
# SFU rate is 16 MUFU ops per SM per clock at the 1.98 GHz boost clock
PEAK_MUFU = 16 * 132 * 1.98e9
FMA_RTOL = 1e-5                  # one rounding per step against two
SPOT_ROWS = 256
DENSE_CHECK_SHAPES = ((37, 29), (2000, 2048))   # (G, N) of the dense checks
DEVICE = "cuda"
# the (cells, cells) attributes, which the pipelines keep as rows
DENSE_VIEWS = ("corrcoef", "corrcoef_random", "transition_prob",
               "transition_prob_random")
# the JAX harness's stage names at this operating point
# (bench_pipeline.py:98-122); the port's harness keeps them
PIPELINE_STAGES = ["normalize", "pca", "knn_imputation(k=500,sight=3000)",
                   "fit_gammas", "velocity",
                   "transition_prob(nn=3500,frac=0.5,rand=True)",
                   "embedding_shift", "grid_arrows"]
BENCH_PIPE_REPS, KNN50K_REPS = 3, 2   # one warm-up run each, then measured
# the balance kernel's hard regimes at 20,000 cells: groups of the
# constrained case, and the small cap that exhausts sights
BALANCE_GROUPS, BALANCE_SMALL_MAXL = 12, 50
KNN50K_CELLS, KNN50K_DIMS = 50000, 50  # bench_knn50k's points
PROFILE_TOP = 5                       # device kernels printed per profile
# the transform/psc cases of the kernel checks (partial semantics are
# the sampled kernel's only semantics)
CASES = [("linear", 0.0, False), ("sqrt", 0.0, False),
         ("sqrt", 1e-10, False), ("sqrt", 1.0, False),
         ("log10", 1.0, False), ("sqrt", 1e-10, True),
         ("log10", 1.0, True)]


def synth(rng, n, g):
    """bench_pipeline.py's synthetic generator, also returning the true
    degradation rates and the (n, 12) latent cell factors: U ~ Poisson(0.4
    gamma * base), S ~ Poisson(base) over a rank-12 cell manifold."""
    gamma_true = rng.uniform(0.2, 1.2, g)
    k_lat = 12
    zl = rng.gamma(2.0, 1.0, (n, k_lat))
    wl = rng.gamma(2.0, 1.0, (k_lat, g))
    base = (zl @ wl) * rng.uniform(0.05, 0.6, g)[None, :]
    S = rng.poisson(base).astype(np.float32).T
    U = rng.poisson(0.4 * gamma_true[:, None] * base.T + 0.05).astype(
        np.float32)
    return S, U, gamma_true, zl


_START = time.perf_counter()


def phase(name):
    print(f"# --- {name} (at {time.perf_counter() - _START:.1f} s)",
          flush=True)


def device_phase():
    phase("device")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is False)")
    from velocyto_tpu_torch.bench_common import card
    name = torch.cuda.get_device_name(0)
    smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"# device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    print(f"# nvidia-smi: {smi}")
    print(f"# allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    return name, smi


def _sass(lib):
    """The SASS of a kernel library, or None where the toolkit has no
    cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def _ffma_count(lib):
    """FFMA instructions in the SASS of the FMA probe's library, or None
    where the toolkit has no cuobjdump."""
    sass = _sass(lib)
    if sass is None:
        return None
    return sum(" FFMA " in line for line in sass.splitlines())


def _short_name(mangled):
    """coldeltacor_dense_kernel<1,0,1> from a mangled kernel name."""
    m = re.search(r"\d+([A-Za-z]\w*?_kernel)I(\w*?)EEv", mangled)
    if not m:
        return mangled
    args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))
    return f"{m.group(1)}<{args}>"


def _ptxas_usage(log):
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    -Xptxas -v output of a build."""
    usage, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = _short_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name] = (int(m.group(1)),) + spills
            spills = (0, 0)
    return usage


def _mufu_counts(lib):
    """{kernel: {MUFU op: count}} in the SASS of a library, or None where
    the toolkit has no cuobjdump."""
    sass = _sass(lib)
    if sass is None:
        return None
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = _short_name(m.group(1))
            counts[name] = {}
        m = re.search(r"\bMUFU\.(\w+)", line)
        if m and name:
            counts[name][m.group(1)] = counts[name].get(m.group(1), 0) + 1
    return counts


def build_phase():
    from velocyto_tpu_torch import kernels, native
    phase("build")
    t0 = time.perf_counter()
    libs = kernels.build()             # one nvcc per source, in parallel
    sampler = native.build()
    print(f"# build: {time.perf_counter() - t0:.3f} s -> "
          f"{sorted(p.name for p in libs.values())}, {sampler.name}")
    print(kernels.build_log.strip(), flush=True)
    usage = _ptxas_usage(kernels.build_log)
    for name, (regs, st, ld) in sorted(usage.items()):
        print(f"# ptxas {name}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B", flush=True)
    spilled = {k: v for k, v in usage.items() if v[1] or v[2]}
    assert not spilled, f"kernels spill registers: {spilled}"
    # the step of every colDeltaCor kernel: one MUFU.SQRT (sqrt) or
    # MUFU.LG2 (log10) per (pair, gene); RSQ and RCP are the per-pair
    # epilogue's IEEE sqrt and division
    for stem in ("coldeltacor_dense", "coldeltacor_partial"):
        for name, ops in sorted((_mufu_counts(libs[stem]) or {}).items()):
            print(f"# SASS {name}: MUFU {ops}", flush=True)
    ffma = _ffma_count(libs["fma_probe"])
    print(f"# fma_probe SASS: {ffma} FFMA instructions (8 chains x 128 "
          f"steps = 1024 expected)", flush=True)
    assert ffma is None or ffma >= 1024, f"probe folded: {ffma} FFMA"


def _err(got, want, mask=None):
    """max |got - want| (over mask), and whether every entry is within
    RTOL/ATOL with NaNs in the same places."""
    if mask is not None:
        got, want = got[mask], want[mask]
    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    fin = ~torch.isnan(want)
    diff = (got[fin] - want[fin]).abs()
    ok = same_nan and bool(torch.all(diff <= ATOL + RTOL * want[fin].abs()))
    return (float(diff.max()) if diff.numel() else 0.0), ok


def _device_backed(v):
    """{name: tensor} of the loom's device-backed attributes (its table's
    device entries)."""
    from velocyto_tpu_torch.analysis import _Device
    return {name: v._get_dev(name, None) for name, entry in
            v._table().items() if isinstance(entry, _Device)}


def _bitwise(a, b):
    """Same shape and the same 32-bit patterns (NaNs included)."""
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))


def _time_ms(fn):
    """(milliseconds on the card, result) of one call, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def _in_turns(kernel_fn, plain_fn, n=3):
    """Median ms of kernel and plain over n calls each, in turns, and the
    last results."""
    ms, plain_ms = [], []
    got = want = None
    for _ in range(n):
        got = want = None
        t, got = _time_ms(kernel_fn)
        ms.append(t)
        t, want = _time_ms(plain_fn)
        plain_ms.append(t)
    return statistics.median(ms), statistics.median(plain_ms), got, want


def _dual_matches_singles(e, d, d2, tf, psc, partial):
    """One dual dense launch against two single launches: whether they
    agree bitwise, the dual launch's ms and the first single one's."""
    from velocyto_tpu_torch.ops.coldeltacor import col_delta_cor
    dual_ms, (main, rndm) = _time_ms(lambda: col_delta_cor(
        e, d, tf, psc, partial_semantics=partial, dmat_random=d2))
    single_ms, one = _time_ms(lambda: col_delta_cor(
        e, d, tf, psc, partial_semantics=partial))
    two = col_delta_cor(e, d2, tf, psc, partial_semantics=partial)
    return _bitwise(main, one) and _bitwise(rndm, two), dual_ms, single_ms


def _with_clocks(fn):
    """fn() while nvidia-smi samples the SM clock and the power draw every
    100 ms; returns (fn's result, [(MHz, W), ...])."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.5)                 # let the sampler start
        out = fn()
    finally:
        smi.terminate()
        lines = smi.communicate()[0].splitlines()
    samples = []
    for line in lines:
        try:
            mhz, watts = (float(v) for v in line.split(","))
        except ValueError:              # "[N/A]" or a cut line
            continue
        samples.append((mhz, watts))
    return out, samples


def dense_phase(smi):
    from velocyto_tpu_torch.ops.coldeltacor import (
        _TRANSFORMS, _col_delta_cor_dense_plain, col_delta_cor)
    phase("dense kernel against plain, dual against single, on the card")
    for g, n in DENSE_CHECK_SHAPES:
        rng = np.random.RandomState(g)
        e = torch.tensor(rng.rand(g, n) * 10, dtype=torch.float32,
                         device=DEVICE)
        d = torch.tensor(rng.randn(g, n), dtype=torch.float32, device=DEVICE)
        d2 = torch.tensor(rng.randn(g, n), dtype=torch.float32, device=DEVICE)
        off = ~torch.eye(n, dtype=torch.bool, device=DEVICE)
        for tf, psc, partial in CASES:
            got = col_delta_cor(e, d, tf, psc, partial_semantics=partial)
            torch.cuda.synchronize()
            want = _col_delta_cor_dense_plain(e, d, _TRANSFORMS[tf], psc,
                                              partial)
            err, ok = _err(got, want, off)
            bitwise = _dual_matches_singles(e, d, d2, tf, psc, partial)[0]
            print(f"# check G={g} N={n} {tf} psc={psc} "
                  f"{'partial' if partial else 'full'}: max_abs_err={err!r}"
                  f" ok={ok}; dual vs two single calls bitwise={bitwise}",
                  flush=True)
            assert ok, f"kernel disagrees with plain: {tf} {psc} {partial}"
            assert bitwise, f"dual differs from single: {tf} {psc} {partial}"

    # the full-mode path's shape: every case dual against single, then
    # the path's configuration (sqrt, psc 1e-10) against plain and timed
    rng = np.random.RandomState(1)
    e = torch.tensor(rng.rand(GENES, CELLS) * 10, dtype=torch.float32,
                     device=DEVICE)
    d = torch.tensor(rng.randn(GENES, CELLS), dtype=torch.float32,
                     device=DEVICE)
    d2 = torch.tensor(rng.randn(GENES, CELLS), dtype=torch.float32,
                      device=DEVICE)

    def _all_cases():
        for tf, psc, partial in CASES:
            bitwise, dual_ms, single_ms = _dual_matches_singles(
                e, d, d2, tf, psc, partial)
            print(f"# dual vs two single calls G={GENES} N={CELLS} {tf} "
                  f"psc={psc} {'partial' if partial else 'full'}: "
                  f"bitwise={bitwise}; dual {dual_ms!r} ms, single "
                  f"{single_ms!r} ms (one call each, CUDA events)",
                  flush=True)
            assert bitwise, f"dual differs from single at 20k: {tf} {psc}"
            torch.cuda.empty_cache()

    _, clocks = _with_clocks(_all_cases)
    if clocks:
        mhz, watts = zip(*clocks)
        print(f"# nvidia-smi over those {len(clocks)} samples: SM clock "
              f"{min(mhz)!r}-{max(mhz)!r} MHz, power draw up to "
              f"{max(watts)!r} W ({smi})", flush=True)
    ms, plain_ms, got, want = _in_turns(
        lambda: col_delta_cor(e, d, "sqrt", 1e-10),
        lambda: _col_delta_cor_dense_plain(e, d, _TRANSFORMS["sqrt"], 1e-10))
    err, ok = _err(got, want,
                   ~torch.eye(CELLS, dtype=torch.bool, device=DEVICE))
    del got, want
    torch.cuda.empty_cache()
    dual_ms = statistics.median(_time_ms(
        lambda: col_delta_cor(e, d, "sqrt", 1e-10, dmat_random=d2))[0]
        for _ in range(3))
    steps = CELLS * CELLS * GENES
    print(f"# time dense G={GENES} N={CELLS} sqrt psc=1e-10 on {smi}: "
          f"kernel {ms!r} ms, dual (two fields) {dual_ms!r} ms, plain "
          f"{plain_ms!r} ms (median of 3, CUDA events); "
          f"{steps / ms / 1e9!r} G(pair, gene)/s single; "
          f"max_abs_err={err!r} ok={ok}", flush=True)
    assert ok, "dense kernel disagrees with plain at the path's shape"
    _print_sfu_floor("dense", steps)
    del e, d, d2
    torch.cuda.empty_cache()
    # single call: 8 flop per (pair, gene), two (G, N) inputs, (N, N) out
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "dual_ms": dual_ms,
            **_bound(8 * steps, (2 * GENES * CELLS + CELLS * CELLS) * 4)}


def _print_sfu_floor(name, steps):
    """The least time of `steps` (pair, gene) steps at one MUFU op each,
    from the data sheet's rate: a derived figure, printed apart from the
    measured ones."""
    print(f"# {name} SFU floor (derived, not measured): {steps!r} MUFU ops "
          f"at {PEAK_MUFU!r}/s = {steps / PEAK_MUFU * 1e3!r} ms", flush=True)


def _bound(flop, nbytes, peak=PEAK_FP32):
    """bound_ms and bound_by of a function doing `flop` operations at
    `peak` (FP32 unless given) and moving `nbytes` compulsory bytes, at
    the H100 SXM peaks."""
    t_ops, t_bytes = flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _sampled_case(g, n, m, nn, seed, idx_dtype):
    """e_full (n, g), e_ctr / d_ctr / d_ctr2 (m, g) = the first m rows,
    ixs (m, nn) distinct non-self neighbours, on the card."""
    rng = np.random.RandomState(seed)
    e = torch.tensor(rng.rand(n, g) * 10, dtype=torch.float32, device=DEVICE)
    d = torch.tensor(rng.randn(m, g), dtype=torch.float32, device=DEVICE)
    d2 = torch.tensor(rng.randn(m, g), dtype=torch.float32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    keys = torch.rand((m, n), generator=gen, device=DEVICE)
    keys[torch.arange(m, device=DEVICE), torch.arange(m, device=DEVICE)] = 2.
    ixs = keys.argsort(dim=1)[:, :nn].to(idx_dtype).contiguous()
    return e, e[:m], d, d2, ixs


def sampled_phase(smi):
    from velocyto_tpu_torch import kernels
    from velocyto_tpu_torch.ops.coldeltacor import (
        _TRANSFORMS, _col_delta_cor_partial_plain)
    phase("sampled kernel against plain, on the card")
    shapes = [(37, 29, 29, 13, torch.int64),
              (GENES, CELLS, 2048, NN_SAMPLED, torch.int64),
              (GENES, 3072, 3072, 512, torch.int32)]
    for g, n, m, nn, idt in shapes:
        e, e_ctr, d, d2, ixs = _sampled_case(g, n, m, nn, g + n, idt)
        for tf, psc in sorted({(c[0], c[1]) for c in CASES}):
            tc = _TRANSFORMS[tf]
            got = kernels.coldeltacor_partial(e, e_ctr, d, ixs, tc, psc)
            main, rndm = kernels.coldeltacor_partial(e, e_ctr, d, ixs, tc,
                                                     psc, d_ctr2=d2)
            got2 = kernels.coldeltacor_partial(e, e_ctr, d2, ixs, tc, psc)
            perm = torch.randperm(m, generator=torch.Generator().manual_seed(
                m), dtype=torch.int32).to(DEVICE)
            o_main, o_rndm = kernels.coldeltacor_partial(
                e, e_ctr, d, ixs, tc, psc, d_ctr2=d2, order=perm)
            torch.cuda.synchronize()
            want = _col_delta_cor_partial_plain(e, e_ctr, d, ixs, tc, psc)
            err, ok = _err(got, want)
            err2, ok2 = _err(got2, _col_delta_cor_partial_plain(
                e, e_ctr, d2, ixs, tc, psc))
            bitwise = _bitwise(main, got) and _bitwise(rndm, got2)
            ordered = _bitwise(o_main, main) and _bitwise(o_rndm, rndm)
            print(f"# check G={g} N={n} M={m} nn={nn} {idt} {tf} psc={psc}:"
                  f" max_abs_err={max(err, err2)!r} ok={ok and ok2}; dual "
                  f"vs two single calls bitwise={bitwise}; permuted center "
                  f"order vs identity bitwise={ordered}", flush=True)
            assert ok and ok2 and bitwise and ordered, \
                f"sampled kernel: {tf} {psc}"
        del e, e_ctr, d, d2, ixs

    # the default-mode path's shape: all 20,000 rows, nn = 1750, the main
    # field and the randomized control in one dual call
    e, e_ctr, d, d2, ixs = _sampled_case(GENES, CELLS, CELLS, NN_SAMPLED, 7,
                                         torch.int64)
    tc = _TRANSFORMS["sqrt"]
    ms, plain_ms, got, want = _in_turns(
        lambda: kernels.coldeltacor_partial(e, e, d, ixs, tc, 1e-10,
                                            d_ctr2=d2),
        lambda: (_col_delta_cor_partial_plain(e, e, d, ixs, tc, 1e-10),
                 _col_delta_cor_partial_plain(e, e, d2, ixs, tc, 1e-10)))
    (err, ok), (err2, ok2) = _err(got[0], want[0]), _err(got[1], want[1])
    err = max(err, err2)
    single_ms = statistics.median(_time_ms(
        lambda: kernels.coldeltacor_partial(e, e, d, ixs, tc, 1e-10))[0]
        for _ in range(3))
    gbps = CELLS * NN_SAMPLED * GENES * 4 / (ms / 1e3) / 1e9
    print(f"# time sampled dual G={GENES} N={CELLS} nn={NN_SAMPLED} sqrt "
          f"psc=1e-10 on {smi}: kernel {ms!r} ms (single call "
          f"{single_ms!r} ms), plain (two calls) {plain_ms!r} ms (median "
          f"of 3, CUDA events); gathered rows {gbps!r} GB/s; "
          f"max_abs_err={err!r} ok={ok and ok2}", flush=True)
    assert ok and ok2, "sampled kernel disagrees with plain at 20k"
    del e, e_ctr, d, d2, ixs, got, want
    torch.cuda.empty_cache()
    # dual call: 10 flop per (pair, gene); e, two displacement matrices,
    # int64 indices in, two (N, nn) outputs
    steps = CELLS * NN_SAMPLED * GENES
    _print_sfu_floor("sampled", steps)
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "single_ms": single_ms,
            **_bound(10 * steps, 3 * CELLS * GENES * 4 +
                     CELLS * NN_SAMPLED * (8 + 2 * 4))}


def cross_check_phase():
    """The two kernel families agree: the dense kernel with partial
    semantics, read at sampled positions, against the sampled kernel."""
    from velocyto_tpu_torch import kernels
    from velocyto_tpu_torch.ops.coldeltacor import _TRANSFORMS
    phase("dense (partial semantics) against sampled, on the card")
    g, n, nn = GENES, 2048, 256
    e_rows, _, d_rows, _, ixs = _sampled_case(g, n, n, nn, 11, torch.int64)
    for tf, psc in (("sqrt", 1e-10), ("log10", 1.0), ("linear", 0.0)):
        tc = _TRANSFORMS[tf]
        dense = kernels.coldeltacor_dense(e_rows.T.contiguous(),
                                          d_rows.T.contiguous(), tc, psc,
                                          partial_semantics=True)
        sampled = kernels.coldeltacor_partial(e_rows, e_rows, d_rows, ixs,
                                              tc, psc)
        err, ok = _err(sampled, dense.gather(1, ixs))
        print(f"# cross-check G={g} N={n} nn={nn} {tf} psc={psc}: "
              f"max_abs_err={err!r} ok={ok}", flush=True)
        assert ok, f"dense and sampled kernels disagree: {tf}"


def _same_state(a, b):
    """Two np.random.get_state() tuples hold the same MT19937 state."""
    return a[0] == b[0] and np.array_equal(a[1], b[1]) and a[2:] == b[2:]


def sampler_phase():
    """The neighbour sampler against numpy's loop, small and at the
    operating point, where the chunked replay (the path's) must equal
    the whole replay and the loop bitwise.  Returns the operating
    point's times and the loop's rows and final state (the default
    pipeline's call is held to them)."""
    from velocyto_tpu_torch import analysis, native
    phase("neighbour sampler against numpy")
    n, nn_k, n_samp = 2000, 401, 200
    p = np.linspace(0.5, 0.1, nn_k)
    p /= p.sum()
    got, draws, state = native.choice_noreplace_rows_state(
        15071990, n, nn_k, n_samp, p)
    want, want_state = native.choice_rows_plain(15071990, n, nn_k, n_samp, p)
    same = np.array_equal(got, want) and _same_state(state, want_state)
    print(f"# sampler N={n} nn_k={nn_k} n_samp={n_samp}: positions and "
          f"final MT19937 state equal to the numpy loop: {same} "
          f"({draws} doubles drawn)", flush=True)
    assert same, "sampler differs from np.random.choice"
    nn_k = N_NEIGHBORS + 1
    p = np.linspace(0.5, 0.1, nn_k)
    p /= p.sum()
    t0 = time.perf_counter()
    whole, w_draws, w_state = native.choice_noreplace_rows_state(
        15071990, CELLS, nn_k, NN_SAMPLED, p)
    whole_s = time.perf_counter() - t0
    bounds = []
    t0 = time.perf_counter()
    chunked, c_draws, c_state = native.choice_noreplace_rows_chunked(
        15071990, CELLS, nn_k, NN_SAMPLED, p,
        n_chunks=analysis.SAMPLER_CHUNKS,
        on_chunk=lambda lo, hi, rows: bounds.append((lo, hi)))
    chunked_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain, plain_state = native.choice_rows_plain(15071990, CELLS, nn_k,
                                                  NN_SAMPLED, p)
    plain_s = time.perf_counter() - t0
    same = (np.array_equal(whole, chunked) and w_draws == c_draws
            and _same_state(w_state, c_state))
    same_plain = np.array_equal(whole, plain) and \
        _same_state(w_state, plain_state)
    print(f"# sampler at the operating point (N={CELLS}, nn_k={nn_k}, "
          f"n_samp={NN_SAMPLED}): whole replay {whole_s:.3f} s host, "
          f"chunked replay ({len(bounds)} chunks {bounds}) {chunked_s:.3f} s;"
          f" positions and final state bitwise equal: {same}; both equal "
          f"to the numpy loop ({plain_s:.3f} s): {same_plain}", flush=True)
    assert same, "the chunked replay differs from the whole replay"
    assert same_plain, "the replay differs from np.random.choice"
    assert len(bounds) == analysis.SAMPLER_CHUNKS
    return {"whole_s": whole_s, "chunked_s": chunked_s, "plain_s": plain_s,
            "rows": plain, "state": plain_state}


def fma_phase(smi):
    from velocyto_tpu_torch import bench, kernels
    phase("FMA probe against plain, on the card")
    worst = 0.0
    for x in (torch.full((8192, 512), 0.4, device=DEVICE),
              torch.empty((8192, 512), device=DEVICE).uniform_(-0.9, 0.9)):
        got = kernels.fma_probe(x)
        want = bench._fma_plain(x)
        diff = (got - want).abs()
        ok = bool(torch.all(diff <= FMA_RTOL * want.abs()))
        worst = max(worst, float(diff.max()))
        print(f"# check fma (8192, 512): max_abs_err={float(diff.max())!r} "
              f"ok={ok}", flush=True)
        assert ok, "FMA probe disagrees with plain"
    ms = bench.device_seconds(lambda: kernels.fma_probe(x), reps=200) * 1e3
    plain_ms = bench.device_seconds(lambda: bench._fma_plain(x), reps=3) * 1e3
    flop = x.numel() * bench.FMA_STEPS * bench.FMA_CHAINS * 2
    tflops = flop / ms / 1e9
    print(f"# time fma (8192, 512) on {smi}: kernel {ms!r} ms (mean of 200"
          f" launches), plain {plain_ms!r} ms (mean of 3); {tflops!r} "
          f"TFLOP/s", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": worst,
            **_bound(flop, 2 * x.numel() * 4)}


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


def _check_gammas(v, gamma_true):
    from scipy.stats import spearmanr
    rho = float(spearmanr(v.gammas, gamma_true).correlation)
    med, want = float(np.median(v.gammas)), 0.4 * float(np.median(gamma_true))
    print(f"# gammas: spearman {rho!r} vs truth; median {med!r} vs "
          f"0.4*median(truth) {want!r}", flush=True)
    assert rho > 0.9, f"gamma spearman {rho}"
    assert abs(med - want) <= 0.25 * want, f"gamma median {med} vs {want}"


def _stager(stages, smi):
    """stage(name, fn): run fn between two synchronisations, record and
    print its seconds on the host clock."""
    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t
        print(f"# stage {name}: {stages[name]:.3f} s on {smi}", flush=True)
        return out
    return stage


_COUNTS = {"dense": "dense_launches", "partial": "partial_launches",
           "flat": "flat_launches", "fma": "fma_launches",
           "svr": "svr_launches",
           "tsne": "tsne_launches", "balance": "balance_launches",
           "balance_decode": "balance_decode_launches"}


def _launches():
    from velocyto_tpu_torch import kernels
    return {k: getattr(kernels, attr) for k, attr in _COUNTS.items()}


def _sampler_chunks():
    """Sampled launches per default transition call: one dual launch
    per chunk of the neighbour-sampling replay."""
    from velocyto_tpu_torch import analysis
    return analysis.SAMPLER_CHUNKS


def _uncounted(fn):
    """fn() with its kernel launches left out of the path's counts (the
    timing repeats of a call the path already made once)."""
    from velocyto_tpu_torch import kernels
    saved = _launches()
    try:
        return fn()
    finally:
        for k, attr in _COUNTS.items():
            setattr(kernels, attr, saved[k])


def _new_loom(S, U, genes):
    """A VelocytoLoom on the card holding S and U (no loom file: h5py is
    not on the card's machine)."""
    import velocyto_tpu_torch as vtt
    v = vtt.VelocytoLoom.__new__(vtt.VelocytoLoom)
    v.device = torch.device(DEVICE)
    v.S, v.U, v.A = S, U, np.zeros_like(S)
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    v.ca = {"CellID": np.array([f"c{i}" for i in range(S.shape[1])])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(genes)])}
    return v


class _HostCopies:
    """Records the shape of every CUDA tensor copied to the host through
    Tensor.cpu / Tensor.to while it is active."""

    def __init__(self):
        self.shapes = []

    def __enter__(self):
        self._cpu, self._to = torch.Tensor.cpu, torch.Tensor.to
        copies, cpu, to = self.shapes, self._cpu, self._to

        def _cpu(t, *args, **kw):
            out = cpu(t, *args, **kw)
            if t.is_cuda:
                copies.append(tuple(t.shape))
            return out

        def _to(t, *args, **kw):
            out = to(t, *args, **kw)
            if t.is_cuda and isinstance(out, torch.Tensor) and not out.is_cuda:
                copies.append(tuple(t.shape))
            return out
        torch.Tensor.cpu, torch.Tensor.to = _cpu, _to
        return self

    def __exit__(self, *exc):
        torch.Tensor.cpu, torch.Tensor.to = self._cpu, self._to


def pipeline_phase(knn_random, smi, sampler=None):
    """Drive the pipeline through bench_pipeline.run_once (the
    VelocytoLoom entry points, stage by stage) with the launch counts set
    to 0 just before; returns (stage seconds, total, launch counts, peak
    device memory, in the default mode the timings of the transition
    stage's sampled launches and its device permutation, and the
    VelocytoLoom).  sampler: sampler_phase's result, which the default
    mode's transition call is held to."""
    from velocyto_tpu_torch import analysis, bench_pipeline, kernels
    from velocyto_tpu_torch.bench_common import transition_split
    from velocyto_tpu_torch.utils.profiling import trace
    mode = "default mode (knn_random=True)" if knn_random else \
        "full mode (knn_random=False)"
    phase(f"pipeline, {mode}, {CELLS} cells x {GENES} genes")
    t0 = time.perf_counter()
    S, U, gamma_true, _zl = synth(np.random.RandomState(0), CELLS, GENES)
    print(f"# synthesize: {time.perf_counter() - t0:.3f} s host, on {smi}",
          flush=True)

    transition, captured = {}, {"runs": []}
    chunked = analysis.make_partial_compact_chunked
    estimate = analysis.VelocytoLoom.estimate_transition_prob

    def _capture(emat, tf, psc):
        # the sampled call's inputs and chunks, kept for the checks below
        captured.update(emat=emat, tf=tf, psc=psc)
        prep_d, run = chunked(emat, tf, psc)

        def _run(d_rows, lo, hi, ixs, d_rows_random=None, order=None):
            captured["runs"].append((d_rows, lo, hi, ixs, d_rows_random,
                                     order))
            return run(d_rows, lo, hi, ixs, d_rows_random, order=order)
        return prep_d, _run

    def _transition(self, *args, **kw):
        # profiled, for the split its spans give (the call's time holds
        # the profiler's cost)
        before = (kernels.dense_launches, kernels.partial_launches)
        with _HostCopies() as copies, trace() as prof:
            with torch.profiler.record_function("transition call"):
                estimate(self, *args, **kw)
        transition.update(
            dense=kernels.dense_launches - before[0],
            partial=kernels.partial_launches - before[1],
            rng_state=np.random.get_state(), host_copies=copies.shapes,
            split=transition_split(prof, "transition call"))

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()              # count this path's launches only
    analysis.make_partial_compact_chunked = _capture
    analysis.VelocytoLoom.estimate_transition_prob = _transition
    try:
        total, stages, v = bench_pipeline.run_once(S, U, DEVICE, knn_random)
    finally:
        analysis.make_partial_compact_chunked = chunked
        analysis.VelocytoLoom.estimate_transition_prob = estimate
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"# pipeline total: {total:.3f} s on {smi}; kernel launches "
          f"{launches} (transition stage: dense {transition['dense']}, "
          f"sampled {transition['partial']}); peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)

    phase(f"checks, {mode}")
    assert list(stages) == PIPELINE_STAGES, list(stages)
    for name in ("delta_embedding", "delta_embedding_random", "flow"):
        assert np.all(np.isfinite(getattr(v, name))), f"{name} not finite"
    _check_gammas(v, gamma_true)
    sampled_times = None
    if knn_random:
        # one dual launch (main field and randomized control) per chunk
        chunks = analysis.SAMPLER_CHUNKS
        assert launches == {"dense": 0, "flat": 0, "partial": chunks,
                            "fma": 0, "svr": 0, "tsne": 0, "balance": 1,
                            "balance_decode": 1} and \
            transition["partial"] == chunks, launches
        _check_sampled_state(v)
        _check_transition_call(v, transition, sampler, smi)
        sampled_times = _uncounted(lambda: _sampled_timings(v, captured,
                                                            smi))
        sampled_times["split"] = transition["split"]
    else:
        # the dual form: main field and randomized control in one launch
        assert launches == {"dense": 1, "flat": 0, "partial": 0, "fma": 0,
                            "svr": 0, "tsne": 0, "balance": 1,
                            "balance_decode": 1} and \
            transition["dense"] == 1, launches
        corr = v._get_dev("corrcoef")           # diagonal already set to 0
        assert corr.shape == (CELLS, CELLS) and bool(torch.isfinite(corr).all())
        assert bool(torch.isfinite(v._get_dev("corrcoef_random")).all())
        _check_knn_rows(v)
    return stages, total, launches, peak, sampled_times, v


def _check_transition_call(v, transition, sampler, smi):
    """The default transition call: no (G, N) tensor (delta_S) crossed to
    the host; sampling_ixs and numpy's state after the call equal the
    numpy loop's (sampler_phase); delta_S_rndm equals permute_rows_nsign
    on the same float32 rows from the same numpy state, bitwise."""
    from velocyto_tpu_torch import analysis
    big = [sh for sh in transition["host_copies"]
           if int(np.prod(sh)) >= GENES * CELLS]
    split = transition["split"]
    print(f"# transition call: {len(transition['host_copies'])} tensors "
          f"copied to the host, largest "
          f"{max(transition['host_copies'], key=np.prod, default=None)}; "
          f"{split['chunks']} chunks; replay {split['replay_s']!r} s in "
          f"the call against {sampler['chunked_s']:.3f} s alone (chunked) / "
          f"{sampler['whole_s']:.3f} s (whole) in sampler_phase; calling "
          f"thread busy {split['main_busy_s']!r} s; tail after the replay "
          f"{split['tail_s']!r} s; call {split['call_s']!r} s (profiled, "
          f"from its vtt.transition.* spans) on {smi}", flush=True)
    assert not big, f"(G, N) tensors copied to the host: {big}"
    assert split["chunks"] == analysis.SAMPLER_CHUNKS
    assert np.array_equal(v.sampling_ixs, sampler["rows"]), \
        "sampling_ixs differ from the numpy loop"
    assert _same_state(transition["rng_state"], sampler["state"]), \
        "numpy's state after the call differs from the numpy loop's"
    host = v._get_dev("delta_S").cpu().numpy().astype(np.float64)
    np.random.seed(15071990)             # the call's numba_random_seed
    analysis.permute_rows_nsign(host)
    got = v._get_dev("delta_S_rndm", None).cpu().numpy()
    same = got.dtype == np.float32 and np.array_equal(
        got.view(np.uint32), host.astype(np.float32).view(np.uint32))
    print(f"# delta_S_rndm (device permutation) against permute_rows_nsign "
          f"on the host, bitwise: {same}; sampling_ixs and numpy's state "
          f"after the call equal the numpy loop's: True", flush=True)
    assert same, "the device permutation differs from permute_rows_nsign"


def _sampled_timings(v, captured, smi):
    """The transition call's sampled launches (chunked against one
    launch, then the one launch in both center orders) and its device
    permutation, on the call's own inputs."""
    times = _chunk_timing(v, captured, smi)
    times.update(_order_timing(captured, smi))
    times.update(_flat_path_timing(captured, smi, times["ordered_ms"]))
    times.update(_permutation_timing(v, smi))
    return times


def _chunk_timing(v, captured, smi, n=3):
    """The transition call's chunks against one unchunked dual launch on
    the same neighbours (the path's locality order): the call's compact
    correlations must equal it bitwise, and each chunk's order must be
    the global order within the chunk.  Times the chunks' launches
    (summed) against the single launch, in turns."""
    from velocyto_tpu_torch import analysis, kernels
    from velocyto_tpu_torch.ops.coldeltacor import (_TRANSFORMS, chunk_order,
                                                    locality_order)
    runs = captured["runs"]
    e_rows = captured["emat"].to(torch.float32).T.contiguous()
    d_rows, d2_rows = runs[0][0], runs[0][4]
    tc, psc = _TRANSFORMS[captured["tf"]], captured["psc"]
    ixs = torch.cat([r[3] for r in runs])
    assert torch.equal(ixs, v._compact_ixs_dev)
    order = locality_order(torch.as_tensor(v.ts, device=ixs.device))
    captured.update(e_rows=e_rows, ixs=ixs, order=order)
    for _d, lo, hi, _i, _d2, o in runs:
        assert torch.equal(o, chunk_order(order, lo, hi)), (lo, hi)
    assert [(r[1], r[2]) for r in runs] == [
        (int(a), int(b)) for a, b in zip(
            np.linspace(0, CELLS, analysis.SAMPLER_CHUNKS + 1)[:-1].astype(
                np.int64),
            np.linspace(0, CELLS, analysis.SAMPLER_CHUNKS + 1)[1:].astype(
                np.int64))]

    def single():
        return kernels.coldeltacor_partial(e_rows, e_rows, d_rows, ixs, tc,
                                           psc, d_ctr2=d2_rows, order=order)

    def chunks():
        return [kernels.coldeltacor_partial(
            e_rows, e_rows[lo:hi], d[lo:hi], i, tc, psc, d_ctr2=d2[lo:hi],
            order=o) for d, lo, hi, i, d2, o in runs]

    times = {"single": [], "chunks": []}
    for k in range(n):
        for name, fn in ((("single", single), ("chunks", chunks)) if k % 2
                         == 0 else (("chunks", chunks), ("single", single))):
            t, out = _time_ms(fn)
            times[name].append(t)
            if name == "single":
                whole = out
    main, rndm = (analysis._fix_nans(t)[0] for t in whole)
    same = _bitwise(main, v._corr_dev) and _bitwise(rndm, v._corr_rndm_dev)
    single_ms = statistics.median(times["single"])
    chunks_ms = statistics.median(times["chunks"])
    print(f"# time sampled dual, the call's {len(runs)} chunk launches "
          f"(each chunk in its own locality order) {chunks_ms!r} ms in all "
          f"against one launch over the {CELLS} rows {single_ms!r} ms "
          f"(median of {n}, in turns, CUDA events) on {smi}; the call's "
          f"compact correlations equal the single launch bitwise: {same}",
          flush=True)
    assert same, "the chunked call differs from one unchunked launch"
    return {"chunks_ms": chunks_ms, "single_ms": single_ms,
            "launches_per_call": len(runs)}


def _permutation_timing(v, smi, n=3):
    """The randomized control's device apply (analysis._permute_apply_dev,
    plain torch) on the pipeline's delta_S, its plan drawn from the call's
    numpy state; median ms of n, and its bound (bytes)."""
    from velocyto_tpu_torch import analysis
    dS = v._get_dev("delta_S")
    g, n_cells = dS.shape
    rng = np.random.RandomState(15071990)
    perms, bits = analysis._permute_rows_nsign_plan(g, n_cells, rng=rng)
    perms = torch.from_numpy(perms).to(dS.device)
    bits = torch.from_numpy(bits).to(dS.device)
    ms = [_time_ms(lambda: analysis._permute_apply_dev(dS, perms, bits))
          for _ in range(n)]
    got = ms[-1][1]
    ms = statistics.median(t for t, _ in ms)
    assert _bitwise(got, v._get_dev("delta_S_rndm", None))
    nbytes = g * n_cells * (4 + perms.element_size() + 4) + bits.numel()
    bound = _bound(0, nbytes)
    print(f"# time device permutation (_permute_apply_dev, plain torch: "
          f"gather, sign unpack, multiply) ({g}, {n_cells}) on {smi}: "
          f"{ms!r} ms (median of {n}, CUDA events); bound "
          f"{bound['bound_ms']!r} ms ({bound['bound_by']}, {nbytes} bytes)",
          flush=True)
    return {"permute_ms": ms, "permute_bound_ms": bound["bound_ms"]}


def _order_timing(captured, smi, n=3):
    """The transition stage's sampled launch over all rows on its own
    inputs (the pipeline's embedding-kNN samples, both fields), with the
    identity center order and with the locality order, in turns
    (identity, ordered, ordered, identity, ...); the two outputs must be
    bitwise equal.  Returns the median ms of each."""
    from velocyto_tpu_torch import kernels
    from velocyto_tpu_torch.ops.coldeltacor import _TRANSFORMS
    e_rows, ixs, order = captured["e_rows"], captured["ixs"], \
        captured["order"]
    d_rows, d2_rows = captured["runs"][0][0], captured["runs"][0][4]
    # the path builds its sampled ids as int32: nothing is converted
    assert ixs.dtype == torch.int32, ixs.dtype
    tc, psc = _TRANSFORMS[captured["tf"]], captured["psc"]

    def run(o):
        return kernels.coldeltacor_partial(e_rows, e_rows, d_rows, ixs, tc,
                                           psc, d_ctr2=d2_rows, order=o)

    times = {"identity": [], "locality": []}
    outs = {}
    turns = [("identity", None), ("locality", order)]
    for i in range(n):
        for name, o in (turns if i % 2 == 0 else turns[::-1]):
            t, outs[name] = _time_ms(lambda: run(o))
            times[name].append(t)
    same = all(_bitwise(a, b) for a, b in zip(outs["identity"],
                                              outs["locality"]))
    ms_i = statistics.median(times["identity"])
    ms_o = statistics.median(times["locality"])
    n_cells, nn = ixs.shape
    gbps = n_cells * nn * e_rows.shape[1] * 4 / (ms_o / 1e3) / 1e9
    print(f"# time sampled dual on the pipeline's own indices "
          f"(N={n_cells}, nn={nn}, G={e_rows.shape[1]}, {captured['tf']}) on "
          f"{smi}: identity order {ms_i!r} ms, locality order {ms_o!r} ms "
          f"(median of {n}, in turns, CUDA events); gathered rows {gbps!r} "
          f"GB/s with the locality order; outputs bitwise equal: {same}",
          flush=True)
    assert same, "the center order changed the sampled kernel's output"
    return {"identity_ms": ms_i, "ordered_ms": ms_o}


def flat_tables(e_rows, d_rows, d2_rows, ixs, p, order=None):
    """The ring plan of ixs (N, nn) over p shards (ops.coldeltacor.
    _ring_plan, q = 16) as the flat kernel's launches, one for each (shard
    s, visiting chunk v): its arguments on the card and its schedule in
    table order ("table") and, with a locality order of the N cells, in
    the locality rank of the shard's centers ("locality").  Returns (the
    launches, inv_pos, the chunk)."""
    from velocyto_tpu_torch import kernels
    from velocyto_tpu_torch.ops import coldeltacor as cdc
    n, g = e_rows.shape
    chunk = -(-n // p)
    qloc, qrow, inv_pos, _bmax = cdc._ring_plan(
        ixs.cpu().numpy(), p, chunk, q=min(16, ixs.shape[1]))

    def chunks(rows):
        pad = torch.zeros((chunk * p, g), dtype=torch.float32, device=DEVICE)
        pad[:n] = rows
        return [pad[i * chunk:(i + 1) * chunk] for i in range(p)]

    ec, dc, d2c = chunks(e_rows), chunks(d_rows), chunks(d2_rows)
    launches = []
    for s in range(p):
        rank = None if order is None else cdc.shard_rank(
            order, s * chunk, min(n, (s + 1) * chunk), chunk)
        for v in range(p):
            qr = torch.as_tensor(qrow[s, v], device=DEVICE)
            launches.append({
                "args": (ec[v], ec[s], dc[s],
                         torch.as_tensor(qloc[s, v], device=DEVICE), qr),
                "d2": d2c[s], "table": kernels.flat_runs(qr),
                "locality": None if rank is None else
                kernels.flat_runs(qr, rank)})
    return launches, torch.as_tensor(inv_pos, device=DEVICE), chunk


def flat_run(launches, tc, psc, schedule, flat=None):
    """Every launch of flat_tables through `flat` (kernels.coldeltacor_flat
    unless given) on the given schedule ("table" or "locality", unchecked
    as the ring passes it, or None for none), both fields; the list of
    their output pairs."""
    from velocyto_tpu_torch import kernels
    flat = flat or kernels.coldeltacor_flat
    out = []
    for t in launches:
        sched = {} if schedule is None else dict(
            run_start=t[schedule][0], run_order=t[schedule][1], check=False)
        out.append(flat(*t["args"], tc, psc, d_ctr2=t["d2"], **sched))
    return out


def flat_compact(outs, inv_pos, chunk, n, p):
    """The flat launches' outputs put back in the compact (N, nn) layout
    through inv_pos, both fields."""
    got = []
    for k in (0, 1):
        rows = [torch.stack([outs[s * p + v][k] for v in range(p)]).reshape(-1)
                [inv_pos[s * chunk:(s + 1) * chunk].to(torch.int64)]
                for s in range(p)]
        got.append(torch.cat(rows)[:n])
    return got


def _flat_path_timing(captured, smi, sampled_ms, n=3):
    """The flat kernel on the transition stage's own sampled indices (the
    pipeline's embedding-kNN samples, both fields), planned over
    MESH_SHARDS shards as the ring plans them: its launches on the four
    tables in table order and in the locality rank of their centers (the
    ring's), in turns; each run's outputs, put back through inv_pos,
    bitwise equal to one sampled launch on the same indices.  Returns the
    median ms of each (the four launches summed) and the gathered rows'
    GB/s."""
    from velocyto_tpu_torch import kernels
    from velocyto_tpu_torch.ops.coldeltacor import _TRANSFORMS
    e_rows, ixs, order = captured["e_rows"], captured["ixs"], \
        captured["order"]
    d_rows, d2_rows = captured["runs"][0][0], captured["runs"][0][4]
    tc, psc = _TRANSFORMS[captured["tf"]], captured["psc"]
    p = MESH_SHARDS
    t0 = time.perf_counter()
    launches, inv_pos, chunk = flat_tables(e_rows, d_rows, d2_rows, ixs, p,
                                           order)
    plan_s = time.perf_counter() - t0
    want = kernels.coldeltacor_partial(e_rows, e_rows, d_rows, ixs, tc, psc,
                                       d_ctr2=d2_rows, order=order)
    turns = [("table", dict(schedule="table")),
             ("locality", dict(schedule="locality"))]
    times = {name: [] for name, _ in turns}
    same = {}
    for i in range(n):
        for name, kw in (turns if i % 2 == 0 else turns[::-1]):
            t, outs = _time_ms(lambda: flat_run(launches, tc, psc, **kw))
            times[name].append(t)
            got = flat_compact(outs, inv_pos, chunk, ixs.shape[0], p)
            same[name] = same.get(name, True) and \
                _bitwise(got[0], want[0]) and _bitwise(got[1], want[1])
            del outs, got
    ms = {name: statistics.median(t) for name, t in times.items()}
    entries = sum(t["args"][3].numel() for t in launches)
    n_cells, nn = ixs.shape
    g = e_rows.shape[1]

    def gbps(t):
        return entries * g * 4 / (t / 1e3) / 1e9

    print(f"# time flat dual on the pipeline's own indices (N={n_cells}, "
          f"nn={nn}, G={g}, {captured['tf']}; {p} shards, {len(launches)} "
          f"tables, {entries} entries, plan {plan_s:.3f} s host) on {smi}: "
          f"table order {ms['table']!r} ms, locality order "
          f"{ms['locality']!r} ms (the {len(launches)} launches summed, "
          f"median of {n}, in turns, CUDA events); gathered rows "
          f"{gbps(ms['table'])!r} / {gbps(ms['locality'])!r} GB/s, the "
          f"sampled kernel's "
          f"{n_cells * nn * g * 4 / (sampled_ms / 1e3) / 1e9!r} GB/s "
          f"({sampled_ms!r} ms, locality order); each bitwise equal to one "
          f"sampled launch: {same}", flush=True)
    assert all(same.values()), f"the flat kernel differs: {same}"
    return {"flat_table_order_ms": ms["table"],
            "flat_locality_ms": ms["locality"],
            "flat_locality_gbps": gbps(ms["locality"])}


def _check_sampled_state(v):
    """Every sampled neighbour lies in its cell's embedding kNN and is not
    the cell itself; the compact state is finite and no dense (N, N) view
    (correlations, probabilities, kNN mask) was built."""
    from velocyto_tpu_torch.ops import knn_device as kd
    ixs = v._compact_ixs_dev
    nn_k = N_NEIGHBORS + 1
    assert tuple(ixs.shape) == (CELLS, NN_SAMPLED), tuple(ixs.shape)
    rows = torch.arange(CELLS, device=ixs.device)[:, None]
    assert not bool((ixs == rows).any()), "a cell sampled itself"
    _d, knn = kd.knn_search_dev(v.ts, nn_k + 1, device=v.device)
    knn = knn.sort(dim=1).values
    pos = torch.searchsorted(knn, ixs).clamp_max(nn_k)
    assert bool((knn.gather(1, pos) == ixs).all()), \
        "a sampled neighbour is outside the embedding kNN"
    uniq = ixs.sort(dim=1).values
    assert bool((uniq[:, 1:] != uniq[:, :-1]).all()), "repeated neighbour"
    for name in ("_corr_dev", "_corr_rndm_dev"):
        t = v.__dict__[name]
        assert tuple(t.shape) == (CELLS, NN_SAMPLED) and \
            bool(torch.isfinite(t).all()), name
    dense = [k for k in DENSE_VIEWS + ("embedding_knn",)
             if k in v.__dict__ or k in _device_backed(v)]
    assert not dense, f"dense (N, N) state built: {dense}"
    assert v.sampling_ixs.shape == (CELLS, NN_SAMPLED)
    print(f"# sampled state: {CELLS} x {NN_SAMPLED} neighbours, none self, "
          f"all within the {nn_k}-neighbour embedding kNN, no repeats; "
          f"compact correlations finite; no (N, N) array", flush=True)


def _check_knn_rows(v):
    from velocyto_tpu_torch.ops import knn_device as kd
    rows = np.random.RandomState(1).choice(CELLS, SPOT_ROWS, replace=False)
    kk = B_SIGHT + 1                        # the balanced search's width
    _d, idx = kd.knn_search_dev(v.pcs, kk, device=v.device)
    got = idx[torch.as_tensor(rows, device=idx.device)].cpu().numpy()
    want_idx = _brute_knn(np.asarray(v.pcs, np.float64), rows, kk)
    n_bad = int(np.sum(np.any(got != want_idx, axis=1)))
    print(f"# knn spot check: {SPOT_ROWS} rows x {kk} neighbours, "
          f"{n_bad} rows differ from host f64 brute force", flush=True)
    assert n_bad == 0, "kNN rows differ from the f64 brute force"


def _tutorial_data():
    """synth at GENES genes plus LOW_GENES barely detected ones (too few
    counts for the detection filter), the cells labelled by their
    dominant latent factor; returns (S, U, true gammas of the expressed
    genes, labels, colour dict)."""
    rng = np.random.RandomState(3)
    S, U, gamma_true, zl = synth(rng, CELLS, GENES)
    S = np.concatenate([S, rng.poisson(0.0005, (LOW_GENES, CELLS)).astype(
        np.float32)])
    U = np.concatenate([U, rng.poisson(0.0002, (LOW_GENES, CELLS)).astype(
        np.float32)])
    labels = np.array([f"cl{i:02d}" for i in zl.argmax(1)], dtype=object)
    colors = {f"cl{i:02d}": [i / N_CLUSTERS, 0.5, 1 - i / N_CLUSTERS]
              for i in range(N_CLUSTERS)}
    return S, U, gamma_true, labels, colors


def tutorial_phase(smi):
    """The tutorial session through the VelocytoLoom entry points, then
    the fused velocity_step and the shims, with the launch counts set to
    0 just before; returns (stage seconds, total, launch counts, peak
    device memory, shim results, velocity_step ms)."""
    import velocyto_tpu_torch as vtt
    from velocyto_tpu_torch import kernels
    genes = GENES + LOW_GENES
    phase(f"tutorial session, {CELLS} cells x {genes} raw genes")
    t0 = time.perf_counter()
    S, U, gamma_true, labels, colors = _tutorial_data()
    print(f"# synthesize: {time.perf_counter() - t0:.3f} s host, on {smi}",
          flush=True)
    v = _new_loom(S, U, genes)
    stages, counts = {}, {}
    stage = _stager(stages, smi)

    def _filters():
        v.normalize("S", size=True, log=False)
        v.normalize("U", size=True, log=False)
        v.score_detection_levels(min_expr_counts=40, min_cells_express=30)
        v.filter_genes(by_detection_levels=True)
        counts["detection"] = v.S.shape[0]
        v.set_clusters(labels, cluster_colors_dict=colors)
        v.score_cluster_expression(min_avg_U=0.02, min_avg_S=0.08)
        v.filter_genes(by_cluster_expression=True)
        counts["cluster_expression"] = v.S.shape[0]

    def _norm():
        v.normalize_by_total()
        v.normalize_median(which="renormalize")

    def _vel():
        v.predict_U()
        v.calculate_velocity()
        v.calculate_shift(assumption="constant_velocity")
        v.extrapolate_cell_at_t(delta_t=1.)

    def _phase_portrait():
        v.filter_genes_by_phase_portrait()
        counts["phase_portrait"] = v.S.shape[0]

    def _markov():
        sd = float(np.std(v.ts))
        v.prepare_markov(sigma_D=sd, sigma_W=0.5 * sd)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()              # count this path's launches only
    t_all = time.perf_counter()
    stage("filters", _filters)
    stage("normalize", _norm)
    stage("pca", lambda: v.perform_PCA(which="S_norm", n_components=50))
    stage("knn_imputation", lambda: v.knn_imputation(
        k=K, balanced=True, b_sight=B_SIGHT, b_maxl=B_MAXL))
    stage("normalize_median", v.normalize_median)
    stage("fit_gammas", lambda: v.fit_gammas(limit_gamma=False,
                                             fit_offset=False))
    stage("phase_portrait", _phase_portrait)
    stage("velocity", _vel)
    v.ts = np.ascontiguousarray(v.pcs[:, :2])
    stage("transition_prob", lambda: v.estimate_transition_prob(
        hidim="Sx_sz", embed="ts", transform="sqrt", knn_random=True,
        n_neighbors=N_NEIGHBORS, sampled_fraction=SAMPLED_FRACTION))
    stage("embedding_shift", lambda: v.calculate_embedding_shift(
        sigma_corr=0.05, expression_scaling=True))
    stage("grid_arrows", lambda: v.calculate_grid_arrows(
        smooth=0.5, steps=(40, 40), n_neighbors=100))
    stage("prepare_markov", _markov)
    stage("run_markov", lambda: v.run_markov(n_steps=MARKOV_STEPS))
    session_total = time.perf_counter() - t_all
    session_launches = _launches()
    print(f"# session total: {session_total:.3f} s on {smi}; genes after "
          f"each filter {counts}; kernel launches {session_launches}",
          flush=True)
    _check_session(v, counts, gamma_true, stages, smi)
    step_ms, step_args, step_out = velocity_step_phase(v, smi)
    shims = shims_phase(v, smi)
    total = time.perf_counter() - t_all
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"# tutorial path total (session, velocity_step, shims): "
          f"{total:.3f} s on {smi}; kernel launches {launches}; peak device "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    # the session's dual sampled launches (one per replay chunk) and
    # balance, the check chain's (its transition call: one per chunk) and
    # velocity_step's, and one launch of each shim
    chunks = _sampler_chunks()
    assert session_launches == {"dense": 0, "flat": 0, "partial": chunks,
                                "fma": 0, "svr": 0, "tsne": 0, "balance": 1,
                                "balance_decode": 1}, session_launches
    assert launches == {"dense": 3, "flat": 0, "partial": 2 * chunks + 4,
                        "fma": 0, "svr": 0, "tsne": 0, "balance": 2,
                        "balance_decode": 2}, launches
    return stages, session_total, launches, peak, shims, step_ms, \
        (step_args, step_out)


def _check_session(v, counts, gamma_true, stages, smi):
    from scipy.stats import spearmanr
    phase("checks, tutorial session")
    assert counts["detection"] == GENES, counts
    assert GENES * 0.95 <= counts["cluster_expression"] <= GENES, counts
    assert 0.4 * GENES <= counts["phase_portrait"] <= \
        counts["cluster_expression"], counts
    kept = np.array([int(g[1:]) for g in v.ra["Gene"]])
    assert kept.max() < GENES, "a barely detected gene passed the filters"
    rho = float(spearmanr(v.gammas, gamma_true[kept]).correlation)
    print(f"# gammas (no offset) against the truth: spearman {rho!r}",
          flush=True)
    assert rho > 0.9, f"gamma spearman {rho}"
    ds = _device_backed(v)
    assert ds["Sx_sz"].shape[0] == len(kept) and ds["Sx_sz"].dtype == \
        torch.float64, "phase-portrait filter left Sx_sz off the device"
    for name in ("delta_embedding", "delta_embedding_random", "flow",
                 "scaling"):
        assert np.all(np.isfinite(getattr(v, name))), f"{name} not finite"
    tr = ds["tr"]
    assert tuple(tr.shape) == (CELLS, CELLS) and tr.dtype == torch.float64
    row_err = float((tr.sum(1) - 1).abs().max())
    diffused = np.asarray(v.diffused)
    assert diffused.shape == (CELLS,) and np.all(diffused >= 0)
    mass_err = abs(float(diffused.sum()) - 1)
    assert row_err < 1e-9, f"tr rows sum to 1 +- {row_err}"
    assert mass_err < 1e-4, f"diffused sums to 1 +- {mass_err}"
    assert "tr" not in v.__dict__ and v._table()["tr"].view is None, \
        "a host csr of tr was built"
    dense = [k for k in DENSE_VIEWS if k in v.__dict__ or k in ds]
    assert not dense, f"dense (N, N) state built: {dense}"
    gbps = MARKOV_STEPS * CELLS * CELLS * 4 / stages["run_markov"] / 1e9
    print(f"# markov: tr {CELLS} x {CELLS} float64 on the card, rows sum to "
          f"1 within {row_err!r}; diffused >= 0, sums to 1 within "
          f"{mass_err!r}; no host csr built; run_markov {MARKOV_STEPS} "
          f"float32 steps read {gbps!r} GB/s of tr (stage clock) on {smi}",
          flush=True)


# velocity_step's (rtol, atol) against the step-by-step chain on the
# tutorial session's state, and the sharded step's against velocity_step
STEP_TOL = {"gammas": (2e-3, 2e-3), "q": (5e-3, 5e-3),
            "velocity": (2e-3, 2e-2), "corr": (1e-3, 2e-3),
            "transition_prob": (2e-3, 2e-4), "delta_embedding": (2e-3, 2e-4)}


def velocity_step_phase(v, smi):
    """The fused velocity_step on the session's state (its S_sz / U_sz,
    kNN graph, embedding), against the step-by-step chain re-run from
    the same state with the step's settings (the smoothing of those
    S_sz / U_sz, maxmin weights with offset, no randomized control, no
    expression scaling) at tests/test_velocity_model.py's tolerances;
    returns its ms, its inputs and its outputs."""
    from velocyto_tpu_torch.analysis import _compact_softmax
    from velocyto_tpu_torch.models import velocity_step
    from velocyto_tpu_torch.ops import knn_device as kd
    phase("velocity_step against the chain, on the session's state")
    v.knn_imputation(k=K, balanced=True, b_sight=B_SIGHT, b_maxl=B_MAXL)
    v.fit_gammas(weights="maxmin", fit_offset=True, limit_gamma=False)
    v.predict_U()
    v.calculate_velocity()
    v.calculate_shift(assumption="constant_velocity")
    v.extrapolate_cell_at_t(delta_t=1.)
    v.estimate_transition_prob(
        hidim="Sx_sz", embed="ts", transform="sqrt", knn_random=True,
        n_neighbors=N_NEIGHBORS, sampled_fraction=SAMPLED_FRACTION,
        calculate_randomized=False)
    v.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=False)
    nbr_idx, nbr_w = kd.compact_weights_dev(v._knn_graph_dev, v._knn_diag)
    f32 = torch.float32
    args = (torch.as_tensor(v.S_sz, dtype=f32, device=DEVICE),
            torch.as_tensor(v.U_sz, dtype=f32, device=DEVICE),
            nbr_idx.to(torch.int32), nbr_w,
            torch.as_tensor(v.ts, dtype=f32, device=DEVICE),
            v._compact_ixs_dev.to(torch.int32))
    first_ms, out = _time_ms(lambda: velocity_step(*args))
    ms = _uncounted(lambda: statistics.median(
        _time_ms(lambda: velocity_step(*args))[0] for _ in range(3)))
    chain = {"gammas": v.gammas, "q": v.q, "velocity": v._get_dev("velocity"),
             "corr": v._corr_dev,
             "transition_prob": _compact_softmax(v._corr_dev, 0.05),
             "delta_embedding": v.delta_embedding}
    errs, bad = {}, {}
    for name, (rtol, atol) in STEP_TOL.items():
        got = getattr(out, name)
        want = torch.as_tensor(np.asarray(chain[name]) if isinstance(
            chain[name], np.ndarray) else chain[name], dtype=f32,
            device=got.device)
        diff = (got - want).abs()
        errs[name] = float(diff.max())
        bad[name] = int((diff > atol + rtol * want.abs()).sum())
        assert bool(torch.isfinite(got).all()), f"velocity_step {name}"
    assert not any(bad.values()), \
        f"velocity_step disagrees with the chain: {errs}, outside {bad}"
    print(f"# velocity_step G={v.S.shape[0]} N={CELLS} nn="
          f"{args[5].shape[1]}: {ms!r} ms (median of 3 warm calls; first "
          f"call {first_ms!r} ms) on {smi} (CUDA events); max abs err "
          f"against the chain {errs}", flush=True)
    return ms, args, out


def shims_phase(v, smi):
    """The six estimation.colDeltaCor* shims at G=GENES-ish, SHIM_CELLS
    cells from the session (Sx_sz, delta_S), nn=SHIM_NN, each against
    its plain version on the same card; returns {shim: (ms, plain ms,
    max abs err)}."""
    from velocyto_tpu_torch import estimation
    from velocyto_tpu_torch.ops.coldeltacor import (
        _TRANSFORMS, _col_delta_cor_dense_plain, _col_delta_cor_partial_plain)
    phase(f"estimation shims against plain, {SHIM_CELLS} cells")
    emat = np.ascontiguousarray(v.Sx_sz[:, :SHIM_CELLS])
    dmat = np.ascontiguousarray(v.delta_S[:, :SHIM_CELLS])
    _e, _c, _d, _d2, ixs_dev = _sampled_case(8, SHIM_CELLS, SHIM_CELLS,
                                             SHIM_NN, 5, torch.int64)
    ixs = ixs_dev.cpu().numpy()
    e_dev = torch.as_tensor(emat, dtype=torch.float32, device=DEVICE)
    d_dev = torch.as_tensor(dmat, dtype=torch.float32, device=DEVICE)
    n = SHIM_CELLS
    rows = torch.arange(n, device=DEVICE)[:, None]
    off = ~torch.eye(n, dtype=torch.bool, device=DEVICE)

    def plain(tf, psc, partial):
        if not partial:
            return _col_delta_cor_dense_plain(e_dev, d_dev, _TRANSFORMS[tf],
                                              psc)
        e_rows = e_dev.T.contiguous()
        out = torch.zeros((n, n), dtype=torch.float64, device=DEVICE)
        out[rows, ixs_dev] = _col_delta_cor_partial_plain(
            e_rows, e_rows, d_dev.T.contiguous(), ixs_dev, _TRANSFORMS[tf],
            psc).double()
        return out

    results = {}
    for name, tf, psc in (("colDeltaCor", "linear", 0.0),
                          ("colDeltaCorSqrt", "sqrt", 1e-10),
                          ("colDeltaCorLog10", "log10", 1.0),
                          ("colDeltaCorpartial", "linear", 0.0),
                          ("colDeltaCorSqrtpartial", "sqrt", 1e-10),
                          ("colDeltaCorLog10partial", "log10", 1.0)):
        partial = name.endswith("partial")
        shim = getattr(estimation, name)
        args = (emat, dmat, ixs) if partial else (emat, dmat)
        kw = {"device": DEVICE} if tf == "linear" else \
            {"device": DEVICE, "psc": psc}
        got = shim(*args, **kw)                   # numpy in, numpy out
        want = plain(tf, psc, partial)
        got_t = torch.as_tensor(got, device=DEVICE).to(want.dtype)
        err, ok = _err(got_t, want, None if partial else off)
        assert ok, f"shim {name} disagrees with its plain version"
        del got, got_t, want
        def _host_ms():                           # one warm call
            t = time.perf_counter()
            shim(*args, **kw)
            return (time.perf_counter() - t) * 1e3
        ms = _uncounted(lambda: statistics.median(
            _host_ms() for _ in range(3)))
        plain_ms = statistics.median(
            _time_ms(lambda: plain(tf, psc, partial))[0] for _ in range(3))
        results[name] = (ms, plain_ms, err)
        print(f"# shim {name} G={emat.shape[0]} N={n}"
              f"{f' nn={SHIM_NN}' if partial else ''}: {ms!r} ms (median of "
              f"3 warm calls, host clock, numpy in and out) vs plain "
              f"{plain_ms!r} ms (median of 3, CUDA events) on {smi}; "
              f"max_abs_err={err!r} ok={ok}", flush=True)
    return results


def _svr_data(shape, n=CELLS):
    """(x, y, C, gamma) of a fit shaped like velocyto's two: log2 CV
    against log2 mean of SVR_CV_N genes with gamma = 150 / n
    (score_cv_vs_mean), or U totals against S totals of n cells with
    C = 100, gamma = 1e-6 (adjust_totS_totU); numpy-seeded."""
    if shape == "cv":
        rng = np.random.RandomState(41)
        log_m = np.log2(rng.lognormal(0.0, 1.5, SVR_CV_N))
        return (log_m, -0.5 * log_m + 0.4 * rng.randn(SVR_CV_N), 1.0,
                150.0 / SVR_CV_N)
    rng = np.random.RandomState(42)
    tot_s = rng.gamma(5.0, 400.0, n)
    return tot_s, 0.3 * tot_s + 30.0 * rng.randn(n), 100.0, 1e-6


def _svr_model(x, alpha, rho, gamma):
    """An ops.svr.SVR on the card holding the solution (alpha, rho) of a
    fit on x."""
    from velocyto_tpu_torch.ops.svr import SVR
    n = x.numel()
    coef = alpha[:n] - alpha[n:]
    sv = torch.nonzero(coef.abs() > 0).flatten()
    return SVR.from_numpy(x[sv].cpu().numpy(), coef[sv].cpu().numpy(),
                          -float(rho), gamma, device=DEVICE)


def _svr_gap(x, y, alpha, C, gamma, chunk=1024):
    """libsvm's stopping measure (the maximal violating pair, Gmax +
    Gmax2) of the solution alpha (2l,) of an epsilon-SVR fit on (x, y),
    with G recomputed from alpha over kernel entries rounded to float32
    as libsvm's Q holds them.  The solver stops once it is below tol."""
    from velocyto_tpu_torch.ops.svr import EPSILON
    n = x.numel()
    ap, an = alpha[:n], alpha[n:]
    coef = ap - an
    sv = torch.nonzero(coef).flatten()
    xs, cs = x[sv], coef[sv]
    f = torch.empty_like(x)
    for a in range(0, n, chunk):
        xa = x[a:a + chunk, None]
        d2 = (xa * xa + xs * xs) - 2.0 * (xa * xs)
        f[a:a + chunk] = torch.exp(-gamma * d2).float().double() @ cs
    g_pos, g_neg = EPSILON - y + f, EPSILON + y - f   # G of the two halves
    none = torch.full_like(x, -float("inf"))
    gmax = max(float(torch.where(ap < C, -g_pos, none).max()),
               float(torch.where(an > 0, g_neg, none).max()))
    gmax2 = max(float(torch.where(ap > 0, g_pos, none).max()),
                float(torch.where(an < C, -g_neg, none).max()))
    return gmax + gmax2


def _sync_us():
    """Microseconds per round of the SVR solver's synchronisation probe
    (median of 3 calls of SVR_SYNC_REPS rounds, CUDA events), after a
    first call that builds and loads it."""
    from velocyto_tpu_torch import kernels
    kernels.svr_sync_probe(1)
    torch.cuda.synchronize()
    ms = statistics.median(
        _time_ms(lambda: kernels.svr_sync_probe(SVR_SYNC_REPS))[0]
        for _ in range(3))
    return ms / SVR_SYNC_REPS * 1e3


def svr_phase(smi):
    """The SVR solver kernel against its plain version (the same libsvm
    loop as float64 torch ops) on the card: a small fit, the CV fit at
    SVR_CV_N genes and the totals fit at CELLS cells, the two shapes the
    heuristic session gives it.  Each size keeps its state in shared
    memory (kernels.svr_route) and is held bitwise (alpha, rho,
    iterations) to the plain loop and to the same kernel with its state
    in global memory, called directly.  A totals fit at SVR_GLOBAL_N
    cells, beyond the shared memory, runs on the global route alone: its
    libsvm stopping gap, recomputed from alpha, is checked against tol.
    The synchronisation probe gives the latency floor.  Returns the CV
    fit's numbers and the totals fit's."""
    from velocyto_tpu_torch import kernels
    from velocyto_tpu_torch.ops.svr import EPSILON, TOL, _smo_plain
    phase("SVR solver kernel against plain, on the card")
    cl = kernels.SVR_CLUSTER
    sync_us = _sync_us()
    print(f"# svr sync probe on {smi}, {SVR_SYNC_REPS} rounds (median of 3, "
          f"CUDA events; {cl} blocks: two block reductions, each pushed to "
          f"every block's inbox, a cluster barrier and a rank-order pick; "
          f"the step on every thread) {sync_us!r} us per SMO iteration",
          flush=True)
    res = {}
    for tag, shape, n in (("small", "cv", 600), ("cv", "cv", SVR_CV_N),
                          ("totals", "totals", CELLS)):
        x_np, y_np, C, gamma = _svr_data(shape)
        if n < len(x_np):
            x_np, y_np = x_np[:n], y_np[:n]
            gamma = 150.0 / n if shape == "cv" else gamma
        x = torch.as_tensor(x_np, dtype=torch.float64, device=DEVICE)
        y = torch.as_tensor(y_np, dtype=torch.float64, device=DEVICE)
        route = kernels.svr_route(n)
        assert route == "shared", (n, route)

        def run(**kw):
            return kernels.svr_smo(x, y, C, EPSILON, gamma, TOL, **kw)

        first_ms, (alpha, rho, stats) = _time_ms(run)
        it, sum_active, evals = (int(v) for v in stats.cpu())
        t0 = time.perf_counter()
        p_alpha, p_rho, p_it = _smo_plain(x, y, C, gamma)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        global_ms, (g_alpha, g_rho, g_stats) = _time_ms(
            lambda: run(route="global"))
        got = _svr_model(x, alpha, rho, gamma).predict(x)
        want = _svr_model(x, p_alpha, p_rho, gamma).predict(x)
        pred_err = float((got - want).abs().max())
        scale = float(want.abs().max())
        err = max(float((alpha - p_alpha).abs().max()),
                  abs(float(rho) - p_rho))
        same = bool(torch.equal(alpha, p_alpha)) and float(rho) == p_rho \
            and it == p_it
        same_global = bool(torch.equal(alpha, g_alpha)) and \
            float(rho) == float(g_rho) and it == int(g_stats[0])
        gap = _svr_gap(x, y, alpha, C, gamma)
        ms = statistics.median([first_ms] + [_time_ms(run)[0]
                                             for _ in range(2)])
        # the latency floor: every iteration waits for the probe's chain
        floor_ms = it * sync_us / 1e3
        print(f"# svr {shape} n={n} C={C} gamma={gamma!r} on {smi}: kernel "
              f"(state in {route} memory) {ms!r} ms (median of 3, CUDA "
              f"events), state in global memory {global_ms!r} ms (one "
              f"call), plain {plain_ms!r} ms (one call, host clock to a "
              f"sync); iterations kernel {it} / plain {p_it}, mean active "
              f"set {sum_active / max(1, it)!r}, {evals} kernel "
              f"evaluations; alpha, rho and iterations bitwise equal to the "
              f"plain loop: {same}, to the global route: {same_global}; max "
              f"|alpha, rho diff| {err!r}; max |prediction diff| "
              f"{pred_err!r} of max |prediction| {scale!r}; recomputed "
              f"stopping gap {gap!r} (tol {TOL}); latency floor "
              f"{floor_ms!r} ms", flush=True)
        assert same and same_global, (same, same_global, it, p_it)
        assert pred_err <= SVR_RTOL * scale, (pred_err, scale)
        assert gap < SVR_GAP_SLACK * TOL, gap
        # FP64 work every SMO iteration needs over the active set, whatever
        # a solver caches: columns i and j of Q (7 each: 6 arithmetic, the
        # exp as one), the selection (6) and the G update (4); G_bar
        # updates and gradient reconstructions left out.  x and y in,
        # alpha out
        res[tag] = {
            "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "iterations": it, "latency_floor_ms": floor_ms,
            "global_route_ms": global_ms,
            **_bound(24 * sum_active, 2 * n * 8 + 2 * n * 8, PEAK_FP64)}
    # beyond the shared memory: the global route's own traffic, a totals
    # fit too large for any other route of the kernel and, in a smoke
    # run's time, for the plain loop
    n = SVR_GLOBAL_N
    x_np, y_np, C, gamma = _svr_data("totals", n)
    x = torch.as_tensor(x_np, dtype=torch.float64, device=DEVICE)
    y = torch.as_tensor(y_np, dtype=torch.float64, device=DEVICE)
    route = kernels.svr_route(n)
    g_ms, (alpha, rho, stats) = _time_ms(
        lambda: kernels.svr_smo(x, y, C, EPSILON, gamma, TOL))
    it, sum_active, evals = (int(v) for v in stats.cpu())
    gap = _svr_gap(x, y, alpha, C, gamma)
    ap, an = alpha[:n], alpha[n:]
    balance = abs(float(ap.sum() - an.sum()))
    in_box = bool(((alpha >= 0) & (alpha <= C)).all())
    print(f"# svr totals n={n} C={C} gamma={gamma!r} on {smi}: kernel (state "
          f"in {route} memory) {g_ms!r} ms (one call, CUDA events); "
          f"iterations {it}, mean active set {sum_active / max(1, it)!r}, "
          f"{evals} kernel evaluations; recomputed stopping gap {gap!r} "
          f"(tol {TOL}); |sum alpha+ - sum alpha-| {balance!r}; alpha in "
          f"[0, C]: {in_box}; rho {float(rho)!r}; latency floor "
          f"{it * sync_us / 1e3!r} ms", flush=True)
    assert route == "global" and it > 0 and in_box and \
        np.isfinite(float(rho)) and gap < SVR_GAP_SLACK * TOL and \
        balance <= 1e-6 * C, (route, it, in_box, gap, balance)
    out = dict(res["cv"])
    out.update(totals_ms=res["totals"]["ms"],
               totals_iterations=res["totals"]["iterations"],
               totals_plain_ms=res["totals"]["plain_ms"],
               totals_bound_ms=res["totals"]["bound_ms"],
               totals_latency_floor_ms=res["totals"]["latency_floor_ms"],
               totals_global_route_ms=res["totals"]["global_route_ms"],
               global_n=n, global_n_ms=g_ms, global_n_iterations=it,
               global_n_latency_floor_ms=it * sync_us / 1e3,
               sync_us_per_iteration=sync_us, cluster_blocks=cl)
    return out


def _clustered(rng, n, d):
    """n points in d dimensions around N_CLUSTERS centres (a PCA space
    with clusters) and their labels."""
    centers = 4.0 * rng.randn(N_CLUSTERS, d)
    labels = rng.randint(N_CLUSTERS, size=n)
    return centers[labels] + rng.randn(n, d), labels


def _tsne_pass_ms(y, P, pval, reps=20):
    """ms per call of the t-SNE kernel's pair pass and attractive pass,
    each launched alone (median of 3 x reps launches, CUDA events; not
    counted: timing launches of a path the checks already ran)."""
    from velocyto_tpu_torch import kernels
    w = kernels._tsne_prepare(y, P.indptr, P.indices32, pval)

    def pairs():
        for _ in range(reps):
            kernels._tsne_pairs(w)

    def attract():
        for _ in range(reps):
            kernels._tsne_attract(w, False)

    pairs()
    attract()
    torch.cuda.synchronize()
    return tuple(statistics.median(_time_ms(f)[0] for _ in range(3)) / reps
                 for f in (pairs, attract)) + (w["splits"],)


def tsne_phase(smi):
    """The t-SNE gradient kernel against the dense plain gradient at
    CELLS points on the card in 1, 2 and 3 dimensions (two calls bitwise
    equal), its two passes timed apart, a 1,000-iteration t-SNE timed, and
    a short perform_TSNE(n_dims=3) through the kernel."""
    from velocyto_tpu_torch import analysis, kernels
    from velocyto_tpu_torch.ops import tsne as tt
    phase(f"t-SNE gradient kernel against plain, {CELLS} points, on the card")
    rng = np.random.RandomState(51)
    X, labels = _clustered(rng, CELLS, TSNE_PCS)
    x = torch.as_tensor(X, device=DEVICE)
    t0 = time.perf_counter()
    P = tt.joint_probabilities_nn(x, TSNE_PERPLEXITY)
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    pval = P.data.to(torch.float32)
    nnz = P.indices.numel()
    pairs = CELLS * CELLS
    worst, passes = 0.0, {}
    for d in (1, 2, 3):
        dof = max(d - 1, 1)
        for scale in (1e-4, 1.0, 30.0):      # the start, mid-run, spread out
            y = torch.as_tensor(
                (scale * rng.randn(CELLS, d)).astype(np.float32),
                device=DEVICE)
            got, err = kernels.tsne_grad(y, P.indptr, P.indices32, pval, True)
            again, err2 = _uncounted(lambda: kernels.tsne_grad(
                y, P.indptr, P.indices32, pval, True))
            torch.cuda.synchronize()
            same = _bitwise(got, again) and float(err) == float(err2)
            want, want_err = tt._tsne_grad_plain(y, P, pval, dof, True)
            diff = (got - want).abs()
            top = float(want.abs().max())
            atol = min(TSNE_ATOL, TSNE_ATOL_REL * top)
            ok = bool(torch.all(diff <= atol + TSNE_RTOL * want.abs()))
            err_rel = abs(float(err) - want_err) / abs(want_err)
            worst = max(worst, float(diff.max()))
            print(f"# check tsne_grad n={CELLS} d={d} nnz={nnz} "
                  f"scale={scale}: max_abs_err={float(diff.max())!r} (max "
                  f"|grad| {top!r}, atol {atol!r}) ok={ok}; KL {float(err)!r} "
                  f"vs plain {want_err!r} (rel {err_rel!r}); two calls "
                  f"bitwise equal: {same}", flush=True)
            assert ok and err_rel <= TSNE_RTOL and same, \
                "t-SNE kernel disagrees"
        pair_ms, attract_ms, splits = _tsne_pass_ms(y, P, pval)
        passes[d] = (pair_ms, attract_ms)
        print(f"# time tsne_grad n={CELLS} d={d} on {smi}: pair pass "
              f"{pair_ms!r} ms ({splits} column ranges), attractive pass "
              f"{attract_ms!r} ms (each alone, median of 3 x 20 launches, "
              f"CUDA events); {pairs / pair_ms / 1e6!r} G pairs/s",
              flush=True)
    y = torch.as_tensor(rng.randn(CELLS, 2).astype(np.float32),
                        device=DEVICE)
    reps = 20

    def kernel_reps():
        for _ in range(reps):
            kernels.tsne_grad(y, P.indptr, P.indices32, pval, False)

    ms = statistics.median(_uncounted(lambda: _time_ms(kernel_reps)[0])
                           for _ in range(3)) / reps
    plain_ms = statistics.median(_time_ms(
        lambda: tt._tsne_grad_plain(y, P, pval, 1, False))[0]
        for _ in range(3))
    print(f"# time tsne_grad n={CELLS} d=2 on {smi}: kernel {ms!r} ms per "
          f"gradient (median of 3 x {reps} calls, CUDA events), plain "
          f"{plain_ms!r} ms (median of 3); P (kNN, perplexity search, "
          f"symmetrisation) {p_s:.3f} s", flush=True)
    _print_sfu_floor("tsne_grad", pairs)
    hist = []
    np.random.seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb, kl, last = tt.tsne(x, perplexity=TSNE_PERPLEXITY, device=DEVICE,
                            history=hist)
    secs = time.perf_counter() - t0
    print(f"# t-SNE n={CELLS} d={TSNE_PCS} perplexity={TSNE_PERPLEXITY}: "
          f"{last + 1} iterations in {secs:.3f} s on {smi} (host clock, P "
          f"and the start included); KL at each check {hist}", flush=True)
    assert np.isfinite(emb).all() and np.isfinite(hist).all(), "t-SNE"
    assert len(hist) > 5 and hist[-1] < hist[4], \
        "KL did not fall after the exploration stage"
    # three output dimensions through VelocytoLoom.perform_TSNE
    v = analysis.VelocytoLoom.__new__(analysis.VelocytoLoom)
    v.device = torch.device(DEVICE)
    v.pcs = X[:TSNE3_CELLS]
    np.random.seed(1)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v.perform_TSNE(n_dims=3, max_iter=TSNE3_ITER)
    secs3 = time.perf_counter() - t0
    launches3 = kernels.tsne_launches
    on_ts = _label_agreement(v.ts, labels[:TSNE3_CELLS])
    on_pcs = _label_agreement(X[:TSNE3_CELLS, :3], labels[:TSNE3_CELLS])
    print(f"# perform_TSNE(n_dims=3) on {TSNE3_CELLS} points, max_iter="
          f"{TSNE3_ITER}: {secs3:.3f} s on {smi} (host clock); ts "
          f"{v.ts.shape}; {launches3} t-SNE kernel launches; 15-NN label "
          f"agreement {on_ts!r} on ts, {on_pcs!r} on pcs[:, :3]", flush=True)
    assert v.ts.shape == (TSNE3_CELLS, 3) and np.isfinite(v.ts).all()
    # two launches per gradient, one gradient per iteration (the descent
    # may stop early)
    assert 0 < launches3 <= 2 * TSNE3_ITER and launches3 % 2 == 0 and \
        on_ts >= on_pcs, (launches3, on_ts, on_pcs)
    # per pair: 2 sub, 3 for d^2, 1 add, 1 rcp, 1 mul, 2 FMA (4), 1 add;
    # positions and the CSR of P in, the gradient out
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": worst,
            "pair_ms": passes[2][0], "attract_ms": passes[2][1],
            "pass_ms_by_dim": passes, "tsne_s": secs,
            "tsne_iterations": last + 1, "tsne3_launches": launches3,
            **_bound(13 * pairs, CELLS * 8 * 2 + (CELLS + 1) * 8 + nnz * 8)}


def _heuristic_data():
    """synth at GENES genes plus BG_GENES background genes (Poisson at
    lognormal rates, enough counts to pass the detection filter, drawn
    in bulk on the device from a seeded generator), the cells labelled
    by their dominant latent factor; returns (S, U, labels, colour
    dict)."""
    rng = np.random.RandomState(4)
    S, U, _gamma_true, zl = synth(rng, CELLS, GENES)
    rate = torch.as_tensor(np.clip(rng.lognormal(-3.0, 1.0, BG_GENES), 0.004,
                                   None)[:, None], dtype=torch.float32,
                           device=DEVICE).expand(BG_GENES, CELLS)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    S = np.concatenate([S, torch.poisson(rate, generator=gen).cpu().numpy()])
    U = np.concatenate([U, torch.poisson(0.3 * rate + 0.01,
                                         generator=gen).cpu().numpy()])
    labels = np.array([f"cl{i:02d}" for i in zl.argmax(1)], dtype=object)
    colors = {f"cl{i:02d}": [i / N_CLUSTERS, 0.5, 1 - i / N_CLUSTERS]
              for i in range(N_CLUSTERS)}
    return S, U, labels, colors


def _label_agreement(points, labels, k=15):
    """The mean share of each cell's k nearest neighbours in `points`
    that carry its label."""
    from velocyto_tpu_torch.ops import knn_device as kd
    _d, idx = kd.knn_search_dev(np.ascontiguousarray(points, np.float64),
                                k + 1, device=DEVICE)
    lab = torch.as_tensor(np.unique(labels, return_inverse=True)[1],
                          device=idx.device)
    return float((lab[idx[:, 1:]] == lab[:, None]).float().mean())


def heuristic_phase(smi):
    """The reference's heuristic session through the VelocytoLoom entry
    points, with the launch counts set to 0 just before; returns (stage
    seconds, total, launch counts, peak device memory)."""
    from velocyto_tpu_torch import analysis, kernels
    genes = GENES + BG_GENES
    phase(f"heuristic session, {CELLS} cells x {genes} raw genes")
    t0 = time.perf_counter()
    S, U, labels, colors = _heuristic_data()
    print(f"# synthesize: {time.perf_counter() - t0:.3f} s host, on {smi}",
          flush=True)
    v = _new_loom(S, U, genes)
    del S, U
    v.set_clusters(labels, cluster_colors_dict=colors)
    n_cv = max(1000, min(int((CELLS / 1000) ** (1 / 3) / 0.0008), 5000))
    fits = []
    base_svr = analysis.SVR

    class _Recorded(base_svr):
        # what each fit of the session saw, for the checks
        def fit(self, X, y):
            out = super().fit(X, y)
            fits.append((len(X), self.n_iter_, len(self.support_)))
            return out

    stages, counts = {}, {}
    stage = _stager(stages, smi)

    def _filter_and_norm():
        analysis.SVR = _Recorded
        try:
            v.default_filter_and_norm()
        finally:
            analysis.SVR = base_svr
        counts["kept"] = v.S.shape[0]

    def _vel():
        v.predict_U()
        v.calculate_velocity()
        v.calculate_shift(assumption="constant_velocity")
        v.extrapolate_cell_at_t(delta_t=1.)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()              # count this path's launches only
    t_all = time.perf_counter()
    stage("filter_and_norm", _filter_and_norm)
    stage("fit_preparation", v.default_fit_preparation)
    stage("fit_gammas", v.fit_gammas)
    stage("velocity", _vel)
    stage("tsne", lambda: v.perform_TSNE(n_pca_dim=TSNE_PCS))
    stage("transition_prob", lambda: v.estimate_transition_prob(
        hidim="Sx_sz", embed="ts", transform="sqrt", knn_random=True,
        n_neighbors=N_NEIGHBORS, sampled_fraction=SAMPLED_FRACTION))
    stage("embedding_shift", lambda: v.calculate_embedding_shift(
        sigma_corr=0.05))
    stage("grid_arrows", lambda: v.calculate_grid_arrows(
        smooth=0.5, steps=(40, 40), n_neighbors=100))
    total = time.perf_counter() - t_all
    launches = _launches()
    svr_routes = {"shared": kernels.svr_shared_launches,
                  "global": kernels.svr_global_launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"# heuristic session total: {total:.3f} s on {smi}; SVR fits "
          f"(points, iterations, support vectors) {fits}; genes kept "
          f"{counts['kept']}; kernel launches {launches}, SVR by route "
          f"{svr_routes}; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)

    phase("checks, heuristic session")
    kept = np.array([int(g[1:]) for g in v.ra["Gene"]])
    n_expressed = int((kept < GENES).sum())
    print(f"# genes kept {len(kept)}, of them {n_expressed} of the {GENES} "
          f"expressed ones; CV-vs-mean selection "
          f"{int(v.cv_mean_selected.sum())} for N={n_cv}", flush=True)
    assert len(fits) == 2 and fits[0][0] >= SVR_CV_MIN and \
        fits[1][0] == CELLS, fits
    assert launches["svr"] == 2 and \
        launches["partial"] == _sampler_chunks() and \
        launches["dense"] == 0 and launches["fma"] == 0 and \
        launches["balance"] == launches["balance_decode"] == 1, launches
    assert svr_routes == {"shared": 2, "global": 0}, svr_routes
    # two launches per gradient, one gradient per t-SNE iteration
    assert 500 < launches["tsne"] <= 2000 and launches["tsne"] % 2 == 0, \
        launches
    # the reference keeps score >= the (N+1)-th largest score: N + 1 genes
    # and any that tie with it (Poisson genes can share mean and CV)
    score, sel = v.cv_mean_score, v.cv_mean_selected
    cut = np.sort(score)[::-1][n_cv]
    n_above, n_sel = int((score > cut).sum()), int(sel.sum())
    print(f"# CV-vs-mean cut: {n_above} genes above the (N+1)-th score, "
          f"{n_sel - n_above} at it", flush=True)
    assert n_above <= n_cv < n_sel and np.array_equal(sel, score >= cut) \
        and score[sel].min() > score[~sel].max(), (n_above, n_sel, n_cv)
    # the CV ranking keeps a larger share of the overdispersed (expressed)
    # genes than of the Poisson background
    assert n_expressed / GENES > (len(kept) - n_expressed) / BG_GENES and \
        len(kept) <= n_sel, (n_expressed, len(kept))
    assert v.ts.shape == (CELLS, 2) and np.all(np.isfinite(v.ts)), "ts"
    for name in ("delta_embedding", "delta_embedding_random", "flow"):
        assert np.all(np.isfinite(getattr(v, name))), f"{name} not finite"
    on_ts = _label_agreement(v.ts, v.cluster_labels)
    on_pcs = _label_agreement(v.pcs[:, :2], v.cluster_labels)
    print(f"# cluster separation: 15-NN label agreement {on_ts!r} on ts, "
          f"{on_pcs!r} on pcs[:, :2]", flush=True)
    assert on_ts >= on_pcs, (on_ts, on_pcs)
    return stages, total, launches, peak


def bench_phase():
    from velocyto_tpu_torch import bench, kernels
    phase("kernel bench (python3 -m velocyto_tpu_torch.bench)")
    kernels.reset_counts()              # count this path's launches only
    result = bench.main()
    launches = _launches()
    print(f"# bench launches {launches}", flush=True)
    assert launches["dense"] and launches["partial"] and launches["fma"] \
        and not launches["svr"] and not launches["tsne"] and \
        not launches["balance"] and not launches["balance_decode"], \
        f"a bench kernel never ran: {launches}"
    for key in ("value", "large_n_cells_per_sec", "dense_kernel_tflops_f32",
                "fma_ceiling_tflops_f32"):
        assert np.isfinite(result[key]) and result[key] > 0, key
    return result, launches


def _scratch_dir():
    """A temporary directory inside the checkout (gitignored), removed
    when its block ends."""
    import tempfile
    return tempfile.TemporaryDirectory(
        prefix="_chip_smoke_", dir=os.path.dirname(os.path.abspath(__file__)))


def bench_pipeline_phase(smi):
    """python3 -m velocyto_tpu_torch.bench_pipeline at full size with
    BENCH_PIPE_REPS runs (one warm-up); each run makes one dual sampled
    launch per replay chunk and a finite delta_embedding, and the JSON's
    stages are the JAX harness's."""
    from velocyto_tpu_torch import bench_pipeline, kernels
    phase(f"pipeline bench (python3 -m velocyto_tpu_torch.bench_pipeline), "
          f"{BENCH_PIPE_REPS} runs")
    run_once = bench_pipeline.run_once
    per_run = []

    def _counted(*args, **kw):
        before = _launches()
        out = run_once(*args, **kw)
        after = _launches()
        per_run.append({k: after[k] - before[k] for k in after})
        assert np.all(np.isfinite(out[2].delta_embedding)), \
            "delta_embedding not finite"
        return out

    kernels.reset_counts()              # count this path's launches only
    bench_pipeline.run_once = _counted
    try:
        result = bench_pipeline.main(reps=BENCH_PIPE_REPS)
    finally:
        bench_pipeline.run_once = run_once
    launches = _launches()
    print(f"# pipeline bench on {smi}: median {result['value']!r} s "
          f"(min {result['min_total']!r}, max {result['max_total']!r}, "
          f"{result['n_clean']} clean of {BENCH_PIPE_REPS - 1} measured); "
          f"launches per run {per_run}", flush=True)
    assert len(per_run) == BENCH_PIPE_REPS and all(
        r == {"dense": 0, "flat": 0, "partial": _sampler_chunks(), "fma": 0,
              "svr": 0, "tsne": 0, "balance": 1, "balance_decode": 1}
        for r in per_run), per_run
    assert list(result["stages"]) == PIPELINE_STAGES, list(result["stages"])
    assert all(list(r["stages"]) == PIPELINE_STAGES for r in result["runs"])
    return result, launches


def profile_phase(smi, S, U, unprofiled):
    """One full-mode and one default-mode pipeline (bench_pipeline.run_once)
    on S, U under utils.profiling.trace: the device's idle share over the
    whole pipeline and over its transition stage, the PROFILE_TOP device
    kernels that took the most time, and the profiled total beside the
    unprofiled one (`unprofiled`: mode -> seconds of pipeline_phase's
    run on the same data)."""
    from velocyto_tpu_torch import bench_common, bench_pipeline, kernels
    from velocyto_tpu_torch.utils.profiling import trace
    phase("pipeline under torch.profiler, full and default mode")
    transition = PIPELINE_STAGES[5]
    out, launches = {}, {}
    kernels.reset_counts()              # count this path's launches only
    for mode, knn_random in (("full", False), ("default", True)):
        with _scratch_dir() as logdir:
            with trace(logdir) as prof:
                with torch.profiler.record_function("pipeline"):
                    total, stages, v = bench_pipeline.run_once(
                        S, U, DEVICE, knn_random)
            del v
            trace_mb = sum(os.path.getsize(os.path.join(logdir, f))
                           for f in os.listdir(logdir)) / 2**20
        rec = {"profiled_s": total, "unprofiled_s": unprofiled[mode],
               "idle_share": bench_common.idle_share(
                   prof, *bench_common.host_window(prof, "pipeline")),
               "transition_idle_share": bench_common.idle_share(
                   prof, *bench_common.host_window(prof, transition)),
               "transition_s": stages[transition],
               "top_kernels": bench_common.top_device_kernels(
                   prof, PROFILE_TOP),
               "trace_mib": trace_mb}
        del prof
        out[mode] = rec
        print(f"# profile, {mode} mode, on {smi}: idle share "
              f"{rec['idle_share']!r} over the pipeline, "
              f"{rec['transition_idle_share']!r} over the transition stage; "
              f"profiled total {total!r} s against {unprofiled[mode]!r} s "
              f"unprofiled; Chrome trace {trace_mb:.1f} MiB", flush=True)
        for k in rec["top_kernels"]:
            print(f"#   {k['ms']:10.3f} ms {k['calls']:6d}x  "
                  f"{k['name'][:110]}", flush=True)
        for share in (rec["idle_share"], rec["transition_idle_share"]):
            assert 0.0 <= share < 1.0, share
        torch.cuda.empty_cache()
    launches = _launches()
    assert launches["dense"] == 1 and \
        launches["partial"] == _sampler_chunks() and \
        launches["balance"] == launches["balance_decode"] == 2, launches
    return out, launches


def attr_phase(smi):
    """python3 -m velocyto_tpu_torch.bench_attr: the transition stage's,
    the 50k kNN's and the 20k kNN's sub-stages on the card."""
    from velocyto_tpu_torch import bench_attr, kernels
    phase("stage attribution (python3 -m velocyto_tpu_torch.bench_attr)")
    kernels.reset_counts()              # count this path's launches only
    res = bench_attr.main("all")
    launches = _launches()
    t = res["transition_prob_substages"]
    k20 = res["knn_20k_substages"]
    print(f"# attribution on {smi}: transition sub-stages sum "
          f"{t['sum']!r} s, whole {t['transition_prob(whole)']!r} s, idle "
          f"share over the whole {t['idle_share(whole)']!r}; knn50k sum "
          f"{res['knn_50k_substages']['sum']!r} s; knn20k sum "
          f"{k20['sum']!r} s with balance_scan {k20['balance_scan']!r} s, "
          f"the host loop on the same candidates "
          f"{k20['balance_loop(host)']!r} s; launches {launches}",
          flush=True)
    # warm-up and timed: main alone, dual; whole (one launch per replay
    # chunk): warm-up, timed, profiled; one balance per kNN run, each kNN
    # warm-up and timed
    assert launches["partial"] == 4 + 3 * _sampler_chunks() and \
        launches["dense"] == 0 and \
        launches["balance"] == launches["balance_decode"] == 4, launches
    assert 0.0 <= t["idle_share(whole)"] < 1.0
    for table in res.values():
        if isinstance(table, dict):
            assert all(np.isfinite(v) and v > 0 for k, v in table.items()
                       if isinstance(v, float) and k != "idle_share(whole)")
    return res, launches


def knn50k_phase(smi):
    """python3 -m velocyto_tpu_torch.bench_knn50k with KNN50K_REPS runs
    (one warm-up) at 50,000 cells."""
    from velocyto_tpu_torch import bench_knn50k, kernels
    phase(f"50k balanced kNN bench (python3 -m "
          f"velocyto_tpu_torch.bench_knn50k), {KNN50K_REPS} runs")
    kernels.reset_counts()              # count this path's launches only
    rec = bench_knn50k.main(reps=KNN50K_REPS)
    launches = _launches()
    print(f"# knn50k bench on {smi}: median {rec['value']!r} s, stages "
          f"{rec['stages']}", flush=True)
    assert launches == {**{k: 0 for k in _COUNTS},
                        "balance": KNN50K_REPS,
                        "balance_decode": KNN50K_REPS}, launches
    assert list(rec["stages"]) == ["candidate_sort", "rescore_f64",
                                   "reorder_truncate", "hub_order",
                                   "balance_scan"]
    return rec, launches


def _bits64(a, b):
    """Same shape and the same 64-bit patterns."""
    view = (lambda t: t.view(torch.int64) if t.dtype == torch.float64
            else t)
    return a.shape == b.shape and bool(torch.equal(view(a), view(b)))


def _same_balance(got, want):
    """dist_new, dsi_new and l bitwise equal (want may be host arrays)."""
    return all(_bits64(g, w if isinstance(w, torch.Tensor) else
                       torch.as_tensor(w, device=g.device))
               for g, w in zip(got, want))


def _balance_invariants(dsi_new, l, maxl):
    """l <= maxl everywhere, and l is the in-degree of the balanced rows
    (their accepted entries: neither -1 nor the row's own cell)."""
    n = dsi_new.shape[0]
    rows = dsi_new[:, 1:]
    taken = (rows >= 0) & (rows != torch.arange(n, device=rows.device)[:,
                                                                        None])
    indeg = torch.bincount(rows[taken], minlength=n)
    return bool((l <= maxl).all()) and bool(torch.equal(indeg, l))


def _host_balance(dsi, dist, lsi, maxl, k, cst=None):
    """The host greedy loops on the card's candidates: the numpy loop
    (balance_knn_loop_plain, the series kept since the balance kernel
    came) and the C++ loop (native.balance_knn_loop).  Returns (the numpy
    loop's outputs back on the card, seconds with the copies to and from
    the host, seconds of the numpy loop alone, the C++ loop's outputs on
    the card, seconds of the C++ loop alone)."""
    from velocyto_tpu_torch import native
    from velocyto_tpu_torch.ops.knn import balance_knn_loop_plain
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = [t.cpu().numpy() for t in (dsi, dist, lsi)]
    c = None if cst is None else cst.cpu().numpy()
    t1 = time.perf_counter()
    out = balance_knn_loop_plain(*host, maxl, k, True, c)
    t2 = time.perf_counter()
    out = [torch.as_tensor(a, device=DEVICE) for a in out]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    nat = native.balance_knn_loop(*host, maxl, k, True, c)
    t4 = time.perf_counter()
    nat = [torch.as_tensor(a, device=DEVICE) for a in nat]
    return out, t3 - t0, t2 - t1, nat, t4 - t3


def _examined(dsi, dsi_new, k):
    """The positions each row examined: up to its k-th acceptance, the
    whole row where it took fewer."""
    n, sight = dsi.shape
    last = dsi_new[:, k]
    full = last != torch.arange(n, device=dsi.device)     # k accepted
    pos = (dsi == last[:, None]).to(torch.int32).argmax(dim=1)
    return torch.where(full, pos + 1, sight)


def _accepted(dsi_new):
    """Accepted entries of the balanced rows (slots 1..k that are neither
    -1 nor the row's own cell)."""
    n = dsi_new.shape[0]
    rows = dsi_new[:, 1:]
    own = rows == torch.arange(n, device=rows.device)[:, None]
    return int(((rows >= 0) & ~own).sum())


def _balance_bound(dsi, dsi_new, k):
    """bound_ms of one balance (walk and decode): compulsory bytes at
    3.35 TB/s, counting what this run's data needs: the examined
    candidate indices of each row (up to its k-th acceptance, the whole
    row where it self-fills), the visit order, the accepted distances,
    and the (n, k+1) int64 and float64 outputs and l written once."""
    n, sight = dsi.shape
    examined = _examined(dsi, dsi_new, k)
    nbytes = 8 * int(examined.sum()) + 8 * n + 8 * _accepted(dsi_new) + \
        16 * n * (k + 1) + 8 * n
    return {**_bound(0, nbytes), "examined_mean": float(
        examined.double().mean())}


def _decode_bound(dsi, dsi_new, k):
    """bound_ms of the decode alone: the words of each row's examined
    region and its (p, self) read, the accepted indices and distances
    gathered, dist[el, 0] for the rows that self-fill, the (n, k+1)
    int64 and float64 rows written."""
    n, sight = dsi.shape
    examined = _examined(dsi, dsi_new, k)
    selffill = int((dsi_new[:, k] == torch.arange(n, device=dsi.device)
                    ).sum())
    nbytes = 4 * int(((examined + 31) // 32).sum()) + 8 * n + \
        16 * _accepted(dsi_new) + 8 * selffill + 16 * n * (k + 1)
    return _bound(0, nbytes)


def _median_ms(fn, reps=3):
    """(median ms of reps calls by CUDA events, the last result); each
    result is dropped before the next call, so the allocator hands the
    next call the same blocks."""
    times, out = [], None
    for _ in range(reps):
        out = None
        t, out = _time_ms(fn)
        times.append(t)
    return statistics.median(times), out


def _hold_balance(name, dsi, dist, lsi, cst, maxl, smi):
    """knn_balance (walk and decode) on one case, bitwise against the
    plain scan, the host loop, the other l route and, with groups, the
    other place of the labels; the decode against its plain twin on the
    walk's bits; the invariants of l; times."""
    from velocyto_tpu_torch import kernels
    from velocyto_tpu_torch.ops import knn_device as kd
    n, sight = dsi.shape
    plan = kernels.balance_plan(n, sight, K, maxl, cst is not None)
    other = "global" if plan.route == "shared" else "shared"
    ms, got = _median_ms(lambda: kernels.knn_balance(
        dsi, dist, lsi, cst, maxl, K))
    walk_ms, (bits, meta, _l, _plan) = _median_ms(
        lambda: kernels.balance_walk(dsi, lsi, cst, maxl, K))
    decode_ms, dec = _median_ms(lambda: kernels.balance_decode(
        bits, meta, dsi, dist, K))
    decode_plain_ms, dec_want = _median_ms(lambda: kd._balance_decode_plain(
        bits, meta, dsi, dist, K), reps=2)
    forced = kernels.knn_balance(dsi, dist, lsi, cst, maxl, K, route=other)
    same = {"plain": None, "host loop": None, "native loop": None,
            f"{other} route": _same_balance(got, forced)}
    if cst is not None:
        labels = "staged" if plan.labels == "shared" else "shared"
        same[f"{labels} labels"] = _same_balance(got, kernels.knn_balance(
            dsi, dist, lsi, cst, maxl, K, labels=labels))
    del forced
    plain_ms, want = _time_ms(lambda: kd._balance_scan_plain(
        dsi, dist, lsi, cst, maxl, K))
    same["plain"] = _same_balance(got, want)
    err = float((got[0] - want[0]).abs().max())
    del want
    host, host_s, loop_s, nat, native_s = _host_balance(dsi, dist, lsi,
                                                        maxl, K, cst)
    same["host loop"] = _same_balance(got, host)
    same["native loop"] = _same_balance(got, nat)
    del host, nat
    dec_same = _same_balance(dec, dec_want) and _same_balance(dec, got[:2])
    inv = _balance_invariants(got[1], got[2], maxl)
    examined = _examined(dsi, got[1], K)
    past = int((examined > plan.depth).sum())
    selffilled = int((got[1][:, K] == torch.arange(n, device=DEVICE)).sum())
    dec_err = float((dec[0] - dec_want[0]).abs().max())
    print(f"# balance {name}: N={n} sight={sight} k={K} maxl={maxl}"
          f"{f' {BALANCE_GROUPS} groups' if cst is not None else ''} on "
          f"{smi}: plan {tuple(plan)} (l route, R, T, labels), "
          f"{kernels._BALANCE_THREADS} walkers; walk + decode {ms!r} ms (median of "
          f"3, CUDA events) = {ms * 1e3 / n!r} us a node; walk {walk_ms!r} "
          f"ms, decode {decode_ms!r} ms (plain twin {decode_plain_ms!r} ms, "
          f"bitwise equal: {dec_same}); plain scan {plain_ms!r} ms, host "
          f"loop (numpy) {loop_s * 1e3!r} ms alone, {host_s * 1e3!r} ms "
          f"with its copies, native loop {native_s * 1e3!r} ms alone (host "
          f"clock); {past} rows examined past T = "
          f"{plan.depth}, {float(examined.double().mean())!r} positions a "
          f"row; {selffilled} rows self-filled; bitwise equal: {same}; "
          f"l <= maxl and l the in-degree of dsi_new: {inv}", flush=True)
    assert all(same.values()) and dec_same and inv and err == 0.0 and \
        dec_err == 0.0, (name, same, dec_same, inv, err, dec_err)
    return {"ms": ms, "walk_ms": walk_ms, "decode_ms": decode_ms,
            "decode_plain_ms": decode_plain_ms, "plain_ms": plain_ms,
            "max_abs_err": err, "decode_max_abs_err": dec_err,
            "host_loop_ms": loop_s * 1e3,
            "host_loop_with_copies_ms": host_s * 1e3,
            "native_loop_ms": native_s * 1e3,
            "us_per_node": ms * 1e3 / n, "rows_past_T": past,
            "self_filled": selffilled, "plan": tuple(plan),
            "got": got, "bits": bits, "meta": meta}


def balance_phase(smi, pcs):
    """The kNN balance kernels (kernels.knn_balance: the walk, then its
    decode) on the card, bitwise against the plain scan, the host loop
    and the other l route on the default pipeline's own candidates
    (`pcs`, its 20,000 x 50 PCA space: sight 3,000, k=500, maxl 1,500)
    and on bench_knn50k's; the decode against its plain twin; every ring
    length bitwise equal and timed; three hard regimes at 20,000 cells
    (12 groups, with the labels in both places, and the same groups as
    raw labels, negative and past n; maxl == k; maxl 50, so rows
    self-fill) and many rows past T (maxl == k at 50,000 cells); the
    invariants of l; the latency floors.
    Returns the numbers of the kernels line."""
    from velocyto_tpu_torch import kernels
    from velocyto_tpu_torch.bench_knn50k import points
    from velocyto_tpu_torch.ops import knn_device as kd
    phase("kNN balance kernels (walk and decode) against plain, the host "
          "loop and the other routes, on the card")
    res = {}
    data = {}
    for tag, x in (("20k", pcs), ("50k", points(KNN50K_CELLS, KNN50K_DIMS))):
        dist, dsi = kd.knn_search_dev(x, B_SIGHT + 1, device=DEVICE)
        lsi = kd._hub_order_impl(dsi)
        n = dsi.shape[0]
        r = _hold_balance(tag, dsi, dist, lsi, None, B_MAXL, smi)
        got = r.pop("got")
        dec_bound = _decode_bound(dsi, got[1], K)
        r.update(_balance_bound(dsi, got[1], K))
        r["decode_bound_ms"] = dec_bound["bound_ms"]
        r["decode_bound_by"] = dec_bound["bound_by"]
        del got, r["bits"], r["meta"]
        # the ring lengths: each bitwise equal, timed
        want = kernels.knn_balance(dsi, dist, lsi, None, B_MAXL, K)
        rings = {}
        for st in range(2, kernels._BALANCE_MAX_STAGES + 1, 2):
            rings[st], g = _median_ms(lambda: kernels.knn_balance(
                dsi, dist, lsi, None, B_MAXL, K, stages=st), reps=2)
            assert _same_balance(g, want), ("stages", st)
        other = "global" if r["plan"][0] == "shared" else "shared"
        r["other_route_ms"], _g = _median_ms(lambda: kernels.knn_balance(
            dsi, dist, lsi, None, B_MAXL, K, route=other), reps=2)
        del want, _g, g
        # n dependent steps of the chain between nodes, with and without
        # the read of a row chunk that nothing loaded ahead
        floor_ms, chain_ms = (statistics.median(_time_ms(
            lambda: kernels.balance_probe(n, n, r["plan"][0], rows=rows))[0]
            for _ in range(3)) for rows in (dsi, None))
        print(f"# balance {tag} on {smi}: ring lengths R {rings} ms (median of 2; every one bitwise "
              f"equal); l in {other} memory {r['other_route_ms']!r} ms; "
              f"chain probe {chain_ms!r} ms ({chain_ms * 1e3 / n!r} us a "
              f"step), {floor_ms!r} ms with each row read when its step "
              f"starts; bound {r['bound_ms']!r} ms ({r['bound_by']}), "
              f"decode bound {r['decode_bound_ms']!r} ms "
              f"({r['decode_bound_by']})", flush=True)
        r.update(latency_floor_ms=floor_ms, chain_ms=chain_ms,
                 rings_ms=rings)
        res[tag] = r
        data[tag] = (dsi, dist, lsi)
        del dist, dsi, lsi
        torch.cuda.empty_cache()
    # the hard regimes at 20,000 cells: groups of the first PC's
    # quantiles (and the same groups as raw labels, negative and past n,
    # which the wrapper ranks densely), a cap of k, a cap so small that
    # sights run out; and at 50,000 cells a cap of k, where most rows run
    # past T
    pc0 = np.asarray(pcs)[:, 0]
    groups = np.searchsorted(np.quantile(pc0, np.linspace(
        0, 1, BALANCE_GROUPS + 1)[1:-1]), pc0)
    cst = torch.as_tensor(groups, dtype=torch.int32, device=DEVICE)
    raw = cst * 7919 - 40000
    assert bool((raw < 0).any()) and bool((raw >= pcs.shape[0]).any())
    for name, tag, maxl, c in (
            ("constrained", "20k", B_MAXL, cst),
            ("raw labels", "20k", B_MAXL, raw), ("maxl == k", "20k", K, None),
            ("self-fill", "20k", BALANCE_SMALL_MAXL, None),
            ("past T", "50k", K, None)):
        r = _hold_balance(name, *data[tag], c, maxl, smi)
        for key in ("got", "bits", "meta"):
            del r[key]
        if name == "self-fill":
            assert r["self_filled"] > 0, "no row self-filled"
        if name == "past T":
            assert r["rows_past_T"] >= KNN50K_CELLS // 10, r["rows_past_T"]
        res[name] = r
        torch.cuda.empty_cache()
    del data, cst, raw
    torch.cuda.empty_cache()
    return res


def checkpoint_phase(v):
    """save_state / load_state(device="cuda") of the default-mode
    session's device tensors, host arrays and metadata: tensors bitwise
    equal on the card, numpy arrays equal with their dtypes, metadata
    equal."""
    from velocyto_tpu_torch.io.checkpoint import load_state, save_state
    phase("checkpoint of the default-mode session (io.checkpoint, DCP)")
    tensors = _device_backed(v)
    arrays = {k: a for k, a in v.__dict__.items()
              if isinstance(a, np.ndarray)}
    meta = {k: m for k, m in v.__dict__.items()
            if isinstance(m, (str, int, float, bool))}
    meta["ca"], meta["ra"] = v.ca, v.ra
    state = {**tensors, **arrays, **meta}
    with _scratch_dir() as d:
        t0 = time.perf_counter()
        save_state(os.path.join(d, "ckpt"), state)
        t1 = time.perf_counter()
        got = load_state(os.path.join(d, "ckpt"), device=DEVICE)
        t2 = time.perf_counter()
    assert got.keys() == state.keys(), set(got) ^ set(state)
    for k, t in tensors.items():
        assert got[k].device == t.device and got[k].dtype == t.dtype and \
            torch.equal(got[k], t), k
    for k, a in arrays.items():
        assert isinstance(got[k], np.ndarray) and got[k].dtype == a.dtype \
            and np.array_equal(got[k], a), k
    for k in ("ca", "ra"):
        assert got[k].keys() == meta[k].keys() and all(
            np.array_equal(got[k][c], meta[k][c]) for c in meta[k]), k
    assert all(got[k] == m for k, m in meta.items() if k not in ("ca", "ra"))
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    print(f"# checkpoint: {len(tensors)} device tensors "
          f"({nbytes / 2**30:.2f} GiB), {len(arrays)} host arrays, "
          f"{len(meta)} metadata values; save {t1 - t0:.3f} s, load "
          f"{t2 - t1:.3f} s; all equal", flush=True)


# the public-surface phase: rows of the f64 brute-force spot check, rows
# of the plain sampled colDeltaCor check, the plain-loop repeats, and the
# attributes the eight plot_* methods read (default session, Sx_sz path)
SURFACE_SPOT_ROWS, SURFACE_PLAIN_ROWS, SURFACE_LOOP_REPS = 64, 500, 2
PLOT_INPUTS = ("S", "A", "U", "pcs", "colorandum", "Sx_sz", "Ux_sz",
               "Sx_sz_t", "S_sz", "gammas", "q", "flow", "flow_rndm",
               "flow_norm", "flow_norm_rndm", "flow_norm_magnitude",
               "flow_norm_magnitude_rndm", "total_p_mass", "flow_grid",
               "flow_embedding", "embedding", "delta_embedding",
               "delta_embedding_random", "ts")


def _host_ms(fn, reps):
    """(median ms on the host clock of reps calls, the last result)."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _check_plot_inputs(v):
    """Every attribute the plots read, materialised: finite, one cached
    host copy (a second read is the same object), and, where the value
    lives on the card, equal to its device tensor."""
    dev_state = _device_backed(v)
    on_card = []
    for name in PLOT_INPUTS:
        val = getattr(v, name)
        assert isinstance(val, np.ndarray) and np.all(np.isfinite(val)), name
        assert getattr(v, name) is val, f"{name}: not one cached copy"
        if name in dev_state:
            want = dev_state[name].cpu().numpy().astype(val.dtype)
            assert np.array_equal(val, want), f"{name} != its device tensor"
            on_card.append(name)
    return on_card


def _draw_plots(v, d):
    """The eight plot_* methods, scatter_viz and score_cv_vs_mean's
    figure on the Agg backend, each saved into d; returns the files."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from velocyto_tpu_torch import analysis
    genes = [str(g) for g in v.ra["Gene"][:2]]    # kept by the filters
    draws = {
        "fractions": lambda: v.plot_fractions(),
        "pca": lambda: v.plot_pca(),
        "pca_imputed": lambda: v._plot_pca_imputed(),
        "phase_portraits": lambda: v.plot_phase_portraits(genes),
        "grid_arrows": lambda: v.plot_grid_arrows(),
        "arrows_embedding": lambda: v.plot_arrows_embedding(new_fig=True),
        "cell_transitions": lambda: v.plot_cell_transitions(cell_ix=0),
        "velocity_as_color": lambda: v.plot_velocity_as_color(
            gene_name=genes[0]),
        "expression_as_color": lambda: v.plot_expression_as_color(
            gene_name=genes[0]),
        "scatter_viz": lambda: analysis.scatter_viz(
            v.ts[:, 0], v.ts[:, 1], c=v.colorandum),
        "cv_vs_mean": lambda: v.score_cv_vs_mean(
            N=500, max_expr_avg=1e9, plot=True)}
    files = []
    for name, draw in draws.items():
        plt.figure()
        draw()
        files.append(os.path.join(d, f"{name}.png"))
        plt.savefig(files[-1], dpi=40)
        plt.close("all")
    return files


def _plots(v):
    """The plots' inputs on the session v (a colour per cluster:
    set_clusters without colours would need matplotlib), then the imputed
    PCA they draw; the figures themselves where matplotlib imports.
    Returns the number of figures drawn."""
    n = v.S.shape[1]
    labels = np.array([f"k{i % BALANCE_GROUPS}" for i in range(n)])
    v.set_clusters(labels, cluster_colors_dict={
        f"k{i}": [(i + 1) / BALANCE_GROUPS, 0.2, 0.5, 1.0]
        for i in range(BALANCE_GROUPS)})
    v.ca["SampleID"] = np.array(["s0", "s1"])[np.arange(n) % 2]
    on_card = _check_plot_inputs(v)
    v.normalize("imputed")
    v._perform_PCA_imputed(n_components=3)
    assert v.pcsx.shape == (n, 3) and np.all(np.isfinite(v.pcsx))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"# plots: matplotlib absent, inputs checked "
              f"({len(PLOT_INPUTS)} attributes, device-backed: {on_card})",
              flush=True)
        return 0
    with _scratch_dir() as d:
        files = _uncounted(lambda: _draw_plots(v, d))
        assert all(os.path.getsize(f) > 0 for f in files)
    print(f"# plots: {len(files)} figures drawn on Agg from "
          f"{len(PLOT_INPUTS)} checked attributes (device-backed: "
          f"{on_card})", flush=True)
    return len(files)


def surface_phase(v, smi):
    """The public names that complete the JAX package's surface, on the
    default session at the operating point: knn_search on the pipeline's
    PCA space, BalancedKNN with the native loop (native/balance.cpp),
    col_delta_cor_partial_compact_dev on the session's compact neighbour
    ids, smooth_dev, and the inputs of the plots (drawn where matplotlib
    imports).  The launch counts are set to 0 just before these entry
    points run and read just after: one sampled launch and no other;
    the comparisons after them are left out of the counts.  Returns the
    counts and the phase's times."""
    from velocyto_tpu_torch import kernels, native
    from velocyto_tpu_torch.analysis import _corr_transform_dev, _fix_nans
    from velocyto_tpu_torch.ops import knn as tknn
    from velocyto_tpu_torch.ops import knn_device as kd
    from velocyto_tpu_torch.ops.coldeltacor import (
        _col_delta_cor_partial_plain, _TRANSFORMS,
        col_delta_cor_partial_compact, col_delta_cor_partial_compact_dev)
    phase(f"public surface on the default session, {CELLS} cells x "
          f"{GENES} genes")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    native.build_balance()
    build_s = time.perf_counter() - t0
    space = np.ascontiguousarray(v.pcs)
    hi = v._get_dev("Sx_sz")
    psc, ixs = 1e-10, v._compact_ixs_dev
    d_main = _corr_transform_dev(hi, v._get_dev("delta_S"), v.used_delta_t,
                                 psc, "sqrt")
    nbr_idx, nbr_w = kd.compact_weights_dev(v._knn_graph_dev)
    S_sz = v._get_dev("S_sz")
    torch.cuda.synchronize()

    times = {}
    kernels.reset_counts()              # count this path's launches only
    times["knn_search_ms"], (dist, idx) = _host_ms(
        lambda: tknn.knn_search(space, K, device=DEVICE), 1)
    bk = tknn.BalancedKNN(k=K, sight_k=B_SIGHT, maxl=B_MAXL, device=DEVICE)
    t0 = time.perf_counter()
    got = bk.fit(space).kneighbors()
    times["balanced_knn_s"] = time.perf_counter() - t0
    times["partial_compact_dev_ms"], corr = _time_ms(
        lambda: col_delta_cor_partial_compact_dev(hi, d_main, ixs, "sqrt",
                                                  psc, device=DEVICE))
    times["smooth_dev_ms"], smooth = _time_ms(
        lambda: kd.smooth_dev(S_sz, nbr_idx, nbr_w))
    torch.cuda.synchronize()
    launches = _launches()
    assert launches == {"dense": 0, "flat": 0, "partial": 1, "fma": 0,
                        "svr": 0, "tsne": 0, "balance": 0,
                        "balance_decode": 0}, launches
    assert native._balance_lib is not None, "native balance loop not loaded"

    def compare():
        # knn_search: the device search's rows bitwise, f64 brute force
        _d, want_idx = kd.knn_search_dev(space, K, device=DEVICE)
        knn_same = np.array_equal(idx, want_idx.cpu().numpy()) and \
            np.array_equal(dist, _d.cpu().numpy())
        rows = np.random.RandomState(2).choice(CELLS, SURFACE_SPOT_ROWS,
                                               replace=False)
        brute = _brute_knn(space.astype(np.float64), rows, K)
        knn_bad = int(np.sum(np.any(idx[rows] != brute, axis=1)))
        # the native loop against the numpy loop and KB, same candidates
        lsi = np.argsort(np.bincount(bk.dsi.ravel(), minlength=CELLS),
                         kind="mergesort")[::-1]
        times["native_loop_ms"], nat = _host_ms(
            lambda: native.balance_knn_loop(bk.dsi, bk.dist, lsi, B_MAXL, K,
                                            True), 3)
        times["numpy_loop_ms"], plain = _host_ms(
            lambda: tknn.balance_knn_loop_plain(bk.dsi, bk.dist, lsi,
                                                B_MAXL, K, True),
            SURFACE_LOOP_REPS)
        kb = kd.balance_knn_dev(torch.as_tensor(bk.dsi, device=DEVICE),
                                torch.as_tensor(bk.dist, device=DEVICE),
                                B_MAXL, K)
        out = [torch.as_tensor(a, device=DEVICE) for a in got]
        bal = {"native is BalancedKNN": _same_balance(out, nat),
               "numpy loop": _same_balance(out, plain),
               "KB": _same_balance(kb, got)}
        # the sampled call: the path's correlations (the session's dual
        # chunked launches), the single-field compact call, the plain
        # version on SURFACE_PLAIN_ROWS rows
        single = col_delta_cor_partial_compact(hi, d_main, ixs, "sqrt", psc)
        e_rows = hi.T.contiguous()
        d_rows = d_main.T.contiguous()
        r = torch.as_tensor(np.sort(np.random.RandomState(3).choice(
            CELLS, SURFACE_PLAIN_ROWS, replace=False)), device=DEVICE)
        plain_corr = _col_delta_cor_partial_plain(
            e_rows, e_rows[r], d_rows[r], ixs[r], _TRANSFORMS["sqrt"], psc)
        err, close = _err(corr[r], plain_corr)
        corr_same = {"compact single field": _bitwise(corr, single),
                     "the session's _corr_dev":
                         _bitwise(_fix_nans(corr)[0], v._corr_dev)}
        # smooth_dev: smooth_dev_multi on the one matrix
        smooth_same = _bitwise(smooth, kd.smooth_dev_multi(
            (S_sz,), nbr_idx, nbr_w)[0])
        return (knn_same, knn_bad, bal, err, close, corr_same, smooth_same)

    knn_same, knn_bad, bal, err, close, corr_same, smooth_same = \
        _uncounted(compare)
    print(f"# public surface on {smi}: native balance library built in "
          f"{build_s:.3f} s; knn_search k={K} {times['knn_search_ms']!r} ms "
          f"(host clock, host arrays out), rows bitwise knn_search_dev's: "
          f"{knn_same}, {knn_bad} of {SURFACE_SPOT_ROWS} rows differ from "
          f"the f64 brute force; BalancedKNN(k={K}, sight_k={B_SIGHT}, "
          f"maxl={B_MAXL}) {times['balanced_knn_s']!r} s; balance loop "
          f"native {times['native_loop_ms']!r} ms (median of 3), numpy "
          f"{times['numpy_loop_ms']!r} ms (median of {SURFACE_LOOP_REPS}), "
          f"host clock; bitwise equal: {bal}; "
          f"col_delta_cor_partial_compact_dev {times['partial_compact_dev_ms']!r} "
          f"ms (CUDA events; identity order, one field): 1 sampled launch, bitwise "
          f"equal: {corr_same}, max |err| {err!r} against the plain version "
          f"on {SURFACE_PLAIN_ROWS} rows (rtol {RTOL}, atol {ATOL}: "
          f"{close}); smooth_dev {times['smooth_dev_ms']!r} ms, bitwise "
          f"smooth_dev_multi: {smooth_same}",
          flush=True)
    assert knn_same and knn_bad == 0, (knn_same, knn_bad)
    assert all(bal.values()), bal
    assert all(corr_same.values()) and close, (corr_same, err)
    assert smooth_same and smooth.shape == S_sz.shape

    _plots(v)
    times["phase_s"] = time.perf_counter() - t_phase
    print(f"# public surface phase: {times['phase_s']:.3f} s", flush=True)
    return launches, {**times, "max_abs_err": err}


# the counting phase: the tracked fixture's valid barcodes and cell batch
# (tests/test_golden_counting.py), the golden cases, and the synthetic
# fixture at bench size (bench_counting's recipe), counted serially and
# by pcount on COUNT_PROCESSES spawned workers
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
COUNT_LOGICS = ["Permissive10X", "Intermediate10X", "ValidatedIntrons10X",
                "Stricter10X", "ObservedSpanning10X", "Discordant10X",
                "SmartSeq2"]
COUNT_READS, COUNT_CELLS, COUNT_GENES, COUNT_PROCESSES = 250000, 400, 64, 4


def _golden_count(logic, mask=False, valid=True, umi_extension="no"):
    """The tracked fixture through the port's ExInCounter: layers and
    cell order sorted by barcode, and the readers its passes opened."""
    from velocyto_tpu_torch.counting import ExInCounter, LOGICS
    g = lambda name: os.path.join(GOLDEN_DIR, name)  # noqa: E731
    c = ExInCounter("s", LOGICS[logic],
                    valid_bcset={f"C{i:03d}" for i in range(15)}
                    if valid else None, umi_extension=umi_extension)
    c.peek(g("cnt_fix.bam"))
    c.read_transcriptmodels(g("cnt_ann.gtf"))
    if mask:
        c.read_repeats(g("cnt_mask.gtf"))
    c.mark_up_introns([g("cnt_fix.bam")], multimap=False)
    d, cells = c.count([g("cnt_fix_cellsorted.bam")], multimap=False,
                       cell_batch_size=5)
    o = np.argsort(cells)
    layers = {k: (np.concatenate(v, axis=1)[:, o] if v else
                  np.zeros((0, 0))) for k, v in d.items()}
    return layers, np.array(cells)[o], c._soa.readers_opened


def _same_counts(a, b, what, same_dtype=True):
    """Equal cell orders and layers (shape, values; dtype unless the
    reference is an archive)."""
    (la, ca), (lb, cb) = a, b
    assert list(ca) == list(cb), f"{what}: cell order differs"
    assert la.keys() == lb.keys(), what
    for k in la:
        assert la[k].shape == lb[k].shape and np.array_equal(la[k], lb[k]), \
            f"{what}: layer {k} differs"
        assert not same_dtype or la[k].dtype == lb[k].dtype, (what, k)


def counting_phase(smi, mesh):
    """The counting pipeline on the host: builds native/bam.cpp from the
    checkout (asserted loaded, no fallback), holds the tracked fixture's
    counts for every logic with and without the mask, the chr UMI
    extension and discovery mode bitwise to counting_golden.npz, then
    writes bench_counting's fixture (COUNT_READS reads, COUNT_CELLS
    cells, COUNT_GENES genes) with the port's bamio, cell-sorts it with
    the native sorter and counts it with the SoA engine on the native
    reader, held bitwise against object mode on the pure-Python reader,
    against pcount on COUNT_PROCESSES workers and against
    count_distributed (feeders merged over the mesh).  No kernel runs."""
    from velocyto_tpu_torch import bench_counting, kernels, native
    from velocyto_tpu_torch.counting import ExInCounter, LOGICS
    phase("counting (host): native BAM engine, goldens, bench fixture")
    kernels.reset_counts()
    before = set(native._BUILD.glob("*.so"))
    t0 = time.perf_counter()
    lib = native.build_bam()
    build_s = time.perf_counter() - t0
    fresh = lib not in before
    assert native.available(), "native BAM engine did not load"
    assert os.path.samefile(native._load()._name, lib), "stale library"
    print(f"# native/bam.cpp -> {lib.name}: {build_s:.3f} s "
          f"({'built' if fresh else 'cached'})", flush=True)

    golden = np.load(os.path.join(GOLDEN_DIR, "counting_golden.npz"))
    cases = [(lg + ("_mask" if m else ""), dict(logic=lg, mask=m))
             for lg in COUNT_LOGICS for m in (False, True)]
    cases += [("ext_chr", dict(logic="Permissive10X", umi_extension="chr")),
              ("discovery", dict(logic="Permissive10X", valid=False))]
    assert {k for k, _ in cases} == {k.split("__")[0] for k in golden}
    t0 = time.perf_counter()
    for key, kw in cases:
        layers, cells, readers = _golden_count(**kw)
        assert readers and set(readers) == {"NativeBamReader"}, (key, readers)
        _same_counts((layers, cells),
                     ({k: golden[f"{key}__{k}"] for k in layers},
                      golden[f"{key}__cells"]), f"golden {key}",
                     same_dtype=False)
    print(f"# counting goldens: {len(cases)} cases bitwise "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    with _scratch_dir() as work:
        t0 = time.perf_counter()
        gtf, bam, cs, bcf = bench_counting.make_fixture(
            work, COUNT_READS, COUNT_CELLS, COUNT_GENES)
        fixture_s = time.perf_counter() - t0
        assert native.read_tag_index(cs + ".vtx") is not None
        bcs = bench_counting.load_bcs(bcf)
        layers, cells, markup_s, count_s, engine = \
            bench_counting.count_two_pass(gtf, bam, cs, bcs)
        assert engine == "soa+NativeBamReader", engine
        assert len(cells) == COUNT_CELLS, len(cells)
        molecules = int(sum(int(m.sum()) for m in layers.values()))
        assert molecules > 0
        t0 = time.perf_counter()
        p_layers, p_cells, _m, p_count_s, p_engine = \
            bench_counting.count_two_pass(gtf, bam, cs, bcs,
                                          n_processes=COUNT_PROCESSES)
        pcount_s = time.perf_counter() - t0
        _same_counts((layers, cells), (p_layers, p_cells),
                     f"pcount({COUNT_PROCESSES})")
        t0 = time.perf_counter()
        c = ExInCounter("s", LOGICS["Permissive10X"], valid_bcset=set(bcs))
        c._fastpath_ok = lambda: False       # object mode, Python reader
        c.peek(bam)
        c.read_transcriptmodels(gtf)
        c.mark_up_introns((bam,), multimap=False)
        d, o_cells = c.count((cs,), multimap=False)
        object_s = time.perf_counter() - t0
        _same_counts((layers, cells),
                     ({k: np.concatenate(v, axis=1) for k, v in d.items()},
                      o_cells), "object mode")
        distributed_s = count_distributed_check(mesh, gtf, bam, cs, bcs,
                                                layers, cells)
    launches = _launches()
    assert not any(launches.values()), f"counting launched {launches}"
    rps = COUNT_READS / (markup_s + count_s)
    result = {"engine": engine, "reads": COUNT_READS, "cells": len(cells),
              "genes": COUNT_GENES, "molecules": molecules,
              "markup_s": markup_s, "count_s": count_s,
              "reads_per_sec": rps, "build_s": build_s,
              "build": "built" if fresh else "cached",
              "fixture_s": fixture_s, "object_mode_s": object_s,
              "pcount_processes": COUNT_PROCESSES, "pcount_s": pcount_s,
              "pcount_count_s": p_count_s,
              "count_distributed_s": distributed_s, "card": smi,
              "host_cpu": bench_counting.host_cpu(),
              "host_cores": os.cpu_count()}
    print("# counting " + json.dumps(result), flush=True)
    return result


MESH_SHARDS = 2          # shards of the mesh phases on one card
RING_RTOL, RING_ATOL = 1e-4, 1e-5   # the ring's floor (test_golden_mesh.py)


def _mesh():
    """The mesh of the mesh phases: MESH_SHARDS shards on cuda:0, each on
    its own stream, or one shard a card where there is more than one."""
    from velocyto_tpu_torch.parallel import make_mesh
    cards = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(cards)] if cards > 1
               else [torch.device("cuda", 0)] * MESH_SHARDS)
    return make_mesh(devices=devices)


def _shards(mesh):
    return mesh.shape["cells"]


def _f64_same(a, b):
    """Two float64 numpy arrays with the same bit patterns."""
    return a.shape == b.shape and np.array_equal(a.view(np.uint64),
                                                 b.view(np.uint64))


def mesh_pipeline_phase(mesh, v1, knn_random, smi, sampler=None):
    """bench_pipeline.run_once with mesh= on the raw counts of v1 (the
    mesh=None run of pipeline_phase), the launch counts set to 0 just
    before and read just after: one dual sampled launch a shard in the
    default transition call, one dual center-range dense launch a shard
    in full mode, one balance walk and decode.  Held bitwise to v1: the
    kNN graph, the transition probabilities, delta_embedding and its
    control; in the default mode the embedding kNN's sampled neighbours,
    both compact correlations, sampling_ixs and numpy's state after the
    call (the numpy loop's, sampler_phase); in full mode both dense
    corrcoefs.  Returns (seconds, stage seconds, launch counts)."""
    from velocyto_tpu_torch import analysis, bench_pipeline, kernels
    p = _shards(mesh)
    mode = "default mode (knn_random=True)" if knn_random else \
        "full mode (knn_random=False)"
    phase(f"pipeline with a mesh of {p} shards, {mode}, {CELLS} cells x "
          f"{GENES} genes")
    print("# mesh: " + "; ".join(mesh.describe().splitlines())
          + f" ({torch.cuda.device_count()} card(s): {smi})", flush=True)
    estimate = analysis.VelocytoLoom.estimate_transition_prob
    after = {}

    def _transition(self, *args, **kw):
        estimate(self, *args, **kw)
        after["rng_state"] = np.random.get_state()

    np.random.seed(1)               # the call must set numpy's state itself
    kernels.reset_counts()          # count this path's launches only
    analysis.VelocytoLoom.estimate_transition_prob = _transition
    try:
        total, stages, vm = bench_pipeline.run_once(v1.S, v1.U, DEVICE,
                                                    knn_random, mesh=mesh)
    finally:
        analysis.VelocytoLoom.estimate_transition_prob = estimate
    launches = _launches()
    print(f"# mesh pipeline total: {total:.3f} s on {smi}; kernel launches "
          f"{launches}", flush=True)
    phase(f"checks, mesh {mode}")
    want = {"dense": 0 if knn_random else p, "flat": 0,
            "partial": p if knn_random else 0, "fma": 0, "svr": 0,
            "tsne": 0, "balance": 1, "balance_decode": 1}
    assert launches == want, (launches, want)
    g1, gm = v1._knn_graph_dev, vm._knn_graph_dev
    checks = {"knn graph": bool(torch.equal(g1.idx, gm.idx))
              and _bits64(g1.dist, gm.dist)}
    if knn_random:
        checks["sampled neighbours"] = bool(torch.equal(
            v1._compact_ixs_dev, vm._compact_ixs_dev))
        checks["corr"] = _bitwise(v1._corr_dev, vm._corr_dev)
        checks["corr_random"] = _bitwise(v1._corr_rndm_dev,
                                         vm._corr_rndm_dev)
        checks["sampling_ixs"] = np.array_equal(vm.sampling_ixs,
                                                v1.sampling_ixs) and \
            np.array_equal(vm.sampling_ixs, sampler["rows"])
        checks["numpy state"] = _same_state(after["rng_state"],
                                            sampler["state"])
        tp1 = v1._stage_input("transition_prob", torch.float64)
        checks["transition_prob"] = _bits64(
            tp1, vm._stage_input("transition_prob", torch.float64))
        del tp1
        torch.cuda.empty_cache()
    else:
        for name in ("corrcoef", "corrcoef_random"):
            checks[name] = _bitwise(v1._get_dev(name), vm._get_dev(name))
        checks["transition_prob"] = _bitwise(
            v1._get_dev("transition_prob"), vm._get_dev("transition_prob"))
    for name in ("delta_embedding", "delta_embedding_random"):
        checks[name] = _f64_same(getattr(v1, name), getattr(vm, name))
    print(f"# mesh {mode} against mesh=None on the same inputs, bitwise: "
          f"{checks}", flush=True)
    assert all(checks.values()), checks
    del vm
    torch.cuda.empty_cache()
    return total, stages, launches


def mesh_kernels_phase(mesh, smi):
    """The kernels the mesh paths add, at the operating point:

      - K1's center range: each shard's range of one dual launch bitwise
        the same rows of the whole dual launch, and an unaligned range
        (the 4-byte copy route) too; the first shard's range timed;
      - the forced ring at 20,000 cells (uniform indices, nn = 1750, both
        fields) through col_delta_cor_partial_sharded_dev with
        _REPLICATION_BYTES at 1 and the locality order of a random
        embedding (timed whole), then through
        col_delta_cor_partial_ring_dev without an order, profiled, its
        pieces read from its vtt.ring.* spans; the launch counts set to
        0 just before the first and read just after the second (2 x P x
        P flat launches, nothing else); each bitwise against one sampled
        launch on the same indices; the replicated sharded call (P
        sampled launches) bitwise against the same launch;
      - the flat kernel against its plain twin (RTOL / ATOL) on every
        table of that ring's plan, each launch timed, and the plain twin
        timed on the same tables;
      - bench_scaling (the sharded and ring calls at 1, 2 and 4 shards).

    Returns the flat kernel's and K1's numbers."""
    from velocyto_tpu_torch import bench_scaling, kernels
    from velocyto_tpu_torch.ops import coldeltacor as cdc
    from velocyto_tpu_torch.parallel.mesh import bounds
    from velocyto_tpu_torch.utils.profiling import span_seconds, trace
    p = _shards(mesh)
    phase(f"mesh kernels: dense center range, flat block table, ring, "
          f"{p} shards")
    t_phase = time.perf_counter()

    def _ranges():
        rng = np.random.RandomState(3)
        e = torch.tensor(rng.rand(GENES, CELLS) * 10, dtype=torch.float32,
                         device=DEVICE)
        d = torch.tensor(rng.randn(GENES, CELLS), dtype=torch.float32,
                         device=DEVICE)
        d2 = torch.tensor(rng.randn(GENES, CELLS), dtype=torch.float32,
                          device=DEVICE)
        whole = kernels.coldeltacor_dense(e, d, 1, 1e-10, dmat2=d2)
        same = {}
        for lo, hi in bounds(CELLS, p) + [(37, min(CELLS, 1037))]:
            part = kernels.coldeltacor_dense(e, d, 1, 1e-10, dmat2=d2,
                                             c0=lo, m=hi - lo)
            same[f"[{lo}, {hi})"] = _bitwise(part[0], whole[0][lo:hi]) and \
                _bitwise(part[1], whole[1][lo:hi])
        lo, hi = bounds(CELLS, p)[0]
        ms = statistics.median(_time_ms(lambda: kernels.coldeltacor_dense(
            e, d, 1, 1e-10, dmat2=d2, c0=lo, m=hi - lo))[0]
            for _ in range(3))
        whole_ms = statistics.median(_time_ms(
            lambda: kernels.coldeltacor_dense(e, d, 1, 1e-10, dmat2=d2))[0]
            for _ in range(3))
        return same, ms, whole_ms, hi - lo

    same, range_ms, whole_ms, rows = _uncounted(_ranges)
    torch.cuda.empty_cache()
    print(f"# dense center ranges of one dual launch (G={GENES}, N={CELLS},"
          f" sqrt) against the whole launch, bitwise: {same}; the first "
          f"shard's {rows} rows {range_ms!r} ms against the whole "
          f"{whole_ms!r} ms (median of 3, CUDA events) on {smi}", flush=True)
    assert all(same.values()), same

    e, _e, d, d2, ixs = _sampled_case(GENES, CELLS, CELLS, NN_SAMPLED, 7,
                                      torch.int32)
    ref = _uncounted(lambda: kernels.coldeltacor_partial(
        e, e, d, ixs, 1, 1e-10, d_ctr2=d2))
    order = cdc.locality_order(torch.tensor(
        np.random.RandomState(7).rand(CELLS, 2), device=DEVICE))
    torch.cuda.synchronize()
    saved = cdc._REPLICATION_BYTES
    kernels.reset_counts()          # the forced ring's launches only
    cdc._REPLICATION_BYTES = 1
    try:
        # one call, timed whole: its host plan (_ring_plan) takes seconds
        ring_ms, ring_o = _time_ms(
            lambda: cdc.col_delta_cor_partial_sharded_dev(
                mesh, e.T, d.T, ixs, "sqrt", 1e-10, dmat_random=d2.T,
                order=order))
        with trace() as prof:
            ring = cdc.col_delta_cor_partial_ring_dev(
                mesh, e.T, d.T, ixs, "sqrt", 1e-10, dmat_random=d2.T)
            torch.cuda.synchronize()
        ring_launches = _launches()
    finally:
        cdc._REPLICATION_BYTES = saved
    split = {name[len("ring."):]: sec for name, (_n, sec)
             in span_seconds(prof).items() if name.startswith("ring.")}
    assert ring_launches == {"dense": 0, "flat": 2 * p * p, "partial": 0,
                             "fma": 0, "svr": 0, "tsne": 0, "balance": 0,
                             "balance_decode": 0}, ring_launches
    ring_bitwise = _bitwise(ring[0], ref[0]) and _bitwise(ring[1], ref[1])
    order_bitwise = _bitwise(ring_o[0], ref[0]) and \
        _bitwise(ring_o[1], ref[1])
    (err, ok), (err2, ok2) = (_ring_err(ring[k], ref[k]) for k in (0, 1))
    sharded_ms, sharded = _uncounted(lambda: _time_ms(
        lambda: cdc.col_delta_cor_partial_sharded_dev(
            mesh, e.T, d.T, ixs, "sqrt", 1e-10, dmat_random=d2.T)))
    sharded_bitwise = _bitwise(sharded[0], ref[0]) and \
        _bitwise(sharded[1], ref[1])
    one_ms = _uncounted(lambda: statistics.median(_time_ms(
        lambda: kernels.coldeltacor_partial(e, e, d, ixs, 1, 1e-10,
                                            d_ctr2=d2))[0]
        for _ in range(3)))
    print(f"# forced ring, {p} shards, N={CELLS} nn={NN_SAMPLED} both "
          f"fields: {ring_launches['flat']} flat launches in two calls; "
          f"against one sampled launch, with a locality order "
          f"bitwise={order_bitwise}, without bitwise={ring_bitwise}, "
          f"max_abs_err={max(err, err2)!r} (within rtol {RING_RTOL} / atol "
          f"{RING_ATOL}: {ok and ok2}); ring call with the order "
          f"{ring_ms!r} ms (host plan included); the call without, profiled, "
          f"its vtt.ring.* spans (s, host clock; launches and copies "
          f"asynchronous, so the card's time falls where the host waits): "
          f"{split}; replicated sharded call "
          f"({p} launches, bitwise={sharded_bitwise}) {sharded_ms!r} ms, one "
          f"launch {one_ms!r} ms (CUDA events) on {smi}", flush=True)
    assert ring_bitwise and order_bitwise, \
        "the ring differs from the sampled kernel"
    assert sharded_bitwise, "the sharded call differs from one launch"
    del ring, ring_o, ref, sharded
    torch.cuda.empty_cache()

    flat = _uncounted(lambda: _flat_against_plain(e, d, d2, ixs, p, smi))
    del e, _e, d, d2, ixs
    torch.cuda.empty_cache()

    phase("bench_scaling (python3 -m velocyto_tpu_torch.bench_scaling)")
    scaling = _uncounted(bench_scaling.main)
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"# mesh kernels phase: {phase_s:.1f} s on {smi}", flush=True)
    return {**flat, "center_range_ms": range_ms, "whole_dense_ms": whole_ms,
            "ring_call_ms": ring_ms, "ring_bitwise": ring_bitwise,
            "ring_order_bitwise": order_bitwise, "ring_split_s": split,
            "ring_max_abs_err": max(err, err2),
            "sharded_call_ms": sharded_ms, "one_launch_ms": one_ms,
            "ring_launches": ring_launches["flat"],
            "scaling": {k: {f: r[f] for f in ("shards", "devices",
                                              "sharded_ms", "ring_ms")}
                        for k, r in scaling["points"].items()}}


def _ring_err(got, want):
    """max |got - want| and whether it lies within RING_RTOL / RING_ATOL
    (NaNs in the same places)."""
    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    fin = ~torch.isnan(want)
    diff = (got[fin] - want[fin]).abs()
    ok = same_nan and bool(torch.all(
        diff <= RING_ATOL + RING_RTOL * want[fin].abs()))
    return (float(diff.max()) if diff.numel() else 0.0), ok


def _flat_against_plain(e, d, d2, ixs, p, smi):
    """Every table of the ring plan of ixs over p shards: one dual flat
    launch against the plain twin (twice, one field each), both timed by
    CUDA events; returns the summed times, the largest error and the
    bound of the launches' work (the table's entries, padding included)."""
    from velocyto_tpu_torch import kernels
    from velocyto_tpu_torch.ops import coldeltacor as cdc
    n, g = e.shape
    launches, _inv, chunk = flat_tables(e, d, d2, ixs, p)
    bmax = launches[0]["args"][4].shape[0]
    ms = plain_ms = err = 0.0
    ok = True
    entries = 0
    for t in launches:
        ev, ec, dc, ql, qr = t["args"]
        run_start, run_order = t["table"]
        # the built schedule passes the wrapper's check; the timed launch
        # takes it unchecked, as the ring does
        kernels._check_schedule(run_start, run_order, qr, bmax)
        ms_k, (m1, m2) = _time_ms(lambda: kernels.coldeltacor_flat(
            ev, ec, dc, ql, qr, 1, 1e-10, d_ctr2=t["d2"],
            run_start=run_start, run_order=run_order, check=False))
        ms += ms_k
        ms_p, (w1, w2) = _time_ms(lambda: tuple(
            cdc._col_delta_cor_flat_plain(ev, ec, dd, ql, qr, 1, 1e-10)
            for dd in (dc, t["d2"])))
        plain_ms += ms_p
        for got, want in ((m1, w1), (m2, w2)):
            e_, ok_ = _err(got, want)
            err, ok = max(err, e_), ok and ok_
        entries += ql.numel()
    steps = entries * g
    padding = entries / (n * ixs.shape[1])
    print(f"# flat block-table kernel, {p * p} tables of Bmax={bmax} x 16 "
          f"(padding {padding!r} of the sampled pairs), both fields: kernel "
          f"{ms!r} ms in all, plain twin {plain_ms!r} ms (CUDA events, one "
          f"call each) on {smi}; max_abs_err={err!r} ok={ok}", flush=True)
    assert ok, "the flat kernel disagrees with its plain twin"
    _print_sfu_floor("flat", steps)
    # 10 flop per (entry, gene) in the dual form; read once: every chunk
    # of e (as gather source and centers), d and d2, the tables; written:
    # two outputs
    nbytes = (3 * chunk * p * g + entries + entries // 16) * 4 + \
        2 * entries * 4
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "padding": padding, "tables": p * p, "entries": entries,
            **_bound(10 * steps, nbytes)}


def mesh_step_phase(mesh, args, single, smi):
    """make_sharded_velocity_step over the mesh on the tutorial session's
    state (velocity_step_phase's inputs), the launch counts set to 0 just
    before and read just after (one sampled launch a shard), against the
    unsharded step at STEP_TOL, the tolerances velocity_step is held to
    on the same state: a shard's smoothing contracts fewer genes at once,
    so its f32 sums round differently, a gene's 2% / 98% percentile
    weights can flip, and the velocity subtracts near-equal terms.  The
    error relative to each output's largest magnitude is printed beside.
    Returns (ms, counts)."""
    from velocyto_tpu_torch import kernels
    from velocyto_tpu_torch.models import make_sharded_velocity_step
    p = _shards(mesh)
    phase(f"sharded velocity_step over {p} shards, on the session's state")
    step = make_sharded_velocity_step(mesh)
    kernels.reset_counts()
    ms, out = _time_ms(lambda: step(*args))
    launches = _launches()
    assert launches == {"dense": 0, "flat": 0, "partial": p, "fma": 0,
                        "svr": 0, "tsne": 0, "balance": 0,
                        "balance_decode": 0}, launches
    errs, rel, bad = {}, {}, {}
    for name, (rtol, atol) in STEP_TOL.items():
        got, want = getattr(out, name), getattr(single, name)
        assert got.shape == want.shape and \
            bool(torch.isfinite(got).all()), name
        diff = (got - want).abs()
        errs[name] = float(diff.max())
        rel[name] = errs[name] / max(float(want.abs().max()), 1e-30)
        bad[name] = int((diff > atol + rtol * want.abs()).sum())
    print(f"# sharded velocity_step, {p} shards: {ms!r} ms (one call, "
          f"CUDA events) on {smi}; launches {launches}; max abs err "
          f"against the unsharded step {errs}, over each output's largest "
          f"magnitude {rel}", flush=True)
    assert not any(bad.values()), f"sharded step disagrees: {bad}"
    return ms, launches


def count_distributed_check(mesh, gtf, bam, cs, bcs, layers, cells):
    """parallel.count_distributed on bench_counting's fixture, 4 feeders
    in this process over barcode ranges (the .vtx ranged decode), merged
    over the mesh on the card: bitwise the serial count, values and
    column order; returns its seconds."""
    from velocyto_tpu_torch.parallel import count_distributed
    t0 = time.perf_counter()
    d_layers, d_cells = count_distributed(
        [cs], gtf, valid_bcs=sorted(bcs), logic_name="Permissive10X",
        markup_bamfiles=[bam], n_feeders=4, mesh=mesh, in_process=True)
    secs = time.perf_counter() - t0
    _same_counts((layers, cells), (d_layers, d_cells),
                 "count_distributed (4 feeders, mesh merge)",
                 same_dtype=False)
    print(f"# count_distributed: 4 feeders, merged over the mesh, bitwise "
          f"the serial count ({secs:.3f} s host)", flush=True)
    return secs


def main():
    _card, smi = device_phase()
    build_phase()
    dense = dense_phase(smi)
    sampled = sampled_phase(smi)
    cross_check_phase()
    sampler = sampler_phase()
    mesh = _mesh()
    counting = counting_phase(smi, mesh)
    fma = fma_phase(smi)
    svr = svr_phase(smi)
    torch.cuda.empty_cache()
    tsne = tsne_phase(smi)
    torch.cuda.empty_cache()
    stages_full, total_full, launches_full, peak_full, _, v = \
        pipeline_phase(knn_random=False, smi=smi)
    mesh_full_s, _stages, launches_mesh_full = mesh_pipeline_phase(
        mesh, v, False, smi)
    del v
    torch.cuda.empty_cache()
    stages_samp, total_samp, launches_samp, peak_samp, sampled_ms, v = \
        pipeline_phase(knn_random=True, smi=smi, sampler=sampler)
    mesh_default_s, mesh_stages, launches_mesh_default = mesh_pipeline_phase(
        mesh, v, True, smi, sampler)
    sampler_s = {k: sampler[k] for k in ("whole_s", "chunked_s", "plain_s")}
    del sampler
    checkpoint_phase(v)
    launches_surface, surface = surface_phase(v, smi)
    S, U = v.S, v.U                     # the raw counts, for the profile
    pcs = np.ascontiguousarray(v.pcs)   # the pipeline's kNN space
    del v
    torch.cuda.empty_cache()
    balance = balance_phase(smi, pcs)
    del pcs
    torch.cuda.empty_cache()
    pipe_bench, launches_pipe_bench = bench_pipeline_phase(smi)
    torch.cuda.empty_cache()
    knn50k, launches_knn50k = knn50k_phase(smi)
    torch.cuda.empty_cache()
    attr, launches_attr = attr_phase(smi)
    torch.cuda.empty_cache()
    profile, launches_prof = profile_phase(
        smi, S, U, {"full": total_full, "default": total_samp})
    del S, U
    torch.cuda.empty_cache()
    _bench, launches_bench = bench_phase()
    torch.cuda.empty_cache()
    stages_tut, total_tut, launches_tut, peak_tut, shims, step_ms, step_io = \
        tutorial_phase(smi)
    torch.cuda.empty_cache()
    mesh_step_ms, launches_mesh_step = mesh_step_phase(mesh, *step_io, smi)
    del step_io
    torch.cuda.empty_cache()
    stages_heur, total_heur, launches_heur, peak_heur = heuristic_phase(smi)
    torch.cuda.empty_cache()
    meshk, clocks = _with_clocks(lambda: mesh_kernels_phase(mesh, smi))
    mesh_mhz = [min(m for m, _w in clocks), max(m for m, _w in clocks)] \
        if clocks else None
    print(f"# nvidia-smi over the mesh kernels phase ({len(clocks)} "
          f"samples): SM clock {mesh_mhz} MHz ({smi})", flush=True)
    print(json.dumps({"card": smi, "pipeline_full_s": total_full,
                      "stages_full_s": stages_full,
                      "peak_full_gib": peak_full / 2**30,
                      "pipeline_default_s": total_samp,
                      "stages_default_s": stages_samp,
                      "peak_default_gib": peak_samp / 2**30,
                      "sampler_s": sampler_s,
                      "transition_default": sampled_ms,
                      "tutorial_session_s": total_tut,
                      "stages_tutorial_s": stages_tut,
                      "peak_tutorial_gib": peak_tut / 2**30,
                      "velocity_step_ms": step_ms,
                      "shims_ms_plain_ms_err": shims,
                      "heuristic_session_s": total_heur,
                      "stages_heuristic_s": stages_heur,
                      "peak_heuristic_gib": peak_heur / 2**30,
                      "svr_totals_ms": svr["totals_ms"],
                      "svr_totals_iterations": svr["totals_iterations"],
                      "svr_cv_iterations": svr["iterations"],
                      "svr_sync_us_per_iteration":
                          svr["sync_us_per_iteration"],
                      "svr_global_n_ms": svr["global_n_ms"],
                      "tsne_pass_ms_by_dim": tsne["pass_ms_by_dim"],
                      "tsne_1000_iterations_s": tsne["tsne_s"],
                      "tsne3_launches": tsne["tsne3_launches"],
                      "pipeline_bench": {
                          k: pipe_bench[k] for k in (
                              "value", "min_total", "max_total", "n_clean",
                              "stages", "probe_thresholds_ms")},
                      "pipeline_bench_runs_s": [
                          r["total"] for r in pipe_bench["runs"]],
                      "pipeline_bench_probes_ms": [
                          (r["probe_ms"], r["host_probe_ms"])
                          for r in pipe_bench["runs"]],
                      "knn50k_bench": {
                          k: knn50k[k] for k in (
                              "value", "n_clean", "stages")},
                      "knn50k_bench_runs_s": [
                          r["total"] for r in knn50k["runs"]],
                      "profile": profile,
                      "attribution": attr,
                      "counting": counting,
                      "public_surface": surface,
                      "mesh": {"shards": _shards(mesh),
                               "sm_clock_mhz": mesh_mhz,
                               "cards": torch.cuda.device_count(),
                               "pipeline_full_s": mesh_full_s,
                               "pipeline_default_s": mesh_default_s,
                               "stages_default_s": mesh_stages,
                               "sharded_velocity_step_ms": mesh_step_ms,
                               **{k: meshk[k] for k in (
                                   "ring_call_ms", "ring_bitwise",
                                   "ring_order_bitwise", "ring_split_s",
                                   "ring_max_abs_err", "sharded_call_ms",
                                   "one_launch_ms", "whole_dense_ms",
                                   "scaling")}},
                      "chip_smoke_s": time.perf_counter() - _START}))
    b20, b50 = balance["20k"], balance["50k"]
    # the paths that balance, each read just after its run
    path_counts = (launches_full, launches_samp, launches_prof,
                   launches_pipe_bench, launches_knn50k, launches_attr,
                   launches_tut, launches_heur, launches_mesh_full,
                   launches_mesh_default)
    # launches: each kernel's count summed over the paths that run it;
    # ms / plain_ms: the kernel and its plain version on the same inputs
    # (dense: one field; sampled: the dual call on uniform indices), with
    # the path's own forms beside them (dense dual; sampled dual on the
    # default pipeline's indices in both center orders)
    print(json.dumps({"kernels": [
        {"name": "coldeltacor_dense", "route": "cuda",
         "source": "velocyto_tpu_torch/kernels/coldeltacor_dense.cu",
         "replaces": "velocyto_tpu/ops/coldeltacor.py:89",
         "launches": launches_full["dense"] + launches_tut["dense"]
         + launches_prof["dense"] + launches_mesh_full["dense"],
         "max_abs_err": dense["max_abs_err"], "ms": dense["ms"],
         "plain_ms": dense["plain_ms"], "bound_ms": dense["bound_ms"],
         "bound_by": dense["bound_by"], "library_ms": None,
         "dual_ms": dense["dual_ms"],
         "center_range_ms": meshk["center_range_ms"]},
        {"name": "coldeltacor_partial", "route": "cuda",
         "source": "velocyto_tpu_torch/kernels/coldeltacor_partial.cu",
         "replaces": "velocyto_tpu/ops/coldeltacor.py:260",
         "launches": launches_samp["partial"] + launches_tut["partial"]
         + launches_heur["partial"] + launches_prof["partial"]
         + launches_pipe_bench["partial"] + launches_attr["partial"]
         + launches_mesh_default["partial"] + launches_mesh_step["partial"]
         + launches_surface["partial"],
         "max_abs_err": sampled["max_abs_err"], "ms": sampled["ms"],
         "plain_ms": sampled["plain_ms"], "bound_ms": sampled["bound_ms"],
         "bound_by": sampled["bound_by"], "library_ms": None,
         "path_identity_ms": sampled_ms["identity_ms"],
         "path_locality_ms": sampled_ms["ordered_ms"],
         "path_chunks_ms": sampled_ms["chunks_ms"],
         "path_single_ms": sampled_ms["single_ms"],
         "launches_per_call": sampled_ms["launches_per_call"]},
        {"name": "coldeltacor_flat", "route": "cuda",
         "source": "velocyto_tpu_torch/kernels/coldeltacor_partial.cu",
         "replaces": "velocyto_tpu/ops/coldeltacor.py:589",
         "launches": meshk["ring_launches"],
         "max_abs_err": meshk["max_abs_err"], "ms": meshk["ms"],
         "plain_ms": meshk["plain_ms"], "bound_ms": meshk["bound_ms"],
         "bound_by": meshk["bound_by"], "library_ms": None,
         "tables": meshk["tables"], "padding": meshk["padding"],
         "path_locality_ms": sampled_ms["flat_locality_ms"],
         "path_table_order_ms": sampled_ms["flat_table_order_ms"]},
        {"name": "fma_probe", "route": "cuda",
         "source": "velocyto_tpu_torch/kernels/fma_probe.cu",
         "replaces": "bench.py:192",
         "launches": launches_bench["fma"],
         "max_abs_err": fma["max_abs_err"], "ms": fma["ms"],
         "plain_ms": fma["plain_ms"], "bound_ms": fma["bound_ms"],
         "bound_by": fma["bound_by"], "library_ms": None},
        {"name": "svr_smo", "route": "cuda",
         "source": "velocyto_tpu_torch/kernels/svr_smo.cu",
         "replaces": "velocyto_tpu/analysis.py:331",
         "launches": launches_heur["svr"],
         "max_abs_err": svr["max_abs_err"], "ms": svr["ms"],
         "plain_ms": svr["plain_ms"], "bound_ms": svr["bound_ms"],
         "bound_by": svr["bound_by"], "library_ms": None,
         "svr_route": "shared", "cluster_blocks": svr["cluster_blocks"],
         "latency_floor_ms": svr["latency_floor_ms"],
         "global_route_ms": svr["global_route_ms"],
         "totals_ms": svr["totals_ms"],
         "totals_plain_ms": svr["totals_plain_ms"],
         "totals_bound_ms": svr["totals_bound_ms"],
         "totals_latency_floor_ms": svr["totals_latency_floor_ms"],
         "totals_global_route_ms": svr["totals_global_route_ms"],
         "global_n": svr["global_n"], "global_n_ms": svr["global_n_ms"],
         "global_n_latency_floor_ms": svr["global_n_latency_floor_ms"]},
        {"name": "tsne_grad", "route": "cuda",
         "source": "velocyto_tpu_torch/kernels/tsne_grad.cu",
         "replaces": "velocyto_tpu/analysis.py:1070",
         "launches": launches_heur["tsne"],
         "max_abs_err": tsne["max_abs_err"], "ms": tsne["ms"],
         "plain_ms": tsne["plain_ms"], "bound_ms": tsne["bound_ms"],
         "bound_by": tsne["bound_by"], "library_ms": None,
         "pair_ms": tsne["pair_ms"], "attract_ms": tsne["attract_ms"]},
        {"name": "knn_balance", "route": "cuda",
         "source": "velocyto_tpu_torch/kernels/knn_balance.cu",
         "replaces": "velocyto_tpu/ops/knn_device.py:185",
         "launches": sum(c["balance"] for c in path_counts),
         "max_abs_err": max(b20["max_abs_err"], b50["max_abs_err"]),
         "ms": b20["ms"], "plain_ms": b20["plain_ms"],
         "bound_ms": b20["bound_ms"], "bound_by": b20["bound_by"],
         "library_ms": None, "plan": b20["plan"],
         "walk_ms": b20["walk_ms"], "us_per_node": b20["us_per_node"],
         "latency_floor_ms": b20["latency_floor_ms"],
         "chain_ms": b20["chain_ms"],
         "other_route_ms": b20["other_route_ms"],
         "rings_ms": b20["rings_ms"],
         "host_loop_ms": b20["host_loop_ms"],
         "host_loop_with_copies_ms": b20["host_loop_with_copies_ms"],
         "native_loop_ms": b20["native_loop_ms"],
         "surface_native_loop_ms": surface["native_loop_ms"],
         "surface_numpy_loop_ms": surface["numpy_loop_ms"],
         "ms_50k": b50["ms"], "plain_ms_50k": b50["plain_ms"],
         "bound_ms_50k": b50["bound_ms"], "walk_ms_50k": b50["walk_ms"],
         "us_per_node_50k": b50["us_per_node"],
         "latency_floor_ms_50k": b50["latency_floor_ms"],
         "chain_ms_50k": b50["chain_ms"],
         "other_route_ms_50k": b50["other_route_ms"],
         "rings_ms_50k": b50["rings_ms"],
         "host_loop_ms_50k": b50["host_loop_ms"],
         "host_loop_with_copies_ms_50k": b50["host_loop_with_copies_ms"],
         "native_loop_ms_50k": b50["native_loop_ms"],
         **{f"{key}_{field}": balance[name][field]
            for key, name in (("constrained", "constrained"),
                              ("raw_labels", "raw labels"),
                              ("maxl_eq_k", "maxl == k"),
                              ("self_fill", "self-fill"),
                              ("past_T", "past T"))
            for field in ("ms", "rows_past_T", "plain_ms")}},
        {"name": "knn_balance_decode", "route": "cuda",
         "source": "velocyto_tpu_torch/kernels/knn_balance.cu",
         "replaces": "velocyto_tpu/ops/knn_device.py:310",
         "launches": sum(c["balance_decode"] for c in path_counts),
         "max_abs_err": max(b20["decode_max_abs_err"],
                            b50["decode_max_abs_err"]),
         "ms": b20["decode_ms"], "plain_ms": b20["decode_plain_ms"],
         "bound_ms": b20["decode_bound_ms"],
         "bound_by": b20["decode_bound_by"], "library_ms": None,
         "ms_50k": b50["decode_ms"], "plain_ms_50k": b50["decode_plain_ms"],
         "bound_ms_50k": b50["decode_bound_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
