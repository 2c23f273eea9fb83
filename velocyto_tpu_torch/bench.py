"""Kernel bench of the port on one CUDA device: the neighbour-sampled
colDeltaCor (the hot kernel of estimate_transition_prob's default mode),
the dense colDeltaCor and the FMA-chain ceiling probe.

    python3 -m velocyto_tpu_torch.bench

Port of the JAX package's bench.py, with its shapes and seeds: G=2000
genes, 3,072 cells, 512 sampled neighbours per cell, sqrt, psc 1e-10
(seed 0); a second pass with a 20,000-cell gather source (seed 1); the
dense kernel at (2000, 3072); the probe on an (8192, 512) tensor.  Each
kernel is timed with CUDA events around repeated launches on the device.
The baseline is the reference's own compiled OpenMP kernel
(tests/refkernel) where it builds on this machine, else a single-thread
numpy implementation scaled by ncpu/2; the JSON names which.  Raises
without a CUDA device: it never falls back.

Prints ONE JSON line and returns the same dict.
"""
import json
import multiprocessing
import os
import sys
import time

import numpy as np
import torch

from . import kernels
from .ops.coldeltacor import _TRANSFORMS

GENES = 2000
CELLS = 3072
NN = 512          # sampled neighbours per cell (n_neighbors * sampled_fraction)
PSC = 1e-10
BASELINE_CELLS = 48
LARGE_N = 20000
FMA_CHAINS, FMA_STEPS = 8, 128

# device-memory bandwidth by CUDA device name (GB/s, NVIDIA data sheets)
_PEAK_HBM_GBPS = {
    "H100 80GB HBM3": 3350.0,     # H100 SXM
    "H100 NVL": 3900.0,
    "H100 PCIe": 2000.0,
    "H200": 4800.0,
}


def peak_hbm_gbps(device_name: str):
    """The data-sheet bandwidth of the named card, or None if unknown."""
    return next((v for k, v in _PEAK_HBM_GBPS.items() if k in device_name),
                None)


def _fma_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the FMA-chain probe (bench.py::_fma_kern):
    eight chains y_i <- y_i * x + 0.25 over FMA_STEPS steps from
    y_i = x * (0.1 + 0.1 i), summed in order.  Rounds after the multiply
    and after the add, where the kernel fuses them."""
    ys = [x * (0.1 + 0.1 * i) for i in range(FMA_CHAINS)]
    for _ in range(FMA_STEPS):
        ys = [y * x + 0.25 for y in ys]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc


def reference_kernel_cells_per_sec(e, d, ixs):
    """The reference's own compiled OpenMP kernel (tests/refkernel), or
    None where it does not build."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    try:
        import refkernel
        if not refkernel.available():
            return None
    except ImportError:
        return None
    n_meas = min(CELLS, 768)   # subset of center cells: enough for a stable rate
    e_s = np.ascontiguousarray(e[:, :n_meas])
    d_s = np.ascontiguousarray(d[:, :n_meas])
    ixs_s = np.ascontiguousarray(np.minimum(ixs[:n_meas], n_meas - 1),
                                 dtype=np.intp)
    refkernel.col_delta_cor_partial(e_s[:, :64], d_s[:, :64],
                                    np.minimum(ixs_s[:64, :16], 63),
                                    "sqrt", PSC)  # warm
    t0 = time.perf_counter()
    refkernel.col_delta_cor_partial(e_s, d_s, ixs_s, "sqrt", PSC)
    dt = time.perf_counter() - t0
    # per-cell cost is O(G * NN), independent of the total cell count
    return n_meas / dt


def numpy_baseline_cells_per_sec(e, d, ixs):
    """Single-thread numpy implementation of the same math (per-cell loop
    with vectorized inner ops, the natural CPU implementation)."""
    n = BASELINE_CELLS
    t0 = time.perf_counter()
    out = np.zeros((n, ixs.shape[1]))
    for c in range(n):
        cols = ixs[c]
        delta = e[:, cols] - e[:, c][:, None]
        a = np.sign(delta) * np.sqrt(np.abs(delta) + PSC)
        a[np.abs(delta) < 1e-16] = 0
        a_c = a - a.mean(0)[None, :]
        b = d[:, c]
        b_c = b - b.mean()
        num = a_c.T @ b_c
        den = np.sqrt((a_c ** 2).sum(0)) * np.sqrt((b_c ** 2).sum())
        with np.errstate(divide="ignore", invalid="ignore"):
            out[c] = num / den
    dt = time.perf_counter() - t0
    return n / dt


def device_seconds(fn, reps: int) -> float:
    """Seconds per call of fn on the card: one warm-up call, then reps
    calls between two CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / reps


def _sampled_inputs(rng, n, dev):
    e = rng.gamma(2.0, 2.0, (n, GENES)).astype(np.float32)
    d = rng.randn(n, GENES).astype(np.float32)
    ixs = np.stack([rng.choice(n, NN, replace=False) for _ in range(n)])
    return (torch.tensor(e, device=dev), torch.tensor(d, device=dev),
            torch.tensor(ixs.astype(np.int32), device=dev))


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("velocyto_tpu_torch.bench needs a CUDA device "
                           "(torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    tcode = _TRANSFORMS["sqrt"]

    rng = np.random.RandomState(0)
    e = rng.gamma(2.0, 2.0, size=(GENES, CELLS)).astype(np.float64)
    d = rng.randn(GENES, CELLS).astype(np.float64)
    ixs = np.stack([rng.choice(CELLS, NN, replace=False)
                    for _ in range(CELLS)]).astype(np.int32)
    e_rows = torch.tensor(e.T, dtype=torch.float32, device=dev).contiguous()
    d_rows = torch.tensor(d.T, dtype=torch.float32, device=dev).contiguous()
    ixs_t = torch.tensor(ixs, device=dev)
    dt = device_seconds(lambda: kernels.coldeltacor_partial(
        e_rows, e_rows, d_rows, ixs_t, tcode, PSC), reps=20)

    # the same kernel with a 20,000-cell (160 MB) gather source, which
    # does not fit the 50 MB L2 where the 24.6 MB one above does
    e_big, d_big, ixs_big = _sampled_inputs(np.random.RandomState(1),
                                            LARGE_N, dev)
    dt_big = device_seconds(lambda: kernels.coldeltacor_partial(
        e_big, e_big, d_big, ixs_big, tcode, PSC), reps=5)
    big_gbps = LARGE_N * NN * GENES * 4 / dt_big / 1e9
    del e_big, d_big, ixs_big

    e_j = torch.tensor(e, dtype=torch.float32, device=dev)
    d_j = torch.tensor(d, dtype=torch.float32, device=dev)
    dt_dense = device_seconds(lambda: kernels.coldeltacor_dense(
        e_j, d_j, tcode, PSC), reps=5)
    # per (c, i, g): delta + transform (~4: abs, add, sqrt, select) + s1 +
    # (a*a, +) + (a*b, +) ~ 9 elementwise flops, bench.py's count
    dense_tflops = CELLS * CELLS * GENES * 9 / dt_dense / 1e12

    xv = torch.full((8192, 512), 0.4, dtype=torch.float32, device=dev)
    dt_fma = device_seconds(lambda: kernels.fma_probe(xv), reps=200)
    fma_tflops = xv.numel() * FMA_STEPS * FMA_CHAINS * 2 / dt_fma / 1e12

    base = reference_kernel_cells_per_sec(e, d, ixs)
    if base is not None:
        baseline_kind = "reference-openmp"
    else:
        base_st = numpy_baseline_cells_per_sec(e, d, ixs)
        base = base_st * max(1, multiprocessing.cpu_count() // 2)
        baseline_kind = "numpy-emulated"

    # bytes the sampled kernel must move: the gathered neighbour rows plus
    # the center expression and displacement rows and the output
    bytes_accessed = CELLS * NN * GENES * 4 + 3 * CELLS * GENES * 4
    achieved_gbps = bytes_accessed / dt / 1e9
    kind = torch.cuda.get_device_name(0)
    peak = peak_hbm_gbps(kind)
    result = {
        "metric": "coldeltacor_sqrt_partial_cells_per_sec",
        "value": round(CELLS / dt, 2),
        "unit": "cells/s (G=2000, nn=512)",
        "vs_baseline": round(CELLS / dt / base, 2),
        "baseline": baseline_kind,
        "baseline_cells_per_sec": round(base, 2),
        "hbm_gbps_achieved": round(achieved_gbps, 1),
        "hbm_roofline_fraction": round(achieved_gbps / peak, 3)
        if peak else None,
        "large_n_cells_per_sec": round(LARGE_N / dt_big, 1),
        "large_n_gather_gbps": round(big_gbps, 1),
        "large_n_roofline_fraction": round(big_gbps / peak, 3)
        if peak else None,
        "dense_kernel_cells_per_sec": round(CELLS / dt_dense, 1),
        "dense_kernel_tflops_f32": round(dense_tflops, 2),
        "fma_ceiling_tflops_f32": round(fma_tflops, 2),
        "dense_kernel_fma_ceiling_fraction": round(dense_tflops / fma_tflops,
                                                   3),
        "sampled_kernel_ms": dt * 1e3,
        "large_n_kernel_ms": dt_big * 1e3,
        "dense_kernel_ms": dt_dense * 1e3,
        "fma_probe_ms": dt_fma * 1e3,
        "bound_analysis": (
            "sampled kernel: bound by the gather of 8 KB neighbour rows in "
            "sampled order. At 3,072 cells the 24.6 MB source stays in the "
            "50 MB L2 across repeated launches, so hbm_gbps_achieved is a "
            "mostly-L2 rate and its roofline fraction may exceed what the "
            "device memory alone allows; the 20,000-cell pass (160 MB "
            "source) reads mostly device memory, as the 20k pipeline does. "
            "dense kernel: the sqrt/log transforms are "
            "nonlinear in delta, so the moment sums cannot be cast as "
            "matrix products for the tensor cores; it is bound by FP32 and "
            "SFU issue, and its counted-flop rate is compared with the "
            "FMA-chain probe, the FP32 FMA issue rate this card sustains "
            "on a synthetic elementwise program (2 flops per FMA)."),
        "device": kind,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
