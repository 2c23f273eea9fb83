"""Shared measurement helpers of the port's bench harnesses (bench_pipeline,
bench_knn50k, bench_attr).

Port of the JAX package's bench_common.py: the device and host
contention probes, the device sync, and the run statistics the harnesses
share (run 0 a warm-up, the headline the true median of the clean
measured runs).  Adds the device's idle share over a host window, read
from a torch.profiler profile, and the split of a sampled transition
call, read from the port's spans in such a profile.
"""
import statistics
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType

from .ops.knn import full_f32
from .utils.profiling import span_ranges


# the clean-run thresholds of the two probes, about 2.5-3x their clean
# readings on one NVIDIA H100 80GB HBM3 at a 700 W power limit and its
# 8-core host (0.071-0.078 ms and 1.0-1.3 ms; PERF.md section 4)
DEVICE_PROBE_MS = 0.2
HOST_PROBE_MS = 4.0


def require_card() -> None:
    """Raise unless a CUDA device is available: the harnesses measure the
    card and never fall back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("the port's benches need a CUDA device "
                           "(torch.cuda.is_available() is False)")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sync(device) -> None:
    """Wait for the work queued on `device`; a CPU device has none."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_probe() -> float:
    """D=50 distance-matmul fingerprint of the card in ms: a float32
    (2048, 50) x (50, 8192) matmul, full f32 (no TF32), 20 repeats
    between two CUDA events.  A contended card measures a multiple of its
    clean time."""
    a = torch.ones((2048, 50), dtype=torch.float32, device="cuda")
    b = torch.ones((8192, 50), dtype=torch.float32, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with full_f32():
        torch.matmul(a, b.T)          # warm
        start.record()
        for _ in range(20):
            torch.matmul(a, b.T)
        stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 20


_HOST_PROBE = {}


def host_probe() -> float:
    """Host BLAS fingerprint (one small dgemm) in ms: the host cores are
    also shared, and host-side stalls (observed: an identical PCA stage
    swinging 3 s -> 34 s) are invisible to the device probe."""
    a = _HOST_PROBE.setdefault("a", np.random.RandomState(1).randn(512, 512))
    a @ a   # warm
    t0 = time.perf_counter()
    for _ in range(5):
        a @ a
    return (time.perf_counter() - t0) / 5 * 1e3


def summarize(runs: Sequence[dict]) -> Tuple[float, List[float], int, str,
                                             dict]:
    """The harnesses' statistics over their runs ({"total", "clean",
    "warmup", ...} each): run 0 is a warm-up and never enters them; the
    headline is the true median (statistics.median) of the clean measured
    runs, or, when no measured run was clean, of all of them, labelled
    CONTENDED.  Returns (median, sorted totals it was taken over,
    n_clean, label, the run closest to the median)."""
    measured = [r for r in runs if not r["warmup"]]
    if not measured:
        raise ValueError("no measured run: reps must be at least 2")
    n_clean = len([r for r in measured if r["clean"]])
    clean_runs = [r for r in measured if r["clean"]] or measured
    label = (f"true median of {n_clean} clean runs, warmup run "
             f"excluded" if n_clean
             else f"median of {len(measured)} CONTENDED runs (no clean "
                  f"run this session -- not representative)")
    totals = sorted(r["total"] for r in clean_runs)
    median = float(statistics.median(totals))
    med_run = min(clean_runs, key=lambda r: abs(r["total"] - median))
    return median, totals, n_clean, label, med_run


# ---------------------------------------------------------------------------
# device activity in a torch.profiler profile
# ---------------------------------------------------------------------------

def device_events(prof) -> list:
    """The profile's events that ran on a CUDA device (kernels, copies,
    memsets), times in µs on the profile's clock.  Range annotations the
    profiler mirrors onto the device timeline (the names of host ranges)
    are not device work and are left out."""
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in host_names]


def busy_share(intervals: Sequence[Tuple[float, float]], t0: float,
               t1: float) -> float:
    """The share of the window [t0, t1] covered by the union of the
    (start, end) intervals."""
    if not t1 > t0:
        raise ValueError(f"empty window [{t0}, {t1}]")
    busy, reach = 0.0, t0
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in intervals):
        s = max(s, reach)
        if e > s:
            busy += e - s
            reach = e
    return busy / (t1 - t0)


def idle_share(prof, t0: float, t1: float) -> float:
    """The share of the host window [t0, t1] (µs on the profile's clock)
    in which no CUDA kernel, copy or memset ran on the device: one minus
    the union of the device events' intervals over the window.  Raises
    if the profile holds no device event at all (a profiler without
    CUDA activity tracing records none): that is no measurement."""
    events = device_events(prof)
    if not events:
        raise RuntimeError("the profile holds no CUDA device events: the "
                           "idle share is not measured")
    return 1.0 - busy_share([(e.time_range.start, e.time_range.end)
                             for e in events], t0, t1)


def host_window(prof, name: str) -> Tuple[float, float]:
    """(start, end) in µs of the host range `name` (a
    torch.profiler.record_function block) in the profile."""
    for e in prof.events():
        if e.name == name and e.device_type == DeviceType.CPU:
            return e.time_range.start, e.time_range.end
    raise KeyError(f"no host range {name!r} in the profile")


def top_device_kernels(prof, n: int = 5) -> List[Dict]:
    """The n device activities that took the most time in the profile,
    summed by name: [{"name", "ms", "calls"}, ...], largest first."""
    totals: Dict[str, List[float]] = {}
    for e in device_events(prof):
        t = totals.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.end - e.time_range.start
        t[1] += 1
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k, "ms": v[0] / 1e3, "calls": v[1]} for k, v in top]


def transition_split(prof, call: str) -> Dict[str, Optional[float]]:
    """The split of one sampled estimate_transition_prob call inside the
    host range `call` of a profile taken with utils.profiling.trace,
    read from the port's spans (seconds): call_s; replay_s
    (transition.replay, on its worker thread; None where the profile
    holds no other thread); main_busy_s (call_s less the calling
    thread's transition.wait.* spans); tail_s (from the replay's end to
    the call's end; None without the replay); chunks (the
    transition.chunk spans)."""
    t0, t1 = host_window(prof, call)
    ranges = span_ranges(prof)
    waits = sum(e - s for name, rs in ranges.items()
                if name.startswith("transition.wait.") for s, e in rs)
    replay = ranges.get("transition.replay")
    return {"call_s": (t1 - t0) / 1e6,
            "replay_s": (sum(e - s for s, e in replay) / 1e6
                         if replay else None),
            "main_busy_s": (t1 - t0 - waits) / 1e6,
            "tail_s": (t1 - max(e for _, e in replay)) / 1e6
            if replay else None,
            "chunks": len(ranges.get("transition.chunk", ()))}
