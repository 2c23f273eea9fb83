"""Profiling utilities, on torch.profiler.

Port of velocyto_tpu/utils/profiling.py.  Any pipeline stage can be
traced and the Chrome trace viewed in Perfetto or TensorBoard:

    from velocyto_tpu_torch.utils.profiling import trace
    with trace("prof/") as prof:
        vlm.estimate_transition_prob(...)

``trace`` yields the ``torch.profiler.profile`` object, so the caller can
read its events after the block (``bench_common.idle_share``).

`stage_timer` gives lightweight wall-clock stage telemetry with a device
sync, so on-accelerator time is attributed to the stage that launched it
rather than to the next host sync point.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with torch.profiler (CPU activity, and CUDA
    kernels and copies where a CUDA device is available) and write its
    Chrome trace into logdir as ``<host>_<pid>.<ns>.pt.trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


class stage_timer:
    """Accumulating per-stage wall-clock timer with device sync.

        timers = stage_timer()
        with timers("knn"):
            ...
        timers.report()
    """

    def __init__(self, sync: bool = True) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._sync = sync

    def _sync_devices(self) -> None:
        # a process that never touched CUDA has no queued device work
        if self._sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        self._sync_devices()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync_devices()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, log: Optional[logging.Logger] = None) -> str:
        lines = [f"{name:>24s}: {tot:8.3f}s  ({self.counts[name]}x)"
                 for name, tot in
                 sorted(self.totals.items(), key=lambda kv: -kv[1])]
        text = "\n".join(lines)
        (log or logging).info("stage timings:\n%s", text)
        return text
