"""Profiling utilities, on torch.profiler.

Port of velocyto_tpu/utils/profiling.py.  Any pipeline stage can be
traced and the Chrome trace viewed in Perfetto or TensorBoard:

    from velocyto_tpu_torch.utils.profiling import trace
    with trace("prof/") as prof:
        vlm.estimate_transition_prob(...)

``trace`` yields the ``torch.profiler.profile`` object, so the caller can
read its events after the block (``bench_common.idle_share``,
``span_ranges``).  It profiles every thread where the torch build can,
so the trace also holds the spans of the port's worker threads.

`span` names a piece of the port's work in any torch profile: the
ranges ``vtt.<name>`` sit in the same trace as the kernels and copies
they launch, on the same clock, nested by call.  With no profiler
running it costs one flag read.  `spanned` puts a whole function in
one; `span_ranges` and `span_seconds` read them back from a finished
profile, and `recorded` from the process while or after it runs (each
span closed under a profiler, on ``time.perf_counter``, with its thread),
for a reader that holds no profile object.

`stage_timer` gives lightweight wall-clock stage telemetry with a device
sync, so on-accelerator time is attributed to the stage that launched it
rather than to the next host sync point.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import logging
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "vtt."         # the name of every span's range starts so
_OFF = contextlib.nullcontext()
# (name, thread ident, start, end) of each span closed under a profiler,
# on time.perf_counter, oldest first; the newest 2**20 kept
_RECORDED: collections.deque = collections.deque(maxlen=1 << 20)


class _Span:
    """``torch.profiler.record_function("vtt." + name)`` that also
    records its own start and end for `recorded`."""
    __slots__ = ("name", "range", "_t0")

    def __init__(self, name: str) -> None:
        self.name = name
        self.range = torch.profiler.record_function(PREFIX + name)

    def __enter__(self) -> "_Span":
        self.range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self.range.__exit__(*exc)
        _RECORDED.append((self.name, threading.get_ident(), self._t0, t1))
        return False


def span(name: str):
    """A context manager naming a piece of the port's work.  While a
    torch profiler collects, it is ``torch.profiler.record_function(
    "vtt." + name)``, recorded besides for `recorded`; otherwise one
    shared no-op context, with nothing called in torch."""
    # the process-wide flag: a worker thread reads it as the thread that
    # started the profile does (torch._C._autograd._profiler_enabled()
    # is thread-local and reads False there)
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def recorded() -> List[Tuple[str, int, float, float]]:
    """(name without "vtt.", thread ident, start, end) of each span
    closed while a profiler collected, on ``time.perf_counter``, in the
    order they closed (the newest 2**20 of the process)."""
    return list(_RECORDED)


def spanned(name: str):
    """Decorator: each call of the function runs in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _all_threads() -> dict:
    """The profile's keyword that takes every thread's ranges into it,
    where the torch build has it; else nothing (the profiling thread's
    own ranges only)."""
    try:
        return {"experimental_config": torch._C._profiler
                ._ExperimentalConfig(profile_all_threads=True)}
    except (AttributeError, TypeError):
        return {}


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile the block with torch.profiler (CPU activity on every
    thread where the torch build can, and CUDA kernels and copies where
    a CUDA device is available) and, given a logdir, write its Chrome
    trace there as ``<host>_<pid>.<ns>.pt.trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    ready = (None if logdir is None else
             torch.profiler.tensorboard_trace_handler(logdir))
    with torch.profiler.profile(activities=activities, on_trace_ready=ready,
                                **_all_threads()) as prof:
        yield prof


def span_ranges(prof) -> Dict[str, List[Tuple[float, float]]]:
    """{span name, without "vtt.": [(start, end)]} of a finished
    profile's spans, in µs on the profile's clock, in the order the
    profile lists them (every thread it holds)."""
    out: Dict[str, List[Tuple[float, float]]] = {}
    for e in prof.events():
        if e.name.startswith(PREFIX) and \
                e.device_type == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name[len(PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    return out


def span_seconds(prof) -> Dict[str, Tuple[int, float]]:
    """{span name, without "vtt.": (ranges, host seconds in them)} of a
    finished profile."""
    return {name: (len(rs), sum(e - s for s, e in rs) / 1e6)
            for name, rs in span_ranges(prof).items()}


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
