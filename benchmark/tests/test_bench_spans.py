"""The program's spans in the benchmark (benchmark/program.py), on
synthetic traces: their placement on the profile's clock, the five
metrics that read them, the idle gaps they name, and the metrics that
must read the same with and without them."""
import threading
import time
import types

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import harness, program, trace
from velocyto_tpu_torch.utils import profiling

METRICS = harness.load_metrics()
SPAN_METRICS = ("span_s.transition.wait", "span_s.transition.control",
                "span_s.embedding_knn", "span_s.pca.blas",
                "idle_named_share")

# two pipelines of 1,000 µs each; the device busy 0-100, 400-500 and
# 1500-1600; stages "pca" 0-300 and "transition" 300-1000 in the first,
# "transition" 1000-2000 in the second
DEVICE = [("gemm_kernel", 0.0, 100.0), ("Memcpy DtoH (Device -> Pageable)",
                                        400.0, 500.0),
          ("coldeltacor_dense_kernel", 1500.0, 1600.0)]
RANGES = {"pipeline": [(0.0, 1000.0), (1000.0, 2000.0)],
          "stage:pca": [(0.0, 300.0)],
          "stage:transition": [(300.0, 1000.0), (1000.0, 2000.0)]}
PROGRAM = {
    # 160 µs less the 40 nested in it: 120 own
    "pca.gram": [(100.0, 260.0)], "upload.x": [(120.0, 160.0)],
    "pca.eigh": [(260.0, 290.0)],
    # 600 µs less the two waits nested in it
    "transition.inputs": [(300.0, 900.0)],
    "transition.wait.chunk": [(310.0, 390.0), (600.0, 700.0)],
    "transition.wait.replay": [(1100.0, 1400.0)],
    "transition.control": [(1000.0, 1050.0)],
    "transition.knn_csr": [(1700.0, 1790.0)],
    "shift.dense_k": [(1790.0, 1840.0)],
}
# the idle gaps: 100-400, 500-1000 (one pipeline), 1000-1500, 1600-2000

HOST0 = 7.0             # the host clock (s) at the profile's 0 µs


def _host(us):
    return HOST0 + us / 1e6


def _recorded(prog, thread=None):
    """The program's record of `prog` (profile µs) on the host clock."""
    thread = threading.get_ident() if thread is None else thread
    return [(name, thread, _host(s), _host(e))
            for name, rs in prog.items() for s, e in rs]


def _trace():
    stages = [{"stage": "transition", "knn_random": False, "cells": 10,
               "genes": 4}]
    spans = [(name[len("stage:"):], _host(s), _host(e))
             for name, rs in RANGES.items() if name.startswith("stage:")
             for s, e in rs]
    return trace.Trace(list(DEVICE), {k: list(v) for k, v in RANGES.items()},
                       sorted(spans, key=lambda r: r[1]), stages, 2)


@pytest.fixture
def record(monkeypatch):
    """record(prog): the program's record reads as `prog` (profile µs)."""
    def put(prog, thread=None):
        monkeypatch.setattr(program, "_recorded",
                            lambda: _recorded(prog, thread))
    put({})
    return put


def test_ranges_places_the_calling_threads_spans_on_the_profile_clock():
    extra = _recorded({"between": [(2100.0, 2200.0)]}) + \
        _recorded({"worker": [(310.0, 320.0)]}, thread=-1)
    got = program.ranges(_trace(), _recorded(PROGRAM) + extra)
    assert set(got) == set(PROGRAM)
    for name, rs in PROGRAM.items():
        assert got[name] == [pytest.approx(r, abs=1e-3) for r in rs]


def test_ranges_needs_stages_on_both_clocks():
    t = _trace()
    t.ranges["stage:pca"] = []
    assert program.ranges(t, _recorded(PROGRAM)) == {}
    assert program.ranges(_trace(), []) == {}


@pytest.mark.parametrize("metric,want", [
    ("span_s.transition.wait", (80 + 100 + 300) / 2e6),
    ("span_s.transition.control", 50 / 2e6),
    ("span_s.embedding_knn", (90 + 50) / 2e6),
    ("span_s.pca.blas", (120 + 30) / 2e6),
])
def test_span_metric_reads_self_time(metric, want, record):
    assert METRICS[metric].read(_trace()) is None
    record(PROGRAM)
    assert METRICS[metric].read(_trace()) == pytest.approx(want)
    record(PROGRAM, thread=-1)
    assert METRICS[metric].read(_trace()) is None
    record({"grid": [(0.0, 5.0)]})
    assert METRICS[metric].read(_trace()) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_program_without_a_record_gives_no_value(metric, monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    assert program._recorded() == []
    assert METRICS[metric].read(_trace()) is None


def test_self_time_takes_off_each_nested_span_once():
    prog = {"a": [(0.0, 100.0)], "b": [(10.0, 60.0)],
            "c": [(20.0, 30.0)], "d": [(70.0, 80.0)]}

    def own(match):
        return program.self_seconds(_trace(), match, prog) * 2e6
    assert own(lambda n: n == "a") == pytest.approx(40.0)
    assert own(lambda n: n == "b") == pytest.approx(40.0)
    assert own(lambda n: n in "cd") == pytest.approx(20.0)


def test_idle_named_share(record):
    # named: 100-290 and 300-400 of the first gap, 500-900 of the second,
    # 1000-1050 and 1100-1400 of the third, 1700-1840 of the fourth
    named = 190 + 100 + 400 + 50 + 300 + 140
    assert METRICS["idle_named_share"].read(_trace()) is None
    record(PROGRAM)
    assert METRICS["idle_named_share"].read(_trace()) == \
        pytest.approx(100.0 * named / 1700.0)
    whole = {"x": [(0.0, 2000.0)], "y": [(150.0, 160.0)]}
    assert program.named_share(_trace(), whole) == pytest.approx(100.0)


def _gaps(gaps):
    return [(round(sec * 1e6), label) for label, sec in gaps]


def test_named_gaps_by_the_innermost_span():
    assert _gaps(program.named_gaps(_trace(), program=PROGRAM)) == [
        (500, "transition/transition.inputs"),      # middle 750
        (500, "transition/transition.wait.replay"),  # 1250
        (400, "transition/shift.dense_k"),           # 1800
        (300, "pca/pca.gram")]                       # 250, not upload.x
    # without spans, the breakdown's own labels
    assert program.named_gaps(_trace(), program={}) == \
        trace.breakdown(_trace())["idle_gaps"]


def test_named_gaps_leave_a_gap_outside_every_span_bare():
    prog = {"grid": [(1590.0, 1610.0)], "pca.gram": [(100.0, 300.0)],
            "knn.smooth": [(1240.0, 1260.0)]}
    assert _gaps(program.named_gaps(_trace(), program=prog)) == [
        (500, "transition"), (500, "transition/knn.smooth"),
        (400, "transition"), (300, "pca/pca.gram")]


@pytest.mark.parametrize("metric", ["idle_share", "d2h_ms",
                                    "device_ms.torch_ops",
                                    "dense_cor_roofline"])
def test_device_metrics_read_the_same_with_program_spans(metric, record):
    plain = METRICS[metric].read(_trace())
    record(PROGRAM)
    assert METRICS[metric].read(_trace()) == plain


def test_breakdown_unchanged_by_program_spans(record):
    plain = trace.breakdown(_trace())
    record(PROGRAM)
    assert trace.breakdown(_trace()) == plain


def _event(name, device_type, start, end, **kw):
    return types.SimpleNamespace(
        name=name, device_type=device_type,
        time_range=types.SimpleNamespace(start=start, end=end), **kw)


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_reduce_keeps_the_program_spans_off_the_device():
    prof = _Profile([
        _event("pipeline", DeviceType.CPU, 0.0, 100.0),
        _event("stage:pca", DeviceType.CPU, 0.0, 100.0),
        _event("vtt.pca.gram", DeviceType.CPU, 10.0, 20.0),
        _event("aten::mm", DeviceType.CPU, 12.0, 18.0),
        _event("gemm_kernel", DeviceType.CUDA, 15.0, 25.0),
        # the span mirrored onto the device timeline
        _event("vtt.pca.gram", DeviceType.CUDA, 10.0, 20.0,
               is_user_annotation=True),
        _event("vtt.pca.gram", DeviceType.CUDA, 30.0, 40.0),
    ])
    t = trace.reduce(prof, [], [], 1)
    assert [n for n, _, _ in t.device] == ["gemm_kernel"]


def test_the_record_lands_on_the_profiles_own_ranges():
    """A real CPU profile: the spans placed from the program's record lie
    where the profile itself has them, to within a few µs."""
    spans = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for stage in ("a", "b", "a"):
            t0 = time.perf_counter()
            with torch.profiler.record_function("stage:" + stage):
                with profiling.span(stage + ".outer"):
                    sum(range(20000))
                    with profiling.span(stage + ".inner"):
                        sum(range(20000))
            spans.append((stage, t0, time.perf_counter()))
    ranges, own = {}, {}
    for e in prof.events():
        if e.name.startswith("stage:"):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
        elif e.name.startswith(profiling.PREFIX):
            own.setdefault(e.name[len(profiling.PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    t = trace.Trace([], ranges, spans, [], 3)
    got = program.ranges(t)
    assert set(got) == set(own) == {"a.outer", "a.inner", "b.outer",
                                    "b.inner"}
    for name in own:
        for (s, e), (ps, pe) in zip(sorted(got[name]), sorted(own[name])):
            assert abs(s - ps) < 200 and abs(e - pe) < 200, name


def test_every_span_metric_has_its_file():
    assert set(SPAN_METRICS) <= set(METRICS)
