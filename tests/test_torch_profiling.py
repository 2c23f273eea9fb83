"""The port's profiling utilities (utils/profiling.py) and the idle-share
arithmetic of bench_common.py, on the CPU.

stage_timer mirrors tests/test_checkpoint.py::test_stage_timer; trace
writes a Chrome trace of CPU activity; the idle share is checked on
synthetic intervals and on a stand-in profile with a known answer, and
refuses a profile that holds no device event (every CPU profile)."""
import json
import types

import pytest
import torch
from torch.autograd import DeviceType

from velocyto_tpu_torch import bench_common
from velocyto_tpu_torch.utils.profiling import stage_timer, trace


def test_stage_timer():
    t = stage_timer(sync=False)
    with t("a"):
        pass
    with t("a"):
        pass
    rep = t.report()
    assert "a" in rep and t.counts["a"] == 2


def test_stage_timer_syncs_the_card_around_each_stage(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("sync"))
    t = stage_timer()
    with t("b"):
        calls.append("stage")
    assert calls == ["sync", "stage", "sync"]


def test_stage_timer_does_not_hide_a_failed_sync(monkeypatch):
    def fail():
        raise RuntimeError("device lost")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", fail)
    with pytest.raises(RuntimeError, match="device lost"):
        with stage_timer()("c"):
            pass


def test_stage_timer_needs_no_card():
    """A process that never initialised CUDA has nothing to wait for."""
    assert not torch.cuda.is_initialized()
    t = stage_timer()
    with t("d"):
        torch.ones(3).sum()
    assert t.counts["d"] == 1


def test_trace_writes_a_chrome_trace_of_cpu_activity(tmp_path):
    with trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("block"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "block" for e in events)
    start, end = bench_common.host_window(prof, "block")
    assert end > start
    assert bench_common.device_events(prof) == []
    with pytest.raises(RuntimeError, match="no CUDA device events"):
        bench_common.idle_share(prof, start, end)


@pytest.mark.parametrize("intervals,t0,t1,share", [
    ([], 0.0, 10.0, 0.0),
    ([(2.0, 4.0), (6.0, 7.0)], 0.0, 10.0, 0.3),          # disjoint
    ([(2.0, 6.0), (4.0, 8.0)], 0.0, 10.0, 0.6),          # overlapping
    ([(1.0, 9.0), (3.0, 4.0)], 0.0, 10.0, 0.8),          # nested
    ([(-5.0, 2.0), (8.0, 15.0)], 0.0, 10.0, 0.4),        # cut by the window
    ([(11.0, 12.0), (-3.0, -1.0)], 0.0, 10.0, 0.0),      # outside it
    ([(0.0, 10.0), (2.0, 3.0)], 0.0, 10.0, 1.0),         # all busy
    ([(5.0, 5.0)], 0.0, 10.0, 0.0),                      # zero length
], ids=["none", "disjoint", "overlap", "nested", "cut", "outside", "full",
        "instant"])
def test_busy_share_of_synthetic_intervals(intervals, t0, t1, share):
    assert bench_common.busy_share(intervals, t0, t1) == pytest.approx(share)


def test_busy_share_refuses_an_empty_window():
    with pytest.raises(ValueError, match="empty window"):
        bench_common.busy_share([(0.0, 1.0)], 5.0, 5.0)


def _event(name, device_type, start, end, **kw):
    return types.SimpleNamespace(
        name=name, device_type=device_type,
        time_range=types.SimpleNamespace(start=start, end=end), **kw)


class _Profile:
    """Stands in for a torch.profiler profile: events() only."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_idle_share_of_a_profile_with_a_known_answer():
    prof = _Profile([
        _event("window", DeviceType.CPU, 100.0, 200.0),
        _event("aten::mm", DeviceType.CPU, 110.0, 120.0),
        _event("gemm_kernel", DeviceType.CUDA, 120.0, 150.0),
        _event("gemm_kernel", DeviceType.CUDA, 140.0, 160.0),
        _event("Memcpy DtoH", DeviceType.CUDA, 190.0, 210.0),
        # the range mirrored onto the device timeline: not device work
        _event("window", DeviceType.CUDA, 100.0, 200.0),
        _event("annotation", DeviceType.CUDA, 0.0, 300.0,
               is_user_annotation=True),
    ])
    window = bench_common.host_window(prof, "window")
    assert window == (100.0, 200.0)
    # busy 120-160 and 190-200 of 100-200
    assert bench_common.idle_share(prof, *window) == pytest.approx(0.5)
    top = bench_common.top_device_kernels(prof, n=5)
    assert [k["name"] for k in top] == ["gemm_kernel", "Memcpy DtoH"]
    assert top[0]["calls"] == 2 and top[0]["ms"] == pytest.approx(0.05)
    with pytest.raises(KeyError):
        bench_common.host_window(prof, "absent")
