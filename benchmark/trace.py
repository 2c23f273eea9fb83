"""Reduction of a torch.profiler profile of the measured window to what
the per-layer metrics read: the device's activity (kernels, copies,
memsets) and the benchmark's own ranges, on the profile's clock (µs).

device_events and the busy-share arithmetic are copied from
velocyto_tpu_torch/bench_common.py.
"""
from dataclasses import dataclass
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

TOP = 10                # entries of each list of the breakdown


@dataclass
class Trace:
    """What one traced window holds. device: (name, start, end) of each
    device activity; ranges: name -> [(start, end)] of the benchmark's
    record_function ranges ("pipeline", "stage:<name>"); spans: (stage,
    start, end) on the host clock in seconds; stages: the parameters of
    each stage of one pipeline (pipeline.Stage.p: the configuration
    updated by the traffic), in order; the number of pipelines in the
    window. The window is the pipelines' ranges: the harness's work
    between two pipelines is not in it."""
    device: List[Tuple[str, float, float]]
    ranges: Dict[str, List[Tuple[float, float]]]
    spans: List[Tuple[str, float, float]]
    stages: List[dict]
    pipelines: int

    def kernel_seconds(self, match) -> float:
        """Device seconds in the activities whose name `match` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e6

    def stage_seconds(self, *stages: str) -> float:
        """Host seconds per pipeline in the spans of `stages`."""
        return sum(e - s for name, s, e in self.spans
                   if name in stages) / self.pipelines

    @property
    def window(self) -> List[Tuple[float, float]]:
        return self.ranges["pipeline"]

    def busy(self):
        """For each pipeline range (t0, t1), the disjoint intervals of
        it in which some device activity ran, in order."""
        merged = []
        for s, e in sorted((s, e) for _, s, e in self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(t0, t1, [(max(s, t0), min(e, t1)) for s, e in merged
                          if s < t1 and e > t0])
                for t0, t1 in self.window]

    def busy_seconds(self) -> float:
        """Seconds of the window covered by any device activity."""
        return sum(e - s for _, _, parts in self.busy()
                   for s, e in parts) / 1e6

    def window_seconds(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.window) / 1e6


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def reduce(prof, spans, stages, pipelines) -> Trace:
    """The Trace of a profile whose window is its "pipeline" ranges. Raises when the profile holds no device activity:
    the profiler then traced nothing of the card."""
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    device = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name not in host_names]
    if not device:
        raise RuntimeError("the profile holds no CUDA device activity")
    ranges: Dict[str, List[Tuple[float, float]]] = {}
    for e in events:
        if e.device_type == DeviceType.CPU and (
                e.name == "pipeline" or e.name.startswith("stage:")):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return Trace(device, ranges, list(spans), list(stages), pipelines)


def breakdown(t: Trace) -> dict:
    """The TOP device operations that took the most time (summed by
    name), and the TOP longest idle gaps of the device in the window,
    each named by the stage range the host was in at the gap's middle."""
    totals: Dict[str, float] = {}
    for name, s, e in t.device:
        totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    for t0, t1, parts in t.busy():
        reach = t0
        for s, e in parts:
            if s > reach:
                gaps.append((reach, s))
            reach = e
        if t1 > reach:
            gaps.append((reach, t1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    stages = [(name[len("stage:"):], s, e) for name, rs in t.ranges.items()
              if name.startswith("stage:") for s, e in rs]

    def label(mid):
        for name, s, e in stages:
            if s <= mid <= e:
                return name
        return "between stages"
    return {"device_ops": [[name[:160], sec] for name, sec in ops],
            "idle_gaps": [[label((s + e) / 2), (e - s) / 1e6]
                          for s, e in gaps]}
