"""The program's spans in a traced window: the host ranges "vtt.<name>"
that velocyto_tpu_torch.utils.profiling.span opens inside the port.

The harness's Trace holds the device's activity and the benchmark's own
ranges only, so the spans are taken from the program itself
(profiling.recorded(): name, thread, start and end on time.perf_counter)
and placed on the profile's clock by the stages, which the Trace holds
on both clocks (Trace.spans on the host's, "stage:<name>" ranges on the
profile's). Only the calling thread's spans are kept, those the
harness's own profile would hold, and only those inside the window's
stages. A program that records no spans gives an empty dict, and every
reader here None.
"""
import statistics
import threading
from typing import Callable, Dict, List, Optional, Tuple

Ranges = Dict[str, List[Tuple[float, float]]]


def _recorded() -> list:
    try:
        from velocyto_tpu_torch.utils import profiling
        return profiling.recorded()
    except (ImportError, AttributeError):
        return []


def _offset(t) -> Optional[float]:
    """µs to add to a host-clock second times 1e6 to land on the
    profile's clock: the median over the window's stages of the
    difference of their middles; None where the two do not pair."""
    host: Dict[str, List[Tuple[float, float]]] = {}
    for name, s, e in t.spans:
        host.setdefault(name, []).append((s, e))
    diffs = []
    for name, rs in host.items():
        prof = sorted(t.ranges.get("stage:" + name, []))
        if len(prof) != len(rs):
            return None
        diffs += [(ps + pe) / 2 - (s + e) / 2 * 1e6
                  for (s, e), (ps, pe) in zip(sorted(rs), prof)]
    return statistics.median(diffs) if diffs else None


def ranges(t, recorded=None) -> Ranges:
    """name (without "vtt.") -> [(start, end)] of the program's spans on
    the calling thread inside the window's stages, on the profile's
    clock (µs); `recorded` defaults to the program's own record."""
    recorded = _recorded() if recorded is None else recorded
    offset = _offset(t)
    if not recorded or offset is None:
        return {}
    me = threading.get_ident()
    stages = [(s, e) for _, s, e in t.spans]
    out: Ranges = {}
    for name, thread, s, e in recorded:
        if thread == me and any(a <= s and e <= b for a, b in stages):
            out.setdefault(name, []).append((s * 1e6 + offset,
                                             e * 1e6 + offset))
    return out


def self_us(program: Ranges) -> Dict[str, float]:
    """name -> µs of its spans less what the spans nested in them cover:
    spans sorted by start (the longer first), each nested in the nearest
    open one that still holds its end."""
    own: Dict[str, float] = {}
    stack: List[list] = []          # [end, name, own µs so far]

    def close():
        _end, name, us = stack.pop()
        own[name] = own.get(name, 0.0) + us
    for s, e, name in sorted(((s, e, n) for n, rs in program.items()
                              for s, e in rs), key=lambda r: (r[0], -r[1])):
        while stack and e > stack[-1][0]:
            close()
        if stack:
            stack[-1][2] -= e - s
        stack.append([e, name, e - s])
    while stack:
        close()
    return own


def self_seconds(t, match: Callable[[str], bool],
                 program: Optional[Ranges] = None) -> Optional[float]:
    """Host seconds per pipeline in the program's spans whose name
    `match` accepts, each less what the spans nested in it cover; None
    where the window holds no such span."""
    own = self_us(ranges(t) if program is None else program)
    names = [n for n in own if match(n)]
    if not names:
        return None
    return sum(own[n] for n in names) / 1e6 / t.pipelines


def idle(t) -> List[Tuple[float, float]]:
    """The intervals of the window in which no device activity ran, in
    order (trace.breakdown's gaps)."""
    gaps = []
    for t0, t1, parts in t.busy():
        reach = t0
        for s, e in parts:
            if s > reach:
                gaps.append((reach, s))
            reach = e
        if t1 > reach:
            gaps.append((reach, t1))
    return gaps


def named_share(t, program: Optional[Ranges] = None) -> Optional[float]:
    """Percent of the window's device-idle time that some program span
    holds; None where the window holds no span or no idle time."""
    program = ranges(t) if program is None else program
    if not program:
        return None
    named = []
    for s, e in sorted(r for rs in program.values() for r in rs):
        if named and s <= named[-1][1]:
            named[-1][1] = max(named[-1][1], e)
        else:
            named.append([s, e])
    gaps = idle(t)              # disjoint and in order, as named is
    total = sum(e - s for s, e in gaps)
    if total <= 0.0:
        return None
    inside, j = 0.0, 0
    for s, e in gaps:
        while j < len(named) and named[j][1] <= s:
            j += 1
        k = j
        while k < len(named) and named[k][0] < e:
            inside += min(e, named[k][1]) - max(s, named[k][0])
            k += 1
    return 100.0 * inside / total


def named_gaps(t, top: int = 10,
               program: Optional[Ranges] = None) -> List[list]:
    """The `top` longest idle gaps of the window, longest first, as
    [label, seconds]: the stage the host was in at the gap's middle, as
    trace.breakdown labels it, and "/<span>" after it where a program
    span holds that moment, the shortest such."""
    program = ranges(t) if program is None else program
    stages = [(name[len("stage:"):], s, e) for name, rs in t.ranges.items()
              if name.startswith("stage:") for s, e in rs]

    def label(mid):
        stage = next((name for name, s, e in stages if s <= mid <= e),
                     "between stages")
        held = [(e - s, name) for name, rs in program.items()
                for s, e in rs if s <= mid <= e]
        return f"{stage}/{min(held)[1]}" if held else stage
    gaps = sorted(idle(t), key=lambda g: g[0] - g[1])[:top]
    return [[label((s + e) / 2), (e - s) / 1e6] for s, e in gaps]
