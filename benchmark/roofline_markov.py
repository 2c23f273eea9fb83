"""The compulsory bytes of the Markov stage's steps (benchmark/stages/
markov.py), from the cell's shapes, at the chip's HBM peak
(roofline.PEAK_BYTES), and the device time spent inside the program's
spans.

A step of run_markov's time evolution is x <- x tr over every cell: the
(N, N) float32 tr read once, 4 N^2 bytes; the vector's N floats in and
out are left out (2.5e-5 of it at 20,000 cells). Its 2 N^2 operations
would take 0.8% of the bytes' time at the FP32 peak: the bytes bound it.
"""
from typing import List, Tuple

import numpy as np

from benchmark import roofline


def markov_steps_bound_s(p: dict) -> float:
    """The least time of one pipeline's Markov steps: every direction's
    markov_n_steps steps over p["cells"] cells."""
    n = p["cells"]
    steps = len(p["markov_directions"]) * p["markov_n_steps"]
    return 4.0 * n * n * steps / roofline.PEAK_BYTES


def seconds_inside(device: List[Tuple[str, float, float]],
                   ranges: List[Tuple[float, float]]) -> float:
    """Device seconds of the activities `device` ((name, start, end), µs)
    inside `ranges` ((start, end), µs): each activity clipped to the
    ranges it overlaps."""
    if not device:
        return 0.0
    s = np.array([a for _, a, _ in device], np.float64)
    e = np.array([b for _, _, b in device], np.float64)
    merged = []
    for a, b in sorted(ranges):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(float(np.clip(np.minimum(e, b) - np.maximum(s, a), 0.0,
                             None).sum()) for a, b in merged) / 1e6
