"""Peaks of the chip and the work of the pipeline's kernels, from the
cell's shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit (the
constants of chip_smoke.py). A roofline bound is the larger of the
operations at the FP32 peak and the compulsory bytes at the HBM peak
(each input byte read once, each output byte written once).

colDeltaCor's work per (center, neighbour, gene) step of a call that
computes the main field and the randomized control together (one dual
launch): the difference, the transform's add (its square root is a
special-function op, not counted), the sum of t and the fused t*t, and a
fused t*d for each field: 10 operations, counted once whichever kernel
runs them.
"""
PEAK_FP32 = 67e12          # FLOP/s, outside the tensor cores
PEAK_BYTES = 3.35e12       # HBM3 bytes/s
FLOP_PER_STEP_DUAL = 10


def bound_s(flop: float, nbytes: float) -> float:
    """The least time of `flop` FP32 operations and `nbytes` moved."""
    return max(flop / PEAK_FP32, nbytes / PEAK_BYTES)


def sampled_neighbours(cfg: dict) -> int:
    """Neighbours a cell is correlated with in sampled mode."""
    nn_k = min(cfg["n_neighbors"] + 1, cfg["cells"] - 1)
    return int(cfg["sampled_fraction"] * nn_k)


def dense_cor_bound_s(cfg: dict) -> float:
    """One dual dense colDeltaCor over N cells x G genes: (G, N) float32
    expression and two displacement fields in, two (N, N) float32
    correlation matrices out."""
    n, g = cfg["cells"], cfg["genes"]
    return bound_s(FLOP_PER_STEP_DUAL * n * n * g,
                   (3 * g * n + 2 * n * n) * 4)


def sampled_cor_bound_s(cfg: dict) -> float:
    """The dual sampled colDeltaCor of one pipeline: N centers x nn
    neighbours x G genes; the three (G, N) float32 inputs, the int32
    neighbour ids and two (N, nn) float32 outputs."""
    n, g = cfg["cells"], cfg["genes"]
    nn = sampled_neighbours(cfg)
    return bound_s(FLOP_PER_STEP_DUAL * n * nn * g,
                   3 * g * n * 4 + n * nn * (4 + 2 * 4))
