"""The comparison that decides `correct`: each number compared, against
its limit from the cell's file.

A gap is max |got - want| / max |want| over the arrays compared (the
largest error in units of the reference's scale). A count is the number
of rows that differ in an exact comparison, whose limit is 0.
"""
import math

import numpy as np

# a component is compared where its eigenvalue stands apart from its
# neighbours' by this share of the largest
PCA_SEP = 1e-2


def names(seq) -> tuple:
    """The numbers of the compared stages (pipeline.compared), in the
    order they are printed."""
    return tuple(n for s in seq for n in s.mod.names(s.p))


def gap(pairs) -> float:
    """The largest of max |got - want| / max |want| over (got, want)
    pairs; inf where shapes differ or a value is not finite."""
    worst = 0.0
    for got, want in pairs:
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            return math.inf
        scale = float(np.max(np.abs(want))) if want.size else 0.0
        err = float(np.max(np.abs(got - want))) if want.size else 0.0
        if scale == 0.0:
            worst = max(worst, 0.0 if err == 0.0 else math.inf)
        else:
            worst = max(worst, err / scale)
    return worst


def rows_differ(got, want) -> int:
    """Rows of two integer tables that are not equal (all, where the
    shapes differ)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return int(max(len(got), len(want)))
    return int(np.count_nonzero((got != want).reshape(len(want), -1)
                                .any(1)))


def pca_gap(got_pcs, got_ev, want_pcs, want_ev, sep: float) -> float:
    """Explained variances, and every component whose eigenvalue stands
    apart from its neighbours by more than `sep` of the largest (a
    component inside a near-degenerate cluster may rotate within it under
    any rounding), matched in sign to the reference."""
    worst = gap([(got_ev, want_ev)])
    ev = np.asarray(want_ev, np.float64)
    nb = np.full(len(ev), np.inf)
    nb[1:] = np.minimum(nb[1:], ev[:-1] - ev[1:])
    nb[:-1] = np.minimum(nb[:-1], ev[:-1] - ev[1:])
    for c in np.flatnonzero(nb > sep * ev[0]):
        g, w = got_pcs[:, c], want_pcs[:, c]
        s = 1.0 if float(np.dot(g, w)) >= 0 else -1.0
        worst = max(worst, gap([(s * g, w)]))
    return worst


def numbers(out: dict, ref: dict, seq) -> dict:
    """Each number of the compared stages, from the outputs compared (the
    program's or the control's) and the reference's."""
    got = {}
    for s in seq:
        got.update(s.mod.numbers(out, ref, s.p))
    return {k: got[k] for k in names(seq)}


def judge(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number with no limit, or one that is not a number, fails."""
    rows, ok = [], True
    for name, value in values.items():
        limit = limits.get(name)
        passed = limit is not None and value == value and value <= limit
        ok = ok and passed
        rows.append((name, value, limit))
    return ok, rows
