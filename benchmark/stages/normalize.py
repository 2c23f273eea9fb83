"""normalize: VelocytoLoom.normalize("both") on the host: each cell's
counts scaled to the mean cell size, and S_norm = log2(S_sz + 1).
The reference recomputes all three from the raw counts."""
import numpy as np

from benchmark import compare, reference

KEYS = ("S_sz", "U_sz", "S_norm")


def names(p):
    return ("norm_gap",)


def run(v, p):
    v.normalize("both")


def read(v, p, cells):
    return {k: np.asarray(getattr(v, k)) for k in KEYS}


def recompute(r, p, got):
    out = reference.normalize(r.S, r.U, r.P, r.dev)
    r.ctx.update(out)
    return {k: reference.host(x) for k, x in out.items()}


def numbers(got, ref, p):
    return {"norm_gap": compare.gap([(got[k], ref[k]) for k in KEYS])}
