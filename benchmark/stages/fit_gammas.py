"""fit_gammas: VelocytoLoom.fit_gammas() at its defaults (the weighted,
offset fit of each gene). The reference fits the program's smoothed
Sx_sz, Ux_sz (checked by the knn_imputation stage at the compared
cells) and compares every gene."""
import numpy as np

from benchmark import compare, reference


def names(p):
    return ("gamma_gap",)


def run(v, p):
    v.fit_gammas()


def read(v, p, cells):
    return {"gammas": np.asarray(v.gammas), "q": np.asarray(v.q)}


def recompute(r, p, got):
    Sx, Ux = reference.f64(got["Sx_sz"], r.dev), reference.f64(
        got["Ux_sz"], r.dev)
    gam, q = reference.fit_gammas(Sx, Ux, r.P)
    r.ctx.update(Sx=Sx, Ux=Ux, gammas=gam, q=q)
    return {"gammas": reference.host(gam), "q": reference.host(q)}


def numbers(got, ref, p):
    return {"gamma_gap": compare.gap([(got["gammas"], ref["gammas"]),
                                      (got["q"], ref["q"])])}
