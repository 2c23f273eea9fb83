"""knn_imputation: VelocytoLoom.knn_imputation(k, balanced=True,
b_sight, b_maxl): the balanced kNN graph over the principal components,
and S_sz, U_sz smoothed over it.

The reference builds the graph from the program's components (checked
by the pca stage; the graph is invariant to a rotation inside a cluster
of equal eigenvalues) and compares it whole, exactly; it smooths its own
S_sz, U_sz over its own graph at the compared cells."""
import numpy as np
import torch

from benchmark import compare, reference


def names(p):
    return ("knn_rows_differ", "smooth_gap")


def run(v, p):
    v.knn_imputation(k=p["k"], balanced=True, b_sight=p["b_sight"],
                     b_maxl=p["b_maxl"])


def read(v, p, cells):
    knn = v.knn
    out = {"knn_idx": knn.indices.reshape(knn.shape[0], -1),
           "Sx_sz": np.asarray(v.Sx_sz), "Ux_sz": np.asarray(v.Ux_sz)}
    out["Sx_sz_cells"] = out["Sx_sz"][:, cells]
    out["Ux_sz_cells"] = out["Ux_sz"][:, cells]
    return out


def recompute(r, p, got):
    x = reference.f64(got["pcs"][:, :p["n_pca"]], r.dev)
    n = x.shape[0]
    sight = min(p["b_sight"] + 1, n)
    d2, dsi = reference.knn_sorted(x, x, sight, r.P, "knn_rescore")
    dist = reference.host(torch.sqrt(torch.clamp_min(d2, 0.0)))
    del d2
    idx, gdist = reference.balance(reference.host(dsi), dist, p["k"],
                                   p["b_maxl"])
    del dsi, dist
    S_sz, U_sz = r.ctx.pop("S_sz"), r.ctx.pop("U_sz")
    return {"knn_idx": idx,
            "Sx_sz_cells": reference.host(reference.smooth_cells(
                S_sz, idx, gdist, r.cells, r.P)),
            "Ux_sz_cells": reference.host(reference.smooth_cells(
                U_sz, idx, gdist, r.cells, r.P))}


def numbers(got, ref, p):
    return {"knn_rows_differ": compare.rows_differ(got["knn_idx"],
                                                   ref["knn_idx"]),
            "smooth_gap": compare.gap(
                [(got["Sx_sz_cells"], ref["Sx_sz_cells"]),
                 (got["Ux_sz_cells"], ref["Ux_sz_cells"])])}
