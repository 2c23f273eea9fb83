"""embedding_shift: VelocytoLoom.calculate_embedding_shift(sigma_corr,
expression_scaling): the transition probabilities (a softmax of the
correlations over each cell's embedding neighbours) and the expected
displacement of each cell on the embedding, for the velocity and the
randomized control.

The reference recomputes both at the compared cells from its own
correlations (the transition stage's), and compares the probabilities
in full mode, where the loom keeps them, and the shifts in both. It has
no expression scaling, and refuses a stage that asks for it."""
import numpy as np
import torch

from benchmark import compare, pipeline, reference


def names(p):
    return ("shift_gap",) if p["knn_random"] else ("tp_gap", "shift_gap")


def run(v, p):
    v.calculate_embedding_shift(sigma_corr=p["sigma_corr"],
                                expression_scaling=p["expression_scaling"])


def read(v, p, cells):
    out = {"delta_embedding": np.asarray(v.delta_embedding),
           "delta_embedding_random": np.asarray(v.delta_embedding_random)}
    out["shift"] = out["delta_embedding"][cells]
    out["shift_rndm"] = out["delta_embedding_random"][cells]
    if not p["knn_random"]:
        out["tp"] = pipeline.rows(v._get_dev("transition_prob"), cells)
        out["tp_rndm"] = pipeline.rows(v._get_dev("transition_prob_random"),
                                       cells)
    return out


def recompute(r, p, got):
    if p["expression_scaling"]:
        raise NotImplementedError("the reference has no expression scaling")
    P, dev, cells = r.P, r.dev, r.cells
    emb, nbrs, corr = r.ctx["emb"], r.ctx["nbrs"], r.ctx.pop("corr")
    sigma = p["sigma_corr"]
    out = {}
    for tag, rows in corr.items():
        tps, shifts = [], []
        for i, c in enumerate(cells):
            nb = torch.as_tensor(nbrs[i], device=dev)
            if p["knn_random"]:
                tp = P("softmax", torch.softmax(rows[i] / sigma, 0))
                on_nb = tp
            else:
                tp = torch.zeros_like(rows[i])
                tp[nb] = torch.softmax(rows[i][nb] / sigma, 0)
                tp = P("softmax", tp)
                on_nb = tp[nb]
            tps.append(tp)
            shifts.append(reference.unit_shift(emb, int(c), nb, on_nb, P))
        if not p["knn_random"]:
            out["tp" + tag] = reference.host(torch.stack(tps))
        out["shift" + tag] = reference.host(torch.stack(shifts))
    return out


def numbers(got, ref, p):
    out = {"shift_gap": compare.gap([(got["shift"], ref["shift"]),
                                     (got["shift_rndm"],
                                      ref["shift_rndm"])])}
    if not p["knn_random"]:
        out["tp_gap"] = compare.gap([(got["tp"], ref["tp"]),
                                     (got["tp_rndm"], ref["tp_rndm"])])
    return out
