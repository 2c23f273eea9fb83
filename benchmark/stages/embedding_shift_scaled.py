"""embedding_shift_scaled: VelocytoLoom.calculate_embedding_shift(
sigma_corr, expression_scaling=True, scaling_penalty): the embedding
shift of the embedding_shift stage, each cell's shift scaled by how far
its velocity points along the expression change its transition
probabilities predict, for the velocity and the randomized control.

The reference recomputes, at the compared cells, the probabilities from
its own correlations (the transition stage's) and the scaling from the
program's Sx_sz (checked by the knn_imputation stage at the compared
cells), delta_S (the velocity stage) and delta_S_rndm (the transition
stage), with velocyto's formula (analysis.py:1714-1719):

    estim_i   = sum_k P_ik hi[:, nb_ik] - mean_k hi[:, nb_ik]
    scaling_i = clip(<dS_i, estim_i> / ||estim_i|| / penalty, 0, 1)

over each cell's sampled neighbours nb_i (sampled mode; the
tutorial's session runs no other). It compares the scaling of both
fields and the scaled shifts at the compared cells."""
import numpy as np
import torch

from benchmark import compare, reference


def names(p):
    return ("scaling_gap", "shift_gap")


def run(v, p):
    v.calculate_embedding_shift(sigma_corr=p["sigma_corr"],
                                expression_scaling=True,
                                scaling_penalty=p["scaling_penalty"])


def read(v, p, cells):
    out = {"delta_embedding": np.asarray(v.delta_embedding),
           "delta_embedding_random": np.asarray(v.delta_embedding_random)}
    out["shift"] = out["delta_embedding"][cells]
    out["shift_rndm"] = out["delta_embedding_random"][cells]
    out["scaling"] = np.asarray(v.scaling)[cells]
    out["scaling_rndm"] = np.asarray(v.scaling_rndm)[cells]
    return out


def scaling(hi: torch.Tensor, d: torch.Tensor, tp: torch.Tensor,
            penalty: float, P) -> torch.Tensor:
    """velocyto's expression scaling of one cell: hi (G, k) the high
    dimensional expression of its k neighbours, d (G,) its velocity, tp
    (k,) its transition probabilities to them."""
    hi = P("expression_scaling", hi)
    estim = P("expression_scaling", hi @ tp - hi.mean(1))
    d = P("expression_scaling", d)
    proj = P("expression_scaling", (d * estim).sum() / torch.sqrt(
        (estim * estim).sum()))
    return torch.clamp(proj / penalty, 0.0, 1.0)


def recompute(r, p, got):
    if not p["knn_random"]:
        raise NotImplementedError("the reference of the scaled shift is "
                                  "the sampled mode's")
    P, dev, cells = r.P, r.dev, r.cells
    emb, nbrs, corr = r.ctx["emb"], r.ctx["nbrs"], r.ctx.pop("corr")
    hi = reference.f64(got["Sx_sz"], dev)
    fields = {"": reference.f64(got["delta_S"], dev),
              "_rndm": reference.f64(got["delta_S_rndm"], dev)}
    sigma = p["sigma_corr"]
    out = {}
    for tag, rows in corr.items():
        shifts, scales = [], []
        for i, c in enumerate(cells):
            nb = torch.as_tensor(nbrs[i], device=dev)
            tp = P("softmax", torch.softmax(rows[i] / sigma, 0))
            s = scaling(hi[:, nb], fields[tag][:, c], tp,
                        p["scaling_penalty"], P)
            scales.append(s)
            shifts.append(P("embedding_shift", reference.unit_shift(
                emb, int(c), nb, tp, P) * s))
        out["scaling" + tag] = reference.host(torch.stack(scales))
        out["shift" + tag] = reference.host(torch.stack(shifts))
    return out


def numbers(got, ref, p):
    return {"scaling_gap": compare.gap([(got["scaling"], ref["scaling"]),
                                        (got["scaling_rndm"],
                                         ref["scaling_rndm"])]),
            "shift_gap": compare.gap([(got["shift"], ref["shift"]),
                                      (got["shift_rndm"],
                                       ref["shift_rndm"])])}
