"""grid_arrows: VelocytoLoom.calculate_grid_arrows(smooth, steps,
n_neighbors): each grid point's Gaussian-weighted mean of its nearest
cells' embedding shifts. The reference recomputes every grid point from
the program's shifts (checked by the embedding_shift stage at the
compared cells) on the embedding of the transition stage."""
import numpy as np

from benchmark import compare, reference


def names(p):
    return ("grid_gap",)


def run(v, p):
    v.calculate_grid_arrows(smooth=p["grid_smooth"],
                            steps=tuple(p["grid_steps"]),
                            n_neighbors=p["grid_neighbors"])


def read(v, p, cells):
    return {"flow": np.asarray(v.flow), "flow_rndm": np.asarray(v.flow_rndm)}


def recompute(r, p, got):
    _, flows = reference.grid_flow(
        r.ctx["emb"], [reference.f64(got["delta_embedding"], r.dev),
                       reference.f64(got["delta_embedding_random"], r.dev)],
        p["grid_steps"], p["grid_smooth"], p["grid_neighbors"], r.P)
    return {"flow": reference.host(flows[0]),
            "flow_rndm": reference.host(flows[1])}


def numbers(got, ref, p):
    return {"grid_gap": compare.gap([(got["flow"], ref["flow"]),
                                     (got["flow_rndm"], ref["flow_rndm"])])}
