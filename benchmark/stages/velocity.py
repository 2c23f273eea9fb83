"""velocity: predict_U, calculate_velocity, calculate_shift under the
constant-velocity assumption and extrapolate_cell_at_t(delta_t=1): the
velocity U - (gamma S + q) of every gene and cell, and the shift
delta_S that the transition stage consumes. The reference recomputes
both from its own gammas and compares every entry."""
import numpy as np

from benchmark import compare, reference

DELTA_T = 1.0


def names(p):
    return ("velocity_gap", "delta_s_gap")


def run(v, p):
    v.predict_U()
    v.calculate_velocity()
    v.calculate_shift(assumption="constant_velocity", delta_t=DELTA_T)
    v.extrapolate_cell_at_t(delta_t=DELTA_T)


def read(v, p, cells):
    return {"velocity": np.asarray(v.velocity),
            "delta_S": np.asarray(v.delta_S)}


def recompute(r, p, got):
    c = r.ctx
    gam, q = c.pop("gammas"), c.pop("q")
    vel = r.P("velocity", c.pop("Ux") - (gam[:, None] * c["Sx"]
                                         + q[:, None]))
    dS = r.P("velocity", DELTA_T * vel)
    return {"velocity": reference.host(vel), "delta_S": reference.host(dS)}


def numbers(got, ref, p):
    return {"velocity_gap": compare.gap([(got["velocity"],
                                          ref["velocity"])]),
            "delta_s_gap": compare.gap([(got["delta_S"], ref["delta_S"])])}
