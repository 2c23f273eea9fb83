"""pca: VelocytoLoom.perform_PCA(which="S_norm", n_components) on the
host. The reference recomputes it from its own S_norm: the explained
variances, and each component that stands apart from its neighbours
(compare.pca_gap)."""
import numpy as np

from benchmark import compare, reference


def names(p):
    return ("pca_gap",)


def run(v, p):
    v.perform_PCA(which="S_norm", n_components=p["n_pca"])


def read(v, p, cells):
    return {"pcs": np.asarray(v.pcs),
            "explained_variance": np.asarray(v.pca.explained_variance_)}


def recompute(r, p, got):
    pcs, ev = reference.pca(r.ctx.pop("S_norm"), p["n_pca"], r.P)
    return {"pcs": reference.host(pcs),
            "explained_variance": reference.host(ev)}


def numbers(got, ref, p):
    return {"pca_gap": compare.pca_gap(
        got["pcs"], got["explained_variance"], ref["pcs"],
        ref["explained_variance"], compare.PCA_SEP)}
