"""transition: VelocytoLoom.estimate_transition_prob(hidim="Sx_sz",
embed="ts", transform, psc, knn_random, n_neighbors, sampled_fraction,
calculate_randomized=True, random_seed), with the first two principal
components as the embedding: the correlation of each cell's velocity
with the displacement to its embedding neighbours (colDeltaCor, sqrt
transform), for the velocity and for the randomized control.

The reference permutes the program's delta_S (checked by the velocity
stage) with velocyto's permute_rows_nsign plan and compares the result
exactly; finds each compared cell's embedding neighbours itself and
compares the lists exactly; in sampled mode (knn_random) takes the
program's sampled positions once their digest matches that of its own
replay of velocyto's sampling; and recomputes the correlations of the
compared cells from the program's Sx_sz."""
import numpy as np
import torch

from benchmark import compare, pipeline, reference


def names(p):
    head = ("sample_differ",) if p["knn_random"] else ("perm_differ",)
    return head + ("neigh_differ", "corr_gap")


def run(v, p):
    v.ts = np.ascontiguousarray(v.pcs[:, :2])
    v.estimate_transition_prob(
        hidim="Sx_sz", embed="ts", transform=p["transform"], psc=p["psc"],
        knn_random=p["knn_random"], n_neighbors=p["n_neighbors"],
        sampled_fraction=p["sampled_fraction"], calculate_randomized=True,
        random_seed=p["random_seed"])


def read(v, p, cells):
    out = {"delta_S_rndm": np.asarray(v.delta_S_rndm)}
    if p["knn_random"]:
        d = v.__dict__
        out["sampling_ixs"] = np.asarray(v.sampling_ixs)
        out["neighbours"] = pipeline.rows(d["_compact_ixs_dev"], cells) \
            .astype(np.int64)
        out["corr"] = pipeline.rows(d["_corr_dev"], cells)
        out["corr_rndm"] = pipeline.rows(d["_corr_rndm_dev"], cells)
    else:
        ek = v.embedding_knn
        out["neighbours"] = ek.indices.reshape(ek.shape[0], -1)[cells]
        out["corr"] = pipeline.rows(v._get_dev("corrcoef"), cells)
        out["corr_rndm"] = pipeline.rows(v._get_dev("corrcoef_random"),
                                         cells)
    return out


def _sqrt_field(M, psc):
    return torch.sign(M) * torch.sqrt(M.abs() + psc)


def recompute(r, p, got):
    dev, cells, P = r.dev, r.cells, r.P
    Sx = r.ctx["Sx"]
    dS = reference.f64(got["delta_S"], dev)
    n = dS.shape[1]
    perm, sign = reference.permutation_plan(dS.shape[0], n,
                                            p["random_seed"])
    dR = torch.gather(dS, 1, torch.as_tensor(perm, device=dev)) * \
        torch.as_tensor(sign, device=dev).to(reference.F64)
    del perm, sign
    out = {"delta_S_rndm": reference.host(dR)}

    emb = reference.f64(got["pcs"][:, :2], dev)
    nn_k = min(p["n_neighbors"] + 1, n - 1)
    _, near = reference.knn_sorted(emb, emb[torch.as_tensor(cells,
                                                            device=dev)],
                                   min(nn_k + 1, n), P, "knn_rescore")
    near = reference.host(near)
    lists = []
    for i, c in enumerate(cells):
        row = near[i]
        self_at = np.flatnonzero(row == c)
        drop = self_at[0] if len(self_at) else len(row) - 1
        lists.append(np.delete(row, drop)[:nn_k])
    if p["knn_random"]:
        samp = np.asarray(got["sampling_ixs"])
        out["sampling_ixs"] = samp
        nbrs = [lists[i][samp[c]] for i, c in enumerate(cells)]
        every = nbrs
    else:
        nbrs = lists
        every = [np.arange(n)] * len(cells)
    out["neighbours"] = np.stack(nbrs)

    corr = {}
    for tag, field in (("", dS), ("_rndm", dR)):
        rows = reference.corr_rows(Sx, _sqrt_field(field, p["psc"]), cells,
                                   every, p["psc"], P, p["knn_random"])
        if not p["knn_random"]:
            for i, c in enumerate(cells):
                rows[i][c] = 0.0
        corr[tag] = rows
        out["corr" + tag] = reference.host(torch.stack(rows))
    r.ctx.pop("Sx")
    r.ctx.update(emb=emb, nbrs=nbrs, corr=corr)
    return out


def numbers(got, ref, p):
    perm = compare.rows_differ(got["delta_S_rndm"], ref["delta_S_rndm"])
    if p["knn_random"]:
        digest = reference.replay_digest(got["sampling_ixs"])
        head = {"sample_differ": perm + int(digest != p["replay_sha256"])}
    else:
        head = {"perm_differ": perm}
    return {**head,
            "neigh_differ": compare.rows_differ(got["neighbours"],
                                                ref["neighbours"]),
            "corr_gap": compare.gap([(got["corr"], ref["corr"]),
                                     (got["corr_rndm"], ref["corr_rndm"])])}
