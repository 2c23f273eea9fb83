"""markov: the start and end points of the tutorial's trajectories, as
velocyto's DentateGyrus notebook finds them. sigma_D is the diagonal of
one step of a markov_grid_steps grid over the embedding (each axis
padded as calculate_grid_arrows pads it), sigma_W = markov_sigma_w_ratio
* sigma_D; then, for each of markov_directions in order,
VelocytoLoom.prepare_markov(sigma_D, sigma_W, direction) over every cell
and run_markov(n_steps=markov_n_steps) from the uniform start. The
diffused vector of each direction is kept, as the notebook's user keeps
it, as the loom's diffused_<direction>.

The reference takes the program's whole compact correlations and
neighbour ids (the sampled mode's; the transition stage holds them to
its own at the compared cells), and from them, in float64, velocyto's
arithmetic (analysis.py:1818-1887): the probabilities, a softmax at
sigma_corr over each cell's neighbours; p for the forward direction and
its transpose for the backwards one, weighted by a gaussian of the
embedding distances at sigma_D, the self-transition set to the row's
largest entry, each row normalised; blended 80/20 with the gaussian
kernel at sigma_W, itself row-normalised; normalised again; then
markov_n_steps steps x <- x tr from the uniform start. It compares the
rows of the last direction's tr at the compared cells and every
direction's whole diffused vector."""
import numpy as np
import torch

from benchmark import compare, pipeline, reference

_BLOCK_BYTES = 1 << 28          # float64 bytes of one block of tr's rows


def names(p):
    return ("markov_tr_gap", "diffused_gap")


def sigmas(emb: np.ndarray, steps, ratio: float):
    """(sigma_D, sigma_W): the diagonal of one step of a `steps` grid
    over the embedding `emb` (N, 2), each axis padded by 2.5% of its span
    (the upper pad from the padded span), and ratio times it."""
    axes = []
    for d in range(emb.shape[1]):
        lo, hi = float(emb[:, d].min()), float(emb[:, d].max())
        lo -= 0.025 * abs(hi - lo)
        hi += 0.025 * abs(hi - lo)
        axes.append(np.linspace(lo, hi, steps[d]))
    diag = float(np.sqrt(sum((a[1] - a[0]) ** 2 for a in axes)))
    return diag, ratio * diag


def run(v, p):
    if p["markov_cells"] != "all" or p["markov_start"] != "uniform":
        raise NotImplementedError("the stage runs every cell from the "
                                  "uniform start")
    sigma_d, sigma_w = sigmas(np.asarray(v.embedding),
                              p["markov_grid_steps"],
                              p["markov_sigma_w_ratio"])
    for direction in p["markov_directions"]:
        v.prepare_markov(sigma_D=sigma_d, sigma_W=sigma_w,
                         direction=direction)
        v.run_markov(n_steps=p["markov_n_steps"])
        setattr(v, "diffused_" + direction, v.diffused)


def read(v, p, cells):
    d = v.__dict__
    out = {"tr": pipeline.rows(v._get_dev("tr", None), cells),
           "corr_all": d["_corr_dev"].cpu().numpy(),
           "ixs_all": d["_compact_ixs_dev"].cpu().numpy()}
    for direction in p["markov_directions"]:
        out["diffused_" + direction] = np.asarray(
            getattr(v, "diffused_" + direction))
    return out


def gaussian(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """velocyto's gaussian_kernel at mu 0."""
    return torch.exp(-x * x / (2 * sigma ** 2)) / np.sqrt(
        2 * np.pi * sigma ** 2)


def probabilities(corr: torch.Tensor, ixs: torch.Tensor, sigma_corr: float,
                  P) -> torch.Tensor:
    """The dense (N, N) transition probabilities: exp(corr / sigma_corr)
    over each row's neighbours ixs, normalised."""
    e = torch.exp(corr / sigma_corr)
    e = P("markov_matrix", e / e.sum(1, keepdim=True))
    n = ixs.shape[0]
    return torch.zeros((n, n), dtype=e.dtype, device=e.device).scatter_(
        1, ixs, e)


def markov_matrix(p: torch.Tensor, emb: torch.Tensor, sigma_d: float,
                  sigma_w: float, P) -> torch.Tensor:
    """prepare_markov's tr of the probabilities p (N, N) (transposed by
    the caller for the backwards direction), in row blocks."""
    n = p.shape[0]
    tr = torch.empty((n, n), dtype=reference.F64, device=p.device)
    block = max(1, _BLOCK_BYTES // (8 * n))
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        diff = emb[None, :, :] - emb[r0:r1, None, :]
        dist = torch.sqrt((diff * diff).sum(-1))            # scipy's pdist
        local = P("markov_matrix", p[r0:r1] * gaussian(dist, sigma_d))
        rows = torch.arange(r1 - r0, device=p.device)
        local[rows, rows + r0] = local.max(1).values
        local = local / local.sum(1, keepdim=True)
        noise = gaussian(dist, sigma_w)
        noise = noise / noise.sum(1, keepdim=True)
        blend = 0.8 * local + 0.2 * noise
        tr[r0:r1] = P("markov_matrix", blend / blend.sum(1, keepdim=True))
    return tr


def diffuse(tr: torch.Tensor, n_steps: int, P) -> torch.Tensor:
    """run_markov's time evolution: n_steps steps x <- x tr from the
    uniform start."""
    n = tr.shape[0]
    tr = P("markov_steps", tr)
    x = torch.full((n,), 1.0 / n, dtype=tr.dtype, device=tr.device)
    for _ in range(n_steps):
        x = P("markov_steps", x @ tr)
    return x


def recompute(r, p, got):
    if not p["knn_random"]:
        raise NotImplementedError("the Markov reference reads the sampled "
                                  "mode's compact correlations")
    dev, P = r.dev, r.P
    emb = r.ctx["emb"]
    sigma_d, sigma_w = sigmas(reference.host(emb), p["markov_grid_steps"],
                              p["markov_sigma_w_ratio"])
    prob = probabilities(reference.f64(got["corr_all"], dev),
                         torch.as_tensor(got["ixs_all"], device=dev)
                         .to(torch.int64), p["sigma_corr"], P)
    out, tr = {}, None
    for direction in p["markov_directions"]:
        tr = None                   # the last direction's tr freed first
        tr = markov_matrix(prob if direction == "forward" else prob.T, emb,
                           sigma_d, sigma_w, P)
        out["diffused_" + direction] = reference.host(
            diffuse(tr, p["markov_n_steps"], P))
    out["tr"] = reference.host(tr[torch.as_tensor(r.cells, device=dev)])
    return out


def numbers(got, ref, p):
    return {"markov_tr_gap": compare.gap([(got["tr"], ref["tr"])]),
            "diffused_gap": compare.gap(
                [(got["diffused_" + d], ref["diffused_" + d])
                 for d in p["markov_directions"]])}
