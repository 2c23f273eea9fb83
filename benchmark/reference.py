"""Plain reference of the tutorial pipeline, in numpy and plain PyTorch.

It imports nothing of the program under test. Each stage follows the
velocyto.py tutorial's estimation path (normalize, PCA, balanced kNN
smoothing, gamma fit, velocity, sampled or full transition
probabilities, embedding shift, grid arrows) and is written from the
published method, in float64. This module holds the arithmetic; each
stage's file under benchmark/stages/ says what it recomputes and from
which inputs, and `run` drives them in the traffic's order.

The stages that come after a discrete choice (the kNN graph, the
sampled neighbours, the embedding's neighbour lists) take the program's
own output of the stage before as their input, so that a rounding
difference upstream cannot move a neighbour and so every stage is
compared on its own; each such input is itself compared.

`prec="control"` computes every stage one step below the precision that
the configuration states for it (float64 -> float32, a float32 matrix
product -> TF32, other float32 -> bfloat16): the control that the
comparison has to reject.
"""
import hashlib

import numpy as np
import torch

F64 = torch.float64
_TF32_DROP = 13                       # float32 mantissa bits TF32 drops
_BLOCK = 512                          # query rows of one kNN block


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest even)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    half = (1 << (_TF32_DROP - 1)) - 1
    b = (b + half + ((b >> _TF32_DROP) & 1)) & ~((1 << _TF32_DROP) - 1)
    return b.view(torch.float32).to(F64)


class Precision:
    """Where a stage rounds: nowhere for the reference; for the control,
    to the type one step below the configuration's stated type of the
    stage."""

    def __init__(self, stated: dict, control: bool):
        self.stated, self.control = stated, control

    def __call__(self, stage: str, x: torch.Tensor) -> torch.Tensor:
        if not self.control:
            return x
        kind = self.stated[stage]
        if kind == "float64":
            return x.to(torch.float32).to(F64)
        if kind == "float32_matmul":
            return _round_tf32(x)
        if kind == "float32":
            return x.to(torch.bfloat16).to(F64)
        raise ValueError(f"unknown stated precision {kind!r} of {stage}")


def f64(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=dev).to(F64)


def host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _percentile_rows(M: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile(M, q, axis=1), linear interpolation."""
    s = torch.sort(M, dim=1).values
    h = (M.shape[1] - 1) * (q / 100.0)
    lo, hi = int(np.floor(h)), int(np.ceil(h))
    return s[:, lo] + (s[:, hi] - s[:, lo]) * (h - lo)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def normalize(S: np.ndarray, U: np.ndarray, P: Precision, dev):
    """Size normalization to the mean cell size, and log2(x + 1) of S."""
    out = {}
    for name, M in (("S", S), ("U", U)):
        M = f64(M, dev)
        size = M.sum(0)
        sz = P("normalize", (size.mean() / size)[None, :] * M)
        out[name + "_sz"] = sz
    out["S_norm"] = P("normalize", torch.log2(out["S_sz"] + 1.0))
    return out


def pca(S_norm: torch.Tensor, n_comp: int, P: Precision):
    """PCA of the cells (rows of S_norm.T), components signed so that each
    one's largest loading is positive. Returns pcs (N, n_comp) and the
    explained variances (n_comp,)."""
    X = S_norm.T
    n = X.shape[0]
    Xc = X - X.mean(0, keepdim=True)
    Xg = P("pca_gram", Xc)
    C = Xg.T @ Xg
    evals, evecs = torch.linalg.eigh(C)
    order = torch.argsort(evals, descending=True)[:n_comp]
    evals, V = evals[order], evecs[:, order]
    top = V.abs().argmax(0)
    sign = torch.sign(V[top, torch.arange(V.shape[1], device=V.device)])
    V = V * torch.where(sign == 0, 1.0, sign)[None, :]
    return Xc @ V, torch.clamp_min(evals, 0.0) / (n - 1)


def knn_sorted(x: torch.Tensor, q: torch.Tensor, k: int, P: Precision,
               stage: str):
    """The k nearest rows of x to each row of q, in (distance, index)
    order: candidates from the expanded form, then exact diff-form
    squared distances. Returns (d2 (M, k), idx (M, k))."""
    n = x.shape[0]
    k2 = min(n, k + 64)
    sq = (x * x).sum(1)
    d2_out = torch.empty((q.shape[0], k), dtype=F64, device=x.device)
    idx_out = torch.empty((q.shape[0], k), dtype=torch.int64, device=x.device)
    for r0 in range(0, q.shape[0], _BLOCK):
        rows = q[r0:r0 + _BLOCK]
        approx = sq[None, :] - 2.0 * rows @ x.T
        cand = torch.topk(approx, k2, dim=1, largest=False).indices
        cand = torch.sort(cand, dim=1).values
        diff = x[cand] - rows[:, None, :]
        d2 = P(stage, (diff * diff).sum(-1))
        order = torch.argsort(d2, dim=1, stable=True)[:, :k]
        d2_out[r0:r0 + _BLOCK] = d2.gather(1, order)
        idx_out[r0:r0 + _BLOCK] = cand.gather(1, order)
    return d2_out, idx_out


def balance(dsi: np.ndarray, dist: np.ndarray, k: int, maxl: int):
    """Greedy in-degree-capped kNN (velocyto's BalancedKNN): nodes visited
    by descending in-degree of the candidate graph (stable ties, larger
    index first); each takes its first k candidates that are not itself
    and whose in-degree is below maxl; a short sight is filled with the
    node itself. Returns (idx (N, k+1), dist (N, k+1)); slot 0 holds the
    node when it was among the candidates read."""
    n, sight = dsi.shape
    indeg = np.bincount(dsi.ravel(), minlength=n)
    order = np.argsort(indeg, kind="mergesort")[::-1]
    l = np.zeros(n, np.int64)
    out = np.full((n, k + 1), -1, np.int64)
    dout = np.zeros((n, k + 1), np.float64)
    for node in order:
        row = dsi[node]
        ok = np.flatnonzero((row != node) & (l[row] < maxl))[:k]
        read = ok[-1] + 1 if len(ok) == k and k else sight
        if np.any(row[:read] == node):
            out[node, 0] = node
        take = row[ok]
        out[node, 1:len(ok) + 1] = take
        dout[node, 1:len(ok) + 1] = dist[node, ok]
        l[take] += 1
        if len(ok) < k:
            out[node, len(ok) + 1:] = node
            dout[node, len(ok) + 1:] = dist[node, 0]
    return out, dout


def smooth_cells(M: torch.Tensor, idx: np.ndarray, dist: np.ndarray,
                 cells: np.ndarray, P: Precision):
    """The kNN-smoothed columns `cells` of M (G, N): the mean of the cell
    and its neighbours at a distance above 0."""
    dev = M.device
    cols = []
    for c in cells:
        nb = idx[c, dist[c] > 0]
        members = torch.as_tensor(np.concatenate([[c], nb]), device=dev)
        cols.append(P("smoothing", M[:, members]).mean(1))
    return P("smoothing", torch.stack(cols, 1))


def fit_gammas(Sx: torch.Tensor, Ux: torch.Tensor, P: Precision):
    """Per-gene weighted fit Ux ~ gamma * Sx + q (velocyto's fit_gammas
    defaults: maxmin_diag weights (the 2nd and 98th percentiles of
    Sx / p99.9(Sx) + Ux / p99.9(Ux)), offset, gamma in [1e-8, 20], q in
    [0, 2 * weighted mean of Ux]), solved exactly (convex quadratic:
    the interior optimum if feasible, else the best edge optimum)."""
    Sx, Ux = P("gamma_fit", Sx), P("gamma_fit", Ux)

    def denom(M):
        d = _percentile_rows(M, 99.9)
        return torch.where(d == 0, torch.clamp_min(M.max(1).values, 0.001), d)

    X = Sx / denom(Sx)[:, None] + Ux / denom(Ux)[:, None]
    down, up = _percentile_rows(X, 2.0), _percentile_rows(X, 98.0)
    W = ((X <= down[:, None]) | (X >= up[:, None])).to(F64)
    x, y = Sx, Ux
    sw, swx, swy = W.sum(1), (W * x).sum(1), (W * y).sum(1)
    swxx, swxy, swyy = (W * x * x).sum(1), (W * x * y).sum(1), \
        (W * y * y).sum(1)
    mlo = torch.full_like(sw, 1e-8)
    mhi = torch.full_like(sw, 20.0)
    qhi = 2.0 * swy / sw

    def loss(m, q):
        return (m * m * swxx[:, None] + q * q * sw[:, None]
                + 2 * m * q * swx[:, None] - 2 * m * swxy[:, None]
                - 2 * q * swy[:, None] + swyy[:, None])

    det = swxx * sw - swx * swx
    m_in = (swxy * sw - swx * swy) / det
    q_in = (swy * swxx - swx * swxy) / det
    inside = (det > 0) & (m_in >= mlo) & (m_in <= mhi) & (q_in >= 0) & \
        (q_in <= qhi)
    zero = torch.zeros_like(sw)

    def q_of(m):
        return torch.minimum(torch.clamp_min((swy - m * swx) / sw, 0.0), qhi)

    def m_of(q):
        return torch.minimum(torch.maximum((swxy - q * swx) / swxx, mlo), mhi)

    cm = torch.stack([mlo, mhi, m_of(zero), m_of(qhi)], 1)
    cq = torch.stack([q_of(mlo), q_of(mhi), zero, qhi], 1)
    best = loss(cm, cq).argmin(1, keepdim=True)
    m = torch.where(inside, m_in, cm.gather(1, best)[:, 0])
    q = torch.where(inside, q_in, cq.gather(1, best)[:, 0])
    any_x, any_y = (Sx != 0).any(1), (Ux != 0).any(1)
    m = torch.where(~any_x, torch.nan, torch.where(~any_y, 0.0, m))
    q = torch.where(~any_x, 0.0, torch.where(~any_y, 0.0, q))
    m = torch.where(torch.isfinite(m), m, 0.0)
    return P("gamma_fit", m), P("gamma_fit", q)


def permutation_plan(g: int, n: int, seed: int):
    """velocyto's permute_rows_nsign control as a plan: numpy's global
    stream seeded with `seed` shuffles each gene's row and draws a sign
    per entry. Returns (perm (g, n), sign (g, n))."""
    rs = np.random.RandomState(seed)
    perm = np.empty((g, n), np.int64)
    sign = np.empty((g, n), np.int8)
    plmi = np.array([+1, -1])
    for i in range(g):
        p = np.arange(n)
        rs.shuffle(p)
        perm[i] = p
        sign[i] = rs.choice(plmi, size=n)
    return perm, sign


def replay(n_rows: int, pop: int, size: int, seed: int,
           probs=(0.5, 0.1)) -> np.ndarray:
    """velocyto's neighbour sampling: after np.random.seed(seed), one
    np.random.choice(pop, size, replace=False, p) per cell, with p falling
    linearly from probs[0] to probs[1]."""
    p = np.linspace(probs[0], probs[1], pop)
    p = p / p.sum()
    rs = np.random.RandomState(seed)
    return np.stack([rs.choice(pop, size=size, replace=False, p=p)
                     for _ in range(n_rows)])


def replay_digest(ixs: np.ndarray) -> str:
    """SHA-256 of sampled neighbour positions, as little-endian int32."""
    return hashlib.sha256(np.ascontiguousarray(
        ixs, dtype="<i4").tobytes()).hexdigest()


def _sqrt_tf(x: torch.Tensor, psc: float, zero_below: bool) -> torch.Tensor:
    t = torch.sign(x) * torch.sqrt(x.abs() + psc)
    return torch.where(x.abs() < 1e-16, 0.0, t) if zero_below else t


def corr_rows(hi: torch.Tensor, d: torch.Tensor, cells: np.ndarray,
              nbrs, psc: float, P: Precision, sampled: bool):
    """velocyto's colDeltaCor (sqrt transform) of each cell c in `cells`
    against the cells nbrs[i]: the Pearson correlation over genes between
    sign(x) sqrt(|x| + psc) of x = hi[:, j] - hi[:, c] and d[:, c]. NaN
    reads 1, as velocyto sets it."""
    out = []
    for i, c in enumerate(cells):
        nb = torch.as_tensor(np.asarray(nbrs[i]), device=hi.device)
        t = P("correlation", _sqrt_tf(hi[:, nb] - hi[:, c:c + 1], psc,
                                      sampled))
        dc = P("correlation", d[:, c])
        t = t - t.mean(0, keepdim=True)
        dc = dc - dc.mean()
        r = (t * dc[:, None]).sum(0) / torch.sqrt(
            (t * t).sum(0) * (dc * dc).sum())
        out.append(torch.where(torch.isnan(r), 1.0, r))
    return out


def unit_shift(emb: torch.Tensor, c: int, nb: torch.Tensor,
               tp: torch.Tensor, P: Precision) -> torch.Tensor:
    """sum_j tp_j unit(e_j - e_c) - mean_j unit(e_j - e_c) over the
    neighbour list nb (the kNN mask of the embedding)."""
    diff = emb[nb] - emb[c][None, :]
    nrm = torch.sqrt((diff * diff).sum(1, keepdim=True))
    unit = P("embedding_shift", torch.where(nrm > 0, diff / nrm, 0.0))
    return P("embedding_shift", (P("embedding_shift", tp)[:, None] * unit)
             .sum(0) - unit.mean(0))


def grid_flow(emb: torch.Tensor, shifts, steps, smooth: float,
              n_neighbors: int, P: Precision):
    """velocyto's calculate_grid_arrows: a grid over the embedding, each
    axis padded by 2.5% of its span (the upper pad from the padded span);
    each grid point averages the shift of its nearest cells under a
    Gaussian of sd smooth * mean grid spacing, divided by max(1, mass)."""
    axes = []
    e = host(emb)
    for d in range(e.shape[1]):
        lo, hi = float(e[:, d].min()), float(e[:, d].max())
        lo -= 0.025 * abs(hi - lo)
        hi += 0.025 * abs(hi - lo)
        axes.append(np.linspace(lo, hi, steps[d]))
    grid = np.stack([a.ravel() for a in np.meshgrid(*axes)], axis=1)
    g = f64(grid, emb.device)
    d2, idx = knn_sorted(emb, g, min(n_neighbors, emb.shape[0]), P, "grid")
    dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    sd = smooth * float(np.mean([a[1] - a[0] for a in axes]))
    w = P("grid", torch.exp(-0.5 * (dist / sd) ** 2) /
          (sd * np.sqrt(2.0 * np.pi)))
    denom = torch.clamp_min(w.sum(1), 1.0)[:, None]
    flows = [P("grid", (w[:, :, None] * s[idx]).sum(1) / denom)
             for s in shifts]
    return grid, flows


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

class State:
    """What the reference's stages share: the raw counts S, U (genes,
    cells), the device, the precision, the cells whose columns and rows
    are recomputed, and `ctx`, the device tensors one stage leaves for
    the next."""

    def __init__(self, S, U, dev, P: Precision, cells: np.ndarray):
        self.S, self.U, self.dev, self.P, self.cells = S, U, dev, P, cells
        self.ctx = {}


def run(S, U, got: dict, seq: list, cfg: dict, cells: np.ndarray, dev,
        prec: str = "reference") -> dict:
    """Every compared stage's reference output, in float64 on `dev`.

    S, U: the benchmark's raw (genes, cells) counts; got: the program's
    outputs (pipeline.outputs), which later stages take as input where
    their file says so; seq: the compared stages (pipeline.compared)."""
    r = State(S, U, dev, Precision(cfg["precision"], prec == "control"),
              cells)
    ref = {}
    for s in seq:
        ref.update(s.mod.recompute(r, s.p, got))
    return ref
