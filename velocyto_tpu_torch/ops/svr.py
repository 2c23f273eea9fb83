"""Epsilon-SVR with the RBF kernel, following libsvm's SMO solver step by step.

The JAX package fits its two noise models with sklearn's ``SVR``
(velocyto_tpu/analysis.py:331, the CV-vs-mean fit of ``score_cv_vs_mean``,
and :650, the totals fit of ``adjust_totS_totU``), which runs libsvm's
``Solver`` (svm.cpp in libsvm 3.x as sklearn vendors it).  This module
repeats that solver on one feature, with sklearn's defaults (C=1;
epsilon=0.1, tol=1e-3, shrinking on and no iteration cap, which no
caller changes, are fixed) and its fitted attributes (``support_``, ``support_vectors_``, ``dual_coef_``,
``intercept_``, ``n_iter_``).  It follows libsvm's working-set sequence,
not only its optimum: two solvers that each stop at tol=1e-3 can predict
~1e-3 apart, and the CV-vs-mean score feeds a top-N cut.  What it keeps
of libsvm's arithmetic:

  - the 2l variables of SVR_Q: position k < l is sample k with sign +1,
    k >= l is sample k - l with sign -1, p = epsilon -/+ y;
  - kernel columns rounded to float32 (libsvm's Qfloat), each entry
    exp(-gamma * ((x_i^2 + x_j^2) - 2 x_i x_j)) in float64, not from the
    difference; the diagonal QD is exactly 1;
  - the gradient G and G_bar in float64, updated in libsvm's order;
  - working-set selection with the second-order j and TAU = 1e-12, the
    ties going to the last index in active order (libsvm's ``>=`` and
    ``<=``);
  - shrinking every min(2l, 1000) iterations with libsvm's in-place swap
    order, the unshrink at 10 * tol and the gradient reconstruction;
  - rho as the mean of y*G over the free variables (a sequential sum),
    else the midpoint of the bounds.

``predict`` evaluates sum_s dual_coef_s exp(-gamma (x - sv_s)^2) - rho in
float64, as libsvm's ``k_function`` does (from the difference).

``smo_solve`` launches the hand CUDA kernel (kernels/svr_smo.cu, the whole
loop in one launch of one thread-block cluster, holding the state in its
shared memory where it fits, else in global memory: ``kernels.svr_route``) for
CUDA tensors and runs ``_smo_plain`` below, the
same loop as float64 torch ops, for CPU tensors.  The two and libsvm agree
to the bit wherever float64 ``exp`` rounds alike; they may part where two
``exp`` implementations round one kernel entry to different float32s.

libsvm is Copyright (c) 2000-2019 Chih-Chung Chang and Chih-Jen Lin, under
the BSD 3-clause licence; this module repeats its algorithm, not its code.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels

_F32, _F64 = torch.float32, torch.float64
EPSILON, TOL = 0.1, 1e-3            # sklearn's SVR defaults
_LOWER, _UPPER, _FREE = 0, 1, 2
_TAU = 1e-12
_INF = float("inf")


def _as_f64(data, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(_F64)
    return torch.as_tensor(np.asarray(data), dtype=_F64, device=device)


def _one_feature(X, device) -> torch.Tensor:
    """(n,) float64 samples from X of shape (n,) or (n, 1)."""
    x = _as_f64(X, device)
    if x.dim() == 2 and x.shape[1] == 1:
        x = x[:, 0]
    if x.dim() != 1:
        raise ValueError(f"one feature is supported, got X of shape "
                         f"{tuple(x.shape)}")
    return x.contiguous()


# ---------------------------------------------------------------------------
# the plain solver (float64 torch ops, libsvm's loop)
# ---------------------------------------------------------------------------

class _Plain:
    """libsvm's Solver state over the 2l SVR variables, in active order.

    Per position: the sample value x, the sign (+1 for k < l), the linear
    term p, alpha, G, G_bar, the status and the original position
    (active_set); the box bound C is the same for all."""

    def __init__(self, x: torch.Tensor, target: torch.Tensor, C: float,
                 gamma: float):
        l = x.numel()
        dev = x.device
        self.L = 2 * l
        self.C, self.gamma, self.eps = float(C), float(gamma), TOL
        pos = torch.arange(self.L, device=dev) < l
        self.s = {
            "x": torch.cat([x, x]),
            "pos": pos,
            "sgn": torch.where(pos, 1.0, -1.0).to(_F32),
            "p": torch.cat([EPSILON - target, EPSILON + target]),
            "alpha": torch.zeros(self.L, dtype=_F64, device=dev),
            "G": torch.cat([EPSILON - target, EPSILON + target]),
            "Gbar": torch.zeros(self.L, dtype=_F64, device=dev),
            "st": torch.full((self.L,), _LOWER, dtype=torch.int8, device=dev),
            "aset": torch.arange(self.L, device=dev),
        }
        self.active = self.L
        self.unshrink = False

    # -- libsvm pieces ---------------------------------------------------

    def col(self, c: int, lo: int, hi: int) -> torch.Tensor:
        """Column c of Q over positions [lo, hi), float32 (SVR_Q::get_Q)."""
        s = self.s
        xc, xk = s["x"][c], s["x"][lo:hi]
        k = torch.exp(((xc * xc + xk * xk) - 2.0 * (xc * xk))
                      * (-self.gamma)).to(_F32)
        return (s["sgn"][c] * s["sgn"][lo:hi]) * k

    def _masks(self, n: int):
        s = self.s
        pos, st, G = s["pos"][:n], s["st"][:n], s["G"][:n]
        up = torch.where(pos, st != _UPPER, st != _LOWER)     # I_up
        low = torch.where(pos, st != _LOWER, st != _UPPER)    # I_low
        return pos, st, G, up, low

    def select_working_set(self) -> Optional[Tuple[int, int, torch.Tensor]]:
        """(i, j, Q_i over the active set), or None when optimal."""
        n = self.active
        pos, _st, G, up, low = self._masks(n)
        v1 = torch.where(pos, -G, G)
        if not bool(up.any()):
            return None                  # Gmax = -inf: no j can qualify
        gmax = float(v1[up].max())
        i = int(torch.nonzero(up & (v1 == gmax))[-1])
        qi = self.col(i, 0, n)
        yi = 1.0 if bool(pos[i]) else -1.0
        v2 = torch.where(pos, G, -G)
        gmax2 = float(v2[low].max()) if bool(low.any()) else -_INF
        grad_diff = torch.where(pos, gmax + G, gmax - G)
        q64 = qi.to(_F64)
        quad = torch.where(pos, 2.0 - (2.0 * yi) * q64, 2.0 + (2.0 * yi) * q64)
        quad = torch.where(quad > 0, quad, _TAU)
        obj = -(grad_diff * grad_diff) / quad
        cand = low & (grad_diff > 0)
        if gmax + gmax2 < self.eps or not bool(cand.any()):
            return None
        obj_min = float(obj[cand].min())
        j = int(torch.nonzero(cand & (obj == obj_min))[-1])
        return i, j, qi

    def reconstruct_gradient(self) -> None:
        n, L, s = self.active, self.L, self.s
        if n == L:
            return
        s["G"][n:] = s["Gbar"][n:] + s["p"][n:]
        free = torch.nonzero(s["st"][:n] == _FREE).flatten().tolist()
        for f in free:                   # in active order, as libsvm sums
            s["G"][n:] += float(s["alpha"][f]) * self.col(f, n, L).to(_F64)

    def _shrunk(self, gmax1: float, gmax2: float, n: int) -> torch.Tensor:
        pos, st, G, _up, _low = self._masks(n)
        upper = (st == _UPPER) & torch.where(pos, -G > gmax1, -G > gmax2)
        lower = (st == _LOWER) & torch.where(pos, G > gmax2, G > gmax1)
        return upper | lower

    def do_shrinking(self) -> None:
        n = self.active
        pos, _st, G, up, low = self._masks(n)
        v1, v2 = torch.where(pos, -G, G), torch.where(pos, G, -G)
        gmax1 = float(v1[up].max()) if bool(up.any()) else -_INF
        gmax2 = float(v2[low].max()) if bool(low.any()) else -_INF
        if not self.unshrink and gmax1 + gmax2 <= self.eps * 10:
            self.unshrink = True
            self.reconstruct_gradient()
            self.active = n = self.L
        shrunk = self._shrunk(gmax1, gmax2, n)
        # libsvm's loop swaps the k-th shrinkable position from the left
        # with the k-th kept one from the right while the first lies left
        # of the second; the kept ones end up in [0, n_kept)
        left = torch.nonzero(shrunk).flatten()
        right = torch.nonzero(~shrunk).flatten().flip(0)
        m = min(left.numel(), right.numel())
        left, right = left[:m], right[:m]
        pairs = left < right
        left, right = left[pairs], right[pairs]
        if left.numel():
            perm = torch.arange(n, device=left.device)
            perm[left], perm[right] = right, left
            for name, t in self.s.items():
                t[:n] = t[:n][perm]
        self.active = int((~shrunk).sum())

    def calculate_rho(self) -> float:
        n = self.active
        pos, st, G, _up, _low = self._masks(n)
        yG = torch.where(pos, G, -G)
        to_ub = ((st == _UPPER) & ~pos) | ((st == _LOWER) & pos)
        to_lb = ((st == _UPPER) & pos) | ((st == _LOWER) & ~pos)
        free = st == _FREE
        if bool(free.any()):
            # libsvm's sequential sum, in active order
            vals = yG[free].cpu().numpy()
            return float(np.add.accumulate(vals)[-1]) / vals.size
        ub = float(yG[to_ub].min()) if bool(to_ub.any()) else _INF
        lb = float(yG[to_lb].max()) if bool(to_lb.any()) else -_INF
        return (ub + lb) / 2

    def update(self, i: int, j: int, qi: torch.Tensor) -> None:
        """Solver::Solve's two-variable step and the G / G_bar updates."""
        s, n, C = self.s, self.active, self.C
        qj = self.col(j, 0, n)
        q_ij = float(qi[j])
        Gi, Gj = float(s["G"][i]), float(s["G"][j])
        ai0, aj0 = float(s["alpha"][i]), float(s["alpha"][j])
        ai, aj = ai0, aj0
        if bool(s["pos"][i]) != bool(s["pos"][j]):
            quad = (1.0 + 1.0) + 2 * q_ij
            if quad <= 0:
                quad = _TAU
            delta = (-Gi - Gj) / quad
            diff = ai - aj
            ai += delta
            aj += delta
            if diff > 0:
                if aj < 0:
                    aj, ai = 0.0, diff
            elif ai < 0:
                ai, aj = 0.0, -diff
            if diff > C - C:
                if ai > C:
                    ai, aj = C, C - diff
            elif aj > C:
                aj, ai = C, C + diff
        else:
            quad = (1.0 + 1.0) - 2 * q_ij
            if quad <= 0:
                quad = _TAU
            delta = (Gi - Gj) / quad
            total = ai + aj
            ai -= delta
            aj += delta
            if total > C:
                if ai > C:
                    ai, aj = C, total - C
            elif aj < 0:
                aj, ai = 0.0, total
            if total > C:
                if aj > C:
                    aj, ai = C, total - C
            elif ai < 0:
                ai, aj = 0.0, total
        s["alpha"][i], s["alpha"][j] = ai, aj
        dai, daj = ai - ai0, aj - aj0
        s["G"][:n] += qi.to(_F64) * dai + qj.to(_F64) * daj
        for c, a in ((i, ai), (j, aj)):
            was_upper = int(s["st"][c]) == _UPPER
            st = _UPPER if a >= C else (_LOWER if a <= 0 else _FREE)
            s["st"][c] = st
            if was_upper != (st == _UPPER):
                col = self.col(c, 0, self.L).to(_F64)
                if was_upper:
                    s["Gbar"] -= C * col
                else:
                    s["Gbar"] += C * col

    def solve(self) -> int:
        it = 0
        counter = min(self.L, 1000) + 1
        while True:
            counter -= 1
            if counter == 0:
                counter = min(self.L, 1000)
                self.do_shrinking()
            ws = self.select_working_set()
            if ws is None:
                self.reconstruct_gradient()
                self.active = self.L
                ws = self.select_working_set()
                if ws is None:
                    break
                counter = 1
            it += 1
            self.update(*ws)
        return it


def _smo_plain(x: torch.Tensor, target: torch.Tensor, C: float,
               gamma: float) -> Tuple[torch.Tensor, float, int]:
    """libsvm's epsilon-SVR solve as float64 torch ops on x's device:
    returns (alpha (2l,) in original order, rho, iterations)."""
    solver = _Plain(x, target, C, gamma)
    it = solver.solve()
    rho = solver.calculate_rho()
    alpha = torch.empty_like(solver.s["alpha"])
    alpha[solver.s["aset"]] = solver.s["alpha"]
    return alpha, rho, it


def smo_solve(x: torch.Tensor, target: torch.Tensor, C: float = 1.0,
              gamma: float = 1.0) -> Tuple[torch.Tensor, float, int]:
    """libsvm's epsilon-SVR dual solve on (l,) float64 samples and targets:
    returns (alpha (2l,) float64 in original order, rho, iterations).  A
    CUDA tensor runs the hand kernel (one launch for the whole loop), a
    CPU tensor the plain version."""
    if x.shape != target.shape or x.dim() != 1 or x.numel() < 1:
        raise ValueError(f"x and target must be one (l,) shape, got "
                         f"{tuple(x.shape)} and {tuple(target.shape)}")
    if x.is_cuda:
        alpha, rho, stats = kernels.svr_smo(
            x.contiguous(), target.contiguous(), C, EPSILON, gamma, TOL)
        return alpha, float(rho), int(stats[0])
    return _smo_plain(x, target, C, gamma)


class SVR:
    """Epsilon-SVR, RBF kernel, one feature: sklearn.svm.SVR's fit /
    predict surface on a torch device (the card unless the caller asks
    for another; a tensor stays on its own device)."""

    def __init__(self, C: float = 1.0, gamma: float = 1.0,
                 device="cuda") -> None:
        self.C, self.gamma = float(C), float(gamma)
        self.device = torch.device(device)

    def fit(self, X, y) -> "SVR":
        x = _one_feature(X, self.device)
        t = _as_f64(y, x.device).reshape(-1).contiguous()
        alpha2, rho, it = smo_solve(x, t, self.C, self.gamma)
        l = x.numel()
        coef = alpha2[:l] - alpha2[l:]
        sv = torch.nonzero(coef.abs() > 0).flatten()
        self._set_model(x[sv], coef[sv], -rho if rho != 0 else 0.0)
        self.support_ = sv.cpu().numpy().astype(np.int32)
        self.n_iter_ = it
        return self

    @classmethod
    def from_numpy(cls, support_vectors, dual_coef, intercept, gamma,
                   device="cuda") -> "SVR":
        """A fitted model from another fit's parameters (sklearn's
        ``support_vectors_``, ``dual_coef_``, ``intercept_``, ``_gamma``)."""
        m = cls(gamma=gamma, device=device)
        icpt = float(np.ravel(np.asarray(intercept))[0])
        m._set_model(_one_feature(support_vectors, m.device),
                     _as_f64(np.ravel(np.asarray(dual_coef)), m.device),
                     icpt)
        return m

    def _set_model(self, sv: torch.Tensor, coef: torch.Tensor,
                   intercept: float) -> None:
        self._sv, self._coef = sv, coef
        self.support_vectors_ = sv.cpu().numpy()[:, None]
        self.dual_coef_ = coef.cpu().numpy()[None, :]
        self.intercept_ = np.array([intercept])

    def predict(self, X) -> torch.Tensor:
        """(n,) float64 predictions on the model's device, in row blocks
        that keep the (block, n_sv) kernel slab near 256 MB."""
        x = _one_feature(X, self._sv.device)
        rho = -float(self.intercept_[0])
        out = torch.empty_like(x)
        block = max(1, (1 << 25) // max(1, self._sv.numel()))
        for r0 in range(0, x.numel(), block):
            d = x[r0:r0 + block, None] - self._sv[None, :]
            k = torch.exp((d * d) * (-self.gamma))
            out[r0:r0 + block] = (k * self._coef).sum(dim=1) - rho
        return out
