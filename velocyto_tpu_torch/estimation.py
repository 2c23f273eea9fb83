"""Reference-parity estimation API.

Port of velocyto_tpu/estimation.py: the reference function names
(velocyto/estimation.py:11-170 for colDeltaCor*, :173-389 for fit_slope*)
over the port's colDeltaCor ops.  Each shim takes numpy arrays, computes
on ``device`` (default "cuda": the hand CUDA kernels there, their plain
PyTorch versions for "cpu") and returns numpy arrays.  ``threads`` is
accepted for signature compatibility and ignored.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.coldeltacor import col_delta_cor, col_delta_cor_partial
from .ops.gamma import (fit_slope, fit_slope_offset, fit_slope_weighted,  # noqa: F401
                        fit_slope_weighted_offset, clusters_stats)


def _dense(emat, dmat, transform: str, psc: float, device) -> np.ndarray:
    e, d = (torch.as_tensor(np.asarray(m), dtype=torch.float32,
                            device=device) for m in (emat, dmat))
    return col_delta_cor(e, d, transform, psc).cpu().numpy()


def _partial(emat, dmat, ixs, transform: str, psc: float,
             device) -> np.ndarray:
    e, d = (torch.as_tensor(np.asarray(m), dtype=torch.float32,
                            device=device) for m in (emat, dmat))
    ix = torch.as_tensor(np.asarray(ixs), dtype=torch.int64, device=device)
    return col_delta_cor_partial(e, d, ix, transform, psc).cpu().numpy()


def colDeltaCor(emat: np.ndarray, dmat: np.ndarray,
                threads: Optional[int] = None, device="cuda") -> np.ndarray:
    return _dense(emat, dmat, "linear", 0.0, device)


def colDeltaCorSqrt(emat: np.ndarray, dmat: np.ndarray,
                    threads: Optional[int] = None,
                    psc: float = 0.0, device="cuda") -> np.ndarray:
    return _dense(emat, dmat, "sqrt", psc, device)


def colDeltaCorLog10(emat: np.ndarray, dmat: np.ndarray,
                     threads: Optional[int] = None,
                     psc: float = 1.0, device="cuda") -> np.ndarray:
    return _dense(emat, dmat, "log10", psc, device)


def colDeltaCorpartial(emat: np.ndarray, dmat: np.ndarray, ixs: np.ndarray,
                       threads: Optional[int] = None,
                       device="cuda") -> np.ndarray:
    return _partial(emat, dmat, ixs, "linear", 0.0, device)


def colDeltaCorSqrtpartial(emat: np.ndarray, dmat: np.ndarray,
                           ixs: np.ndarray, threads: Optional[int] = None,
                           psc: float = 0.0, device="cuda") -> np.ndarray:
    return _partial(emat, dmat, ixs, "sqrt", psc, device)


def colDeltaCorLog10partial(emat: np.ndarray, dmat: np.ndarray,
                            ixs: np.ndarray, threads: Optional[int] = None,
                            psc: float = 1.0, device="cuda") -> np.ndarray:
    return _partial(emat, dmat, ixs, "log10", psc, device)
