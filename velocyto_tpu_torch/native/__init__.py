"""Host C++ helpers of the port, bound by ctypes.

``sampler.cpp`` replays numpy's MT19937 stream for the per-cell neighbour
sampling of ``estimate_transition_prob(knn_random=True)``.  It is
compiled on first use (never at import) with the host C++ compiler into
``_build/``, named by the hash of its source, so an edited source is
rebuilt.  ``choice_rows_plain`` is the numpy loop it replaces: the tests
and ``chip_smoke.py`` hold the two to bit equality.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_BUILD = _HERE / "_build"
SOURCE = _HERE / "sampler.cpp"

_lib = None


def build() -> Path:
    """Compile sampler.cpp unless a library built from the same source
    exists; returns the library's path.  Raises on any compiler error."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = _BUILD / f"libvtt_sampler_{tag}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++) on PATH")
    _BUILD.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    # no -march=native (the library must run on any host of the arch) and
    # no FMA contraction (the cdf sums must round as numpy's do)
    cmd = [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"c++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)     # atomic: a concurrent build never loads half
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.vtt_choice_noreplace_rows
        fn.argtypes = [ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int64
        _lib = lib
    return _lib


def choice_noreplace_rows(seed: int, n_rows: int, pop: int, size: int,
                          p: np.ndarray) -> Tuple[np.ndarray, int, tuple]:
    """``np.random.seed(seed)`` then, per row,
    ``np.random.choice(pop, size, replace=False, p=p)``, replayed in C++.

    Returns (positions (n_rows, size) int64, doubles drawn, numpy's final
    state as an ``np.random.set_state`` tuple).  numpy's own global
    stream is not touched.  Releases the GIL while it samples."""
    lib = _load()
    p = np.ascontiguousarray(p, dtype=np.float64)
    if p.shape != (pop,):
        raise ValueError(f"p has shape {p.shape}, expected ({pop},)")
    out = np.empty((n_rows, size), np.int64)
    state = np.empty(625, np.uint32)
    draws = lib.vtt_choice_noreplace_rows(
        seed & 0xFFFFFFFF, n_rows, pop, size, p.ctypes.data,
        out.ctypes.data, state.ctypes.data)
    if draws < 0:
        raise ValueError("Fewer non-zero entries in p than size")
    return out, int(draws), ("MT19937", state[:624].copy(), int(state[624]),
                             0, 0.0)


def choice_rows_plain(seed: int, n_rows: int, pop: int, size: int,
                      p: np.ndarray) -> Tuple[np.ndarray, tuple]:
    """The numpy loop that choice_noreplace_rows replays (the reference's
    sampling, velocyto/analysis.py:1555-1560), on numpy's global stream.
    Returns (positions, np.random.get_state() after the loop)."""
    np.random.seed(seed)
    rows = np.stack([np.random.choice(pop, size=(size,), replace=False, p=p)
                     for _ in range(n_rows)], 0)
    return rows, np.random.get_state()
