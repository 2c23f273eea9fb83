"""Hand-written CUDA kernels of the port, built with nvcc and bound by ctypes.

Each kernel's source lives beside this module.  It is compiled on first
use (never at import, so the package imports on machines without CUDA)
into ``_build/`` as a shared library with a plain C interface, named by
the hash of its source so an edited source is rebuilt, and loaded with
ctypes.  Wrappers take CUDA tensors only and raise on anything else; the
plain PyTorch version of each kernel lives in the ops module that calls
it (``ops/coldeltacor.py::_col_delta_cor_dense_plain``) and serves CPU
tensors there.

``dense_launches`` counts the launches of the dense colDeltaCor kernel, so
a run can show that its main path went through it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
_BUILD = _HERE / "_build"
DENSE_SOURCE = _HERE / "coldeltacor_dense.cu"

dense_launches = 0      # launches of the dense colDeltaCor kernel
build_log = ""          # nvcc's output (-Xptxas -v) from the last build

_lib = None
_TILE = 64              # cells per block side, kTile in the source


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile the kernels' source for sm_90a unless a library built from
    the same source exists; returns the library's path.  Raises on any
    compiler error."""
    global build_log
    src = DENSE_SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    lib = _BUILD / f"libvtt_kernels_{tag}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), str(DENSE_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)     # atomic: a concurrent build never loads half
    build_log = proc.stdout + proc.stderr
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.vtt_coldeltacor_dense
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_pair(emat: torch.Tensor, dmat: torch.Tensor) -> None:
    for name, t in (("emat", emat), ("dmat", dmat)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D (genes, cells)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if emat.shape != dmat.shape:
        raise ValueError(f"shape mismatch {tuple(emat.shape)} vs "
                         f"{tuple(dmat.shape)}")
    if emat.device != dmat.device:
        raise ValueError("emat and dmat must be on the same device")
    g, n = emat.shape
    if g < 1 or n < 1 or n > 65535 * _TILE:      # gridDim.y <= 65535
        raise ValueError(f"unsupported shape {tuple(emat.shape)}")


def coldeltacor_dense(emat: torch.Tensor, dmat: torch.Tensor,
                      transform: int, psc: float,
                      partial_semantics: bool = False) -> torch.Tensor:
    """Dense colDeltaCor on the card: (G, N) f32 CUDA tensors -> (N, N).

    transform: 0 linear, 1 sqrt, 2 log10 (ops.coldeltacor._TRANSFORMS).
    Launches on the current stream and does not synchronise."""
    global dense_launches
    _check_pair(emat, dmat)
    if transform not in (0, 1, 2):
        raise ValueError(f"unknown transform code {transform}")
    lib = _load()
    g, n = emat.shape
    out = torch.empty((n, n), dtype=torch.float32, device=emat.device)
    with torch.cuda.device(emat.device):
        stream = torch.cuda.current_stream(emat.device).cuda_stream
        rc = lib.vtt_coldeltacor_dense(
            emat.data_ptr(), dmat.data_ptr(), out.data_ptr(), g, n,
            transform, int(bool(partial_semantics)), float(psc), stream)
    if rc != 0:
        raise RuntimeError(f"coldeltacor_dense launch failed: cudaError {rc}")
    dense_launches += 1
    return out
