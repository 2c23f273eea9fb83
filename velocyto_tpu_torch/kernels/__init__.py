"""Hand-written CUDA kernels of the port, built with nvcc and bound by ctypes.

Each kernel's source (``*.cu``) lives beside this module.  It is compiled
on first use (never at import, so the package imports on machines without
CUDA) into ``_build/`` as a shared library with a plain C interface, one
library per source named by the hash of that source and the shared
headers (``*.cuh``), so an edit to any of them rebuilds what it touches.  The sources that need a build are compiled in
parallel, one nvcc each.  Wrappers take CUDA tensors only and raise on
anything else; the plain PyTorch version of each kernel lives in the
module that calls it and serves CPU tensors there:

  coldeltacor_dense    ops/coldeltacor.py::_col_delta_cor_dense_plain
  coldeltacor_partial  ops/coldeltacor.py::_col_delta_cor_partial_plain
  coldeltacor_flat     ops/coldeltacor.py::_col_delta_cor_flat_plain
  fma_probe            bench.py::_fma_plain
  svr_smo              ops/svr.py::_smo_plain
  tsne_grad            ops/tsne.py::_tsne_grad_plain
  knn_balance          ops/knn_device.py::_balance_scan_plain (the walk
                       and its decode, together)
  balance_decode       ops/knn_device.py::_balance_decode_plain

``dense_launches``, ``partial_launches``, ``flat_launches``,
``fma_launches``,
``svr_launches``, ``tsne_launches``, ``balance_launches`` (the balance
walk) and ``balance_decode_launches`` count each kernel's launches (a
``tsne_grad`` call, one gradient, adds two: the pair pass and the
attractive pass; a ``knn_balance`` call one walk and one decode), so a
run can show that its main path went through it; ``svr_shared_launches``
and ``svr_global_launches`` split the SVR solver's launches by where it
keeps its state (``svr_route``).
``svr_sync_probe`` and ``balance_probe`` are measurement probes beside the
SVR solver and the balance scan, not path kernels, and have no count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..utils.profiling import span

_HERE = Path(__file__).resolve().parent
_BUILD = _HERE / "_build"
SOURCES = sorted(_HERE.glob("*.cu"))
HEADERS = sorted(_HERE.glob("*.cuh"))

dense_launches = 0      # launches of the dense colDeltaCor kernel
partial_launches = 0    # launches of the sampled colDeltaCor kernel
flat_launches = 0       # launches of its flat block-table form (the ring)
fma_launches = 0        # launches of the FMA-chain probe
svr_launches = 0        # launches of the SVR solver (one per fit)
svr_shared_launches = 0     # of them, with the state in shared memory
svr_global_launches = 0     # of them, with the state in global memory
tsne_launches = 0       # launches of the t-SNE gradient (two per call)
balance_launches = 0    # launches of the kNN balance walk (one per graph)
balance_decode_launches = 0     # launches of its decode (one per graph)
build_log = ""          # nvcc's output (-Xptxas -v) from the last build

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_double
# name -> (source stem, exported C function, its argtypes)
_SIGNATURES = {
    "coldeltacor_dense": ("coldeltacor_dense", "vtt_coldeltacor_dense",
                          [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                           _P]),
    "coldeltacor_partial": ("coldeltacor_partial", "vtt_coldeltacor_partial",
                            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _F, _P]),
    "coldeltacor_flat": ("coldeltacor_partial", "vtt_coldeltacor_flat",
                         [_P] * 10 + [_I] * 7 + [_F, _P]),
    "fma_probe": ("fma_probe", "vtt_fma_probe",
                  [_P, _P, ctypes.c_int64, _P]),
    "svr_smo": ("svr_smo", "vtt_svr_smo",
                [_P] * 15 + [_I, _D, _D, _D, _D, _I, _P]),
    "svr_sync_probe": ("svr_smo", "vtt_svr_sync_probe", [_I, _P, _P]),
    "tsne_pairs": ("tsne_grad", "vtt_tsne_pairs",
                   [_P, _I, _I, _I, _P, _P, _P, _P, _P]),
    "tsne_attract": ("tsne_grad", "vtt_tsne_attract",
                     [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                      _P]),
    "knn_balance_walk": ("knn_balance", "vtt_knn_balance_walk",
                         [_P] * 7 + [_I] * 8 + [_P]),
    "knn_balance_decode": ("knn_balance", "vtt_knn_balance_decode",
                           [_P] * 6 + [_I] * 3 + [_P]),
    "knn_balance_probe": ("knn_balance", "vtt_knn_balance_probe",
                          [_P, _I, _I, _P, _I, _I, _P, _P]),
}

_lib: Optional[Dict[str, Any]] = None   # ctypes functions, on first use
_TILE_C = 64            # dense kernel: centers per block, kTC
_CHUNK = 256            # partial kernel: neighbours per block, kChunk
_MAX_SMEM = 232448      # bytes of shared memory a block may use (sm_90)
_RUN_ROWS = 128         # flat kernel: table rows of one run, at most


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Dict[str, Path]:
    """Compile every kernel source for sm_90a unless a library built from
    the same source exists; returns {source stem: library path}.  Raises
    on any compiler error."""
    global build_log
    libs, todo = {}, []
    headers = b"".join(h.read_bytes() for h in HEADERS)
    for src in SOURCES:
        tag = hashlib.sha256(src.read_bytes() + headers).hexdigest()[:16]
        libs[src.stem] = lib = _BUILD / f"libvtt_{src.stem}_{tag}.so"
        if not lib.exists():
            todo.append((src, lib))
    if not todo:
        return libs
    _BUILD.mkdir(exist_ok=True)
    procs = []
    for src, lib in todo:
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, lib, tmp, proc in procs:
        # the nvcc runs overlap: each span is the wait for its library
        # after the ones before it
        with span("build." + src.stem):
            out, _ = proc.communicate()
        logs.append(f"# nvcc {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode == 0:
            os.replace(tmp, lib)  # atomic: a concurrent build never loads half
        else:
            failed.append(src.name)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    return libs


def _fn(name: str):
    global _lib
    if _lib is None:
        paths = build()
        fns = {}
        for fname, (stem, symbol, argtypes) in _SIGNATURES.items():
            fn = getattr(ctypes.CDLL(str(paths[stem])), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[fname] = fn
        _lib = fns
    return _lib[name]


def _check(name: str, t: torch.Tensor, dtypes=(torch.float32,),
           dim: int = 2) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_same_device(**tensors: torch.Tensor) -> None:
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{', '.join(tensors)} must be on one device")


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _fn(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def coldeltacor_dense(emat: torch.Tensor, dmat: torch.Tensor,
                      transform: int, psc: float,
                      partial_semantics: bool = False,
                      dmat2: Optional[torch.Tensor] = None,
                      c0: int = 0, m: Optional[int] = None
                      ) -> Union[torch.Tensor,
                                 Tuple[torch.Tensor, torch.Tensor]]:
    """Dense colDeltaCor on the card: (G, N) f32 CUDA tensors -> (N, N).
    With dmat2 (G, N), returns the pair of outputs for dmat and dmat2 from
    one pass, each bitwise equal to a single call.  c0, m: the center
    range [c0, c0 + m) (default every center), an (m, N) output whose
    rows are bitwise the same rows of the whole launch; 0 <= c0 and
    1 <= m <= N - c0, else ValueError.

    transform: 0 linear, 1 sqrt, 2 log10 (ops.coldeltacor._TRANSFORMS).
    Launches on the current stream and does not synchronise."""
    global dense_launches
    mats = dict(emat=emat, dmat=dmat)
    if dmat2 is not None:
        mats["dmat2"] = dmat2
    for name, t in mats.items():
        _check(name, t)
        if t.shape != emat.shape:
            raise ValueError(f"shape mismatch {tuple(emat.shape)} vs "
                             f"{name} {tuple(t.shape)}")
    _check_same_device(**mats)
    g, n = emat.shape
    if g < 1 or n < 1 or n >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(emat.shape)}")
    m = n - c0 if m is None else m
    if not (isinstance(c0, int) and isinstance(m, int)) or c0 < 0 or \
            m < 1 or c0 + m > n or m > 65535 * _TILE_C:  # gridDim.y <= 65535
        raise ValueError(f"center range c0={c0}, m={m} outside the {n} "
                         f"centers")
    if transform not in (0, 1, 2):
        raise ValueError(f"unknown transform code {transform}")
    out = torch.empty((m, n), dtype=torch.float32, device=emat.device)
    out2 = torch.empty_like(out) if dmat2 is not None else None
    _launch("coldeltacor_dense", emat.device, emat.data_ptr(),
            dmat.data_ptr(), None if dmat2 is None else dmat2.data_ptr(),
            out.data_ptr(), None if out2 is None else out2.data_ptr(), g, n,
            c0, m, transform, int(bool(partial_semantics)), float(psc))
    dense_launches += 1
    return out if out2 is None else (out, out2)


def coldeltacor_partial(e_full: torch.Tensor, e_ctr: torch.Tensor,
                        d_ctr: torch.Tensor, ixs: torch.Tensor,
                        transform: int, psc: float,
                        d_ctr2: Optional[torch.Tensor] = None,
                        order: Optional[torch.Tensor] = None
                        ) -> Union[torch.Tensor,
                                   Tuple[torch.Tensor, torch.Tensor]]:
    """Sampled colDeltaCor on the card, partial semantics.

    e_full (N, G), e_ctr / d_ctr (M, G) f32 and ixs (M, nn) int32 or int64
    CUDA tensors -> (M, nn) f32.  With d_ctr2 (M, G), returns the pair of
    outputs for d_ctr and d_ctr2 from one pass over the gathered rows.
    An index outside [0, N) gives NaN; int64 indices are converted to the
    kernel's int32 (N < 2**31).  order: an optional (M,) int32 permutation
    of the centers; the blocks take the centers in that order (a locality
    order lets L2 serve the gathered rows), and the output is the same
    with any order.  It is not checked here (that would cost a sync):
    a center it leaves out keeps its output row unwritten, so callers
    pass a permutation (``ops.coldeltacor.col_delta_cor_partial_compact``
    checks one).  transform: 0 linear, 1 sqrt, 2 log10.  Launches on
    the current stream and does not synchronise."""
    global partial_launches
    rows = dict(e_full=e_full, e_ctr=e_ctr, d_ctr=d_ctr)
    if d_ctr2 is not None:
        rows["d_ctr2"] = d_ctr2
    for name, t in rows.items():
        _check(name, t)
    _check("ixs", ixs, (torch.int32, torch.int64))
    tensors = dict(ixs=ixs, **rows)
    if order is not None:
        _check("order", order, (torch.int32,), dim=1)
        tensors["order"] = order
    _check_same_device(**tensors)
    n, g = e_full.shape
    m, nn = ixs.shape
    for name in ("e_ctr", "d_ctr", "d_ctr2"):
        if name in rows and rows[name].shape != (m, g):
            raise ValueError(f"{name} must be ({m}, {g}), got "
                             f"{tuple(rows[name].shape)}")
    if order is not None and order.shape != (m,):
        raise ValueError(f"order must be ({m},), got {tuple(order.shape)}")
    n_rows = 3 if d_ctr2 is not None else 2
    if n < 1 or m < 1 or nn < 1 or n >= 2 ** 31 - 1 or \
            m * -(-nn // _CHUNK) >= 2 ** 31 or n_rows * g * 4 > _MAX_SMEM:
        raise ValueError(f"unsupported shape: N={n}, G={g}, M={m}, nn={nn}")
    if transform not in (0, 1, 2):
        raise ValueError(f"unknown transform code {transform}")
    if ixs.dtype == torch.int64:
        # out-of-range ids stay out of range (-1 or N) in int32
        ixs = ixs.clamp(-1, n).to(torch.int32)
    out = torch.empty((m, nn), dtype=torch.float32, device=e_full.device)
    out2 = torch.empty_like(out) if d_ctr2 is not None else None
    _launch("coldeltacor_partial", e_full.device, e_full.data_ptr(),
            e_ctr.data_ptr(), d_ctr.data_ptr(),
            None if d_ctr2 is None else d_ctr2.data_ptr(), ixs.data_ptr(),
            None if order is None else order.data_ptr(), out.data_ptr(),
            None if out2 is None else out2.data_ptr(), n, m, g, nn,
            transform, float(psc))
    partial_launches += 1
    return out if out2 is None else (out, out2)


def flat_runs(qrow: torch.Tensor, rank: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat kernel's schedule over a block table with center rows
    qrow (F,): run_start (S + 1,) int32, run r holding the table rows
    [run_start[r], run_start[r + 1]), and run_order (S,) int32, the runs
    in the order the kernel's blocks take them.

    A run is a maximal segment of consecutive table rows with one center,
    cut into pieces of at most _RUN_ROWS rows (the plan's dummy tail, one
    segment of center 0, spreads over blocks), so every table row lies in
    exactly one run and the kernel stages each center once a run.  rank:
    an optional (M,) rank of each center row (its place in the locality
    order, ``ops.coldeltacor.shard_rank``); the runs are then stably
    sorted by the rank of their center, else taken in table order.  Plain
    torch on qrow's device (one synchronisation, for the number of
    runs)."""
    f = qrow.shape[0]
    dev = qrow.device
    heads, counts = torch.unique_consecutive(qrow, return_counts=True)
    pieces = (counts + _RUN_ROWS - 1) // _RUN_ROWS
    seg = torch.repeat_interleave(torch.arange(heads.shape[0], device=dev),
                                  pieces)
    first = torch.cumsum(pieces, 0) - pieces        # each segment's first run
    begin = torch.cumsum(counts, 0) - counts        # its first table row
    start = begin[seg] + (torch.arange(seg.shape[0], device=dev)
                          - first[seg]) * _RUN_ROWS
    run_start = torch.cat([start, start.new_full((1,), f)]).to(torch.int32)
    if rank is None:
        run_order = torch.arange(seg.shape[0], dtype=torch.int32, device=dev)
    else:
        rank = rank.to(device=dev, dtype=torch.int64)
        key = rank[heads.to(torch.int64).clamp(0, rank.shape[0] - 1)][seg]
        run_order = torch.argsort(key, stable=True).to(torch.int32)
    return run_start, run_order


def _check_schedule_shape(run_start: torch.Tensor, run_order: torch.Tensor,
                          f: int) -> None:
    """Raise ValueError unless run_start is (S + 1,) and run_order (S,)
    with 1 <= S <= F.  No synchronisation."""
    s = run_start.shape[0] - 1
    if s < 1 or s > f or tuple(run_order.shape) != (s,):
        raise ValueError(f"run_start must be (S + 1,) and run_order (S,) "
                         f"with 1 <= S <= F={f}, got "
                         f"{tuple(run_start.shape)} and "
                         f"{tuple(run_order.shape)}")


def _check_schedule(run_start: torch.Tensor, run_order: torch.Tensor,
                    qrow: torch.Tensor, f: int) -> None:
    """Raise ValueError unless run_start (S + 1,) starts at 0, ends at F
    and increases, run_order (S,) is a permutation of range(S), and every
    run's table rows name one center (a new qrow only at a run's start).
    One synchronisation."""
    _check_schedule_shape(run_start, run_order, f)
    s = run_start.shape[0] - 1
    rs = run_start.to(torch.int64)
    qr = qrow.to(torch.int64)
    # S entries that hit each of the S in-range values once leave none
    # out; out-of-range ones land in the bins at -1 and S
    counts = torch.bincount(run_order.to(torch.int64).clamp(-1, s) + 1,
                            minlength=s + 2)[1:s + 1]
    starts = torch.zeros(f, dtype=torch.bool, device=rs.device)
    starts[rs[:-1].clamp(0, f - 1)] = True
    new_center = torch.zeros_like(starts)
    new_center[1:] = qr[1:] != qr[:-1]
    ends, steps, perm, one_center = torch.stack([
        (rs[0] == 0) & (rs[-1] == f), (rs[1:] > rs[:-1]).all(),
        counts.eq(1).all(), ~(new_center & ~starts).any()]).tolist()
    if not ends:
        raise ValueError(f"run_start must start at 0 and end at F={f}")
    if not steps:
        raise ValueError("run_start must increase")
    if not perm:
        raise ValueError(f"run_order is not a permutation of range({s})")
    if not one_center:
        raise ValueError("a run holds table rows of more than one center")


def coldeltacor_flat(e_visit: torch.Tensor, e_ctr: torch.Tensor,
                     d_ctr: torch.Tensor, qloc: torch.Tensor,
                     qrow: torch.Tensor, transform: int, psc: float,
                     d_ctr2: Optional[torch.Tensor] = None,
                     run_start: Optional[torch.Tensor] = None,
                     run_order: Optional[torch.Tensor] = None,
                     check: bool = True
                     ) -> Union[torch.Tensor,
                                Tuple[torch.Tensor, torch.Tensor]]:
    """The flat block-table colDeltaCor on the card (one step of the ring
    schedule), partial semantics: e_visit (C, G) the gather source, e_ctr
    / d_ctr (M, G) f32 center rows, qloc (F, q) int32 rows of e_visit and
    qrow (F,) int32 rows of e_ctr, CUDA tensors on one device -> (F, q)
    f32, entry [f, k] the correlation of e_visit[qloc[f, k]] - e_ctr[qrow
    [f]] with d_ctr[qrow[f]].  With d_ctr2 (M, G), the pair for d_ctr and
    d_ctr2 from one pass, each bitwise equal to a single call.  A qloc
    outside [0, C) or a qrow outside [0, M) gives NaN there.  Each entry
    is bitwise the sampled kernel's for the same pair (same G, aligned
    sources).

    run_start (S + 1,) / run_order (S,) int32: the schedule, one block a
    run (flat_runs builds it; without run_start it is built here in table
    order, without run_order the runs are taken in table order).  The
    schedule never changes an output.  A schedule the caller passes is
    checked with one synchronisation: one that does not start at 0, end
    at F, increase, take each run once or keep one center a run raises
    ValueError.  check=False skips that check (its shapes are still
    checked), for a schedule flat_runs built, which is right by
    construction: the ring's, whose launches must not wait for the card.
    transform: 0 linear, 1 sqrt, 2 log10.  Launches on the current stream
    and, but for that check, does not synchronise."""
    global flat_launches
    rows = dict(e_visit=e_visit, e_ctr=e_ctr, d_ctr=d_ctr)
    if d_ctr2 is not None:
        rows["d_ctr2"] = d_ctr2
    for name, t in rows.items():
        _check(name, t)
    _check("qloc", qloc, (torch.int32,))
    _check("qrow", qrow, (torch.int32,), dim=1)
    tables = dict(qloc=qloc, qrow=qrow)
    for name, t in (("run_start", run_start), ("run_order", run_order)):
        if t is not None:
            _check(name, t, (torch.int32,), dim=1)
            tables[name] = t
    _check_same_device(**tables, **rows)
    c, g = e_visit.shape
    m = e_ctr.shape[0]
    f, q = qloc.shape
    for name in ("e_ctr", "d_ctr", "d_ctr2"):
        if name in rows and rows[name].shape != (m, g):
            raise ValueError(f"{name} must be ({m}, {g}), got "
                             f"{tuple(rows[name].shape)}")
    if qrow.shape != (f,):
        raise ValueError(f"qrow must be ({f},), got {tuple(qrow.shape)}")
    n_rows = 3 if d_ctr2 is not None else 2
    if c < 1 or m < 1 or f < 1 or q < 1 or c >= 2 ** 31 - 1 or \
            f * q >= 2 ** 31 or n_rows * g * 4 > _MAX_SMEM:
        raise ValueError(f"unsupported shape: C={c}, G={g}, M={m}, F={f}, "
                         f"q={q}")
    if transform not in (0, 1, 2):
        raise ValueError(f"unknown transform code {transform}")
    if run_start is None:
        if run_order is not None:
            raise ValueError("run_order needs its run_start")
        run_start, run_order = flat_runs(qrow)
    else:
        if run_order is None:
            run_order = torch.arange(max(run_start.shape[0] - 1, 0),
                                     dtype=torch.int32,
                                     device=run_start.device)
        if check:
            _check_schedule(run_start, run_order, qrow, f)
        else:
            _check_schedule_shape(run_start, run_order, f)
    out = torch.empty((f, q), dtype=torch.float32, device=e_visit.device)
    out2 = torch.empty_like(out) if d_ctr2 is not None else None
    _launch("coldeltacor_flat", e_visit.device, e_visit.data_ptr(),
            e_ctr.data_ptr(), d_ctr.data_ptr(),
            None if d_ctr2 is None else d_ctr2.data_ptr(), qloc.data_ptr(),
            qrow.data_ptr(), run_start.data_ptr(), run_order.data_ptr(),
            out.data_ptr(), None if out2 is None else out2.data_ptr(), c, m,
            g, f, q, run_start.shape[0] - 1, transform, float(psc))
    flat_launches += 1
    return out if out2 is None else (out, out2)


def fma_probe(x: torch.Tensor) -> torch.Tensor:
    """The FMA-chain ceiling probe on the card: f32 CUDA tensor of any
    shape -> same shape.  Launches on the current stream and does not
    synchronise."""
    global fma_launches
    _check("x", x, dim=x.dim())
    if x.numel() < 1:
        raise ValueError("x is empty")
    out = torch.empty_like(x)
    _launch("fma_probe", x.device, x.data_ptr(), out.data_ptr(), x.numel())
    fma_launches += 1
    return out


SVR_CLUSTER = 16           # blocks of the solver's cluster, kCluster
_SVR_THREADS = 512         # svr_smo.cu kThreads
_SVR_SLOT_BYTES = 37       # kSlotBytes: shared state per position
_SVR_SMEM = 200 * 1024     # kMaxSmem: of it, a block at most


def svr_route(l: int) -> str:
    """Where the solver keeps its per-iteration state for l samples (2l
    positions): "shared" while each of the cluster's blocks holds its
    share (whole multiples of the block's threads, 37 B a position) in
    200 KiB of shared memory, else "global"; the same loop either way."""
    per_block = -(-2 * l // (SVR_CLUSTER * _SVR_THREADS)) * _SVR_THREADS
    return "shared" if per_block * _SVR_SLOT_BYTES <= _SVR_SMEM \
        else "global"


def svr_smo(x: torch.Tensor, target: torch.Tensor, C: float,
            epsilon: float, gamma: float, tol: float,
            route: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """libsvm's epsilon-SVR solve (RBF kernel, one feature, shrinking, no
    iteration cap) on the card in one launch of a thread-block cluster:
    x, target (l,) float64 CUDA tensors -> (alpha (2l,) float64 in
    original order, rho (1,) float64, stats (3,) int64 = iterations, sum
    of the active-set sizes over them, kernel evaluations).  route:
    "shared" or "global", where the cluster keeps its state; None takes
    ``svr_route(l)``.  The two give bitwise equal results.  Launches on
    the current stream and does not synchronise."""
    global svr_launches, svr_shared_launches, svr_global_launches
    _check("x", x, (torch.float64,), dim=1)
    _check("target", target, (torch.float64,), dim=1)
    _check_same_device(x=x, target=target)
    l = x.numel()
    if target.numel() != l or l < 1 or l > 2 ** 29:
        raise ValueError(f"unsupported shapes: x {tuple(x.shape)}, target "
                         f"{tuple(target.shape)}")
    if route is None:
        route = svr_route(l)
    if route not in ("shared", "global") or \
            route == "shared" and svr_route(l) != "shared":
        raise ValueError(f"route {route!r} cannot take l={l}")
    dev, n2 = x.device, 2 * l
    work = [torch.empty(n2, dtype=dt, device=dev) for dt in (
        torch.float64, torch.float64, torch.float64, torch.float64,
        torch.float64, torch.uint8, torch.int32, torch.float32, torch.int32,
        torch.int32)]     # G, Gbar, alpha, p, xs, flags, aset, qi, posL, posR
    alpha = torch.empty(n2, dtype=torch.float64, device=dev)
    rho = torch.empty(1, dtype=torch.float64, device=dev)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    _launch("svr_smo", dev, x.data_ptr(), target.data_ptr(),
            *(t.data_ptr() for t in work), alpha.data_ptr(),
            rho.data_ptr(), stats.data_ptr(), l, float(C), float(epsilon),
            float(gamma), float(tol), int(route == "shared"))
    if route == "shared":
        svr_shared_launches += 1
    else:
        svr_global_launches += 1
    svr_launches += 1
    return alpha, rho, stats


def svr_sync_probe(reps: int, device: Union[str, torch.device] = "cuda"
                   ) -> torch.Tensor:
    """Run `reps` rounds of the SVR solver's per-iteration synchronisation
    (two block reductions, each pushed into every block's inbox through
    distributed shared memory, a cluster barrier and a pick in rank
    order, and the step on every thread) in one cluster of the solver's
    shape, with no pass over any variables; returns a (1,) float64
    tensor.  Timed, it gives the latency floor of one SMO iteration.  A
    measurement probe, not counted.  Launches on the current stream and
    does not synchronise."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"svr_sync_probe runs on a CUDA device, got {device}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    out = torch.empty(1, dtype=torch.float64, device=device)
    _launch("svr_sync_probe", device, int(reps), out.data_ptr())
    return out


_TSNE_BLOCK_ROWS = 256     # tsne_grad.cu kBlockRows
_TSNE_WARPS = 8            # kWarpsAttract: rows per block of the second pass
_TSNE_BLOCKS_PER_SM = 16   # pair-pass blocks per SM, the target


def tsne_splits(n: int, sms: int) -> int:
    """Column ranges of the pair pass for n points on `sms` SMs: about
    _TSNE_BLOCKS_PER_SM blocks per SM, 1 to 32."""
    row_blocks = -(-n // _TSNE_BLOCK_ROWS)
    return max(1, min(32, round(_TSNE_BLOCKS_PER_SM * sms / row_blocks)))


def _tsne_check(y: torch.Tensor, indptr: torch.Tensor,
                indices: torch.Tensor, pval: torch.Tensor) -> Tuple[int, int]:
    """Check the inputs of a gradient (devices, dtypes, shapes); returns
    (n, d)."""
    _check("y", y)
    _check("indptr", indptr, (torch.int64,), dim=1)
    _check("indices", indices, (torch.int32,), dim=1)
    _check("pval", pval, dim=1)
    _check_same_device(y=y, indptr=indptr, indices=indices, pval=pval)
    n, d = y.shape
    if d not in (1, 2, 3) or n < 2 or n >= 2 ** 31 // 32 or \
            indptr.numel() != n + 1 or indices.numel() != pval.numel():
        raise ValueError(f"unsupported shapes: y {tuple(y.shape)}, indptr "
                         f"{tuple(indptr.shape)}, indices "
                         f"{tuple(indices.shape)}, pval {tuple(pval.shape)}")
    return n, d


def _tsne_prepare(y: torch.Tensor, indptr: torch.Tensor,
                  indices: torch.Tensor, pval: torch.Tensor
                  ) -> Dict[str, Any]:
    """Check the inputs of a gradient and allocate its outputs and
    scratch.  The scratch is the call's own, the ticket (an int32 the
    last block of each pass takes and sets back to 0) included, so calls
    on different streams may overlap."""
    n, d = _tsne_check(y, indptr, indices, pval)
    dev = y.device
    splits = tsne_splits(
        n, torch.cuda.get_device_properties(dev).multi_processor_count)
    f64 = dict(dtype=torch.float64, device=dev)
    return dict(
        y=y, n=n, d=d, splits=splits, indptr=indptr, indices=indices,
        pval=pval, rep=torch.empty((n, splits, d), **f64),
        zpart=torch.empty(-(-n // _TSNE_BLOCK_ROWS) * splits, **f64),
        z=torch.empty(1, **f64), grad=torch.empty_like(y),
        err_part=torch.empty(-(-n // _TSNE_WARPS), **f64),
        err=torch.empty(1, **f64),
        ticket=torch.zeros(1, dtype=torch.int32, device=dev))


def _tsne_pairs(w: Dict[str, Any]) -> None:
    """The pair pass: partial repulsive forces and Z."""
    _launch("tsne_pairs", w["y"].device, w["y"].data_ptr(), w["n"], w["d"],
            w["splits"], w["rep"].data_ptr(), w["zpart"].data_ptr(),
            w["z"].data_ptr(), w["ticket"].data_ptr())


def _tsne_attract(w: Dict[str, Any], compute_error: bool) -> None:
    """The attractive pass: the gradient and, with compute_error, the KL
    error."""
    _launch("tsne_attract", w["y"].device, w["y"].data_ptr(), w["n"],
            w["d"], w["splits"], w["indptr"].data_ptr(),
            w["indices"].data_ptr(), w["pval"].data_ptr(),
            w["rep"].data_ptr(), w["z"].data_ptr(), int(bool(compute_error)),
            w["grad"].data_ptr(), w["err_part"].data_ptr(),
            w["err"].data_ptr(), w["ticket"].data_ptr())


def tsne_grad(y: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
              pval: torch.Tensor, compute_error: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Exact t-SNE gradient on the card with sklearn's degrees of freedom,
    max(d - 1, 1): y (n, d) float32, d = 1, 2 or 3, the CSR of P (indptr
    (n+1,) int64, indices int32, pval float32) -> (grad (n, d) float32,
    the KL error as a (1,) float64 tensor, or None without
    compute_error).  Two launches on the current stream (the pair pass,
    the attractive pass), no synchronisation; every sum is in a fixed
    order, so two calls on one input agree bitwise."""
    global tsne_launches
    w = _tsne_prepare(y, indptr, indices, pval)
    _tsne_pairs(w)
    _tsne_attract(w, compute_error)
    tsne_launches += 2
    return w["grad"], (w["err"] if compute_error else None)


_BALANCE_THREADS = 256       # knn_balance.cu kThreads: the walkers
_BALANCE_MAX_DEPTH = 1024    # kMaxDepth: staged positions a row, at most
_BALANCE_MAX_STAGES = 8      # kMaxStages: stages of the ring, at most
_BALANCE_SMEM = 224 * 1024   # kMaxSmem: dynamic shared memory, bytes
_BALANCE_OUT_WORDS = 34      # kOutWords: a stage's results, bits, p, self
_BALANCE_MAX_L16 = 65535     # kMaxL16: the largest l or label a uint16 holds
_BALANCE_PROBE_MIN = 1024    # kProbeMinCells: the probe's smallest n
_LABEL_CODES = {None: 0, "shared": 1, "staged": 2}


class BalancePlan(NamedTuple):
    """How the balance walk runs: where l lives ("shared" or "global"),
    the ring's stages R and staged depth T, and where the candidates'
    group labels live (None unconstrained, "shared" beside l, "staged"
    through the ring)."""
    route: str
    stages: int
    depth: int
    labels: Optional[str]


def _pad16(b: int) -> int:
    return -(-b // 16) * 16


def _balance_smem(n: int, depth: int, stages: int, labels: Optional[str],
                  route: str) -> int:
    """Bytes of the walk's dynamic shared memory (knn_balance.cu layout()):
    the ring's indices (and staged labels), each stage's results (its
    staged chunk's bits, p and self), l as uint16, the labels as
    uint16."""
    cells = stages * depth
    # a stage holds T + 1 indices rounded up to even (knn_balance.cu
    # stage_len): a row copied from the 16-byte boundary before it
    return (_pad16(8 * stages * ((depth + 2) // 2 * 2))
            + (_pad16(4 * cells) if labels == "staged" else 0)
            + _pad16(4 * stages * _BALANCE_OUT_WORDS)
            + (_pad16(2 * n) if route == "shared" else 0)
            + (_pad16(2 * n) if labels == "shared" else 0))


def balance_depth(sight: int, k: int) -> int:
    """T, the candidates of a row staged ahead: the JAX package's depth
    (velocyto_tpu/ops/knn_device.py::_balance_plan, k + 1 + max(192,
    k // 2) rounded up to 128), at most 1,024 (one warp scans the chunk's
    warp totals) and the row."""
    t = -(-(k + 1 + max(192, k // 2)) // 128) * 128
    return max(1, min(sight, t, _BALANCE_MAX_DEPTH))


def balance_plan(n: int, sight: int, k: int, maxl: int, grouped: bool,
                 route: Optional[str] = None, stages: Optional[int] = None,
                 labels: Optional[str] = None) -> BalancePlan:
    """How the walk balances n cells of `sight` candidates, k a node,
    under the cap maxl, with or without group labels.

    l stays in shared memory ("shared") while every in-degree (at most
    min(maxl, n - 1)) fits uint16 and 2 B a cell fit beside a ring of two
    stages (with staged labels when grouped), else it goes to global
    memory.  Labels sit beside l as uint16 when n <= 65,535 (the walk's
    dense labels lie in [0, n)) and the layout still holds the longest ring, else they are
    staged through the ring.  R is the longest even ring up to 8 that
    fits.  route, stages or labels force one (raising ValueError where it
    cannot be)."""
    depth = balance_depth(sight, k)
    top = min(max(int(maxl), 0), n - 1)
    staged = "staged" if grouped else None
    fits_shared = top <= _BALANCE_MAX_L16 and _balance_smem(
        n, depth, 2, staged, "shared") <= _BALANCE_SMEM
    if route is None:
        route = "shared" if fits_shared else "global"
    elif route not in ("shared", "global") or \
            route == "shared" and not fits_shared:
        raise ValueError(f"route {route!r} cannot take n={n}, maxl={maxl}")
    if labels is None:
        labels = staged
        if grouped and n <= _BALANCE_MAX_L16 and _balance_smem(
                n, depth, _BALANCE_MAX_STAGES, "shared", route) <= \
                _BALANCE_SMEM:
            labels = "shared"
    elif not grouped or labels not in ("shared", "staged") or \
            labels == "shared" and n > _BALANCE_MAX_L16:
        raise ValueError(f"labels {labels!r} cannot take n={n}, grouped="
                         f"{grouped}")
    fit = [r for r in range(2, _BALANCE_MAX_STAGES + 1, 2)
           if _balance_smem(n, depth, r, labels, route) <= _BALANCE_SMEM]
    if not fit:
        raise ValueError(f"labels {labels!r} do not fit beside l for n={n}")
    if stages is None:
        stages = fit[-1]
    elif stages not in fit:
        raise ValueError(f"stages={stages} cannot take n={n} (fit: {fit})")
    return BalancePlan(route, stages, depth, labels)


def _balance_check(dsi: torch.Tensor, lsi: torch.Tensor,
                   constraint: Optional[torch.Tensor], k: int,
                   dist: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """Check the walk's inputs (devices, dtypes, shapes); returns (n,
    sight)."""
    _check("dsi", dsi, (torch.int64,))
    _check("lsi", lsi, (torch.int64,), dim=1)
    tensors = dict(dsi=dsi, lsi=lsi)
    if dist is not None:
        _check("dist", dist, (torch.float64,))
        tensors["dist"] = dist
    if constraint is not None:
        _check("constraint", constraint, (torch.int32,), dim=1)
        tensors["constraint"] = constraint
    _check_same_device(**tensors)
    n, sight = dsi.shape
    if (dist is not None and dist.shape != dsi.shape) or \
            lsi.shape != (n,) or n < 1 or n >= 2 ** 31 - 1 or \
            sight >= 2 ** 31 - 1 or k < 0 or \
            (constraint is not None and constraint.shape != (n,)):
        raise ValueError(f"unsupported shapes: dsi {tuple(dsi.shape)}, "
                         f"dist {None if dist is None else tuple(dist.shape)}"
                         f", lsi {tuple(lsi.shape)}, k {k}")
    if sight < k:
        raise ValueError(f"sight needs to be bigger than k: {sight} < {k}")
    return n, sight


def _dense_labels(constraint: torch.Tensor) -> torch.Tensor:
    """Each label's rank among the distinct labels, as int32 in [0, n):
    the same equalities as the labels given, with no copy to the host (a
    sort and a scan, not torch.unique)."""
    s, order = torch.sort(constraint)
    rank = torch.zeros_like(constraint)
    rank[1:] = torch.cumsum(s[1:] != s[:-1], 0)
    return torch.empty_like(constraint).scatter_(0, order, rank)


def balance_walk(dsi: torch.Tensor, lsi: torch.Tensor,
                 constraint: Optional[torch.Tensor], maxl: int, k: int,
                 route: Optional[str] = None, stages: Optional[int] = None,
                 labels: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            BalancePlan]:
    """The balance walk on the card in one launch of one block (the
    walkers and a producer warp that fills their ring of rows): dsi (n,
    sight) int64 candidates (distinct in each row), lsi (n,) int64 visit
    order, constraint (n,) int32 group labels (any values: only their
    equality matters; the walk gets their dense ranks) or None ->
    (bits (n, ceil(sight / 32)) int32, the accepted positions of each row
    as bits, the words of its examined region written where it accepted
    any, the rest left as they were; meta (n, 2)
    int32, the accepted count p and whether the row examined its own
    node, (-1, 0) for a row never visited; l (n,) int64; the plan).
    route, stages, labels: as ``balance_plan``.  Launches on the current
    stream and does not synchronise."""
    global balance_launches
    k = int(k)
    n, sight = _balance_check(dsi, lsi, constraint, k)
    # no l passes n - 1, so every cap from n up takes the same decisions,
    # and every cap up to 0 accepts nothing
    maxl = min(max(int(maxl), 0), n)
    plan = balance_plan(n, sight, k, maxl, constraint is not None, route,
                        stages, labels)
    dev = dsi.device
    bits = torch.empty((n, -(-sight // 32)), dtype=torch.int32, device=dev)
    meta = torch.empty((n, 2), dtype=torch.int32, device=dev)
    l = torch.empty(n, dtype=torch.int64, device=dev)
    work = None if plan.route == "shared" else \
        torch.empty(n, dtype=torch.int32, device=dev)
    if constraint is not None:
        constraint = _dense_labels(constraint)
    _launch("knn_balance_walk", dev, dsi.data_ptr(), lsi.data_ptr(),
            None if constraint is None else constraint.data_ptr(),
            None if work is None else work.data_ptr(), bits.data_ptr(),
            meta.data_ptr(), l.data_ptr(), n, sight, maxl, k, plan.depth,
            plan.stages, _LABEL_CODES[plan.labels],
            int(plan.route == "shared"))
    balance_launches += 1
    return bits, meta, l, plan


def balance_decode(bits: torch.Tensor, meta: torch.Tensor,
                   dsi: torch.Tensor, dist: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk's bits and meta with the candidates dsi (n, sight) int64
    and dist (n, sight) float64 -> (dist_new (n, k+1) float64, dsi_new
    (n, k+1) int64) on the card, one warp a row over every SM: slot 0 the
    node or -1, slots 1..p the accepted candidates in acceptance order,
    slots p+1..k the node with dist[el, 0]; a row with p < 0 is -1 / 0.
    The plain twin is ops.knn_device._balance_decode_plain.  Launches on
    the current stream and does not synchronise."""
    global balance_decode_launches
    k = int(k)
    _check("bits", bits, (torch.int32,))
    _check("meta", meta, (torch.int32,))
    _check("dsi", dsi, (torch.int64,))
    _check("dist", dist, (torch.float64,))
    _check_same_device(bits=bits, meta=meta, dsi=dsi, dist=dist)
    n, sight = dsi.shape
    if dist.shape != dsi.shape or bits.shape != (n, -(-sight // 32)) or \
            meta.shape != (n, 2) or n < 1 or n >= 2 ** 31 - 1 or \
            sight >= 2 ** 31 - 1 or k < 0 or sight < k:
        raise ValueError(f"unsupported shapes: bits {tuple(bits.shape)}, "
                         f"meta {tuple(meta.shape)}, dsi {tuple(dsi.shape)}, "
                         f"dist {tuple(dist.shape)}, k {k}")
    dev = dsi.device
    idx_new = torch.empty((n, k + 1), dtype=torch.int64, device=dev)
    dist_new = torch.empty((n, k + 1), dtype=torch.float64, device=dev)
    _launch("knn_balance_decode", dev, bits.data_ptr(), meta.data_ptr(),
            dsi.data_ptr(), dist.data_ptr(), idx_new.data_ptr(),
            dist_new.data_ptr(), n, sight, k)
    balance_decode_launches += 1
    return dist_new, idx_new


def knn_balance(dsi: torch.Tensor, dist: torch.Tensor, lsi: torch.Tensor,
                constraint: Optional[torch.Tensor], maxl: int, k: int,
                route: Optional[str] = None, stages: Optional[int] = None,
                labels: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The greedy degree-capped kNN balance on the card: the walk (one
    block, ``balance_walk``) then the decode (every SM,
    ``balance_decode``).  dsi (n, sight) int64 candidate indices
    (distinct in each row) and dist (n, sight) float64 in row order, lsi
    (n,) int64 visit order, constraint (n,) int32 group labels (any
    values: candidates match on equal labels) or None ->
    (dist_new (n, k+1) float64, dsi_new (n, k+1) int64, l (n,) int64),
    the layout of ops.knn_device._balance_scan_plain, bitwise.  An index
    outside [0, n) is never accepted.  route, stages, labels: as
    ``balance_walk``; every choice gives bitwise equal results.  Launches
    on the current stream and does not synchronise."""
    k = int(k)
    _balance_check(dsi, lsi, constraint, k, dist)
    bits, meta, l, _plan = balance_walk(dsi, lsi, constraint, maxl, k,
                                        route, stages, labels)
    dist_new, idx_new = balance_decode(bits, meta, dsi, dist, k)
    return dist_new, idx_new, l


def balance_probe(n: int, reps: int, route: str = "shared",
                  device: Union[str, torch.device] = "cuda",
                  rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run `reps` dependent steps of what chains one node of the balance
    walk to the next (a load of l, a ballot, the chunk's barrier and
    scan, a store to l, the node's barrier) in one block of the walk's
    256 walkers, over n >= 1024 cells with l in `route`'s memory
    ("shared" while n uint16 fit the block's shared memory); with rows
    (n, sight) int64 on a card (the probe then runs on its device), each
    step first reads the first chunk of a row no step read before, only
    once the step before has ended (a node's row, read when it is
    needed).  Returns a (1,) int64 tensor.  Timed with reps = n, it gives
    the walk's latency floor.  A measurement probe, not counted.
    Launches on the current stream and does not synchronise."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"balance_probe runs on a CUDA device, got {device}")
    if n < _BALANCE_PROBE_MIN or reps < 1 or \
            route not in ("shared", "global") or \
            route == "shared" and _pad16(2 * n) > _BALANCE_SMEM:
        raise ValueError(f"unsupported probe: n={n}, reps={reps}, "
                         f"route={route!r}")
    if rows is not None:
        _check("rows", rows, (torch.int64,))
        if rows.shape[0] != n or rows.shape[1] < 1:
            raise ValueError(f"rows must be ({n}, sight), got "
                             f"{tuple(rows.shape)}")
        device = rows.device
    out = torch.empty(1, dtype=torch.int64, device=device)
    work = None if route == "shared" else \
        torch.empty(n, dtype=torch.int32, device=device)
    _launch("knn_balance_probe", device,
            None if work is None else work.data_ptr(), int(n), int(reps),
            None if rows is None else rows.data_ptr(),
            0 if rows is None else rows.shape[1], int(route == "shared"),
            out.data_ptr())
    return out


def reset_counts() -> None:
    """Set every launch count to 0."""
    global dense_launches, partial_launches, flat_launches, fma_launches, \
        svr_launches, svr_shared_launches, svr_global_launches, \
        tsne_launches, balance_launches, balance_decode_launches
    dense_launches = partial_launches = flat_launches = fma_launches = \
        svr_launches = svr_shared_launches = svr_global_launches = \
        tsne_launches = balance_launches = balance_decode_launches = 0
