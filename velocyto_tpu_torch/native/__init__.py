"""Host C++ helpers of the port, bound by ctypes.

``sampler.cpp`` replays numpy's MT19937 stream for the per-cell neighbour
sampling of ``estimate_transition_prob(knn_random=True)``, resumably, so
the rows come out in chunks (``choice_noreplace_rows_chunked``).
``choice_rows_plain`` is the numpy loop it replaces: the tests and
``chip_smoke.py`` hold the two to bit equality.  ``sampler_replays``
counts its calls, the rows they sampled, the rounds of numpy's rejection
loop those rows took and the doubles they drew.

``balance.cpp`` is the greedy balanced-kNN loop of ``BalancedKNN``,
``knn_balance`` and ``ops.knn.balance_knn_loop`` (the balance half of
the JAX package's ``vtpu.cpp``); ``balance_knn_loop`` below binds it with
the JAX package's signature, and the numpy loop of ``ops/knn.py`` stays
as its plain version, held to it bitwise by the tests.

``permute.cpp`` draws the randomized control's plan (the row
permutations and sign flips of ``analysis.permute_rows_nsign``) from a
given numpy MT19937 state; ``permute_rows_nsign_plan`` below binds it,
and ``analysis._permute_rows_nsign_plan_plain`` is the numpy loop it
replays, held to it bitwise by the tests.  ``permute_plans`` counts its
calls and the words they drew.

``bam.cpp`` is the counting engine's BGZF/BAM decoder, its exact hash
factorize and its external sorter by cell tag (the counting half of the
JAX package's ``velocyto_tpu/native/vtpu.cpp``).  The wrappers below
(``available``, ``bam_sort_by_tag``, ``read_tag_index``,
``bam_record_ranges``, ``factorize_fixed``) are copies of the JAX
package's (``velocyto_tpu/native/__init__.py``).  As there, counting
falls back to its Python and numpy paths when the library cannot be
built; ``available()`` then logs the compiler's error once.

All four are compiled on first use (never at import) with the host C++
compiler into ``_build/``, named by the hash of their source, so an
edited source is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..utils.profiling import span

_HERE = Path(__file__).resolve().parent
_BUILD = _HERE / "_build"
SOURCE = _HERE / "sampler.cpp"
BAM_SOURCE = _HERE / "bam.cpp"
BALANCE_SOURCE = _HERE / "balance.cpp"
PERMUTE_SOURCE = _HERE / "permute.cpp"

_lib = None
_balance_lib = None
_permute_lib = None
_lock = threading.Lock()    # the plan library's load; both counters
_bam_lib = None
_bam_error: Optional[str] = None     # the compiler's error, once logged

# the control's plans drawn by permute.cpp, and the MT19937 words they drew
permute_plans = {"plans": 0, "words": 0}
# the replays of sampler.cpp (one choice_noreplace_rows_chunked call each),
# their rows, the rounds of the rejection loop and the doubles drawn
sampler_replays = {"calls": 0, "rows": 0, "rounds": 0, "doubles": 0}

# most record boundaries bam_record_ranges holds at once (bam.cpp thins
# them, doubling their spacing, when more qualify)
MAX_BOUNDARIES = 65536


def _compile(source: Path, stem: str, flags: List[str],
             libs: List[str]) -> Path:
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = _BUILD / f"lib{stem}_{tag}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++) on PATH")
    _BUILD.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    # no -march=native: the library must run on any host of the arch
    cmd = [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", *flags,
           "-o", str(tmp), str(source), *libs]
    with span("build." + stem):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"c++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)     # atomic: a concurrent build never loads half
    return lib


def build() -> Path:
    """Compile sampler.cpp unless a library built from the same source
    exists; returns the library's path.  Raises on any compiler error."""
    # no FMA contraction: the cdf sums must round as numpy's do
    return _compile(SOURCE, "vtt_sampler", ["-ffp-contract=off"], [])


def build_bam() -> Path:
    """Compile bam.cpp (zlib, threads) unless a library built from the
    same source exists; returns the library's path.  Raises on any
    compiler error."""
    return _compile(BAM_SOURCE, "vtt_bam", ["-pthread"], ["-lz"])


def build_balance() -> Path:
    """Compile balance.cpp unless a library built from the same source
    exists; returns the library's path.  Raises on any compiler error."""
    return _compile(BALANCE_SOURCE, "vtt_balance", [], [])


def build_permute() -> Path:
    """Compile permute.cpp unless a library built from the same source
    exists; returns the library's path.  Raises on any compiler error."""
    return _compile(PERMUTE_SOURCE, "vtt_permute", [], [])


def _load_sampler():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.vtt_mt19937_seed.argtypes = [ctypes.c_uint32, ctypes.c_void_p]
        lib.vtt_mt19937_seed.restype = None
        fn = lib.vtt_choice_noreplace_resume
        fn.argtypes = [ctypes.c_void_p,                  # state (625,) uint32
                       ctypes.c_int64, ctypes.c_int64,   # n_rows, pop
                       ctypes.c_int64, ctypes.c_void_p,  # size, p (pop,)
                       ctypes.c_void_p,                  # out (n_rows, size)
                       ctypes.POINTER(ctypes.c_int64)]   # rounds, added to
        fn.restype = ctypes.c_int64
        _lib = lib
    return _lib


def choice_noreplace_rows(seed: int, n_rows: int, pop: int, size: int,
                          p: np.ndarray) -> Tuple[np.ndarray, int]:
    """``np.random.seed(seed)`` then, per row,
    ``np.random.choice(pop, size, replace=False, p=p)``, replayed in C++.

    Returns (positions (n_rows, size) int64, doubles drawn), the JAX
    package's contract (``velocyto_tpu/native/__init__.py::
    choice_noreplace_rows``); ``choice_noreplace_rows_state`` also gives
    numpy's final state.  numpy's own global stream is not touched."""
    return choice_noreplace_rows_state(seed, n_rows, pop, size, p)[:2]


def choice_noreplace_rows_state(seed: int, n_rows: int, pop: int, size: int,
                                p: np.ndarray
                                ) -> Tuple[np.ndarray, int, tuple]:
    """``choice_noreplace_rows`` and numpy's final state as an
    ``np.random.set_state`` tuple, so the caller can position the global
    stream directly.  Releases the GIL while it samples.  The whole
    replay in one chunk of ``choice_noreplace_rows_chunked``."""
    return choice_noreplace_rows_chunked(seed, n_rows, pop, size, p,
                                         n_chunks=1)


def choice_noreplace_rows_chunked(seed: int, n_rows: int, pop: int,
                                  size: int, p: np.ndarray,
                                  n_chunks: int = 4, on_chunk=None
                                  ) -> Tuple[np.ndarray, int, tuple]:
    """``choice_noreplace_rows_state`` produced in row chunks: after each chunk
    of rows is sampled, ``on_chunk(lo, hi, rows_view)`` fires, so the
    caller can hand the rows on while the MT19937 replay goes on with
    the next chunk.  Copy of the JAX package's
    ``velocyto_tpu/native/__init__.py::choice_noreplace_rows_chunked``:
    the same ``np.linspace`` chunk bounds, empty chunks skipped, the same
    rows and final state as the whole replay for every ``n_chunks``.

    Unlike the JAX copy it raises where that one returns None: a
    ValueError when fewer than ``size`` weights are positive, checked
    before the first chunk (so no ``on_chunk`` fires before a refusal),
    and a RuntimeError when the state between two chunks is not a
    valid position (``state[624]`` past 624).  A weight that is negative
    or not finite, a sum of them that is not finite or 2**31 weights or
    more is a ValueError before the first chunk too.  Adds one call, the rows, their rounds
    and their doubles to ``sampler_replays`` once every chunk is in."""
    lib = _load_sampler()
    p = np.ascontiguousarray(p, dtype=np.float64)
    if p.shape != (pop,):
        raise ValueError(f"p has shape {p.shape}, expected ({pop},)")
    if int(np.count_nonzero(p > 0)) < size:
        raise ValueError("Fewer non-zero entries in p than size")
    state = np.empty(625, np.uint32)
    lib.vtt_mt19937_seed(seed & 0xFFFFFFFF, state.ctypes.data)
    out = np.empty((n_rows, size), np.int64)
    draws = 0
    rounds = ctypes.c_int64(0)
    bounds = np.linspace(0, n_rows, max(1, n_chunks) + 1).astype(np.int64)
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        if hi <= lo:
            continue
        d = lib.vtt_choice_noreplace_resume(
            state.ctypes.data, hi - lo, pop, size, p.ctypes.data,
            out[lo:].ctypes.data, ctypes.byref(rounds))
        if d == -1:
            raise ValueError("Fewer non-zero entries in p than size")
        if d == -2:
            raise ValueError("p holds a negative or non-finite weight, its "
                             "sum is not finite or it has 2**31 or more")
        if d < 0 or state[624] > 624:
            raise RuntimeError(f"MT19937 position {state[624]} past 624 "
                               f"after rows [{lo}, {hi})")
        draws += d
        if on_chunk is not None:
            on_chunk(lo, hi, out[lo:hi])
    with _lock:
        sampler_replays["calls"] += 1
        sampler_replays["rows"] += n_rows
        sampler_replays["rounds"] += rounds.value
        sampler_replays["doubles"] += int(draws)
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


# -- the randomized control's plan (permute.cpp) ----------------------------

def _load_permute():
    global _permute_lib
    with _lock:
        if _permute_lib is None:
            lib = ctypes.CDLL(str(build_permute()))
            lib.vtt_permute_plan.argtypes = [
                ctypes.c_void_p,                     # state (625,) uint32
                ctypes.c_int64, ctypes.c_int64,      # g, n
                ctypes.c_int,                        # perm_bytes
                ctypes.c_void_p, ctypes.c_void_p]    # out perms, sign bits
            lib.vtt_permute_plan.restype = ctypes.c_int64
            _permute_lib = lib
    return _permute_lib


def permute_rows_nsign_plan(g: int, n: int, state: tuple
                            ) -> Tuple[np.ndarray, np.ndarray, tuple]:
    """For each of g rows, ``RandomState.shuffle(np.arange(n))`` then
    ``RandomState.choice([+1, -1], size=n)``, replayed in C++
    (permute.cpp) from ``state``, an ``np.random.get_state()`` tuple.

    Returns (perms (g, n), uint16, or int32 past 65,536 columns; the
    signs bit-packed (g, ceil(n / 8)) uint8, the first column in the top
    bit and 1 for +1; numpy's state after the draws, with has_gauss and
    the cached gaussian carried through).  Bitwise
    ``analysis._permute_rows_nsign_plan_plain``.  Releases the GIL while
    it draws."""
    name, key, pos, has_gauss, cached = state[:5]
    key = np.asarray(key)
    if name != "MT19937" or key.shape != (624,):
        raise ValueError(f"not an MT19937 state: {name!r}, key {key.shape}")
    if not 0 <= int(pos) <= 624:
        raise ValueError(f"MT19937 position {pos} outside [0, 624]")
    if g < 0 or not 0 <= n < 2 ** 31:
        raise ValueError(f"no plan for ({g}, {n})")
    lib = _load_permute()
    st = np.empty(625, np.uint32)
    st[:624] = key
    st[624] = int(pos)
    perms = np.empty((g, n), np.uint16 if n <= 65536 else np.int32)
    bits = np.empty((g, (n + 7) // 8), np.uint8)
    words = lib.vtt_permute_plan(st.ctypes.data, g, n, perms.itemsize,
                                 perms.ctypes.data, bits.ctypes.data)
    if words < 0:
        raise RuntimeError(f"permute.cpp refused the plan ({g}, {n})")
    with _lock:
        permute_plans["plans"] += 1
        permute_plans["words"] += int(words)
    return perms, bits, ("MT19937", st[:624].copy(), int(st[624]),
                         has_gauss, cached)


# -- the greedy kNN balance (balance.cpp) -----------------------------------

def _load_balance():
    global _balance_lib
    if _balance_lib is None:
        lib = ctypes.CDLL(str(build_balance()))
        lib.vtt_balance_knn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,    # dsi, dist (n, sight)
            ctypes.c_void_p, ctypes.c_void_p,    # lsi (n,), constraint or NULL
            ctypes.c_int64, ctypes.c_int64,      # n, sight
            ctypes.c_int64, ctypes.c_int64,      # maxl, k
            ctypes.c_int,                        # return_distance
            ctypes.c_void_p, ctypes.c_void_p,    # out dsi_new, dist_new
            ctypes.c_void_p]                     # out l (n,)
        lib.vtt_balance_knn.restype = ctypes.c_int64
        _balance_lib = lib
    return _balance_lib


def balance_knn_loop(dsi: np.ndarray, dist: np.ndarray, lsi: np.ndarray,
                     maxl: int, k: int, return_distance: bool,
                     constraint: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The greedy balanced-kNN loop in C++ (balance.cpp): returns
    (dist_new (n, k+1) f64, dsi_new (n, k+1) int64, l (n,) int64),
    bitwise equal to ``ops.knn.balance_knn_loop``'s numpy loop.  Copy of
    the JAX package's ``velocyto_tpu/native/__init__.py::
    balance_knn_loop``, with the inputs checked: ValueError for
    mismatched shapes or a sight smaller than k (the numpy loop's
    refusal) before any pointer is passed, and for an index outside
    [0, n) in lsi or among the candidates the loop reads (balance.cpp
    checks each before it uses it)."""
    dsi = np.ascontiguousarray(dsi, dtype=np.int64)
    n, sight = dsi.shape
    dist = np.ascontiguousarray(dist, dtype=np.float64)
    lsi = np.ascontiguousarray(lsi, dtype=np.int64)
    if sight < k:
        raise ValueError("sight needs to be bigger than k")
    if dist.shape != dsi.shape or lsi.shape != (n,):
        raise ValueError(f"dist {dist.shape} and lsi {lsi.shape} do not "
                         f"match dsi {dsi.shape}")
    if constraint is not None:
        constraint = np.ascontiguousarray(constraint, dtype=np.int64)
        if constraint.shape != (n,):
            raise ValueError(f"constraint has shape {constraint.shape}, "
                             f"expected ({n},)")
    lib = _load_balance()
    dsi_new = np.full((n, k + 1), -1, np.int64)
    dist_new = np.zeros((n, k + 1), np.float64)
    l = np.zeros(n, np.int64)
    if lib.vtt_balance_knn(
            dsi.ctypes.data, dist.ctypes.data, lsi.ctypes.data,
            None if constraint is None else constraint.ctypes.data,
            n, sight, int(maxl), int(k), int(bool(return_distance)),
            dsi_new.ctypes.data, dist_new.ctypes.data, l.ctypes.data) < 0:
        raise ValueError(f"lsi or dsi holds an index outside [0, {n})")
    if not return_distance:
        dist_new = np.ones_like(dsi_new, np.float64)
    return dist_new, dsi_new, l


# -- the counting engine's library (bam.cpp) --------------------------------

def _configure_bam(lib) -> None:
    from ctypes import POINTER, c_char_p, c_int, c_int32, c_int64, c_uint8, \
        c_uint64, c_void_p
    lib.vtpu_bam_open.restype = c_void_p
    lib.vtpu_bam_open.argtypes = [c_char_p]
    lib.vtpu_bam_close.argtypes = [c_void_p]
    lib.vtpu_bam_close.restype = None
    lib.vtpu_bam_n_refs.argtypes = [c_void_p]
    lib.vtpu_bam_n_refs.restype = c_int64
    lib.vtpu_bam_ref_name.argtypes = [c_void_p, c_int64]
    lib.vtpu_bam_ref_name.restype = c_char_p
    lib.vtpu_bam_read_batch.restype = c_int64
    lib.vtpu_bam_read_batch.argtypes = [
        c_void_p,           # handle
        c_int64,            # max_reads
        c_int64,            # max_segs per read
        c_char_p, c_char_p,  # bc tag (2 chars), umi tag (2 chars)
        POINTER(c_int32),   # out chrom_id (n,)
        POINTER(c_uint8),   # out strand  (n,) 0='+', 1='-'
        POINTER(c_int64),   # out pos     (n,) 1-based
        POINTER(c_int32),   # out n_segs  (n,)
        POINTER(c_int64),   # out seg_start (n, max_segs)
        POINTER(c_int64),   # out seg_end   (n, max_segs)
        POINTER(c_int32),   # out clip5, (n,)
        POINTER(c_int32),   # out clip3  (n,)
        POINTER(c_uint8),   # out ref_skip (n,)
        POINTER(c_uint8),   # out flags_ok (n,) 1 = keep
        c_char_p,           # out bc buffer   (n * 32)
        c_char_p,           # out umi buffer  (n * 32)
        c_int,              # require_unique (NH==1)
        c_char_p,           # aux tag (2 chars) or b""
        c_char_p,           # out aux buffer (n * 32) or None
        c_int32,            # seq prefix length to decode (0 = none)
        c_char_p,           # out seq buffer (n * 32) or None
    ]
    lib.vtpu_bam_sort_by_tag_indexed.restype = c_int64
    lib.vtpu_bam_sort_by_tag_indexed.argtypes = [
        c_char_p, c_char_p, c_char_p,   # src, dst, tag
        c_int64,                        # mem_limit bytes
        c_int32, c_int32,               # n_threads, compression level
        c_char_p,                       # .vtx cell-index path (or None)
    ]
    lib.vtpu_bam_seek_uncompressed.restype = c_int
    lib.vtpu_bam_seek_uncompressed.argtypes = [c_void_p, c_uint64]
    lib.vtpu_bam_set_limit.restype = None
    lib.vtpu_bam_set_limit.argtypes = [c_void_p, c_uint64]
    lib.vtpu_bam_record_offsets.restype = c_int64
    lib.vtpu_bam_record_offsets.argtypes = [
        c_char_p, c_uint64,             # path, stride bytes
        POINTER(c_uint64), c_int64,     # out offsets, max_out
        POINTER(c_int64),               # out n_records
        POINTER(c_uint64),              # out end-of-records offset
    ]
    lib.vtpu_factorize_fixed.restype = c_int64
    lib.vtpu_factorize_fixed.argtypes = [
        c_char_p,                       # keys (n * width bytes)
        c_int64, c_int64,               # n, width
        POINTER(c_int64),               # out codes (n,)
        POINTER(c_int64),               # out firsts (n,)
    ]


def _load():
    """The counting engine's library, built on first call; None (and the
    compiler's error logged once) when it cannot be built or loaded."""
    global _bam_lib, _bam_error
    if _bam_lib is None and _bam_error is None:
        try:
            lib = ctypes.CDLL(str(build_bam()))
            _configure_bam(lib)
            _bam_lib = lib
        except (RuntimeError, OSError) as e:
            _bam_error = str(e)
            logging.warning("native BAM engine unavailable, counting runs "
                            f"its Python/numpy paths: {_bam_error}")
    return _bam_lib


def available() -> bool:
    return _load() is not None


def bam_sort_by_tag(src: str, dst: str, tag: str,
                    mem_limit: int = 4 << 30, n_threads: int = 0,
                    level: int = 1, write_index: bool = True) -> int:
    """Sort a BAM by an aux tag (the `samtools sort -t CB` equivalent).
    External sort with spill runs above mem_limit bytes; BGZF output is
    compressed by a thread pool.  Returns the number of records.

    write_index=True also emits `dst + ".vtx"`: the per-cell
    uncompressed-offset index that lets multi-feeder counting seek each
    feeder straight to its barcode range (see read_tag_index)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native BAM engine not available")
    if n_threads <= 0:
        n_threads = max(1, (os.cpu_count() or 2) - 1)
    ix = (dst + ".vtx").encode() if write_index else None
    n = lib.vtpu_bam_sort_by_tag_indexed(src.encode(), dst.encode(),
                                         tag.encode()[:2], mem_limit,
                                         n_threads, level, ix)
    if n < 0:
        raise IOError(f"native BAM sort failed for {src}")
    return int(n)


def read_tag_index(path: str):
    """Parse a `.vtx` cell index: returns (keys list[bytes], offsets
    np.uint64 (n+1,)) where offsets[i] is the uncompressed stream offset
    of the first record with tag value keys[i] and offsets[-1] is the
    end-of-records offset.  Returns None if absent, invalid, or STALE:
    the VTX2 header records the compressed size of the BAM it was
    written with, and a mismatch (e.g. the BAM was re-sorted by a tool
    that writes no index) rejects the index rather than seeking into
    the wrong stream."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if len(data) < 12 or data[:4] != b"VTX2":
        return None
    (bam_size,) = struct.unpack_from("<Q", data, 4)
    bam_path = path[:-4] if path.endswith(".vtx") else None
    try:
        if bam_path is None or os.path.getsize(bam_path) != bam_size:
            return None
    except OSError:
        return None
    keys, offs = [], []
    p = 12
    while p + 12 <= len(data):
        klen, off = struct.unpack_from("<IQ", data, p)
        p += 12
        if klen == 0xFFFFFFFF:          # terminal entry
            offs.append(off)
            return keys, np.asarray(offs, dtype=np.uint64)
        if p + klen > len(data):
            return None
        keys.append(data[p:p + klen])
        p += klen
        offs.append(off)
    return None                          # missing terminal entry


def bam_record_ranges(path: str, n_ranges: int,
                      stride: Optional[int] = None):
    """Split a BAM's record stream into `n_ranges` contiguous
    (ustart, uend) uncompressed ranges at record boundaries, for ranged
    parallel scans of an un-indexed (e.g. position-sorted) BAM.  One
    native pass walks record length prefixes only (inflate-bound, no
    field/tag parse, no python).  Returns a list of ranges covering
    [first record, end-of-records), or None when the native library is
    unavailable or the scan fails.

    Unlike the JAX package's copy, it returns min(n_ranges, records)
    ranges whatever the file's size: bam.cpp keeps at most
    MAX_BOUNDARIES boundaries spread over the whole stream, and each cut
    is the boundary nearest its ideal split point."""
    lib = _load()
    if lib is None:
        return None
    if stride is None:
        # ~8 candidate boundaries per range; the compressed size is a
        # conservative lower bound on the uncompressed span
        try:
            csize = os.path.getsize(path)
        except OSError:
            return None
        stride = max(4096, min(8 << 20, csize // (8 * max(1, n_ranges))))
    out = np.zeros(MAX_BOUNDARIES, dtype=np.uint64)
    n_records = ctypes.c_int64(0)
    u_end = ctypes.c_uint64(0)
    n = lib.vtpu_bam_record_offsets(
        path.encode(), ctypes.c_uint64(max(1, int(stride))),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), MAX_BOUNDARIES,
        ctypes.byref(n_records), ctypes.byref(u_end))
    if n <= 0:
        return None
    offs = out[:n].astype(np.int64)
    end = int(u_end.value)
    n_ranges = max(1, min(int(n_ranges), int(n)))
    span = end - int(offs[0])
    cuts = [0]                    # indices into offs, strictly increasing
    for i in range(1, n_ranges):
        target = int(offs[0]) + span * i // n_ranges
        j = int(np.searchsorted(offs, target))
        if j > 0 and (j == n or target - offs[j - 1] <= offs[j] - target):
            j -= 1                # the nearer of the two neighbours
        # leave one boundary for each cut still to place
        cuts.append(min(max(j, cuts[-1] + 1), int(n) - (n_ranges - i)))
    bounds = [int(offs[j]) for j in cuts] + [end]
    return [(bounds[i], bounds[i + 1]) for i in range(n_ranges)]


def factorize_fixed(arr: np.ndarray
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(uniques, codes) for a fixed-width numpy bytes array (dtype S*),
    exact (open-addressing hash + memcmp), uniques in first-appearance
    order.  Returns None when the native library is absent."""
    lib = _load()
    if lib is None:
        return None
    from ctypes import POINTER, c_char_p, c_int64, cast
    arr = np.ascontiguousarray(arr)
    n = len(arr)
    width = arr.dtype.itemsize
    codes = np.empty(n, np.int64)
    firsts = np.empty(n, np.int64)
    k = lib.vtpu_factorize_fixed(
        cast(arr.ctypes.data, c_char_p), n, width,
        codes.ctypes.data_as(POINTER(c_int64)),
        firsts.ctypes.data_as(POINTER(c_int64)))
    return arr[firsts[:k]], codes
