# Copy of velocyto_tpu/counting/fastio.py; imports nothing of the JAX package.
"""Batched structure-of-arrays BAM decoding (the counting fast path).

The reference decodes one pysam AlignedSegment at a time and builds a
Python object per read (velocyto/counter.py:217-306).  Here the native
C++ decoder (velocyto_tpu_torch/native/bam.cpp: vtpu_bam_read_batch) inflates
BGZF blocks and decodes alignment records straight into preallocated
numpy arrays -- including the CIGAR->segments parse with small-indel
patching (reference counter.py:85-129 semantics) -- so the counting
pipeline never touches per-read Python objects.

A pure-Python producer (`_python_soa_batches`) builds byte-identical
batches from bamio.BamReader; it is the fallback when libvtpu is absent
and the differential-test oracle for the native decoder.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from .. import native
from . import bamio
from .reads import parse_cigar_tuple

MAX_SEGS = 16         # segments per read (reads with more are dropped+logged)
BC_BYTES = 32         # bc/umi tag buffers (fixed-width S32)


@dataclass
class ReadBatch:
    """One decoded batch, structure-of-arrays.  `ok[i] == 0` marks records
    that must be skipped (unmapped / NH!=1 / CIGAR overflow) but still
    occupy a slot so the arrays stay aligned with the BAM stream."""
    chrom_id: np.ndarray   # (n,) int32 - index into `refs`
    strand: np.ndarray     # (n,) uint8 - 0 = '+', 1 = '-'
    pos: np.ndarray        # (n,) int64 - 1-based leftmost
    n_segs: np.ndarray     # (n,) int32
    seg_start: np.ndarray  # (n, MAX_SEGS) int64
    seg_end: np.ndarray    # (n, MAX_SEGS) int64
    clip5: np.ndarray      # (n,) int32
    clip3: np.ndarray      # (n,) int32
    ref_skip: np.ndarray   # (n,) uint8 - 1 if the CIGAR had an N op
    ok: np.ndarray         # (n,) uint8
    bc: np.ndarray         # (n,) S{BC_BYTES} raw barcode tag ("" if absent)
    umi: np.ndarray        # (n,) S{BC_BYTES} raw umi tag ("" if absent)
    aux: np.ndarray        # (n,) S{BC_BYTES} aux tag (GX for Gene umi
                           # extension; "" when no aux tag requested)
    seq: np.ndarray        # (n,) S{BC_BYTES} first seq bases (Nbp umi
                           # extension; "" when not requested)

    def __len__(self) -> int:
        return len(self.pos)

    @property
    def seg_mask(self) -> np.ndarray:
        """(n, MAX_SEGS) bool: valid segment slots."""
        return np.arange(self.seg_start.shape[1])[None, :] < \
            self.n_segs[:, None]

    @staticmethod
    def concatenate(parts: List["ReadBatch"]) -> "ReadBatch":
        """Concatenate parts that may carry different segment-table
        widths (copies are width-trimmed); the result uses the max
        width, trailing slots left unspecified (only slots < n_segs are
        meaningful)."""
        scalars = ("chrom_id", "strand", "pos", "n_segs", "clip5", "clip3",
                   "ref_skip", "ok", "bc", "umi", "aux", "seq")
        out = {f: np.concatenate([getattr(p, f) for p in parts])
               for f in scalars}
        w = max(p.seg_start.shape[1] for p in parts)
        n = len(out["pos"])
        ss = np.empty((n, w), parts[0].seg_start.dtype)
        se = np.empty((n, w), parts[0].seg_end.dtype)
        at = 0
        for p in parts:
            m, pw = p.seg_start.shape
            ss[at:at + m, :pw] = p.seg_start
            se[at:at + m, :pw] = p.seg_end
            at += m
        return ReadBatch(out["chrom_id"], out["strand"], out["pos"],
                         out["n_segs"], ss, se, out["clip5"], out["clip3"],
                         out["ref_skip"], out["ok"], out["bc"], out["umi"],
                         out["aux"], out["seq"])

    def slice(self, lo: int, hi: int) -> "ReadBatch":
        return ReadBatch(self.chrom_id[lo:hi], self.strand[lo:hi],
                         self.pos[lo:hi], self.n_segs[lo:hi],
                         self.seg_start[lo:hi], self.seg_end[lo:hi],
                         self.clip5[lo:hi], self.clip3[lo:hi],
                         self.ref_skip[lo:hi], self.ok[lo:hi],
                         self.bc[lo:hi], self.umi[lo:hi], self.aux[lo:hi],
                         self.seq[lo:hi])

    def copy_range(self, lo: int, hi: int) -> "ReadBatch":
        """Materialized copy of rows [lo, hi) with the segment table
        trimmed to the range's max segment count.  Use instead of
        slice() when the rows are kept past the next read_batch() call
        (readers reuse their buffers)."""
        ns = self.n_segs[lo:hi].copy()
        w = max(1, int(ns.max())) if len(ns) else 1
        return ReadBatch(self.chrom_id[lo:hi].copy(),
                         self.strand[lo:hi].copy(), self.pos[lo:hi].copy(),
                         ns, np.ascontiguousarray(self.seg_start[lo:hi, :w]),
                         np.ascontiguousarray(self.seg_end[lo:hi, :w]),
                         self.clip5[lo:hi].copy(), self.clip3[lo:hi].copy(),
                         self.ref_skip[lo:hi].copy(), self.ok[lo:hi].copy(),
                         self.bc[lo:hi].copy(), self.umi[lo:hi].copy(),
                         self.aux[lo:hi].copy(), self.seq[lo:hi].copy())

    def take(self, idx: np.ndarray) -> "ReadBatch":
        """Gather rows by index array or boolean mask (always a copy);
        the segment table is trimmed to the gathered max width."""
        ns = self.n_segs[idx]
        w = max(1, int(ns.max())) if len(ns) else 1
        return ReadBatch(self.chrom_id[idx], self.strand[idx],
                         self.pos[idx], ns,
                         self.seg_start[:, :w][idx],
                         self.seg_end[:, :w][idx],
                         self.clip5[idx], self.clip3[idx],
                         self.ref_skip[idx], self.ok[idx],
                         self.bc[idx], self.umi[idx], self.aux[idx],
                         self.seq[idx])


# -- reusable batch buffers -------------------------------------------------
# First-touch page faults make fresh multi-MB allocations expensive; every
# reader borrows its decode buffer from this pool and returns it on close,
# so a whole multi-file, multi-pass counting run touches each page once.

_BUF_POOL: List[ReadBatch] = []


def _alloc_batch(n: int) -> ReadBatch:
    return ReadBatch(
        chrom_id=np.zeros(n, np.int32), strand=np.zeros(n, np.uint8),
        pos=np.zeros(n, np.int64), n_segs=np.zeros(n, np.int32),
        seg_start=np.zeros((n, MAX_SEGS), np.int64),
        seg_end=np.zeros((n, MAX_SEGS), np.int64),
        clip5=np.zeros(n, np.int32), clip3=np.zeros(n, np.int32),
        ref_skip=np.zeros(n, np.uint8), ok=np.zeros(n, np.uint8),
        bc=np.zeros(n, f"S{BC_BYTES}"), umi=np.zeros(n, f"S{BC_BYTES}"),
        aux=np.zeros(n, f"S{BC_BYTES}"), seq=np.zeros(n, f"S{BC_BYTES}"))


def _acquire_batch(n: int) -> ReadBatch:
    for i, b in enumerate(_BUF_POOL):
        if len(b.pos) >= n:
            return _BUF_POOL.pop(i)
    return _alloc_batch(n)


def _release_batch(b: Optional[ReadBatch]) -> None:
    if b is not None and len(_BUF_POOL) < 2:
        _BUF_POOL.append(b)


class NativeBamReader:
    """Streaming SoA reader over libvtpu's BGZF/BAM decoder."""

    def __init__(self, path: str, bc_tag: str, umi_tag: str,
                 require_unique: bool, aux_tag: str = "",
                 seq_prefix: int = 0, byte_range=None) -> None:
        """byte_range: optional (ustart, uend) UNCOMPRESSED stream
        offsets (record boundaries from the .vtx cell index) -- the
        reader seeks to ustart and reports EOF at uend, so a feeder
        decodes only its owned slice of the BAM."""
        lib = native._load()
        if lib is None:
            raise RuntimeError("libvtpu not available")
        self._lib = lib
        self._h = lib.vtpu_bam_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open BAM file {path}")
        if byte_range is not None:
            ustart, uend = byte_range
            if lib.vtpu_bam_seek_uncompressed(self._h, int(ustart)) != 0:
                raise IOError(
                    f"cannot seek to offset {ustart} in {path}")
            lib.vtpu_bam_set_limit(self._h, int(uend))
        n = lib.vtpu_bam_n_refs(self._h)
        self.references = [lib.vtpu_bam_ref_name(self._h, i).decode()
                           for i in range(n)]
        self._bc_tag = bc_tag.encode()[:2]
        self._umi_tag = umi_tag.encode()[:2]
        self._aux_tag = aux_tag.encode()[:2]
        self._seq_prefix = int(seq_prefix)
        self._unique = int(require_unique)
        # two rotating decode buffers: batch k stays valid while batch
        # k+1 decodes (what PrefetchReader's overlap relies on)
        self._bufs: List[Optional[ReadBatch]] = [None, None]
        self._turn = 0

    def read_batch(self, max_reads: int = 1 << 18) -> Optional[ReadBatch]:
        """Decode the next batch.  The returned ReadBatch is a VIEW into
        buffers owned by the reader and is invalidated by the SECOND
        following read_batch() call (buffers rotate pairwise) -- use
        ReadBatch.copy_range()/take() for rows that are kept longer
        (fresh large allocations are expensive; reuse keeps the decode
        loop allocation-free)."""
        n = max_reads
        self._turn ^= 1
        if self._bufs[self._turn] is None or \
                len(self._bufs[self._turn].pos) < n:
            _release_batch(self._bufs[self._turn])
            self._bufs[self._turn] = _acquire_batch(n)
        b = self._bufs[self._turn]
        from ctypes import POINTER, c_int32, c_int64, c_uint8, c_char_p

        def p(arr, ct):
            return arr.ctypes.data_as(POINTER(ct))

        got = self._lib.vtpu_bam_read_batch(
            self._h, n, MAX_SEGS, self._bc_tag, self._umi_tag,
            p(b.chrom_id, c_int32), p(b.strand, c_uint8), p(b.pos, c_int64),
            p(b.n_segs, c_int32), p(b.seg_start, c_int64),
            p(b.seg_end, c_int64), p(b.clip5, c_int32), p(b.clip3, c_int32),
            p(b.ref_skip, c_uint8), p(b.ok, c_uint8),
            ctypes.cast(b.bc.ctypes.data, c_char_p),
            ctypes.cast(b.umi.ctypes.data, c_char_p), self._unique,
            self._aux_tag,
            ctypes.cast(b.aux.ctypes.data, c_char_p)
            if self._aux_tag else None,
            self._seq_prefix,
            ctypes.cast(b.seq.ctypes.data, c_char_p)
            if self._seq_prefix else None)
        if got < 0:
            raise IOError("corrupt BAM stream (native decoder)")
        if got == 0:
            return None
        return b.slice(0, int(got))

    def close(self) -> None:
        if self._h:
            self._lib.vtpu_bam_close(self._h)
            self._h = None
        for i, b in enumerate(self._bufs):
            _release_batch(b)
            self._bufs[i] = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


class PrefetchReader:
    """Decode-ahead wrapper: while the consumer processes batch k, a
    worker thread decodes batch k+1 (the ctypes call into libvtpu
    releases the GIL, so decode genuinely overlaps the python/numpy
    counting work; measured ~25-30% off the two-pass counting wall).

    Safe because NativeBamReader rotates two buffers: the batch handed
    to the consumer is not touched by the in-flight decode.  The
    prefetched batch is decoded with the max_reads of the PREVIOUS
    call; both counting passes use a constant batch size."""

    def __init__(self, inner) -> None:
        import concurrent.futures
        self._inner = inner
        self.references = inner.references
        self._ex = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="vtpu-decode")
        self._fut = None
        self._done = False

    def read_batch(self, max_reads: int = 1 << 18) -> Optional[ReadBatch]:
        if self._done:
            return None
        if self._fut is None:
            rb = self._inner.read_batch(max_reads)
        else:
            rb = self._fut.result()
            self._fut = None
        if rb is None:
            self._done = True
            return None
        self._fut = self._ex.submit(self._inner.read_batch, max_reads)
        return rb

    def close(self) -> None:
        if self._fut is not None:
            try:
                self._fut.result()
            except Exception:
                pass
            self._fut = None
        self._ex.shutdown(wait=True)
        self._inner.close()


class PythonBamReader:
    """Pure-python SoA producer with semantics identical to
    NativeBamReader (fallback + differential-test oracle)."""

    def __init__(self, path: str, bc_tag: str, umi_tag: str,
                 require_unique: bool, aux_tag: str = "",
                 seq_prefix: int = 0) -> None:
        self._reader = bamio.BamReader(path)
        self.references = list(self._reader.references)
        self._it = iter(self._reader)
        self._bc_tag = bc_tag
        self._umi_tag = umi_tag
        self._aux_tag = aux_tag
        self._seq_prefix = int(seq_prefix)
        self._unique = require_unique
        self._buf: Optional[ReadBatch] = None

    def read_batch(self, max_reads: int = 1 << 18) -> Optional[ReadBatch]:
        """Same buffer-reuse contract as NativeBamReader.read_batch."""
        n = max_reads
        if self._buf is None or len(self._buf.pos) < n:
            _release_batch(self._buf)
            self._buf = _acquire_batch(n)
        b = self._buf
        i = 0
        for rec in self._it:
            b.chrom_id[i] = rec.ref_id
            b.strand[i] = 1 if rec.is_reverse else 0
            b.pos[i] = rec.pos + 1
            b.n_segs[i] = 0
            b.ok[i] = 0
            b.bc[i] = b""
            b.umi[i] = b""
            b.clip5[i] = 0
            b.clip3[i] = 0
            b.ref_skip[i] = 0
            if self._aux_tag:
                b.aux[i] = b""
            if self._seq_prefix:
                b.seq[i] = b""
            if not rec.is_unmapped and \
                    not (self._unique and rec.tags.get("NH", 1) != 1):
                segments, ref_skip, clip5, clip3 = parse_cigar_tuple(
                    rec.cigar, rec.pos + 1)
                if len(segments) <= MAX_SEGS:
                    b.n_segs[i] = len(segments)
                    for s, seg in enumerate(segments):
                        b.seg_start[i, s] = seg[0]
                        b.seg_end[i, s] = seg[1]
                    b.clip5[i] = clip5
                    b.clip3[i] = clip3
                    b.ref_skip[i] = 1 if ref_skip else 0
                    b.bc[i] = rec.tags.get(self._bc_tag, "").encode() \
                        if isinstance(rec.tags.get(self._bc_tag, ""), str) \
                        else b""
                    b.umi[i] = rec.tags.get(self._umi_tag, "").encode() \
                        if isinstance(rec.tags.get(self._umi_tag, ""), str) \
                        else b""
                    if self._aux_tag:
                        av = rec.tags.get(self._aux_tag, "")
                        b.aux[i] = av.encode() if isinstance(av, str) else b""
                    if self._seq_prefix:
                        b.seq[i] = rec.seq[:min(self._seq_prefix, 31)] \
                            .encode()
                    b.ok[i] = 1
            i += 1
            if i >= n:
                break
        if i == 0:
            return None
        return b.slice(0, i)

    def close(self) -> None:
        _release_batch(self._buf)
        self._buf = None


def open_soa_reader(path: str, bc_tag: str, umi_tag: str,
                    require_unique: bool, aux_tag: str = "",
                    seq_prefix: int = 0, byte_range=None):
    """Native SoA reader when libvtpu is available, else the Python one.
    The native reader is wrapped in PrefetchReader (decode/compute
    overlap); set VELOCYTO_NO_PREFETCH=1 to disable.  byte_range (native
    only): decode just the (ustart, uend) uncompressed slice."""
    import os
    if native.available():
        r = NativeBamReader(path, bc_tag, umi_tag, require_unique,
                            aux_tag, seq_prefix, byte_range=byte_range)
        if os.environ.get("VELOCYTO_NO_PREFETCH", "") not in ("", "0"):
            return r
        return PrefetchReader(r)
    if byte_range is not None:
        raise RuntimeError("byte_range decoding needs libvtpu")
    return PythonBamReader(path, bc_tag, umi_tag, require_unique, aux_tag,
                           seq_prefix)


def soa_batches(path: str, bc_tag: str, umi_tag: str, require_unique: bool,
                batch_size: int = 1 << 18) -> Iterator[ReadBatch]:
    r = open_soa_reader(path, bc_tag, umi_tag, require_unique)
    try:
        while True:
            b = r.read_batch(batch_size)
            if b is None:
                return
            yield b
    finally:
        r.close()
