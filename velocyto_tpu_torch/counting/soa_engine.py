# Copy of velocyto_tpu/counting/soa_engine.py; imports nothing of the JAX package.
"""Structure-of-arrays counting passes (the production fast path).

Consumes `fastio.ReadBatch` batches straight from the native decoder and
runs both BAM passes of the counting pipeline without creating a single
per-read Python object:

  pass 1 (markup): intron validation over batched segment arrays
      (reference velocyto/counter.py:622-699);
  pass 2 (count):  cell-batched molecule counting (reference
      counter.py:701-1254) with vectorized repeat-mask filtering, window
      matching (features.FeatureArrays), molecule-key construction and
      the grouped classification tail (molecules.assemble_and_classify).

Semantics are validated against the object-mode engine (objectmode.py)
by differential tests; molecule keys use tuples instead of the
reference's formatted strings (counter.py:193-209) - equality-equivalent
by construction:
    "no"          (bc, umi)
    "chr"         (bc, umi, ref_id, rec.pos // 1e7)
    without_umi   (bc, running read index)  [reference: random placeholder
                  UMI per read -> every read its own molecule]
"""
from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..constants import MATCH_INSIDE, MAX_READ_SPAN
from .fastio import ReadBatch, open_soa_reader
from .molecules import (RecordArrays, build_read_records,
                        F_INTRON, F_EXON, F_VALID, F_SPAN_GATED,
                        F_SPAN_UNGATED)
from .reads import normalize_chrom


def factorize(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(uniques, inverse) with np.unique(return_inverse=True) grouping
    semantics but hash-based (no O(n log n) sort of byte strings).
    Unique ORDER is arbitrary - callers must only rely on the grouping,
    not on sortedness.

    Fixed-width byte keys go through the native exact hash
    (vtpu_factorize_fixed) when available: pandas.factorize boxes every
    S-dtype row into a python bytes object first, which dominated the
    counting profile.  pandas itself is imported lazily: with the native
    library present it is never needed, and its import alone measured
    ~0.8 s (20% of a 1M-read count) on this 2-core box."""
    if arr.dtype.kind in "SV":
        nf = native.factorize_fixed(arr)
        if nf is not None:
            return nf
    try:
        import pandas as _pd
    except ImportError:      # pragma: no cover - pandas is a baked-in dep
        _pd = None
    if _pd is not None:
        codes, uniq = _pd.factorize(arr)
        return np.asarray(uniq), codes
    u, inv = np.unique(arr, return_inverse=True)
    return u, inv


_POOL_ENGINE = None   # per-worker engine for pcount workers


def _init_pool_worker(counter_bytes: bytes) -> None:
    """pcount worker initializer (spawn context): rebuild the engine from
    the pickled ExInCounter.  Spawn, not fork - forking a torch-threaded
    parent risks deadlock in the child (POSIX forbids non-async-signal-
    safe work after fork of a multithreaded process)."""
    global _POOL_ENGINE
    import pickle
    _POOL_ENGINE = SoaEngine(pickle.loads(counter_bytes))


def _pool_count_owner(bamfiles: List[str], multimap: bool,
                      cell_batch_size: int, owner_spec, track_global: bool,
                      byte_ranges=None):
    """Counting worker: runs the serial counting pass over the cells this
    worker owns -- `owner_spec` is either a (wid, nproc) stable-hash
    partition or an explicit frozenset of barcodes (multi-host barcode
    ranges) -- against the initializer-built engine.  With byte_ranges
    the worker decodes only its own .vtx-indexed BAM slice.  Returns
    concatenated per-layer matrices + column order + per-file marks
    (+ the global first-encounter cell order when track_global) + its
    own count-pass wall time."""
    import time
    eng = _POOL_ENGINE
    t0 = time.perf_counter()
    dla, order, marks, glob = eng._count_impl(
        bamfiles, multimap, cell_batch_size, owner=owner_spec,
        track_global=track_global,
        batch_reads=1 << 16,   # small decode batches: fresh processes pay
                               # first-touch faults per page
        byte_ranges=byte_ranges)
    elapsed = time.perf_counter() - t0
    n_genes = len(eng.c.geneid2ix)
    mats = {layer: (np.concatenate(arrs, axis=1) if arrs else
                    np.zeros((n_genes, 0), dtype=eng.c.loom_numeric_dtype))
            for layer, arrs in dla.items()}
    return mats, order, marks, glob, eng.skipped_no_barcode, elapsed


def _pool_markup_task(bamfile: str, multimap: bool, byte_range):
    """Markup worker: scan one (file, byte-range) slice against the
    initializer-built engine, returning the is_validated flags, the
    chromosome visit sequence, barcode accretion, and telemetry deltas.
    Marking is order-independent (a pure OR over feature overlap), so
    slice results merge exactly (merge_markup_results)."""
    import time
    eng = _POOL_ENGINE
    t0 = time.perf_counter()
    skipped_before = eng.skipped_no_barcode
    visits = eng.mark_up_introns([bamfile], multimap,
                                 byte_ranges=[byte_range],
                                 collect_visits=True)
    marks = {key: fa.is_validated.copy()
             for key, fa in eng.c.feature_indexes.items()
             if fa.is_validated.any()}
    return (marks, visits[0],
            set(eng.c.valid_bcset) if not eng.c.filter_mode else None,
            eng.skipped_no_barcode - skipped_before,
            time.perf_counter() - t0)


def merge_markup_results(counter, task_results,
                         task_order: List) -> None:
    """OR-merge ranged markup results into `counter` and validate the
    position-sorted property across slices: per file, the concatenated
    slice visit sequences (adjacent duplicates collapsed -- a chromosome
    may span a slice boundary) must not revisit a chromosome, exactly
    the serial scan's check."""
    per_file_seq: Dict[int, List[str]] = {}
    for (fi, _rng), (marks, visit, bcset, _skipped, _t) in zip(
            task_order, task_results):
        seq = per_file_seq.setdefault(fi, [])
        for name in visit:
            if not seq or seq[-1] != name:
                seq.append(name)
        for key, arr in marks.items():
            fa = counter.feature_indexes[key]
            fa.is_validated |= arr
        if bcset is not None:
            counter.valid_bcset |= bcset
    for fi, seq in per_file_seq.items():
        if len(seq) != len(set(seq)):
            raise IOError("Input .bam file should be sorted. "
                          "(Hint: samtools sort)")
    # sync the per-Feature mirror the object-mode consumers read
    for fa in counter.feature_indexes.values():
        for i in np.flatnonzero(fa.is_validated):
            fa.features[i].is_validated = True


def run_markup_pool(counter, bamfiles: List[str], multimap: bool,
                    n_workers: int, in_process: bool = False) -> bool:
    """Ranged parallel intron-validation markup (pass 1).

    The `.vtx`-style ranged decode that parallelizes counting cannot
    index a position-sorted input, so split points come from a native
    record-boundary scan (inflate + record-length walk only, ~10x
    cheaper than the markup scan).  One spawned worker per slice runs
    the ordinary markup over its byte range; flags OR-merge; the
    chromosome-sorted check composes across slices from the visit
    sequences.  Returns False when ranged decode is unavailable (caller
    falls back to the serial scan).  Total telemetry (skipped reads) is
    summed from per-slice deltas.
    """
    from .. import native
    if not native.available():
        return False
    tasks: List[Tuple[int, Tuple[int, int]]] = []
    for fi, bam in enumerate(bamfiles):
        ranges = native.bam_record_ranges(str(bam), n_workers)
        if ranges is None:
            return False
        tasks.extend((fi, r) for r in ranges)
    if len(tasks) <= 1:
        return False
    import pickle
    soa = counter.__dict__.pop("_soa", None)
    try:
        payload = pickle.dumps(counter, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        if soa is not None:
            counter._soa = soa

    if in_process:
        results = []
        for fi, rng in tasks:
            _init_pool_worker(payload)
            results.append(_pool_markup_task(bamfiles[fi], multimap, rng))
    else:
        import concurrent.futures as cf
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        with cf.ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx,
                                    initializer=_init_pool_worker,
                                    initargs=(payload,)) as pool:
            futs = [pool.submit(_pool_markup_task, bamfiles[fi], multimap,
                                rng) for fi, rng in tasks]
            results = [f.result() for f in futs]
    merge_markup_results(counter, results, tasks)
    eng = counter._soa_engine()
    eng.skipped_no_barcode += sum(r[3] for r in results)
    logging.debug(f"ranged markup: {len(tasks)} slices x "
                  f"{n_workers} workers, slice walls "
                  f"{[round(r[4], 2) for r in results]}")
    return True


def run_owner_pool(counter, bamfiles: List[str], multimap: bool,
                   cell_batch_size: int, owners: List,
                   in_process: bool = False,
                   byte_ranges: Optional[List] = None) -> List:
    """THE parallel-counting mechanism: one worker per ownership spec,
    every worker rebuilt from ONE pickled prepared (GTF-parsed +
    marked-up) counter -- annotation parsing and the intron-validation
    BAM pass happen exactly once, in the caller.

    Used by ExInCounter.pcount (stable-hash owners, single host) and by
    parallel.feeders.count_distributed (barcode-range owners, the
    multi-host layout).  Workers are SPAWNED (fork is unsafe in a
    torch-threaded parent); in_process=True runs them sequentially here
    (dryruns / tests).
    """
    import pickle
    bamfiles = [str(b) for b in bamfiles]
    soa = counter.__dict__.pop("_soa", None)   # engine buffers stay local
    try:
        payload = pickle.dumps(counter, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        if soa is not None:
            counter._soa = soa
    # in ranged mode the caller derives the global order from the .vtx
    # index, so no worker needs to track it; otherwise worker 0 scans
    # everything and records the first-encounter order
    def tg(w):
        return byte_ranges is None and w == 0

    def br(w):
        return byte_ranges[w] if byte_ranges is not None else None

    if in_process or len(owners) == 1:
        results = []
        for w, spec in enumerate(owners):
            _init_pool_worker(payload)
            results.append(_pool_count_owner(bamfiles, multimap,
                                             cell_batch_size, spec, tg(w),
                                             br(w)))
        return results
    import concurrent.futures as cf
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=len(owners), mp_context=ctx,
                                initializer=_init_pool_worker,
                                initargs=(payload,)) as pool:
        futs = [pool.submit(_pool_count_owner, bamfiles, multimap,
                            cell_batch_size, spec, tg(w), br(w))
                for w, spec in enumerate(owners)]
        return [f.result() for f in futs]


def feeder_byte_ranges(bamfile: str, owners: Sequence[frozenset]):
    """Copy of velocyto_tpu/parallel/feeders.py:63 (pcount's ranged plan).

    Per-feeder (ustart, uend) uncompressed byte ranges from the
    `.vtx` cell index next to a (native-sorted) cell-sorted BAM, plus
    the file's serial cell order.  Returns None when the index (or the
    native library) is unavailable -- feeders then full-scan.

    The index maps every raw tag value to the offset of its first
    record; ownership uses gem-group-stripped names, so a feeder's range
    spans [first owned key, one past last owned key] and interleaved
    non-owned cells are filtered by the worker's ownership check."""
    from .. import native
    if not native.available():
        return None
    idx = native.read_tag_index(str(bamfile) + ".vtx")
    if idx is None:
        return None
    keys, offs = idx
    stripped = [k.decode(errors="replace").split("-")[0] for k in keys]
    byte_ranges = []
    for owned in owners:
        pos = [i for i, s in enumerate(stripped) if s in owned]
        if pos:
            rng = (int(offs[min(pos)]), int(offs[max(pos) + 1]))
        else:
            rng = (0, 0)                       # owns nothing in this file
        byte_ranges.append([rng])              # one range per bamfile
    # fold the untagged head of the file (records with no/unknown tag
    # sort first) into the earliest range so the skipped-read telemetry
    # still sees those records
    nonempty = [i for i, r in enumerate(byte_ranges) if r[0][0] < r[0][1]]
    if nonempty:
        first = min(nonempty, key=lambda i: byte_ranges[i][0][0])
        byte_ranges[first] = [(0, byte_ranges[first][0][1])]
    return byte_ranges, stripped


def assemble_owner_results(results: List,
                           name_order: Optional[List[str]] = None) -> Tuple:
    """Map each worker column to its global position in the serial
    first-encounter order.  Returns (col_of {(file_idx, name): (worker,
    col)}, final ordered keys, cell name order).

    name_order: explicit serial cell order (from the .vtx index) for
    ranged single-file runs, where no worker scanned the whole file;
    otherwise worker 0's tracked global order is used."""
    col_of: Dict[Tuple[int, str], Tuple[int, int]] = {}
    for w, (mats, order, marks, _glob, _skipped, *_t) in enumerate(results):
        fi = 0
        for j, name in enumerate(order):
            while fi < len(marks) and j >= marks[fi]:
                fi += 1
            col_of[(fi, name)] = (w, j)
    if name_order is not None:
        seen = set()
        final = []
        for n in name_order:
            key = (0, n)
            if key in col_of and key not in seen:
                seen.add(key)
                final.append(key)
    else:
        global_order = results[0][3]
        final = [key for key in global_order if key in col_of]
    return col_of, final, [name for (_fi, name) in final]


def _last_end(rb: ReadBatch) -> np.ndarray:
    """Per-read end coordinate (end of the last segment)."""
    n = len(rb)
    last = np.maximum(rb.n_segs - 1, 0)
    return rb.seg_end[np.arange(n), last]


def _base_keep(rb: ReadBatch) -> np.ndarray:
    """Decode-valid reads with >=1 segment within the span limit."""
    keep = rb.ok.astype(bool) & (rb.n_segs > 0)
    span = _last_end(rb) - rb.seg_start[:, 0] + 1
    too_long = keep & (span > MAX_READ_SPAN)
    n_long = int(too_long.sum())
    if n_long:
        logging.warning(f"Trashing {n_long} reads, too long span")
    return keep & ~too_long


def _reader_kind(reader) -> str:
    return type(getattr(reader, "_inner", reader)).__name__


class SoaEngine:
    """Stateful driver for the two SoA passes, bound to an ExInCounter."""

    def __init__(self, counter) -> None:
        self.c = counter
        # global chromosome-name table (batches may span files whose
        # BAM headers enumerate references differently)
        self._chrom_names: List[str] = []
        self._chrom_ids: Dict[str, int] = {}
        self.skipped_no_barcode = 0
        # class of every BAM reader the passes opened (NativeBamReader or
        # PythonBamReader), so a caller can show which decoder counted
        self.readers_opened: List[str] = []
        # cache of per-unique-barcode keep/strip decisions
        self._bc_cache: Dict[bytes, Optional[str]] = {}

    # -- shared helpers -------------------------------------------------

    def _global_chrom_map(self, references: List[str]) -> np.ndarray:
        out = np.empty(len(references), dtype=np.int64)
        for i, name in enumerate(references):
            norm = normalize_chrom(name)
            gid = self._chrom_ids.get(norm)
            if gid is None:
                gid = len(self._chrom_names)
                self._chrom_ids[norm] = gid
                self._chrom_names.append(norm)
            out[i] = gid
        return out

    def _strip_bcs(self, rb: ReadBatch) -> Tuple[np.ndarray, np.ndarray]:
        """(keep mask, stripped-barcode name per read (object array)).

        Reproduces iter_alignments barcode handling (reference
        counter.py:255-270): no tag -> skip (counted); strip the gem-group
        suffix; filter-mode membership / discovery-mode accretion.
        """
        c = self.c
        self.skipped_no_barcode += int((rb.bc == b"").sum())
        uniq, inv = factorize(rb.bc)
        keep_u = np.empty(len(uniq), dtype=bool)
        name_u = np.empty(len(uniq), dtype=object)
        for i, b in enumerate(uniq):
            if b in self._bc_cache:
                cached = self._bc_cache[b]
                keep_u[i] = cached is not None
                name_u[i] = cached
                continue
            if not b:
                keep_u[i] = False
                name_u[i] = None
                self._bc_cache[b] = None
                continue
            s = b.decode().split("-")[0]
            if s in c.valid_bcset:
                ok = True
            elif c.filter_mode:
                ok = False
            else:
                c.valid_bcset.add(s)
                ok = True
            keep_u[i] = ok
            name_u[i] = s if ok else None
            self._bc_cache[b] = s if ok else None
        return keep_u[inv], name_u[inv]

    def _check_chrom_sorted(self, cids: np.ndarray, seen: set,
                            cur: List[int],
                            visit: Optional[List[int]] = None) -> None:
        """Position-sorted inputs visit each chromosome once
        (reference counter.py:674-676).  `visit` (optional) records the
        ordered sequence of distinct chromosomes -- ranged parallel
        markup validates the cross-slice ordering from it."""
        if len(cids) == 0:
            return
        change = np.ones(len(cids), dtype=bool)
        change[1:] = cids[1:] != cids[:-1]
        for cid in cids[change]:
            if cid != cur[0]:
                if cid in seen:
                    raise IOError("Input .bam file should be sorted. "
                                  "(Hint: samtools sort)")
                seen.add(int(cid))
                cur[0] = int(cid)
                if visit is not None:
                    visit.append(int(cid))

    def _flat_segments(self, rb: ReadBatch, read_idx: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Flatten the ragged segment table of the selected reads.
        Returns (seg_start, seg_end, seg_read(global row id), counts),
        grouped contiguously per read in read_idx order."""
        ns = rb.n_segs[read_idx]
        w = int(ns.max()) if len(ns) else 1
        if w == 1 and len(ns) and ns.min() == 1:
            # all single-segment (the dominant case): plain column gather
            return (rb.seg_start[read_idx, 0], rb.seg_end[read_idx, 0],
                    read_idx, ns)
        cols = np.arange(w)
        m = cols[None, :] < ns[:, None]
        rows = read_idx[:, None]
        starts = rb.seg_start[rows, cols[None, :]][m]
        ends = rb.seg_end[rows, cols[None, :]][m]
        seg_read = np.repeat(read_idx, ns)
        return starts, ends, seg_read, ns

    # -- pass 1: markup -------------------------------------------------

    def mark_up_introns(self, bamfiles: Iterable[str], multimap: bool,
                        byte_ranges: Optional[List] = None,
                        collect_visits: bool = False
                        ) -> Optional[List[List[str]]]:
        """Intron-validation markup scan.

        byte_ranges: optional per-bamfile (ustart, uend) uncompressed
        record-boundary offsets (native.bam_record_ranges) -- the reader
        decodes only that slice, enabling ranged parallel markup whose
        is_validated flags OR-merge (marking is order-independent).
        collect_visits: also return, per bamfile, the ordered sequence
        of distinct chromosome names visited, so a ranged caller can
        validate the position-sorted property ACROSS slices exactly as
        the serial scan does within one (reference counter.py:674-676).
        """
        c = self.c
        visits: List[List[str]] = []
        for fi, bamfile in enumerate(bamfiles):
            byte_range = byte_ranges[fi] if byte_ranges else None
            if byte_range is not None and byte_range[0] >= byte_range[1]:
                visits.append([])
                continue
            reader = open_soa_reader(
                str(bamfile), c.cellbarcode_str, c.umibarcode_str,
                not multimap,
                aux_tag="GX" if c.umi_extension == "Gene" else "",
                seq_prefix=(c.umi_bp if c.umi_extension == "Nbp" else 0),
                byte_range=byte_range)
            self.readers_opened.append(_reader_kind(reader))
            gmap = self._global_chrom_map(reader.references)
            seen: set = set()
            cur = [-1]
            visit: List[int] = []
            while True:
                rb = reader.read_batch()
                if rb is None:
                    break
                keep = _base_keep(rb)
                if not c.onefilepercell:
                    bc_keep, _names = self._strip_bcs(rb)
                    keep &= bc_keep
                if c.umi_extension != "without_umi":
                    keep &= rb.umi != b""
                self._check_chrom_sorted(rb.chrom_id[keep], seen, cur,
                                         visit if collect_visits else None)
                keep &= rb.ref_skip == 0     # spliced reads don't validate
                key = gmap[rb.chrom_id] * 2 + rb.strand
                for k in np.unique(key[keep]):
                    cs = self._chrom_names[int(k) >> 1] + \
                        ("-" if (int(k) & 1) else "+")
                    fa = c.feature_indexes.get(cs)
                    if fa is None:
                        continue
                    idx = np.flatnonzero(keep & (key == k))
                    ss, ee, _sr, _ns = self._flat_segments(rb, idx)
                    fa.mark_overlapping(ss, ee)
            refs = list(reader.references)
            reader.close()
            if collect_visits:
                # visit holds the file's LOCAL reference ids (that is
                # what _check_chrom_sorted sees); map to names so the
                # parent can compare sequences across slices
                visits.append([refs[cid] for cid in visit])
        logging.debug(f"{self.skipped_no_barcode} reads without barcode "
                      f"skipped")
        return visits if collect_visits else None

    # -- pass 2: counting -----------------------------------------------

    def count(self, bamfiles: Iterable[str], multimap: bool,
              cell_batch_size: int = 100
              ) -> Tuple[Dict[str, List[np.ndarray]], List[str]]:
        dla, order, _marks, _glob = self._count_impl(
            bamfiles, multimap, cell_batch_size)
        return dla, order

    def _count_impl(self, bamfiles: Iterable[str], multimap: bool,
                    cell_batch_size: int = 100,
                    owner=None,
                    track_global: bool = False,
                    batch_reads: int = 1 << 18,
                    byte_ranges=None):
        """Serial counting pass.

        owner: process only owned cells -- either (wid, nproc) stable
        hash (pcount partitioning) or an explicit set of barcodes
        (multi-host ranges).  Per-cell results are identical to the
        unpartitioned run because molecule assembly and the <80-molecule
        filter are per-cell.
        track_global: also record the first-encounter order of ALL kept
        cells (pre-ownership), tagged (file_idx, name), so a pcount
        parent can restore the serial column order.
        byte_ranges: optional per-bamfile (ustart, uend) uncompressed
        offsets from a .vtx cell index -- the reader decodes only that
        slice, so feeders skip the decode of non-owned cells entirely.

        Returns (dict_list_arrays, cell_bcs_order, file_marks,
        global_order) where file_marks[i] = len(cell_bcs_order) after
        file i (columns between marks belong to that file - a barcode
        seen in two input files yields two columns, like the reference's
        per-file batch flush, counter.py:783-788).
        """
        from zlib import crc32
        c = self.c
        import os
        bamfiles = list(bamfiles)
        from collections import Counter as _Counter
        use_basename = (not bamfiles or
                        _Counter(bamfiles).most_common(1)[0][1] == 1)
        cell_bcs_order: List[str] = []
        dict_list_arrays: Dict[str, List[np.ndarray]] = {
            layer: [] for layer in c.logic.layers}

        pend: List[ReadBatch] = []
        pend_bcidx: List[np.ndarray] = []
        cur_cells: Dict[str, int] = {}
        nth = [0]
        mol_serial = [0]   # running counter for without_umi molecule keys
        file_marks: List[int] = []
        global_order: List[Tuple[int, str]] = []
        global_seen: set = set()

        def owned(name: str) -> bool:
            if owner is None:
                return True
            if isinstance(owner, (set, frozenset)):
                return name in owner          # explicit barcode ownership
            wid, nproc = owner                # stable-hash ownership
            return crc32(name.encode()) % nproc == wid

        def flush() -> None:
            nth[0] += 1
            if pend:
                rb_all = ReadBatch.concatenate(pend)
                bcidx = np.concatenate(pend_bcidx)
                bc_list = list(cur_cells.keys())
                logging.debug(f"Counting batch {nth[0]}: {len(bc_list)} "
                              f"cells, {len(rb_all)} reads")
                dlc = self.count_cell_batch(rb_all, bcidx, bc_list)
                c._append_batch_result(dlc, bc_list, dict_list_arrays,
                                       cell_bcs_order)
            pend.clear()
            pend_bcidx.clear()
            cur_cells.clear()

        for fi, bamfile in enumerate(bamfiles):
            label = os.path.basename(bamfile) if use_basename else str(bamfile)
            byte_range = byte_ranges[fi] if byte_ranges else None
            if byte_range is not None and \
                    byte_range[0] >= byte_range[1]:
                file_marks.append(len(cell_bcs_order))
                continue                       # feeder owns nothing here
            reader = open_soa_reader(
                str(bamfile), c.cellbarcode_str, c.umibarcode_str,
                not multimap,
                aux_tag="GX" if c.umi_extension == "Gene" else "",
                seq_prefix=(c.umi_bp if c.umi_extension == "Nbp" else 0),
                byte_range=byte_range)
            self.readers_opened.append(_reader_kind(reader))
            gmap = self._global_chrom_map(reader.references)
            while True:
                rb = reader.read_batch(batch_reads)
                if rb is None:
                    break
                keep = _base_keep(rb)
                if c.umi_extension != "without_umi":
                    keep &= rb.umi != b""
                if c.onefilepercell:
                    names = np.empty(len(rb), dtype=object)
                    names[:] = label
                    bc_keep = np.ones(len(rb), dtype=bool)
                else:
                    bc_keep, names = self._strip_bcs(rb)
                keep &= bc_keep
                # remap chromosomes to the global table before accumulating
                import dataclasses
                rb = dataclasses.replace(
                    rb, chrom_id=gmap[rb.chrom_id].astype(np.int32))
                # cell-contiguous runs (the stream is cell-sorted)
                change = np.ones(len(rb), dtype=bool)
                change[1:] = rb.bc[1:] != rb.bc[:-1]
                run_starts = np.flatnonzero(change)
                run_ends = np.append(run_starts[1:], len(rb))
                for s, e in zip(run_starts, run_ends):
                    krun = keep[s:e]
                    n_keep = int(krun.sum())
                    if n_keep == 0:
                        continue
                    name = names[s] if krun[0] else \
                        names[np.flatnonzero(krun)[0] + s]
                    if track_global and (fi, name) not in global_seen:
                        global_seen.add((fi, name))
                        global_order.append((fi, name))
                    if not owned(name):
                        continue
                    if n_keep == e - s:       # common case: whole run kept
                        part = rb.copy_range(s, e)
                    else:
                        part = rb.take(np.flatnonzero(krun) + s)
                    if name not in cur_cells:
                        if len(cur_cells) == cell_batch_size:
                            flush()
                        cur_cells[name] = len(cur_cells)
                    pend.append(part)
                    pend_bcidx.append(np.full(n_keep, cur_cells[name],
                                              dtype=np.int64))
            reader.close()
            flush()   # file boundary (reference None sentinel)
            file_marks.append(len(cell_bcs_order))
        logging.debug(f"{self.skipped_no_barcode} reads without barcode "
                      f"skipped")
        logging.debug("Counting done!")
        return dict_list_arrays, cell_bcs_order, file_marks, global_order

    # -- parallel counting (the reference's pcount stub, implemented:
    #    reference counter.py:1256-1265 raises NotImplementedError) ------

    def pcount(self, bamfiles: Iterable[str], multimap: bool,
               cell_batch_size: int = 100, n_processes: int = 2
               ) -> Tuple[Dict[str, List[np.ndarray]], List[str]]:
        """Parallel counting by cell-ownership partitioning.

        Each fork-inherited worker decodes the (cheap, native) BAM
        stream itself and counts only the cells whose stable hash it
        owns, so nothing but the final count columns crosses process
        boundaries.  Per-cell results are identical to the serial pass:
        molecule assembly and the <80-molecule filter are per-cell, and
        batch composition has no cross-cell effects.  Worker 0 also
        records the global first-encounter cell order, which the parent
        uses to restore the serial column order exactly.
        """
        if n_processes <= 1:
            return self.count(bamfiles, multimap, cell_batch_size)
        c = self.c
        bamfiles = list(bamfiles)
        owners: List = [(w, n_processes) for w in range(n_processes)]
        byte_ranges = name_order = None
        if c.filter_mode and len(bamfiles) == 1 and not c.onefilepercell:
            # whitelist + .vtx cell index (native-sorted BAM): contiguous
            # barcode-range owners let each worker decode ONLY its slice
            bcs = sorted(c.valid_bcset)
            splits = np.array_split(np.arange(len(bcs)), n_processes)
            range_owners = [frozenset(bcs[i] for i in r) for r in splits]
            plan = feeder_byte_ranges(bamfiles[0], range_owners)
            if plan is not None:
                owners = range_owners
                byte_ranges, name_order = plan
        results = run_owner_pool(c, bamfiles, multimap,
                                 cell_batch_size, owners,
                                 byte_ranges=byte_ranges)
        # ranged workers decode DISJOINT slices (incl. the untagged
        # prefix, folded into the first range): the no-barcode counts
        # sum; in hash mode every worker decodes everything, so worker
        # 0's count is the total
        if byte_ranges is not None:
            self.skipped_no_barcode = sum(r[4] for r in results)
        else:
            self.skipped_no_barcode = results[0][4]
        col_of, final, cell_bcs_order = assemble_owner_results(
            results, name_order=name_order)
        dict_list_arrays: Dict[str, List[np.ndarray]] = {}
        for layer in c.logic.layers:
            out = np.zeros((len(c.geneid2ix), len(final)),
                           dtype=c.loom_numeric_dtype, order="C")
            for k, key in enumerate(final):
                w, j = col_of[key]
                m = results[w][0][layer]
                if m.shape[1]:
                    out[:, k] = m[:, j]
            dict_list_arrays[layer] = [out] if len(final) else []
        logging.debug("Counting done!")
        return dict_list_arrays, cell_bcs_order


    # -- one cell batch, fully vectorized --------------------------------

    def count_cell_batch(self, rb: ReadBatch, read_bcidx: np.ndarray,
                         bc_list: List[str]) -> Dict[str, np.ndarray]:
        from .counter import reverse
        from .logics import NONE, _LAYER_OF_ACTION
        from .molecules import assemble_and_classify
        c = self.c
        n = len(rb)
        shape = (len(c.geneid2ix), len(bc_list))
        dict_layers_columns: Dict[str, np.ndarray] = {
            layer: np.zeros(shape, dtype=c.loom_numeric_dtype, order="C")
            for layer in c.logic.layers}
        if n == 0:
            return dict_layers_columns

        # order reads like the object path (Read.__lt__: chrom, start, end)
        names = np.array(self._chrom_names, dtype=object)
        rank_of = np.argsort(np.argsort(names[:len(self._chrom_names)]
                                        .astype(str)))
        rank = rank_of[rb.chrom_id]
        start = rb.seg_start[:, 0]
        end = _last_end(rb)
        order = np.lexsort((end, start, rank))
        rb = rb.take(order)
        read_bcidx = read_bcidx[order]
        start = start[order]
        end = end[order]

        # molecule ids: factorize (bc, umi[, chrom:pos-window]) into dense
        # integer keys (one bytes-unique for umis + one int64 unique,
        # cheaper than a structured-dtype sort)
        if c.umi_extension == "without_umi":
            # placeholder UMIs: every read is its own molecule
            mol_of_read = np.arange(n, dtype=np.int64)
            mol_bcidx_arr = read_bcidx.astype(np.int64)
            n_mol = n
        else:
            umi_uniq, umi_inv = factorize(rb.umi)
            key = read_bcidx * len(umi_uniq) + umi_inv
            if c.umi_extension == "Nbp":
                # reference: umi + rec.seq[:N] (counter.py:205-206)
                sq_uniq, sq_inv = factorize(rb.seq)
                key = key * len(sq_uniq) + sq_inv
            if c.umi_extension == "Gene":
                # reference: f"{umi}_{GX}" / "{umi}_withoutGX"
                # (counter.py:202-204); missing GX = its own class
                gx_uniq, gx_inv = factorize(rb.aux)
                key = key * len(gx_uniq) + gx_inv
            if c.umi_extension == "chr":
                # reference: f"{umi}_{ref_id}:{rec.pos // 10000000}"
                # (counter.py:200-201); rec.pos is 0-based
                extra = (rb.chrom_id.astype(np.int64) << 16) | \
                    ((rb.pos - 1) // 10_000_000)
                ex_uniq, ex_inv = factorize(extra)
                key = key * len(ex_uniq) + ex_inv
            _uniq, first, inv = np.unique(key, return_index=True,
                                          return_inverse=True)
            mol_of_read = inv.astype(np.int64)
            mol_bcidx_arr = read_bcidx[first].astype(np.int64)
            n_mol = len(first)

        # per chromstrand matching
        stranded = c.logic.stranded
        discordant = c.logic.accept_discordant
        record_parts: List[RecordArrays] = []
        # non-stranded per-batch strand-overlap telemetry
        # (reference counter.py:1151-1154)
        repeats_reads = plus_reads = minus_reads = both_reads = 0
        ckey = rb.chrom_id.astype(np.int64) * 2 + rb.strand
        for k in np.unique(ckey):
            idx = np.flatnonzero(ckey == k)
            chrom = self._chrom_names[int(k) >> 1]
            strand = "-" if (int(k) & 1) else "+"
            rcs = chrom + strand
            rev_cs = chrom + reverse(strand)

            keep_idx, rescue_idx = self._mask_filter_soa(
                rb, idx, rcs, rev_cs, stranded, discordant)

            if stranded and not discordant:
                record_parts.append(self._match_group_soa(
                    rb, keep_idx, c.feature_indexes.get(rcs), rcs,
                    mol_of_read, pseudo_offset=0))
            elif discordant:
                record_parts.append(self._match_group_soa(
                    rb, keep_idx, c.feature_indexes.get(rcs), rcs,
                    mol_of_read, pseudo_offset=0))
                record_parts.append(self._match_group_soa(
                    rb, rescue_idx, c.feature_indexes.get(rev_cs), rev_cs,
                    mol_of_read, pseudo_offset=n))
            else:
                repeats_reads += len(idx) - len(keep_idx)
                part_own = self._match_group_soa(
                    rb, keep_idx, c.feature_indexes.get(rcs), rcs,
                    mol_of_read, pseudo_offset=0)
                part_rev = self._match_group_soa(
                    rb, keep_idx, c.feature_indexes.get(rev_cs), rev_cs,
                    mol_of_read, pseudo_offset=n)
                record_parts.append(part_own)
                record_parts.append(part_rev)
                own_r = np.unique(part_own.rec_read)
                rev_r = np.unique(part_rev.rec_read) - n
                # plus/minus count by FEATURE strand (own group features
                # share the read strand; reverse group features oppose it)
                if strand == "+":
                    plus_reads += len(own_r)
                    minus_reads += len(rev_r)
                else:
                    minus_reads += len(own_r)
                    plus_reads += len(rev_r)
                both_reads += len(np.intersect1d(own_r, rev_r,
                                                 assume_unique=True))
        if not stranded:
            logging.debug(f"{repeats_reads} reads in repeat masked regions")
            logging.debug(f"{plus_reads} reads overlapping with features "
                          f"on plus strand")
            logging.debug(f"{minus_reads} reads overlapping with features "
                          f"on minus strand")
            logging.debug(f"{both_reads} reads overlapping with features "
                          f"on both strands")

        records = RecordArrays.concatenate(record_parts)
        # Classification stays on the host: a device-resident variant
        # (jitted sort + segment reductions) was measured 5-100x SLOWER
        # at realistic batch sizes (5k-200k molecules) - the host pass is
        # a few ms and the records transfer alone dwarfs it - so it was
        # removed (r2; formerly counting/device_classify.py).
        actions, genes, codes = assemble_and_classify(records, c.logic,
                                                      n_mol)
        counted = actions != NONE
        for action_code, layer in _LAYER_OF_ACTION.items():
            if layer not in dict_layers_columns:
                continue
            sel = counted & (actions == action_code)
            if sel.any():
                np.add.at(dict_layers_columns[layer],
                          (genes[sel], mol_bcidx_arr[sel]), 1)

        # categorized molitem-failure telemetry (reference counter.py:854-864)
        failures = int((codes != 0).sum())
        if n_mol and failures > 0.25 * n_mol:
            cnt = np.bincount(codes, minlength=5)
            logging.warning(
                f"More than 20% ({100 * failures / n_mol:.1f}%) of "
                f"molitems trashed, of those:")
            logging.warning(
                f"A situation where many genes were compatible with the "
                f"observation in {100 * cnt[1] / n_mol:.1f} cases")
            logging.warning(
                f"No gene is compatible with the observation in "
                f"{100 * cnt[2] / n_mol:.1f} cases")
            logging.warning(
                f"Observation compatible with more genes "
                f"{100 * cnt[3] / n_mol:.1f} of the cases")
            logging.warning(
                f"Situation that were not described by the logic in the "
                f"{100 * cnt[4] / n_mol:.1f} of the cases")
        return dict_layers_columns

    def _mask_filter_soa(self, rb: ReadBatch, idx: np.ndarray, cs: str,
                         rev_cs: str, stranded: bool, discordant: bool
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized repeat-mask enclosure filter (reference
        counter.py:824-827, 977-982, 1124-1127; indexes.py:81-129:
        EVERY segment must match exactly MATCH_INSIDE)."""
        c = self.c
        ma = c.mask_indexes.get(cs)
        mar = c.mask_indexes.get(rev_cs)
        empty = np.zeros(0, dtype=np.int64)
        if ma is None and mar is None:
            return idx, empty

        ss, ee, _sr, ns = self._flat_segments(rb, idx)
        offs = np.cumsum(ns) - ns

        def enclosed(index_arrays) -> np.ndarray:
            if index_arrays is None or len(idx) == 0:
                return np.zeros(len(idx), dtype=bool)
            mt = index_arrays.segment_matchtype(ss, ee)
            inside = (mt == MATCH_INSIDE).astype(np.int8)
            return np.minimum.reduceat(inside, offs).astype(bool) \
                if len(inside) else np.zeros(len(idx), dtype=bool)

        own_enc = enclosed(ma)
        if stranded and not discordant:
            return idx[~own_enc], empty
        if discordant:
            enc_idx = idx[own_enc]
            if len(enc_idx):
                rev_enc_sub = np.zeros(len(enc_idx), dtype=bool)
                ss2, ee2, _sr2, ns2 = self._flat_segments(rb, enc_idx)
                offs2 = np.cumsum(ns2) - ns2
                if mar is not None and len(ss2):
                    mt2 = mar.segment_matchtype(ss2, ee2)
                    rev_enc_sub = np.minimum.reduceat(
                        (mt2 == MATCH_INSIDE).astype(np.int8),
                        offs2).astype(bool)
                rescue = enc_idx[~rev_enc_sub]
            else:
                rescue = empty
            return idx[~own_enc], rescue
        rev_enc = enclosed(mar)
        return idx[~(own_enc | rev_enc)], empty

    def _match_group_soa(self, rb: ReadBatch, idx: np.ndarray,
                         fa, cs: str, mol_of_read: np.ndarray,
                         pseudo_offset: int) -> RecordArrays:
        """Window-match the selected reads' segments against a feature
        index and build mapping records (mirrors
        ExInCounter._match_group, array-in/array-out)."""
        c = self.c
        empty = RecordArrays(*(np.zeros(0, np.int64),) * 4 +
                             (np.zeros(0, np.int32), np.zeros(0, np.int32)))
        if fa is None or fa.n == 0 or len(idx) == 0:
            return empty
        ss, ee, seg_read, _ns = self._flat_segments(rb, idx)
        if len(ss) == 0:
            return empty
        srow, feat = fa.match_segments(ss, ee)
        if len(feat) == 0:
            return empty
        pairs_read = seg_read[srow]
        tm_local = fa.tm_idx[feat].astype(np.int64)
        pairs_tm = tm_local + c._tm_offset.get(cs, 0)
        pairs_gene = fa.tm_gene_ix[tm_local]
        span_ungated = fa.exin_span_flags(srow, feat, ss, ee)
        validated = fa.is_validated[feat]
        flags = ((fa.kind[feat] == ord("i")) * F_INTRON +
                 (fa.kind[feat] == ord("e")) * F_EXON +
                 validated * F_VALID +
                 (span_ungated & validated) * F_SPAN_GATED +
                 span_ungated * F_SPAN_UNGATED).astype(np.int32)
        seg_spliced = rb.ref_skip.astype(bool)[seg_read][srow]
        # skip_makes_sense on the pair's own segment coordinates
        from ..constants import SPLIC_INACUR
        near = (np.abs(fa.starts[feat] - ss[srow]) <= SPLIC_INACUR) | \
               (np.abs(fa.ends[feat] - ee[srow]) <= SPLIC_INACUR)
        skip_ok = np.where(seg_spliced, near, True)
        mol_map = np.concatenate([mol_of_read, mol_of_read])
        return build_read_records(pairs_read + pseudo_offset, pairs_tm,
                                  pairs_gene, flags, skip_ok, mol_map)
