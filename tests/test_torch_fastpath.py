"""The port's SoA fast path (native decoder + vectorized passes) on
written BAM files: native and Python readers agree, the fast path equals
the port's object mode and the JAX package's engine bitwise, pcount
equals count (spawned workers that unpickle the port's ExInCounter), the
native sorter's .vtx index is read across the two packages, and the
repaired record-range split (reference fault R4) keeps its ranges even."""
import numpy as np
import pytest

import velocyto_tpu as vt
from velocyto_tpu import native as jnative
from velocyto_tpu.counting.counter import ExInCounter as JCounter
from velocyto_tpu_torch import native
from velocyto_tpu_torch.commands._run import _internal_cellsort
from velocyto_tpu_torch.counting import bamio
from velocyto_tpu_torch.counting.counter import ExInCounter
from velocyto_tpu_torch.counting.fastio import (NativeBamReader,
                                                PythonBamReader)
from velocyto_tpu_torch.counting.logics import LOGICS

ALL_LOGICS = ["Permissive10X", "Intermediate10X", "ValidatedIntrons10X",
              "Stricter10X", "ObservedSpanning10X", "Discordant10X",
              "SmartSeq2"]


def _gtf_line(chrom, start, end, strand, trid, gene, exno):
    tags = (f'gene_id "{gene}"; transcript_id "{trid}"; '
            f'gene_name "{gene}_n"; exon_number "{exno}";')
    return f"{chrom}\ttest\texon\t{start}\t{end}\t.\t{strand}\t.\t{tags}\n"


@pytest.fixture
def annotation(tmp_path):
    rng = np.random.RandomState(7)
    lines, genes, pos = [], [], 1000
    for g in range(12):
        chrom = "1" if g < 8 else "2"
        strand = "+" if g % 2 == 0 else "-"
        nex = rng.randint(2, 5)
        exons, p = [], pos
        for _ in range(nex):
            ln = rng.randint(100, 300)
            exons.append((p, p + ln - 1))
            p += ln + rng.randint(150, 900)
        for i, (s, e) in enumerate(exons):
            exno = i + 1 if strand == "+" else nex - i
            lines.append(_gtf_line(chrom, s, e, strand, f"T{g}", f"G{g}",
                                   exno))
        genes.append((chrom, strand, exons))
        pos = p + 2000
    path = str(tmp_path / "ann.gtf")
    with open(path, "w") as f:
        f.writelines(lines)
    return path, genes


def _random_bam(tmp_path, genes, seed, n_reads=600, n_cells=12,
                suffix=False, name="t.bam", extra_tags=None):
    """Position-sorted BAM of junction, intronic, exonic and
    boundary-spanning reads (tests/test_fastpath.py's recipe), written
    with the port's bamio."""
    rng = np.random.RandomState(seed)
    bcs = [f"C{c:03d}" + ("-1" if suffix else "") for c in range(n_cells)]
    recs = []
    for n in range(n_reads):
        bc = bcs[rng.randint(n_cells)]
        umi = f"U{rng.randint(300):04d}"
        chrom, strand, exons = genes[rng.randint(len(genes))]
        flag = 0 if rng.rand() < 0.5 else 16
        tags = {"CB": bc, "UB": umi, "NH": 1}
        if extra_tags is not None:
            tags.update(extra_tags(rng))
        kind = rng.rand()
        ref_id = 0 if chrom == "1" else 1
        seq = "".join(rng.choice(list("ACGT"), 98))
        if kind < 0.4 and len(exons) >= 2:
            ei = rng.randint(len(exons) - 1)
            s0, e0 = exons[ei]
            s1, _e1 = exons[ei + 1]
            half = rng.randint(15, min(48, e0 - s0))
            cig = [(0, half), (3, s1 - e0 - 1), (0, 98 - half)]
            recs.append(bamio.BamRecord(f"r{n}", flag, ref_id, e0 - half,
                                        cig, tags, seq=seq))
        elif kind < 0.75:
            ei = rng.randint(len(exons) - 1)
            istart, iend = exons[ei][1] + 1, exons[ei + 1][0] - 1
            if iend - istart < 110:
                continue
            recs.append(bamio.BamRecord(
                f"r{n}", flag, ref_id, rng.randint(istart, iend - 100),
                [(0, 98)], tags, seq=seq))
        elif kind < 0.9:
            ei = rng.randint(len(exons))
            s0, e0 = exons[ei]
            start = s0 if e0 - s0 < 110 else rng.randint(s0, e0 - 100)
            recs.append(bamio.BamRecord(f"r{n}", flag, ref_id, start,
                                        [(0, 98)], tags, seq=seq))
        else:
            ei = rng.randint(len(exons))
            s0, e0 = exons[ei]
            cig = [(4, 5), (0, 90)] if rng.rand() < 0.3 else [(0, 95)]
            recs.append(bamio.BamRecord(f"r{n}", flag, ref_id,
                                        max(0, e0 - 40), cig, tags,
                                        seq=seq[:95]))
    recs.sort(key=lambda r: (r.ref_id, r.pos))
    path = str(tmp_path / name)
    bamio.write_bam(path, [("1", 200000), ("2", 200000)], recs)
    return path, [b.split("-")[0] for b in bcs]


def _cellsort(tmp_path, bam, name="cs.bam"):
    out = str(tmp_path / name)
    _internal_cellsort(bam, out, "CB")
    return out


def _run_two_pass(cls, counter_args, gtf, bam_sorted, bam_pos,
                  mask_gtf=None, force_object=False, n_processes=1):
    counter = cls(**counter_args)
    if force_object:
        counter._fastpath_ok = lambda: False
    counter.peek(bam_pos)
    counter.read_transcriptmodels(gtf)
    if mask_gtf:
        counter.read_repeats(mask_gtf)
    counter.mark_up_introns([bam_pos], multimap=False)
    if n_processes > 1:
        d, bcs = counter.pcount([bam_sorted], multimap=False,
                                cell_batch_size=4, n_processes=n_processes)
    else:
        d, bcs = counter.count([bam_sorted], multimap=False,
                               cell_batch_size=5)
    layers = {k: (np.concatenate(v, axis=1) if v else
                  np.zeros((len(counter.geneid2ix), 0)))
              for k, v in d.items()}
    return layers, bcs


def _assert_equal_runs(a, b, same_order=False):
    la, ba = a
    lb, bb = b
    if same_order:
        assert ba == bb
    assert sorted(ba) == sorted(bb)
    pa, pb = np.argsort(np.array(ba)), np.argsort(np.array(bb))
    total = 0
    for layer in la:
        assert la[layer].dtype == lb[layer].dtype
        np.testing.assert_array_equal(la[layer][:, pa], lb[layer][:, pb],
                                      err_msg=f"layer {layer}")
        total += int(la[layer].sum())
    assert len(ba) > 0 and total > 0, "vacuous comparison"


def _three_engines(args, jargs, gtf, cs, bam, mask=None):
    """Port fast path == port object mode == JAX package's fast path,
    the first and last in the same column order."""
    fast = _run_two_pass(ExInCounter, args, gtf, cs, bam, mask_gtf=mask)
    obj = _run_two_pass(ExInCounter, args, gtf, cs, bam, mask_gtf=mask,
                        force_object=True)
    ref = _run_two_pass(JCounter, jargs, gtf, cs, bam, mask_gtf=mask)
    _assert_equal_runs(fast, obj)
    _assert_equal_runs(fast, ref, same_order=True)


def test_native_engine_is_built_and_used(tmp_path, annotation):
    """The library is built from the port's bam.cpp, and both passes run
    the SoA engine on the native reader."""
    from velocyto_tpu_torch.counting.fastio import (PrefetchReader,
                                                    open_soa_reader)
    assert native.available()
    lib = native.build_bam()
    assert lib.parent == native.BAM_SOURCE.parent / "_build"
    assert lib.name.startswith("libvtt_bam_")
    gtf, genes = annotation
    bam, bcs = _random_bam(tmp_path, genes, seed=0)
    cs = _cellsort(tmp_path, bam)
    c = ExInCounter("s", LOGICS["Permissive10X"], valid_bcset=set(bcs))
    c.peek(bam)
    c.read_transcriptmodels(gtf)
    c.mark_up_introns([bam], multimap=False)
    c.count([cs], multimap=False)
    assert c._soa.readers_opened == ["NativeBamReader", "NativeBamReader"]
    r = open_soa_reader(bam, "CB", "UB", True)
    assert isinstance(r, PrefetchReader)
    r.close()


def test_native_matches_python_soa(tmp_path, annotation):
    gtf, genes = annotation
    bam, _ = _random_bam(tmp_path, genes, seed=0)
    rn = NativeBamReader(bam, "CB", "UB", True, seq_prefix=4)
    rp = PythonBamReader(bam, "CB", "UB", True, seq_prefix=4)
    assert rn.references == rp.references
    n = 0
    while True:
        bn, bp = rn.read_batch(128), rp.read_batch(128)
        if bn is None or bp is None:
            assert bn is None and bp is None
            break
        assert len(bn) == len(bp)
        n += len(bn)
        for f in ("chrom_id", "strand", "pos", "n_segs", "clip5", "clip3",
                  "ref_skip", "ok", "bc", "umi", "seq"):
            np.testing.assert_array_equal(getattr(bn, f), getattr(bp, f),
                                          err_msg=f)
        m = bn.seg_mask
        np.testing.assert_array_equal(bn.seg_start[m], bp.seg_start[m])
        np.testing.assert_array_equal(bn.seg_end[m], bp.seg_end[m])
    rn.close()
    assert n > 300


@pytest.mark.parametrize("logic_name", ALL_LOGICS)
def test_fastpath_matches_object_and_jax(tmp_path, annotation, logic_name):
    gtf, genes = annotation
    bam, bcs = _random_bam(tmp_path, genes, seed=1, suffix=True)
    cs = _cellsort(tmp_path, bam)
    _three_engines(
        dict(sampleid="s", logic=LOGICS[logic_name], valid_bcset=set(bcs)),
        dict(sampleid="s", logic=vt.counting.LOGICS[logic_name],
             valid_bcset=set(bcs)), gtf, cs, bam)


def test_discovery_mode(tmp_path, annotation):
    """No whitelist: barcode accretion and the >80-molecule cell filter."""
    gtf, genes = annotation
    bam, _ = _random_bam(tmp_path, genes, seed=2, n_reads=3000, n_cells=6)
    cs = _cellsort(tmp_path, bam)
    _three_engines(dict(sampleid="s", logic=LOGICS["Permissive10X"]),
                   dict(sampleid="s", logic=vt.Permissive10X),
                   gtf, cs, bam)


@pytest.mark.parametrize("ext", ["chr", "Gene", "4bp"])
def test_umi_extensions(tmp_path, annotation, ext):
    gtf, genes = annotation
    gx = (lambda rng: {"GX": f"G{rng.randint(12)}"} if rng.rand() < 0.7
          else {}) if ext == "Gene" else None
    bam, bcs = _random_bam(tmp_path, genes, seed=3, extra_tags=gx)
    cs = _cellsort(tmp_path, bam)
    _three_engines(
        dict(sampleid="s", logic=LOGICS["Permissive10X"],
             valid_bcset=set(bcs), umi_extension=ext),
        dict(sampleid="s", logic=vt.Permissive10X, valid_bcset=set(bcs),
             umi_extension=ext), gtf, cs, bam)


def test_with_mask(tmp_path, annotation):
    gtf, genes = annotation
    chrom, _strand, exons = genes[0]
    s0, e0 = exons[0]
    mask = str(tmp_path / "mask.gtf")
    with open(mask, "w") as f:
        for strand, rep in (("+", "rep1"), ("-", "rep2")):
            f.write(f'{chrom}\tmask\texon\t{s0 - 20}\t{e0 + 20}\t.\t'
                    f'{strand}\t.\tgene_id "{rep}";\n')
    bam, bcs = _random_bam(tmp_path, genes, seed=4)
    cs = _cellsort(tmp_path, bam)
    for logic in ("Permissive10X", "Discordant10X", "SmartSeq2"):
        _three_engines(
            dict(sampleid="s", logic=LOGICS[logic], valid_bcset=set(bcs)),
            dict(sampleid="s", logic=vt.counting.LOGICS[logic],
                 valid_bcset=set(bcs)), gtf, cs, bam, mask=mask)


def test_onefilepercell_without_umi(tmp_path, annotation):
    """SmartSeq2 mode: one BAM per cell, every read its own molecule."""
    gtf, genes = annotation
    bams = [_random_bam(tmp_path, genes, seed=10 + i, n_reads=200,
                        n_cells=1, name=f"cell{i}.bam")[0] for i in range(3)]
    runs = []
    for cls, logic, obj in ((ExInCounter, LOGICS["SmartSeq2"], False),
                            (ExInCounter, LOGICS["SmartSeq2"], True),
                            (JCounter, vt.SmartSeq2, False)):
        c = cls(sampleid="s", logic=logic, umi_extension="without_umi",
                onefilepercell=True)
        if obj:
            c._fastpath_ok = lambda: False
        c.read_transcriptmodels(gtf)
        c.mark_up_introns(bams, multimap=False)
        d, b = c.count(bams, multimap=False, cell_batch_size=5)
        runs.append(({k: np.concatenate(v, axis=1) for k, v in d.items()},
                     b))
    _assert_equal_runs(runs[0], runs[1])
    _assert_equal_runs(runs[0], runs[2], same_order=True)


def test_pcount_matches_count(tmp_path, annotation):
    """Spawned workers rebuild the port's ExInCounter from its pickle;
    the whitelisted single file takes the .vtx-ranged owners."""
    gtf, genes = annotation
    bam, bcs = _random_bam(tmp_path, genes, seed=5, n_reads=1200,
                           n_cells=20)
    cs = _cellsort(tmp_path, bam)
    assert native.read_tag_index(cs + ".vtx") is not None
    args = dict(sampleid="s", logic=LOGICS["Permissive10X"],
                valid_bcset=set(bcs))
    serial = _run_two_pass(ExInCounter, args, gtf, cs, bam)
    par = _run_two_pass(ExInCounter, args, gtf, cs, bam, n_processes=2)
    assert len(serial[1]) == 20
    _assert_equal_runs(serial, par, same_order=True)


def test_pcount_multifile_and_discovery(tmp_path, annotation):
    """Column order across two files sharing barcodes, in discovery mode
    (hash owners; the <80-molecule filter per cell)."""
    gtf, genes = annotation
    bam1, _ = _random_bam(tmp_path, genes, seed=6, n_reads=2500,
                          n_cells=6, name="a.bam")
    bam2, _ = _random_bam(tmp_path, genes, seed=7, n_reads=2500,
                          n_cells=6, name="b.bam")
    cs1 = _cellsort(tmp_path, bam1, "cs1.bam")
    cs2 = _cellsort(tmp_path, bam2, "cs2.bam")
    runs = []
    for nproc in (1, 2):
        c = ExInCounter(sampleid="s", logic=LOGICS["Permissive10X"])
        c.peek(bam1)
        c.read_transcriptmodels(gtf)
        c.mark_up_introns([bam1, bam2], multimap=False)
        if nproc == 1:
            d, b = c.count([cs1, cs2], multimap=False, cell_batch_size=4)
        else:
            d, b = c.pcount([cs1, cs2], multimap=False, cell_batch_size=4,
                            n_processes=nproc)
        runs.append(({k: np.concatenate(v, axis=1) for k, v in d.items()},
                     b))
    _assert_equal_runs(runs[0], runs[1], same_order=True)


# ---------------------------------------------------------------------------
# native sorter, .vtx index, factorize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sorter", ["port", "jax"])
def test_vtx_index_read_across_packages(tmp_path, annotation, sorter):
    gtf, genes = annotation
    bam, _ = _random_bam(tmp_path, genes, seed=8, suffix=True)
    dst = str(tmp_path / f"cs_{sorter}.bam")
    writer = native if sorter == "port" else jnative
    n = writer.bam_sort_by_tag(bam, dst, "CB")
    mine = native.read_tag_index(dst + ".vtx")
    theirs = jnative.read_tag_index(dst + ".vtx")
    assert mine is not None and theirs is not None
    assert mine[0] == theirs[0] and len(mine[0]) == 12
    np.testing.assert_array_equal(mine[1], theirs[1])
    recs = list(bamio.BamReader(dst))
    assert len(recs) == n
    keys = [r.tags["CB"].encode() for r in recs]
    assert keys == sorted(keys)
    # the index points each cell at its first record
    reader = NativeBamReader(dst, "CB", "UB", False,
                             byte_range=(int(mine[1][3]), int(mine[1][4])))
    rb = reader.read_batch(1 << 12)
    reader.close()
    assert set(rb.bc.tolist()) == {mine[0][3]}


def test_sorters_agree(tmp_path, annotation):
    gtf, genes = annotation
    bam, _ = _random_bam(tmp_path, genes, seed=9)
    a, b = str(tmp_path / "a.bam"), str(tmp_path / "b.bam")
    native.bam_sort_by_tag(bam, a, "CB", mem_limit=20_000)   # spill runs
    jnative.bam_sort_by_tag(bam, b, "CB")
    fa = [(r.name, r.pos, r.tags) for r in bamio.BamReader(a)]
    assert fa == [(r.name, r.pos, r.tags) for r in bamio.BamReader(b)]


def test_factorize_matches_jax():
    rng = np.random.RandomState(0)
    arr = np.array([f"K{rng.randint(50)}".encode() for _ in range(500)],
                   dtype="S6")
    u, codes = native.factorize_fixed(arr)
    ju, jcodes = jnative.factorize_fixed(arr)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(u[codes], arr)


# ---------------------------------------------------------------------------
# R4: record ranges past the boundary cap
# ---------------------------------------------------------------------------

def _spans(ranges):
    return np.array([e - s for s, e in ranges], dtype=np.float64)


@pytest.mark.parametrize("cap", [64, 256])
def test_record_ranges_stay_even_past_the_cap(tmp_path, annotation,
                                              monkeypatch, cap):
    """With stride 1 every record qualifies as a boundary, far more than
    `cap`: the ranges must still cover the stream in comparable spans
    (the JAX package's copy stops recording at its cap and hands the
    whole tail to the last range)."""
    gtf, genes = annotation
    bam, bcs = _random_bam(tmp_path, genes, seed=12, n_reads=3000)
    serial = native.bam_record_ranges(bam, 1, stride=1)
    assert len(serial) == 1
    monkeypatch.setattr(native, "MAX_BOUNDARIES", cap)
    for n_ranges in (2, 4, 7):
        ranges = native.bam_record_ranges(bam, n_ranges, stride=1)
        assert len(ranges) == n_ranges
        assert ranges[0][0] == serial[0][0] and \
            ranges[-1][1] == serial[0][1]
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        spans = _spans(ranges)
        assert spans.max() / spans.min() < 1.5, (n_ranges, spans)

    # the ranged markup over those slices equals the serial one
    from velocyto_tpu_torch.counting.soa_engine import run_markup_pool
    marks = []
    for ranged in (False, True):
        c = ExInCounter("s", LOGICS["Permissive10X"], valid_bcset=set(bcs))
        c.peek(bam)
        c.read_transcriptmodels(gtf)
        if ranged:
            assert run_markup_pool(c, [bam], False, 4, in_process=True)
        else:
            c.mark_up_introns([bam], multimap=False)
        marks.append({k: fa.is_validated.copy()
                      for k, fa in c.feature_indexes.items()})
    assert marks[0].keys() == marks[1].keys()
    assert any(v.any() for v in marks[0].values())
    for k in marks[0]:
        np.testing.assert_array_equal(marks[0][k], marks[1][k], err_msg=k)


def test_record_ranges_match_jax_below_the_cap(tmp_path, annotation):
    gtf, genes = annotation
    bam, _ = _random_bam(tmp_path, genes, seed=13, n_reads=2000)
    for n_ranges in (1, 3):
        mine = native.bam_record_ranges(bam, n_ranges, stride=4096)
        theirs = jnative.bam_record_ranges(bam, n_ranges, stride=4096)
        assert mine[0][0] == theirs[0][0] and mine[-1][1] == theirs[-1][1]
        assert len(mine) == n_ranges


def test_record_ranges_past_the_real_cap(tmp_path):
    """150,000 records at stride 1 bytes: more than MAX_BOUNDARIES
    boundaries.  The JAX package's split (R4) returns 3 of the 4 ranges,
    the last holding over half the stream; the port's returns 4 equal
    ones."""
    recs = [bamio.BamRecord("r", 0, 0, i, [(0, 20)], {})
            for i in range(150_000)]
    bam = str(tmp_path / "many.bam")
    bamio.write_bam(bam, [("1", 10 ** 7)], recs)
    assert native.MAX_BOUNDARIES < len(recs)
    mine = native.bam_record_ranges(bam, 4, stride=1)
    theirs = jnative.bam_record_ranges(bam, 4, stride=1)
    assert mine[0][0] == theirs[0][0] and mine[-1][1] == theirs[-1][1]
    assert len(mine) == 4
    spans = _spans(mine)
    assert spans.max() / spans.min() < 1.01
    assert len(theirs) == 3
    assert _spans(theirs)[-1] > 0.5 * spans.sum()


def test_fallback_is_seen(tmp_path, monkeypatch, caplog):
    """Where bam.cpp does not build, available() is False, the compiler's
    error is logged once, and counting runs the Python reader with the
    same result."""
    import logging
    import os
    broken = tmp_path / "bam.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BAM_SOURCE", broken)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "_bam_lib", None)
    monkeypatch.setattr(native, "_bam_error", None)
    golden = os.path.join(os.path.dirname(__file__), "golden")
    with caplog.at_level(logging.WARNING):
        assert not native.available() and not native.available()
        c = ExInCounter("s", LOGICS["Permissive10X"],
                        valid_bcset={f"C{i:03d}" for i in range(15)})
        c.peek(os.path.join(golden, "cnt_fix.bam"))
        c.read_transcriptmodels(os.path.join(golden, "cnt_ann.gtf"))
        c.mark_up_introns([os.path.join(golden, "cnt_fix.bam")],
                          multimap=False)
        d, cells = c.count([os.path.join(golden, "cnt_fix_cellsorted.bam")],
                           multimap=False, cell_batch_size=5)
    msgs = [r.getMessage() for r in caplog.records
            if "native BAM engine unavailable" in r.getMessage()]
    assert len(msgs) == 1 and "c++ failed" in msgs[0]
    assert c._soa.readers_opened == ["PythonBamReader", "PythonBamReader"]
    want = np.load(os.path.join(golden, "counting_golden.npz"))
    order = np.argsort(cells)
    assert list(np.array(cells)[order]) == list(want["Permissive10X__cells"])
    for layer, arrs in d.items():
        np.testing.assert_array_equal(np.concatenate(arrs, axis=1)[:, order],
                                      want[f"Permissive10X__{layer}"])
