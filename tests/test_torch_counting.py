"""The port's counting engine (velocyto_tpu_torch.counting) against the
JAX package's on the same inputs: CIGAR, GTF and 3' helpers, the BAM
codec both ways, and the count matrices of test_counting.py's hand reads
and seeded fuzz fixtures for every logic, bitwise.  Also the port's
object-mode engine against its array engine, the --dump report, and the
RDS and metadata round trips."""
import numpy as np
import pytest

import velocyto_tpu as vt
import velocyto_tpu_torch as vtt
from velocyto_tpu.counting import bamio as jbamio
from velocyto_tpu.counting.counter import ExInCounter as JCounter
from velocyto_tpu.counting.reads import Read as JRead
from velocyto_tpu.counting.reads import parse_cigar_tuple as j_parse_cigar
from velocyto_tpu_torch.counting import bamio
from velocyto_tpu_torch.counting.counter import ExInCounter
from velocyto_tpu_torch.counting.logics import LOGICS
from velocyto_tpu_torch.counting.reads import Read, parse_cigar_tuple

ALL_LOGICS = ["Permissive10X", "Intermediate10X", "ValidatedIntrons10X",
              "Stricter10X", "ObservedSpanning10X", "Discordant10X",
              "SmartSeq2"]


# ---------------------------------------------------------------------------
# CIGAR
# ---------------------------------------------------------------------------

CIGARS = [
    [(0, 100)],
    [(0, 50), (3, 200), (0, 50)],
    [(0, 50), (2, 2), (0, 50)],            # small deletion merges
    [(0, 50), (2, 10), (0, 50)],           # large deletion does not
    [(0, 50), (1, 2), (0, 50)],            # insertion merges
    [(4, 10), (0, 50), (4, 5)],            # soft clips advance the cursor
    [(5, 3), (0, 40), (3, 1000), (0, 20), (2, 3), (0, 30), (4, 7)],
    [(0, 30), (1, 4), (0, 10), (3, 50), (0, 25), (7, 5), (8, 3)],
]


@pytest.mark.parametrize("cigar", CIGARS, ids=range(len(CIGARS)))
def test_cigar_matches_jax(cigar):
    assert parse_cigar_tuple(cigar, 1000) == j_parse_cigar(cigar, 1000)


def test_cigar_semantics():
    assert parse_cigar_tuple([(0, 100)], 1000) == ([(1000, 1099)], False,
                                                    0, 0)
    segs, skip, *_ = parse_cigar_tuple([(0, 50), (3, 200), (0, 50)], 1000)
    assert segs == [(1000, 1049), (1250, 1299)] and skip
    segs, *_ = parse_cigar_tuple([(0, 50), (2, 2), (0, 50)], 1000)
    assert segs == [(1000, 1101)]
    segs, skip, c5, c3 = parse_cigar_tuple([(4, 10), (0, 50), (4, 5)], 1000)
    assert (segs, c5, c3) == ([(1010, 1059)], 10, 5)


# ---------------------------------------------------------------------------
# BAM codec, both ways
# ---------------------------------------------------------------------------

def _records(mod):
    return [
        mod.BamRecord("r1", 0, 0, 999, [(0, 100)],
                      {"CB": "AAACCC-1", "UB": "CATCAT", "NH": 1},
                      seq="A" * 100),
        mod.BamRecord("r2", 16, 1, 500, [(0, 30), (3, 100), (0, 20)],
                      {"CB": "GGGTTT-1", "UB": "TGCTGC", "NH": 1},
                      seq="C" * 50),
        mod.BamRecord("r3", 4, -1, -1, [], {"NH": 2}),
    ]


def _fields(reader):
    return [(r.name, r.flag, r.ref_id, r.pos, r.cigar, r.tags, r.seq,
             r.is_reverse, r.is_unmapped) for r in reader]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bam_roundtrip_both_ways(tmp_path, writer):
    refs = [("chr1", 10000), ("chr2", 5000)]
    path = str(tmp_path / "t.bam")
    if writer == "port":
        bamio.write_bam(path, refs, _records(bamio))
    else:
        jbamio.write_bam(path, refs, _records(jbamio))
    mine, theirs = bamio.BamReader(path), jbamio.BamReader(path)
    assert mine.references == theirs.references == ["chr1", "chr2"]
    assert mine.lengths == theirs.lengths
    got = _fields(mine)
    assert got == _fields(theirs)
    assert got[0][0] == "r1" and got[0][3] == 999
    assert got[1][7] and got[1][4] == [(0, 30), (3, 100), (0, 20)]


def test_bam_writer_bytes_match_jax(tmp_path):
    refs = [("chr1", 10000), ("chr2", 5000)]
    a, b = str(tmp_path / "a.bam"), str(tmp_path / "b.bam")
    bamio.write_bam(a, refs, _records(bamio))
    jbamio.write_bam(b, refs, _records(jbamio))
    assert open(a, "rb").read() == open(b, "rb").read()


# ---------------------------------------------------------------------------
# GTF
# ---------------------------------------------------------------------------

def _gtf_line(chrom, ftype, start, end, strand, trid, gene, exno):
    tags = (f'gene_id "{gene}"; transcript_id "{trid}"; '
            f'gene_name "{gene}_name"; transcript_name "{trid}_name"; '
            f'exon_number "{exno}";')
    return f"{chrom}\ttest\t{ftype}\t{start}\t{end}\t.\t{strand}\t.\t{tags}\n"


@pytest.fixture
def small_gtf(tmp_path):
    lines = [
        _gtf_line("1", "exon", 1000, 1200, "+", "A1", "GA", 1),
        _gtf_line("1", "exon", 2000, 2200, "+", "A1", "GA", 2),
        _gtf_line("1", "exon", 3000, 3200, "+", "A1", "GA", 3),
        _gtf_line("1", "exon", 1000, 1200, "+", "A2", "GA", 1),
        _gtf_line("1", "exon", 3000, 3200, "+", "A2", "GA", 2),
        _gtf_line("1", "exon", 6000, 6200, "-", "B1", "GB", 1),
        _gtf_line("1", "exon", 5000, 5200, "-", "B1", "GB", 2),
        _gtf_line("2", "exon", 100, 900, "+", "C1", "GC", 1),
        _gtf_line("1", "exon", 50000, 50500, "+", "E1", "GE", 1),
        _gtf_line("1", "exon", 51000, 51400, "+", "E1", "GE", 2),
    ]
    path = str(tmp_path / "ann.gtf")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def _model_summary(ann):
    return {cs: {tr: [(chr(f.kind), f.exin_no, f.start, f.end)
                      for f in tm.list_features]
                 for tr, tm in d.items()}
            for cs, d in ann.items()}


def test_gtf_parsing_matches_jax(small_gtf):
    port = ExInCounter("s", vtt.Permissive10X)
    ref = JCounter("s", vt.Permissive10X)
    ann = port.read_transcriptmodels(small_gtf)
    assert _model_summary(ann) == _model_summary(
        ref.read_transcriptmodels(small_gtf))
    assert port.geneid2ix == ref.geneid2ix
    info = lambda g: tuple(getattr(g, a) for a in g.__slots__)  # noqa
    assert {k: info(g) for k, g in port.genes.items()} == \
        {k: info(g) for k, g in ref.genes.items()}
    for cs, fa in port.feature_indexes.items():
        fb = ref.feature_indexes[cs]
        for name in ("starts", "ends", "kind", "exin_no", "tm_idx",
                     "tm_gene_ix", "is_validated"):
            np.testing.assert_array_equal(getattr(fa, name),
                                          getattr(fb, name), err_msg=name)
    a1 = ann["1+"]["A1"]
    assert [chr(f.kind) + str(f.exin_no) for f in a1.list_features] == \
        ["e1", "i1", "e2", "i2", "e3"]
    i1 = a1.list_features[1]
    assert i1.get_upstream_exon() is a1.list_features[0]
    assert i1.get_downstream_exon() is a1.list_features[2]


def test_repeats_match_jax(tmp_path):
    mask = tmp_path / "mask.gtf"
    mask.write_text("".join([
        _gtf_line("1", "exon", 1300, 1400, "+", "R1", "RA", 1),
        _gtf_line("1", "exon", 1403, 1500, "+", "R2", "RB", 1),
        _gtf_line("1", "exon", 7000, 7100, "-", "R3", "RC", 1),
    ]))
    port = ExInCounter("s", vtt.Permissive10X).read_repeats(str(mask))
    ref = JCounter("s", vt.Permissive10X).read_repeats(str(mask))
    summary = lambda d: {k: [(f.start, f.end, f.kind) for f in v]  # noqa
                         for k, v in d.items()}
    assert summary(port) == summary(ref) and summary(port)


# ---------------------------------------------------------------------------
# count matrices, port vs JAX package, bitwise
# ---------------------------------------------------------------------------

HAND = [
    ("c1", "u1", "1", "+", [(1050, 1150)], False),
    ("c1", "u2", "1", "+", [(1300, 1400)], False),
    ("c1", "u3", "1", "+", [(1150, 1260)], False),
    ("c2", "u4", "1", "+", [(2050, 2150)], False),
    ("c2", "u5", "1", "+", [(1150, 1200), (3000, 3050)], True),
    ("c2", "u6", "1", "-", [(6050, 6150)], False),
    ("c3", "u7", "2", "+", [(200, 300)], False),
    ("c3", "u8", "9", "+", [(100, 200)], False),
    ("c3", "u9", "1", "+", [(1050, 1150)], False),
    ("c3", "u9", "1", "+", [(1300, 1400)], False),
]


def _reads(cls, specs):
    return [cls(bc, umi, chrom, strand, segs[0][0], list(segs), 0, 0, sp)
            for bc, umi, chrom, strand, segs, sp in specs]


def _count_batch(counter, reads):
    """Markup from the unspliced reads, then one cell batch; columns
    in sorted barcode order."""
    segs = {}
    for r in sorted(reads):
        if not r.is_spliced:
            segs.setdefault(r.chrom + r.strand, []).extend(r.segments)
    for cs, ss in segs.items():
        if cs in counter.feature_indexes:
            arr = np.asarray(ss, dtype=np.int64)
            counter.feature_indexes[cs].mark_overlapping(arr[:, 0], arr[:, 1])
    bcs = sorted({r.bc for r in reads})
    counter.reads_to_count = list(reads)
    counter.cell_batch = dict.fromkeys(bcs)
    got, got_bcs = counter.count_cell_batch()
    perm = [got_bcs.index(b) for b in bcs]
    return {k: v[:, perm] for k, v in got.items()}


def _assert_port_equals_jax(gtf, specs, logic_name):
    port = ExInCounter("s", LOGICS[logic_name])
    ref = JCounter("s", vt.counting.LOGICS[logic_name])
    port.read_transcriptmodels(gtf)
    ref.read_transcriptmodels(gtf)
    mine = _count_batch(port, _reads(Read, specs))
    theirs = _count_batch(ref, _reads(JRead, specs))
    assert list(mine) == list(theirs) == list(LOGICS[logic_name].layers)
    for layer in mine:
        assert mine[layer].dtype == theirs[layer].dtype
        np.testing.assert_array_equal(mine[layer], theirs[layer],
                                      err_msg=f"{logic_name} {layer}")
    for cs, fa in port.feature_indexes.items():
        np.testing.assert_array_equal(fa.is_validated,
                                      ref.feature_indexes[cs].is_validated)
    return mine


@pytest.mark.parametrize("logic_name", ALL_LOGICS)
def test_hand_reads_match_jax(small_gtf, logic_name):
    got = _assert_port_equals_jax(small_gtf, HAND, logic_name)
    assert sum(int(m.sum()) for m in got.values()) > 0


def _random_models(rng, chrom, strand, n_genes=4, tx_per_gene=2):
    lines = []
    pos = 1000
    for g in range(n_genes):
        gene = f"G{chrom}{strand}{g}"
        n_ex = rng.randint(2, 5)
        exons = []
        p = pos
        for _ in range(n_ex):
            length = rng.randint(80, 300)
            gap = rng.randint(60, 500)
            exons.append((p, p + length))
            p += length + gap
        pos = p + rng.randint(200, 1500)
        for t in range(tx_per_gene):
            trid = f"T{gene}_{t}"
            keep = sorted(rng.choice(
                len(exons), size=max(2, rng.randint(2, len(exons) + 1)),
                replace=False))
            for i, e in enumerate(keep):
                exno = i + 1 if strand == "+" else len(keep) - i
                lines.append(_gtf_line(chrom, "exon", exons[e][0],
                                       exons[e][1], strand, trid, gene,
                                       exno))
    return lines


def _random_specs(rng, lo, hi, chroms, n=300):
    specs = []
    for _ in range(n):
        chrom = chroms[rng.randint(len(chroms))]
        strand = "+-"[rng.randint(2)]
        bc = f"c{rng.randint(6)}"
        umi = f"u{rng.randint(60)}"
        start = rng.randint(lo, hi)
        if rng.rand() < 0.25:
            l1, gap, l2 = (rng.randint(20, 120), rng.randint(50, 800),
                           rng.randint(20, 120))
            segs = [(start, start + l1),
                    (start + l1 + gap, start + l1 + gap + l2)]
            specs.append((bc, umi, chrom, strand, segs, True))
        else:
            specs.append((bc, umi, chrom, strand,
                          [(start, start + rng.randint(20, 400))], False))
    return specs


@pytest.mark.parametrize("logic_name", ALL_LOGICS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_matches_jax(tmp_path, logic_name, seed):
    rng = np.random.RandomState(seed)
    lines = (_random_models(rng, "1", "+") + _random_models(rng, "1", "-") +
             _random_models(rng, "2", "+", n_genes=2))
    gtf = str(tmp_path / f"fuzz{seed}.gtf")
    with open(gtf, "w") as f:
        f.writelines(lines)
    specs = _random_specs(rng, 900, 9000, ["1", "2"], n=400)
    got = _assert_port_equals_jax(gtf, specs, logic_name)
    assert sum(int(m.sum()) for m in got.values()) > 0


def test_objectmode_matches_array_mode(small_gtf):
    """The port's object-mode engine (the literal reference transcription)
    agrees with its array engine."""
    from velocyto_tpu_torch.counting.objectmode import (build_molitems,
                                                        count_molitems)
    counter = ExInCounter("s", vtt.Permissive10X)
    counter.read_transcriptmodels(small_gtf)
    reads = _reads(Read, HAND)
    bcs = sorted({r.bc for r in reads})
    shape = (len(counter.geneid2ix), len(bcs))
    molitems = build_molitems(reads, counter.annotations_by_chrm_strand,
                              counter.mask_ivls_by_chromstrand,
                              vtt.Permissive10X)
    exp = count_molitems(molitems, vtt.Permissive10X, counter.geneid2ix,
                         {b: i for i, b in enumerate(bcs)}, shape)
    counter.reads_to_count = list(reads)
    counter.cell_batch = dict.fromkeys(bcs)
    got, got_bcs = counter.count_cell_batch()
    perm = [got_bcs.index(b) for b in bcs]
    for layer in vtt.Permissive10X.layers:
        np.testing.assert_array_equal(got[layer][:, perm], exp[layer])


# ---------------------------------------------------------------------------
# 3' helpers, the --dump report
# ---------------------------------------------------------------------------

def _next_3p(fn, feature):
    try:
        nxt = fn(feature)
    except IndexError:
        return "IndexError"
    return (nxt.start, nxt.end, chr(nxt.kind), nxt.exin_no)


def test_threeprime_matches_jax(small_gtf):
    from velocyto_tpu.counting.molecules import SegmentMatch as JSM
    from velocyto_tpu.counting.threeprime import closest_3prime as jclosest
    from velocyto_tpu.counting.threeprime import jump_next_3p_exon as jjump
    from velocyto_tpu_torch.counting.molecules import SegmentMatch
    from velocyto_tpu_torch.counting.threeprime import (closest_3prime,
                                                        jump_next_3p_exon)
    ann = ExInCounter("s", vtt.Permissive10X).read_transcriptmodels(small_gtf)
    jann = JCounter("s", vt.Permissive10X).read_transcriptmodels(small_gtf)
    e1, i1 = ann["1+"]["A1"].list_features[:2]
    assert closest_3prime(SegmentMatch((1100, 1150), e1)) == \
        (1200 - 1100 + 1) + 201 + 201
    assert closest_3prime(SegmentMatch((1500, 1550), i1)) == \
        (1999 - 1500 + 1) + 201 + 201
    for cs, trs in ann.items():
        for tr, tm in trs.items():
            jfeats = jann[cs][tr].list_features
            for f, jf in zip(tm.list_features, jfeats):
                for seg in ((f.start, f.start + 20), (f.end - 20, f.end)):
                    assert closest_3prime(SegmentMatch(seg, f)) == \
                        jclosest(JSM(seg, jf)), (tr, seg)
                assert _next_3p(jump_next_3p_exon, f) == \
                    _next_3p(jjump, jf), (tr, f.start)


def test_dump_report(small_gtf, tmp_path):
    import h5py
    counter = ExInCounter("dumpsample", vtt.Permissive10X, dump_option="1",
                          outputfolder=str(tmp_path / "p"))
    ref = JCounter("dumpsample", vt.Permissive10X, dump_option="1",
                   outputfolder=str(tmp_path / "j"))
    for c, cls in ((counter, Read), (ref, JRead)):
        c.read_transcriptmodels(small_gtf)
        reads = _reads(cls, HAND)
        c.reads_to_count = list(reads)
        c.cell_batch = {r.bc: None for r in reads}
        c.count_cell_batch()
    with h5py.File(tmp_path / "p" / "dump" / "dumpsample.hdf5", "r") as f, \
            h5py.File(tmp_path / "j" / "dump" / "dumpsample.hdf5", "r") as g:
        names = []
        f.visit(names.append)
        gnames = []
        g.visit(gnames.append)
        assert names == gnames and "info/tr_id" in names
        n_info = f["info/tr_id"].shape[0]
        for name in names:
            if not isinstance(f[name], h5py.Dataset):
                continue
            if name.endswith("/ixs"):
                # which transcript of an intersected molecule is reported
                # follows a set's order (as in the reference), so only the
                # shape and the range are held
                assert f[name].shape == g[name].shape
                assert (f[name][()] < n_info).all()
            else:
                np.testing.assert_array_equal(f[name][()], g[name][()],
                                              err_msg=name)


# ---------------------------------------------------------------------------
# rds, metadata
# ---------------------------------------------------------------------------

def test_rds_round_trip(tmp_path):
    from test_aux import _write_minimal_rds
    from velocyto_tpu.utils.rds import read_rds as jread
    from velocyto_tpu_torch.utils.rds import read_rds
    path = str(tmp_path / "t.rds")
    _write_minimal_rds(path)
    got = read_rds(path)
    assert got == jread(path)
    assert got["merge_targets"] == {"AAA": "BBB", "CCC": "DDD"}


def test_metadata_round_trip(tmp_path):
    from velocyto_tpu.metadata import MetadataCollection as JMC
    path = str(tmp_path / "samples.csv")
    with open(path, "w") as f:
        f.write("sampleid:str,age:int,tissue:str\n")
        f.write("S1,10,brain\n\nS2,21,liver\n")
    mc, jmc = vtt.MetadataCollection(path), JMC(path)
    assert [m.dict for m in mc.items] == [m.dict for m in jmc.items]
    rows = mc.where("sampleid", "S2")
    assert len(rows) == 1 and isinstance(rows[0], vtt.Metadata)
    assert rows[0].tissue == "liver" and rows[0].age == "21"
    assert rows[0].types == jmc.where("sampleid", "S2")[0].types


def test_constants_match_jax():
    import velocyto_tpu.constants as jc
    import velocyto_tpu_torch.constants as pc
    names = [n for n in dir(jc) if n.isupper()]
    assert names and all(getattr(pc, n) == getattr(jc, n) for n in names)
    assert pc.GEM_codes == jc.GEM_codes
    assert vtt.__version__ == vt.__version__
