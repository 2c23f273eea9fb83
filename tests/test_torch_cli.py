"""The port's `velocyto` click group (velocyto_tpu_torch.commands) against
the JAX package's on the same inputs: each subcommand through click's
CliRunner, with the sample id fixed, writes a loom equal to the JAX
CLI's in every layer, row and column attribute and file attribute.
Also the custom-logic reflection on velocyto_tpu_torch's namespace,
`tools dropest-bc-correct`, and bench_counting at a small size."""
import gzip
import json
import os
import shutil

import h5py
import numpy as np
import pytest
from click.testing import CliRunner

from velocyto_tpu.commands.velocyto import cli as jcli
from velocyto_tpu_torch.commands.velocyto import cli
from velocyto_tpu_torch.counting import bamio


def _gtf_line(chrom, start, end, strand, trid, gene, exno):
    tags = (f'gene_id "{gene}"; transcript_id "{trid}"; '
            f'gene_name "{gene}_n"; transcript_name "{trid}_n"; '
            f'exon_number "{exno}";')
    return f"{chrom}\ttest\texon\t{start}\t{end}\t.\t{strand}\t.\t{tags}\n"


GTF = [
    _gtf_line("1", 1000, 1200, "+", "A1", "GA", 1),
    _gtf_line("1", 2000, 2200, "+", "A1", "GA", 2),
    _gtf_line("1", 3000, 3200, "+", "A1", "GA", 3),
    _gtf_line("1", 1000, 1200, "+", "A2", "GA", 1),
    _gtf_line("1", 3000, 3200, "+", "A2", "GA", 2),
    _gtf_line("1", 6000, 6200, "-", "B1", "GB", 1),
    _gtf_line("1", 5000, 5200, "-", "B1", "GB", 2),
    _gtf_line("1", 90000, 90500, "+", "Z1", "GZ", 1),
    _gtf_line("1", 91000, 91200, "+", "Z1", "GZ", 2),
]
CELLS = [f"BC{i:02d}" for i in range(5)]


def _sample_records(rng, cells, with_umi=True, reads=(25, 60)):
    recs = []
    for bc in cells:
        for m in range(int(rng.randint(*reads))):
            kind = rng.rand()
            if kind < 0.5:                       # exonic
                pos0, cig = 1000 + rng.randint(0, 100), [(0, 98)]
            elif kind < 0.75:                    # intronic
                pos0, cig = 1300 + rng.randint(0, 500), [(0, 80)]
            elif kind < 0.85:                    # spanning exon 1 / intron 1
                pos0, cig = 1149, [(0, 100)]
            elif kind < 0.95:                    # junction e1 -> e3
                pos0, cig = 1150, [(0, 51), (3, 1799), (0, 40)]
            else:                                # minus-strand gene
                pos0, cig = 5050 + rng.randint(0, 50), [(0, 90)]
            tags = {"NH": 1}
            if with_umi:
                tags.update(CB=bc + "-1", UB=f"U{rng.randint(40):04d}")
            recs.append(bamio.BamRecord(
                f"r{len(recs)}", 16 if kind >= 0.95 else 0, 0, int(pos0),
                cig, tags, seq="A" * sum(n for op, n in cig if op == 0)))
    recs.sort(key=lambda r: r.pos)
    return recs


@pytest.fixture
def inputs(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "ann.gtf").write_text("".join(GTF))
    rng = np.random.RandomState(0)
    bamio.write_bam(str(src / "sample.bam"), [("chr1", 200000)],
                    _sample_records(rng, CELLS))
    (src / "barcodes.tsv").write_text("\n".join(f"{c}-1" for c in CELLS))
    for i in range(3):
        bamio.write_bam(str(src / f"cell{i}.bam"), [("chr1", 200000)],
                        # past the 80-molecule cut of discovery mode
                        _sample_records(rng, [f"w{i}"], with_umi=False,
                                        reads=(120, 160)))
    return src


def _workdir(tmp_path, src, name):
    """A fresh copy of the inputs for each CLI (the run writes its
    cell-sorted BAM beside the input)."""
    work = tmp_path / name
    shutil.copytree(src, work)
    return work


def _invoke(group, argv):
    res = CliRunner().invoke(group, argv, catch_exceptions=False)
    assert res.exit_code == 0, res.output
    return res


def _loom_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj.dtype.str, obj[()])
        f.visititems(visit)
        out["@attrs"] = {k: f.attrs[k] for k in f.attrs}
    return out


def _assert_same_loom(mine, theirs):
    a, b = _loom_items(mine), _loom_items(theirs)
    assert sorted(a) == sorted(b)
    for k in ("layers/spliced", "layers/unspliced", "layers/ambiguous",
              "matrix", "row_attrs/Gene", "col_attrs/CellID"):
        assert k in a, k
    assert a.pop("@attrs") == b.pop("@attrs")
    for k, (dtype, value) in a.items():
        assert dtype == b[k][0], k
        np.testing.assert_array_equal(value, b[k][1], err_msg=k)
    assert int(a["layers/spliced"][1].sum()) > 0


def _both(tmp_path, inputs, argv_of):
    """Run one subcommand through each package's group on its own copy
    of the inputs; returns the two workdirs."""
    dirs = []
    for name, group in (("port", cli), ("jax", jcli)):
        work = _workdir(tmp_path, inputs, name)
        _invoke(group, argv_of(work))
        dirs.append(work)
    return dirs


def test_group_help():
    res = _invoke(cli, ["--help"])
    for sub in ("run", "run10x", "run-dropest", "run-smartseq2", "tools"):
        assert sub in res.output
    assert "dropest-bc-correct" in _invoke(cli, ["tools", "--help"]).output
    assert _invoke(cli, ["--version"]).output == \
        _invoke(jcli, ["--version"]).output


@pytest.mark.parametrize("extra", [[], ["-l", "Intermediate10X", "-U"],
                                   ["-M", "-t", "uint32"]],
                         ids=["default", "intermediate_umi", "multimap"])
def test_run_loom_equals_jax(tmp_path, inputs, extra):
    port, jax = _both(tmp_path, inputs, lambda w: [
        "run", str(w / "sample.bam"), str(w / "ann.gtf"),
        "-b", str(w / "barcodes.tsv"), "-o", str(w / "out"),
        "-e", "testsample", "-m", str(w / "ann.gtf")] + extra)
    _assert_same_loom(port / "out" / "testsample.loom",
                      jax / "out" / "testsample.loom")


def test_run_parallel_loom_equals_serial(tmp_path, inputs):
    port, jax = _both(tmp_path, inputs, lambda w: [
        "run", str(w / "sample.bam"), str(w / "ann.gtf"),
        "-b", str(w / "barcodes.tsv"), "-o", str(w / "out"),
        "-e", "par", "-p", "2" if w.name == "port" else "0"])
    _assert_same_loom(port / "out" / "par.loom", jax / "out" / "par.loom")


def test_run10x_loom_equals_jax(tmp_path, inputs):
    def layout(w):
        sample = w / "SAMPLE10X"
        outs = sample / "outs"
        (outs / "filtered_feature_bc_matrix").mkdir(parents=True)
        (sample / "_log").write_text("Pipestance completed successfully!\n")
        shutil.copy(w / "sample.bam", outs / "possorted_genome_bam.bam")
        with gzip.open(outs / "filtered_feature_bc_matrix" /
                       "barcodes.tsv.gz", "wt") as f:
            f.write((w / "barcodes.tsv").read_text())
        tsne = outs / "analysis" / "tsne" / "2_components"
        tsne.mkdir(parents=True)
        (tsne / "projection.csv").write_text(
            "Barcode,TSNE-1,TSNE-2\n" + "".join(
                f"{c}-1,{i * 1.5},{-i * 2.0}\n" for i, c in enumerate(CELLS)))
        cl = outs / "analysis" / "clustering" / "graphclust"
        cl.mkdir(parents=True)
        (cl / "clusters.csv").write_text("Barcode,Cluster\n" + "".join(
            f"{c}-1,{1 + i % 2}\n" for i, c in enumerate(CELLS)))
        return ["run10x", str(sample), str(w / "ann.gtf"), "-@", "1"]

    port, jax = _both(tmp_path, inputs, layout)
    loom = os.path.join("SAMPLE10X", "velocyto", "SAMPLE10X.loom")
    _assert_same_loom(port / loom, jax / loom)
    with h5py.File(port / loom, "r") as f:
        assert {"_X", "_Y", "Clusters"} <= set(f["col_attrs"])


def test_run_smartseq2_loom_equals_jax(tmp_path, inputs):
    port, jax = _both(tmp_path, inputs, lambda w: [
        "run-smartseq2", *[str(w / f"cell{i}.bam") for i in range(3)],
        str(w / "ann.gtf"), "-o", str(w / "out"), "-e", "plate1"])
    _assert_same_loom(port / "out" / "plate1.loom",
                      jax / "out" / "plate1.loom")
    with h5py.File(port / "out" / "plate1.loom", "r") as f:
        assert "spanning" in f["layers"] and f["matrix"].shape[1] == 3


def test_run_dropest_loom_equals_jax(tmp_path, inputs):
    def layout(w):
        shutil.copy(w / "sample.bam", w / "SAMPLEA_tagged.bam")
        shutil.copy(w / "barcodes.tsv", w / "barcodes_SAMPLEA.tsv")
        return ["run-dropest", "-o", str(w / "out"), "-e", "dropA",
                "-@", "1", str(w / "SAMPLEA_tagged.bam"), str(w / "ann.gtf")]

    port, jax = _both(tmp_path, inputs, layout)
    _assert_same_loom(port / "out" / "dropA.loom", jax / "out" / "dropA.loom")


def test_dropest_bc_correct_equals_jax(tmp_path, inputs):
    from test_aux import _write_minimal_rds

    def layout(w):
        recs = [bamio.BamRecord("r1", 0, 0, 100, [(0, 50)],
                                {"CB": "AAA", "UB": "U1", "NH": 1}),
                bamio.BamRecord("r2", 0, 0, 200, [(0, 50)],
                                {"CB": "XYZ", "UB": "U2", "NH": 1})]
        bamio.write_bam(str(w / "in.bam"), [("1", 10000)], recs)
        _write_minimal_rds(str(w / "d.rds"))
        return ["tools", "dropest-bc-correct", str(w / "in.bam"),
                str(w / "d.rds")]

    port, jax = _both(tmp_path, inputs, layout)
    got = [(r.name, r.tags) for r in
           bamio.BamReader(str(port / "correct_in.bam"))]
    assert got == [(r.name, r.tags) for r in
                   bamio.BamReader(str(jax / "correct_in.bam"))]
    assert dict((n, t["CB"]) for n, t in got) == {"r1": "BBB", "r2": "XYZ"}


def test_custom_logic_reflection(tmp_path, inputs, monkeypatch):
    """A user Logic subclass set on velocyto_tpu_torch resolves by name
    (reference _run.py:86-91); one set on the JAX package does not."""
    import velocyto_tpu as vt
    import velocyto_tpu_torch as vtt

    class MyLogic(vtt.Permissive10X):
        name = "MyLogic"

    w = _workdir(tmp_path, inputs, "custom")
    argv = ["run", "-b", str(w / "barcodes.tsv"), "-o", str(w / "out"),
            "-e", "CUST", "-l", "MyLogic", str(w / "sample.bam"),
            str(w / "ann.gtf")]
    monkeypatch.setattr(vt, "MyLogic", MyLogic, raising=False)
    with pytest.raises(ValueError, match="not a valid logic"):
        CliRunner().invoke(cli, argv, catch_exceptions=False)
    monkeypatch.setattr(vtt, "MyLogic", MyLogic, raising=False)
    _invoke(cli, argv)
    with h5py.File(w / "out" / "CUST.loom", "r") as f:
        assert f.attrs["velocyto.logic"] == "MyLogic"
        assert f["layers/spliced"][()].sum() > 0


def test_bench_counting_small(tmp_path, capsys):
    from velocyto_tpu_torch import bench_counting
    out = bench_counting.main(n_reads=6000, n_cells=12, n_genes=16,
                              workdir=str(tmp_path / "bench"))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec == out
    assert rec["engine"] == "soa+NativeBamReader"
    assert rec["reads"] > 0 and rec["counting_reads_per_sec"] > 0
    assert rec["molecules"] > 0 and rec["cells"] == 12
    assert os.listdir(tmp_path) == ["bench"]


def test_run_raises_when_the_native_cell_sort_fails(tmp_path, inputs,
                                                    monkeypatch):
    """With no samtools the cell sort runs on the native sorter's
    thread; when that sort raises, `run` raises too and writes no loom
    (the JAX package's handle reads the failure as success, reference
    fault R5)."""
    import subprocess

    from velocyto_tpu_torch import native
    from velocyto_tpu_torch.commands import _run

    popen = subprocess.Popen

    def no_samtools(args, *a, **kw):
        if args[0] == "samtools":
            raise FileNotFoundError(2, "No such file or directory: samtools")
        return popen(args, *a, **kw)

    def failing_sort(*args, **kw):
        raise IOError("native BAM sort failed")

    assert native.available()
    monkeypatch.setattr(_run.subprocess, "Popen", no_samtools)
    monkeypatch.setattr(native, "bam_sort_by_tag", failing_sort)
    w = _workdir(tmp_path, inputs, "sortfail")
    res = CliRunner().invoke(cli, [
        "run", str(w / "sample.bam"), str(w / "ann.gtf"),
        "-b", str(w / "barcodes.tsv"), "-o", str(w / "out"),
        "-e", "sortfail"])
    assert res.exit_code != 0
    assert isinstance(res.exception, MemoryError), res.exception
    assert "could not be sorted" in str(res.exception)
    assert not (w / "out" / "sortfail.loom").exists()
    assert not list(w.rglob("*.loom"))
