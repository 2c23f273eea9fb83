"""Counting throughput of the port's engine (BAM + GTF -> count matrices).

The port's counterpart of the JAX package's ``bench_counting.py``: the
same synthetic fixture recipe (a molecule pool with ~6 reads a molecule,
junction, intronic, exonic and boundary-spanning reads over ``n_genes``
multi-exon genes on two chromosomes), written with the port's
``bamio`` and cell-sorted with its native sorter, then the same two
passes (intron markup on the position-sorted BAM, molecule counting on
the cell-sorted one) with the Permissive10X logic and a whitelist.  The
reference velocyto.py engine is not timed: the port's machines do not
carry it.  Counting is host code, so the numbers are the host CPU's.

    python3 -m velocyto_tpu_torch.bench_counting [n_reads] [n_cells]

prints one JSON line (``counting_reads_per_sec`` over both passes, the
markup and count seconds, the engine that counted) and writes nothing
outside its work directory, a temporary one unless ``workdir`` is given.
"""
from __future__ import annotations

import json
import os
import platform
import sys
import tempfile
import time
from typing import Dict, Optional, Set, Tuple

import numpy as np

READS_PER_MOL = 6.0


def _b4(n: int, width: int = 10) -> str:
    s = []
    for _ in range(width):
        s.append("ACGT"[n & 3])
        n >>= 2
    return "".join(s)


def make_fixture(work: str, n_reads: int, n_cells: int, n_genes: int = 64,
                 seed: int = 11) -> Tuple[str, str, str, str]:
    """Write (gtf, position-sorted bam, cell-sorted bam, barcode file)
    into ``work``; the JAX package's bench_counting.make_fixture recipe
    at the given sizes.  The cell sort is the port's native sorter (it
    also writes the .vtx cell index)."""
    from .commands._run import _internal_cellsort
    from .counting import bamio

    tag = f"{n_reads}_{n_cells}_{n_genes}"
    gtf = os.path.join(work, f"ann_{tag}.gtf")
    bam = os.path.join(work, f"pos_{tag}.bam")
    cs = os.path.join(work, f"cell_{tag}.bam")
    bcf = os.path.join(work, f"bc_{tag}.tsv")

    rng = np.random.RandomState(seed)
    lines, genes, pos = [], [], 1000
    for g in range(n_genes):
        chrom = "1" if g < n_genes // 2 else "2"
        strand = "+" if g % 2 == 0 else "-"
        nex = rng.randint(2, 8)
        exons, p = [], pos
        for _ in range(nex):
            ln = rng.randint(100, 300)
            exons.append((p, p + ln - 1))
            p += ln + rng.randint(150, 900)
        for i, (s, e) in enumerate(exons):
            exno = i + 1 if strand == "+" else nex - i
            lines.append(
                f'{chrom}\tsyn\texon\t{s}\t{e}\t.\t{strand}\t.\t'
                f'gene_id "G{g}"; transcript_id "T{g}"; '
                f'gene_name "G{g}_n"; exon_number "{exno}";\n')
        genes.append((chrom, strand, exons))
        pos = p + 2000
    with open(gtf, "w") as f:
        f.writelines(lines)

    bcs = [_b4(c, 8) for c in range(n_cells)]
    with open(bcf, "w") as f:
        f.write("\n".join(f"{b}-1" for b in bcs))

    n_mol = max(1, int(n_reads / READS_PER_MOL))
    mol_cell = rng.randint(n_cells, size=n_mol)
    mol_gene = rng.randint(n_genes, size=n_mol)
    mol_umi = rng.randint(1 << 20, size=n_mol)
    read_mol = rng.randint(n_mol, size=n_reads)
    kinds = rng.rand(n_reads)
    flags = np.where(rng.rand(n_reads) < 0.5, 0, 16)

    recs = []
    for n in range(n_reads):
        m = read_mol[n]
        chrom, strand, exons = genes[mol_gene[m]]
        tags = {"CB": bcs[mol_cell[m]] + "-1", "UB": _b4(mol_umi[m]),
                "NH": 1}
        ref_id = 0 if chrom == "1" else 1
        kind = kinds[n]
        if kind < 0.35 and len(exons) >= 2:
            ei = rng.randint(len(exons) - 1)
            s0, e0 = exons[ei]
            s1, _e1 = exons[ei + 1]
            half = rng.randint(15, min(48, e0 - s0))
            cig = [(0, half), (3, s1 - e0 - 1), (0, 98 - half)]
            recs.append(bamio.BamRecord(f"r{n}", flags[n], ref_id,
                                        e0 - half, cig, tags))
        elif kind < 0.6:
            ei = rng.randint(len(exons) - 1)
            istart, iend = exons[ei][1] + 1, exons[ei + 1][0] - 1
            if iend - istart < 110:
                continue
            recs.append(bamio.BamRecord(
                f"r{n}", flags[n], ref_id,
                rng.randint(istart, iend - 100), [(0, 98)], tags))
        elif kind < 0.88:
            ei = rng.randint(len(exons))
            s0, e0 = exons[ei]
            start = s0 if e0 - s0 < 110 else rng.randint(s0, e0 - 100)
            recs.append(bamio.BamRecord(f"r{n}", flags[n], ref_id, start,
                                        [(0, 98)], tags))
        else:
            ei = rng.randint(len(exons))
            s0, e0 = exons[ei]
            cig = [(4, 5), (0, 90)] if kind > 0.96 else [(0, 95)]
            recs.append(bamio.BamRecord(f"r{n}", flags[n], ref_id,
                                        max(0, e0 - 40), cig, tags))
    recs.sort(key=lambda r: (r.ref_id, r.pos))
    bamio.write_bam(bam, [("1", 50_000_000), ("2", 50_000_000)], recs)
    _internal_cellsort(bam, cs, "CB")
    return gtf, bam, cs, bcf


def load_bcs(bcf: str) -> Set[str]:
    with open(bcf) as f:
        return {line.strip().split("-")[0] for line in f if line.strip()}


def count_two_pass(gtf: str, bam: str, cs: str, bcs: Set[str],
                   n_processes: int = 1):
    """The two timed passes.  Returns (layers {name: (genes, cells)},
    cell order, markup seconds, count seconds, the engine that counted:
    "soa+<reader class>" or "objectmode")."""
    from .counting import logics
    from .counting.counter import ExInCounter
    c = ExInCounter("s", logics.Permissive10X, valid_bcset=set(bcs))
    c.peek(bam)
    c.read_transcriptmodels(gtf)
    t0 = time.perf_counter()
    c.mark_up_introns((bam,), multimap=False)
    t1 = time.perf_counter()
    if n_processes > 1:
        d, order = c.pcount((cs,), multimap=False, n_processes=n_processes)
    else:
        d, order = c.count((cs,), multimap=False)
    t2 = time.perf_counter()
    soa = c.__dict__.get("_soa")
    kinds = sorted(set(soa.readers_opened)) if soa is not None else []
    engine = ("soa+" + "+".join(kinds)) if kinds else "objectmode"
    layers = {k: (np.concatenate(v, axis=1) if v else
                  np.zeros((len(c.geneid2ix), 0), np.uint16))
              for k, v in d.items()}
    return layers, order, t1 - t0, t2 - t1, engine


def host_cpu() -> str:
    """The host CPU's model name from /proc/cpuinfo; where a sandbox
    reports it as unknown, its vendor, family and model numbers."""
    info: Dict[str, str] = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name", "")
    if name and name != "unknown":
        return name
    if "vendor_id" in info:
        return (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')}")
    return platform.processor() or platform.machine() or "unknown"


def main(n_reads: int = 600_000, n_cells: int = 400, n_genes: int = 64,
         workdir: Optional[str] = None) -> Dict:
    with tempfile.TemporaryDirectory() as tmp:
        work = workdir or tmp
        os.makedirs(work, exist_ok=True)
        t0 = time.perf_counter()
        gtf, bam, cs, bcf = make_fixture(work, n_reads, n_cells, n_genes)
        fixture_s = time.perf_counter() - t0
        layers, order, markup_s, count_s, engine = count_two_pass(
            gtf, bam, cs, load_bcs(bcf))
    out = {"metric": "counting_reads_per_sec",
           "counting_reads_per_sec": n_reads / (markup_s + count_s),
           "unit": f"reads/s ({n_reads} reads, two-pass, host CPU)",
           "reads": n_reads, "cells": len(order), "genes": n_genes,
           "molecules": int(sum(int(m.sum()) for m in layers.values())),
           "markup_s": markup_s, "count_s": count_s,
           "fixture_s": fixture_s, "engine": engine,
           "host_cpu": host_cpu(), "host_cores": os.cpu_count()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:3]]
    main(*args)
