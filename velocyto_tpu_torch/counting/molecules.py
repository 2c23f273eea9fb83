# Copy of velocyto_tpu/counting/molecules.py; imports nothing of the JAX package.
"""Molecule (UMI) assembly and classification.

Two interchangeable implementations, cross-validated in tests:

  - object mode: Molitem/SegmentMatch value classes with the reference's
    dictionary-intersection semantics (velocyto/molitem.py:25-56,
    segment_match.py:5-43) -- the literal semantic model;
  - array mode (`assemble_and_classify`): the production path.  Mapping
    records are (read, transcript-model) groups in flat numpy arrays;
    per-read pruning, cross-read intersection and the logic decision
    evaluate as grouped array ops (lexsort + reduceat), the same dataflow
    a jnp segment-op offload uses.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, DefaultDict, Dict, List, Optional, Tuple

import numpy as np

from ..constants import KIND_EXON, KIND_INTRON, SPLIC_INACUR
from .gtf import Feature, TranscriptModel
from .logics import Logic, NONE

# per-(read,tm) record flag bits
F_INTRON, F_EXON, F_VALID, F_SPAN_GATED, F_SPAN_UNGATED = 1, 2, 4, 8, 16


def dictionary_union(d1, d2):
    keys_set = set(d1) | set(d2)
    return defaultdict(list, {k: d1[k] + d2[k] for k in keys_set})


def dictionary_intersect(d1, d2):
    keys_set = set(d1) & set(d2)
    return defaultdict(list, ((k, d1[k] + d2[k]) for k in keys_set))


class SegmentMatch:
    """(segment, feature, is_spliced) triple (reference segment_match.py)."""
    __slots__ = ["segment", "feature", "is_spliced"]

    def __init__(self, segment: Tuple[int, int], feature: Feature,
                 is_spliced: bool = False) -> None:
        self.segment = segment
        self.feature = feature
        self.is_spliced = is_spliced

    @property
    def maps_to_intron(self) -> bool:
        return self.feature.kind == KIND_INTRON

    @property
    def maps_to_exon(self) -> bool:
        return self.feature.kind == KIND_EXON

    @property
    def skip_makes_sense(self) -> bool:
        if not self.is_spliced:
            return True
        return (abs(self.feature.start - self.segment[0]) <= SPLIC_INACUR or
                abs(self.feature.end - self.segment[1]) <= SPLIC_INACUR)


class Molitem:
    """Per-(bc, UMI) molecule (reference molitem.py:44-56)."""
    __slots__ = ["mappings_record"]

    def __init__(self) -> None:
        self.mappings_record: Optional[DefaultDict] = None

    def add_mappings_record(self, mappings_record) -> None:
        if self.mappings_record is None:
            self.mappings_record = mappings_record
        else:
            self.mappings_record = dictionary_intersect(self.mappings_record,
                                                        mappings_record)


def molitem_flags(molitem: Molitem, gate_span_on_validation: bool = True
                  ) -> Tuple[Dict[str, bool], bool]:
    """Molecule flags from a Molitem (reference logic.py:96-148 loop).

    Returns ({OI, OS, OIV, VM, IM, OE}, singleton).
    """
    OI = OIV = VM = IM = OE = False
    OS = True
    seg_count = 0
    for tm, segments_list in molitem.mappings_record.items():
        seg_count = len(segments_list)
        has_introns = has_exons = has_validated = has_span = False
        for sm in segments_list:
            if sm.maps_to_intron:
                has_introns = True
                f = sm.feature
                check = (f.is_validated if gate_span_on_validation else True)
                if f.is_validated:
                    has_validated = True
                if check:
                    s = sm.segment
                    if f.end_overlaps_with_part_of(s):
                        if f.get_downstream_exon().start_overlaps_with_part_of(s):
                            has_span = True
                    if f.start_overlaps_with_part_of(s):
                        if f.get_upstream_exon().end_overlaps_with_part_of(s):
                            has_span = True
            elif sm.maps_to_exon:
                has_exons = True
        if has_validated and not has_exons:
            OIV = True
        if has_introns and not has_exons:
            OI = True
        if has_exons and not has_introns:
            OE = True
        if gate_span_on_validation:
            if has_exons and has_introns and not has_validated and not has_span:
                IM = True
            if has_exons and has_introns and has_validated and not has_span:
                VM = True
        else:
            if has_exons and has_introns and not has_span:
                VM = True
        if not has_span:
            OS = False
    return (dict(OI=OI, OS=OS, OIV=OIV, VM=VM, IM=IM, OE=OE),
            seg_count == 1)


# ---------------------------------------------------------------------------
# array mode
# ---------------------------------------------------------------------------

class RecordArrays:
    """Flat per-(read, transcript-model) mapping records for one batch.

    rec_read:  (R,) global read id of the record
    rec_mol:   (R,) molecule id of the read
    rec_tm:    (R,) global transcript-model id
    rec_gene:  (R,) gene column index of the tm
    rec_flags: (R,) OR of F_* bits over the record's segment matches
    rec_nseg:  (R,) number of segment matches in the record
    """

    def __init__(self, rec_read, rec_mol, rec_tm, rec_gene, rec_flags,
                 rec_nseg):
        self.rec_read = rec_read
        self.rec_mol = rec_mol
        self.rec_tm = rec_tm
        self.rec_gene = rec_gene
        self.rec_flags = rec_flags
        self.rec_nseg = rec_nseg

    @staticmethod
    def concatenate(parts: List["RecordArrays"]) -> "RecordArrays":
        if not parts:
            z = np.zeros(0, np.int64)
            return RecordArrays(z, z, z, z, z.astype(np.int32),
                                z.astype(np.int32))
        return RecordArrays(
            *(np.concatenate([getattr(p, f) for p in parts])
              for f in ("rec_read", "rec_mol", "rec_tm", "rec_gene",
                        "rec_flags", "rec_nseg")))


def build_read_records(pairs_read: np.ndarray, pairs_tm: np.ndarray,
                       pairs_gene: np.ndarray, pairs_flags: np.ndarray,
                       pairs_skip_ok: np.ndarray,
                       mol_of_read: np.ndarray) -> RecordArrays:
    """Per-read mapping records from (segment, feature) match pairs,
    applying the reference's two prunings (indexes.py:250-267):
      1. drop TMs with fewer matches than the read's max,
      2. drop TMs with any nonsense SKIP.
    """
    if len(pairs_read) == 0:
        z = np.zeros(0, np.int64)
        return RecordArrays(z, z, z, z, z.astype(np.int32),
                            z.astype(np.int32))
    order = np.lexsort((pairs_tm, pairs_read))
    pr = pairs_read[order]
    pt = pairs_tm[order]
    pg = pairs_gene[order]
    pf = pairs_flags[order]
    ps = pairs_skip_ok[order]
    # group boundaries of (read, tm)
    new_grp = np.ones(len(pr), dtype=bool)
    new_grp[1:] = (pr[1:] != pr[:-1]) | (pt[1:] != pt[:-1])
    grp_start = np.flatnonzero(new_grp)
    grp_id = np.cumsum(new_grp) - 1
    n_grp = len(grp_start)
    grp_count = np.diff(np.append(grp_start, len(pr))).astype(np.int32)
    grp_read = pr[grp_start]
    grp_tm = pt[grp_start]
    grp_gene = pg[grp_start]
    grp_flags = np.zeros(n_grp, dtype=np.int32)
    np.bitwise_or.at(grp_flags, grp_id, pf.astype(np.int32))
    grp_skip_ok = np.ones(n_grp, dtype=bool)
    np.logical_and.at(grp_skip_ok, grp_id, ps)
    # pruning 1: per-read max count
    new_read = np.ones(n_grp, dtype=bool)
    new_read[1:] = grp_read[1:] != grp_read[:-1]
    read_gid = np.cumsum(new_read) - 1
    read_max = np.zeros(read_gid[-1] + 1, dtype=np.int32)
    np.maximum.at(read_max, read_gid, grp_count)
    keep = grp_count == read_max[read_gid]
    # pruning 2: nonsense skips
    keep &= grp_skip_ok
    return RecordArrays(grp_read[keep], mol_of_read[grp_read[keep]],
                        grp_tm[keep], grp_gene[keep],
                        grp_flags[keep], grp_count[keep])


def assemble_and_classify(records: RecordArrays, logic: Logic,
                          n_molecules: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Molecule assembly (cross-read TM intersection) + logic decision.

    Returns (mol_action (n_molecules,) int8, mol_gene (n_molecules,) int64,
    mol_code int8 telemetry).  Molecules with no surviving record get
    action NONE and code 2; multigene molecules code 3.
    """
    actions = np.zeros(n_molecules, dtype=np.int8)
    genes = np.full(n_molecules, -1, dtype=np.int64)
    codes = np.full(n_molecules, 2, dtype=np.int8)  # default: no record
    if len(records.rec_read) == 0:
        return actions, genes, codes

    # reads-with-record per molecule
    uniq_reads, r_first = np.unique(records.rec_read, return_index=True)
    reads_per_mol = np.bincount(records.rec_mol[r_first],
                                minlength=n_molecules)

    # (mol, tm) groups
    order = np.lexsort((records.rec_tm, records.rec_mol))
    m = records.rec_mol[order]
    t = records.rec_tm[order]
    g = records.rec_gene[order]
    f = records.rec_flags[order]
    c = records.rec_nseg[order]
    new_grp = np.ones(len(m), dtype=bool)
    new_grp[1:] = (m[1:] != m[:-1]) | (t[1:] != t[:-1])
    gid = np.cumsum(new_grp) - 1
    gs = np.flatnonzero(new_grp)
    n_grp = len(gs)
    grp_mol = m[gs]
    grp_gene = g[gs]
    grp_reads = np.diff(np.append(gs, len(m)))       # reads contributing tm
    grp_flags = np.zeros(n_grp, dtype=np.int32)
    np.bitwise_or.at(grp_flags, gid, f.astype(np.int32))
    grp_nseg = np.zeros(n_grp, dtype=np.int64)
    np.add.at(grp_nseg, gid, c.astype(np.int64))

    # tm survives iff present in every contributing read of the molecule
    survive = grp_reads == reads_per_mol[grp_mol]
    grp_mol = grp_mol[survive]
    grp_gene = grp_gene[survive]
    grp_flags = grp_flags[survive]
    grp_nseg = grp_nseg[survive]
    if len(grp_mol) == 0:
        return actions, genes, codes

    # per-molecule aggregation over surviving tms
    has_rec = np.zeros(n_molecules, dtype=bool)
    has_rec[grp_mol] = True

    tm_introns = (grp_flags & F_INTRON) != 0
    tm_exons = (grp_flags & F_EXON) != 0
    tm_valid = (grp_flags & F_VALID) != 0
    if isinstance(logic, type):
        logic = logic()
    gated = logic.span_gated_on_validation
    if gated:
        tm_span = (grp_flags & F_SPAN_GATED) != 0
    else:
        tm_span = (grp_flags & F_SPAN_UNGATED) != 0

    def agg_or(vals):
        out = np.zeros(n_molecules, dtype=bool)
        np.logical_or.at(out, grp_mol, vals)
        return out

    def agg_and(vals):
        out = np.ones(n_molecules, dtype=bool)
        np.logical_and.at(out, grp_mol, vals)
        return out & has_rec

    OI = agg_or(tm_introns & ~tm_exons)
    OE = agg_or(tm_exons & ~tm_introns)
    OIV = agg_or(tm_valid & ~tm_exons)
    if gated:
        IM = agg_or(tm_exons & tm_introns & ~tm_valid & ~tm_span)
        VM = agg_or(tm_exons & tm_introns & tm_valid & ~tm_span)
    else:
        IM = np.zeros(n_molecules, dtype=bool)
        VM = agg_or(tm_exons & tm_introns & ~tm_span)
    OS = agg_and(tm_span)

    # singleton: total segment matches of (any surviving) tm == 1; all
    # surviving tms share the same count (per-read pruning equalizes them)
    nseg_per_mol = np.zeros(n_molecules, dtype=np.int64)
    np.maximum.at(nseg_per_mol, grp_mol, grp_nseg)
    singleton = nseg_per_mol == 1

    # gene uniqueness
    gmin = np.full(n_molecules, np.iinfo(np.int64).max, dtype=np.int64)
    gmax = np.full(n_molecules, -1, dtype=np.int64)
    np.minimum.at(gmin, grp_mol, grp_gene)
    np.maximum.at(gmax, grp_mol, grp_gene)
    single_gene = has_rec & (gmin == gmax)

    act = logic.decide_batch(OI, OS, OIV, VM, IM, OE, singleton)
    act = np.where(single_gene, act, NONE).astype(np.int8)
    codes[has_rec & ~single_gene] = 3
    codes[single_gene] = np.where(act[single_gene] != NONE, 0, 4)
    actions[:] = act
    genes[:] = np.where(single_gene, gmax, -1)
    return actions, genes, codes
