# Copy of velocyto_tpu/counting/objectmode.py; imports nothing of the JAX package.
"""Object-mode counting engine: the literal semantic model.

A direct transcription of the reference's per-read index scan
(velocyto/indexes.py:63-269) and batch counting loops
(velocyto/counter.py:800-1254) over the port's Feature / Molitem /
Logic objects.  Roles:

  - ground truth for the differential tests of the vectorized engine;
  - the engine behind `--dump` molecular mapping reports, which need the
    per-molecule object graph the array engine deliberately avoids.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from ..constants import (MATCH_INSIDE, MATCH_OVER5END, MATCH_OVER3END,
                         MIN_FLANK, KIND_INTRON)
from .gtf import Feature
from .logics import Logic
from .molecules import Molitem, SegmentMatch


class FeatureIndex:
    """Monotonic-cursor scan over a sorted feature list
    (reference indexes.py:63-269, including the `while i < maxiidx`
    off-by-one that never examines the last feature)."""

    def __init__(self, ivls: Optional[List[Feature]] = None):
        self.ivls = sorted(ivls or [])
        self.iidx = 0
        self.maxiidx = len(self.ivls) - 1

    @property
    def last_interval_not_reached(self):
        return self.iidx < self.maxiidx

    def reset(self):
        self.iidx = 0

    def has_ivls_enclosing(self, read) -> bool:
        if len(self.ivls) == 0:
            return False
        ivl = self.ivls[self.iidx]
        while self.last_interval_not_reached and ivl.ends_upstream_of(read):
            self.iidx += 1
            ivl = self.ivls[self.iidx]
        for segment in read.segments:
            segment_matchtype = 0
            i = self.iidx
            ivl = self.ivls[self.iidx]
            while i < self.maxiidx and ivl.doesnt_start_after(segment):
                matchtype = 0
                if ivl.contains(segment):
                    matchtype = MATCH_INSIDE
                if ivl.start_overlaps_with_part_of(segment):
                    matchtype |= MATCH_OVER5END
                if ivl.end_overlaps_with_part_of(segment):
                    matchtype |= MATCH_OVER3END
                segment_matchtype |= matchtype
                i += 1
                ivl = self.ivls[i]
            if segment_matchtype ^ MATCH_INSIDE:
                return False
        return True

    def mark_overlapping_ivls(self, read) -> None:
        if len(self.ivls) == 0:
            return
        feature = self.ivls[self.iidx]
        while self.last_interval_not_reached and feature.ends_upstream_of(read):
            self.iidx += 1
            feature = self.ivls[self.iidx]
        for segment in read.segments:
            i = self.iidx
            feature = self.ivls[self.iidx]
            while i < self.maxiidx and feature.doesnt_start_after(segment):
                if feature.kind == KIND_INTRON:
                    if feature.end_overlaps_with_part_of(segment):
                        if feature.get_downstream_exon() \
                                .start_overlaps_with_part_of(segment):
                            feature.is_validated = True
                    if feature.start_overlaps_with_part_of(segment):
                        if feature.get_upstream_exon() \
                                .end_overlaps_with_part_of(segment):
                            feature.is_validated = True
                i += 1
                feature = self.ivls[i]

    def find_overlapping_ivls(self, read):
        mapping_record = defaultdict(list)
        if len(self.ivls) == 0:
            return mapping_record
        feature = self.ivls[self.iidx]
        while self.last_interval_not_reached and feature.ends_upstream_of(read):
            self.iidx += 1
            feature = self.ivls[self.iidx]
        for segment in read.segments:
            i = self.iidx
            feature = self.ivls[i]
            while i < self.maxiidx and feature.doesnt_start_after(segment):
                if feature.intersects(segment) and \
                        (segment[-1] - segment[0]) > MIN_FLANK:
                    mapping_record[feature.transcript_model].append(
                        SegmentMatch(segment, feature, read.is_spliced))
                i += 1
                feature = self.ivls[i]
        if len(mapping_record) != 0:
            max_n_segments = len(max(mapping_record.values(), key=len))
            for tm, seglist in list(mapping_record.items()):
                if len(seglist) < max_n_segments:
                    del mapping_record[tm]
        if len(mapping_record) != 0:
            for tm, seglist in list(mapping_record.items()):
                for sm in seglist:
                    if not sm.skip_makes_sense:
                        del mapping_record[tm]
                        break
        return mapping_record


def build_molitems(reads, annotations, mask_ivls, logic: Logic
                   ) -> Dict[str, Molitem]:
    """Run the per-read scan over a (sorted) read batch and assemble the
    molitem dictionary (reference counter.py:812-838,969-994,1113-1149)."""
    from itertools import chain
    logic = logic() if isinstance(logic, type) else logic
    feature_indexes: Dict[str, FeatureIndex] = {}
    for cs, tm_dict in annotations.items():
        feature_indexes[cs] = FeatureIndex(
            sorted(chain.from_iterable(tm.list_features
                                       for tm in tm_dict.values())))
    mask_indexes = {cs: FeatureIndex(fl) for cs, fl in mask_ivls.items()}

    def get_fi(cs):
        return feature_indexes.setdefault(cs, FeatureIndex([]))

    def get_mi(cs):
        return mask_indexes.setdefault(cs, FeatureIndex([]))

    def rev(s):
        return "-" if s == "+" else "+"

    molitems: Dict[str, Molitem] = defaultdict(Molitem)
    for r in sorted(reads):
        ii = get_fi(r.chrom + r.strand)
        iir = get_fi(r.chrom + rev(r.strand))
        iim = get_mi(r.chrom + r.strand)
        iimr = get_mi(r.chrom + rev(r.strand))
        if logic.stranded and not logic.accept_discordant:
            if iim.has_ivls_enclosing(r):
                continue
            record = ii.find_overlapping_ivls(r)
            if len(record):
                molitems[f"{r.bc}${r.umi}"].add_mappings_record(record)
        elif logic.accept_discordant:
            if iim.has_ivls_enclosing(r):
                if not iimr.has_ivls_enclosing(r):
                    record = iir.find_overlapping_ivls(r)
                else:
                    continue
            else:
                record = ii.find_overlapping_ivls(r)
            if len(record):
                molitems[f"{r.bc}${r.umi}"].add_mappings_record(record)
        else:
            if iim.has_ivls_enclosing(r) or iimr.has_ivls_enclosing(r):
                continue
            record = ii.find_overlapping_ivls(r)
            if len(record):
                molitems[f"{r.bc}${r.umi}"].add_mappings_record(record)
            record_r = iir.find_overlapping_ivls(r)
            if len(record_r):
                molitems[f"{r.bc}${r.umi}"].add_mappings_record(record_r)
    return molitems


def count_molitems(molitems: Dict[str, Molitem], logic: Logic,
                   geneid2ix: Dict[str, int], bc2idx: Dict[str, int],
                   layers_shape, dtype="uint32"):
    """Classify assembled molitems into layer matrices."""
    logic = logic() if isinstance(logic, type) else logic
    dict_layers_columns = {layer: np.zeros(layers_shape, dtype=dtype)
                           for layer in logic.layers}
    for bcumi, molitem in molitems.items():
        bc = bcumi.split("$")[0]
        if molitem.mappings_record is None:
            continue
        logic.count(molitem, bc2idx[bc], dict_layers_columns, geneid2ix)
    return dict_layers_columns


def markup_features(reads, annotations) -> Dict[str, "FeatureIndex"]:
    """Intron-validation markup pass over (sorted) reads (reference
    counter.py:622-699): non-spliced reads spanning an exon-intron
    boundary set Feature.is_validated on the intron."""
    from itertools import chain
    feature_indexes: Dict[str, FeatureIndex] = {}
    for cs, tm_dict in annotations.items():
        feature_indexes[cs] = FeatureIndex(
            sorted(chain.from_iterable(tm.list_features
                                       for tm in tm_dict.values())))
    for r in reads:
        if r.is_spliced:
            continue
        cs = r.chrom + r.strand
        if cs in feature_indexes:
            feature_indexes[cs].mark_overlapping_ivls(r)
    return feature_indexes
