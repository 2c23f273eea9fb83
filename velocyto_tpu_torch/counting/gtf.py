# Copy of velocyto_tpu/counting/gtf.py; imports nothing of the JAX package.
"""Genomic annotation model + GTF parsing.

Object model mirrors the reference value classes (velocyto/feature.py,
transcript_model.py, gene_info.py) -- these are the construction-time
representation.  The counting hot loops never touch these objects: they
are flattened into the structure-of-arrays index in
velocyto_tpu_torch.counting.features before any read is processed.

Parsing semantics follow reference counter.py:436-620 (transcript
models, in-memory `sort -k1,1 -k7,7 -k4,4n` equivalent, exon_number
inference fallback, long-intron chopping) and counter.py:308-420
(repeat-mask intervals merged within a 5bp tolerance).
"""
from __future__ import annotations

import logging
import re
from collections import OrderedDict, defaultdict
from typing import Any, Dict, List, Optional, Tuple

from ..constants import (KIND_EXON, KIND_INTRON, KIND_REPEAT, MIN_FLANK,
                         LONGEST_INTRON_ALLOWED)


class Feature:
    """An annotated genomic interval (reference feature.py:7-143)."""
    __slots__ = ["start", "end", "kind", "exin_no", "is_validated",
                 "transcript_model"]

    def __init__(self, start: int, end: int, kind: int, exin_no: Any,
                 transcript_model: Any = None) -> None:
        self.start = start
        self.end = end
        self.transcript_model = transcript_model
        self.kind = kind
        self.exin_no = int(exin_no)
        self.is_validated = False

    def __lt__(self, other: Any) -> bool:
        if self.start == other.start:
            return self.end < other.end
        return self.start < other.start

    def __gt__(self, other: Any) -> bool:
        if self.start == other.start:
            return self.end > other.end
        return self.start > other.start

    def __len__(self) -> int:
        return (self.end - self.start) + 1

    def __repr__(self) -> str:
        if self.transcript_model is None:
            return (f"Feature not linked to Transcript Model: "
                    f"{self.start}-{self.end} {chr(self.kind)}{self.exin_no}")
        return (f"Feature: chr{self.transcript_model.chromstrand}:"
                f"{self.start}-{self.end} {self.transcript_model.trname} "
                f"({self.transcript_model.trid}) "
                f"{chr(self.kind)}{self.exin_no}")

    @property
    def is_last_3prime(self) -> bool:
        if self.transcript_model.chromstrand[-1] == "+":
            return self == self.transcript_model.list_features[-1]
        return self == self.transcript_model.list_features[0]

    def get_downstream_exon(self) -> "Feature":
        """For introns: the neighbour exon downstream
        (reference feature.py:45-59)."""
        if self.transcript_model.chromstrand[-1] == "+":
            ix = self.exin_no * 2
        else:
            ix = len(self.transcript_model.list_features) - 2 * self.exin_no + 1
        return self.transcript_model.list_features[ix]

    def get_upstream_exon(self) -> "Feature":
        """For introns: the neighbour exon upstream
        (reference feature.py:61-75)."""
        if self.transcript_model.chromstrand[-1] == "+":
            ix = (self.exin_no * 2) - 2
        else:
            ix = len(self.transcript_model.list_features) - 2 * self.exin_no - 1
        return self.transcript_model.list_features[ix]

    # geometric predicates (reference feature.py:82-143)
    def ends_upstream_of(self, read: Any) -> bool:
        return self.end < read.pos

    def doesnt_start_after(self, segment: Tuple[int, int]) -> bool:
        return self.start < segment[-1]

    def intersects(self, segment: Tuple[int, int],
                   minimum_flanking: int = MIN_FLANK) -> bool:
        return (segment[-1] - minimum_flanking > self.start) and \
               (segment[0] + minimum_flanking < self.end)

    def contains(self, segment: Tuple[int, int],
                 minimum_flanking: int = MIN_FLANK) -> bool:
        return (segment[0] + minimum_flanking >= self.start) and \
               (segment[-1] - minimum_flanking <= self.end) and \
               ((segment[-1] - segment[0]) > minimum_flanking)

    def start_overlaps_with_part_of(self, segment: Tuple[int, int],
                                    minimum_flanking: int = MIN_FLANK) -> bool:
        return (segment[0] + minimum_flanking < self.start) and \
               (segment[-1] - minimum_flanking > self.start)

    def end_overlaps_with_part_of(self, segment: Tuple[int, int],
                                  minimum_flanking: int = MIN_FLANK) -> bool:
        return (segment[0] + minimum_flanking < self.end) and \
               (segment[-1] - minimum_flanking > self.end)


class TranscriptModel:
    """Ordered exon list; introns synthesized between appended exons
    (reference transcript_model.py:5-136)."""
    __slots__ = ["trid", "trname", "geneid", "genename", "chromstrand",
                 "list_features"]

    def __init__(self, trid: str, trname: str, geneid: str, genename: str,
                 chromstrand: str) -> None:
        self.trid = trid
        self.trname = trname
        self.geneid = geneid
        self.genename = genename
        self.chromstrand = chromstrand
        self.list_features: List[Feature] = []

    def __iter__(self):
        for i in self.list_features:
            yield i

    def __lt__(self, other: Any) -> bool:
        assert self.chromstrand == other.chromstrand
        return self.list_features[0].start < other.list_features[0].start

    def __gt__(self, other: Any) -> bool:
        assert self.chromstrand == other.chromstrand
        return self.list_features[0].start > other.list_features[0].start

    @property
    def start(self) -> int:
        return self.list_features[0].start

    @property
    def end(self) -> int:
        return self.list_features[-1].end

    def ends_upstream_of(self, read: Any) -> bool:
        return self.list_features[-1].end < read.pos

    def intersects(self, segment: Tuple[int, int],
                   minimum_flanking: int = MIN_FLANK) -> bool:
        return (segment[-1] - minimum_flanking > self.start) and \
               (segment[0] + minimum_flanking < self.end)

    def append_exon(self, exon_feature: Feature) -> None:
        """Append an exon, synthesizing the intervening intron with
        strand-aware numbering (reference transcript_model.py:53-76)."""
        exon_feature.transcript_model = self
        if len(self.list_features) == 0:
            self.list_features.append(exon_feature)
        else:
            if self.chromstrand[-1] == "+":
                intron_number = self.list_features[-1].exin_no
            else:
                intron_number = self.list_features[-1].exin_no - 1
            self.list_features.append(
                Feature(start=self.list_features[-1].end + 1,
                        end=exon_feature.start - 1,
                        kind=KIND_INTRON,
                        exin_no=intron_number,
                        transcript_model=self))
            self.list_features.append(exon_feature)

    def chop_if_long_intron(self, maxlen: int = LONGEST_INTRON_ALLOWED) -> None:
        """Chop the 5' region upstream of very long introns
        (reference transcript_model.py:78-132)."""
        long_feats = [i for i in self.list_features
                      if len(i) > maxlen and i.kind == KIND_INTRON]
        if len(long_feats):
            if self.chromstrand[-1] == "+":
                self._remove_upstream_of(long_feats[-1])
            else:
                self._remove_downstream_of(long_feats[0])
            self.trid = self.trid + "_mod"
            self.trname = self.trname + "_mod"

    def _remove_upstream_of(self, longest_feat: Feature) -> None:
        tmp = []
        ec = ic = 1
        for feat in self.list_features:
            if feat > longest_feat:
                if feat.kind == KIND_EXON:
                    feat.exin_no = ec
                    ec += 1
                    tmp.append(feat)
                elif feat.kind == KIND_INTRON:
                    feat.exin_no = ic
                    ic += 1
                    tmp.append(feat)
        self.list_features = tmp

    def _remove_downstream_of(self, longest_feat: Feature) -> None:
        tmp = []
        ec = ic = 1
        for feat in self.list_features[::-1]:
            if feat < longest_feat:
                if feat.kind == KIND_EXON:
                    feat.exin_no = ec
                    ec += 1
                    tmp.append(feat)
                elif feat.kind == KIND_INTRON:
                    feat.exin_no = ic
                    ic += 1
                    tmp.append(feat)
        self.list_features = tmp[::-1]

    def __repr__(self) -> str:
        list_feats = "-".join(f"{chr(i.kind)}{i.exin_no}"
                              for i in self.list_features)
        return f"<TrMod {self.trid}\t{list_feats}>"


class GeneInfo:
    """Basic gene info for loom row attrs (reference gene_info.py:7-18)."""
    __slots__ = ["genename", "geneid", "chrom", "strand", "start", "end"]

    def __init__(self, genename: str, geneid: str, chromstrand: str,
                 start: int, end: int) -> None:
        self.genename = genename
        self.geneid = geneid
        self.chrom = chromstrand[:-1]
        self.strand = chromstrand[-1]
        self.start = start
        self.end = end


# ---------------------------------------------------------------------------
# GTF parsing
# ---------------------------------------------------------------------------

_REGEX_TRID = re.compile(r'transcript_id "([^"]+)"')
_REGEX_TRNAME = re.compile(r'transcript_name "([^"]+)"')
_REGEX_GENEID = re.compile(r'gene_id "([^"]+)"')
_REGEX_GENENAME = re.compile(r'gene_name "([^"]+)"')
_REGEX_EXONNO = re.compile(r'exon_number "*?([\w]+)')


def _sorting_key(entry: str) -> Tuple[str, bool, int, str]:
    """Equivalent to `sort -k1,1 -k7,7 -k4,4n` (reference counter.py:342-345)."""
    x = entry.split("\t")
    return (x[0], x[6] == "+", int(x[3]), entry)


def peek_and_correct(gtf_lines: List[str]) -> List[str]:
    """Infer exon_number when missing (reference counter.py:554-620,
    including its quirk of emitting all corrected lines in the plus list)."""
    flag = False
    for lin in gtf_lines[:500]:
        fields = lin.split("\t")
        if len(fields) < 9:
            continue
        if fields[2] == "exon":
            if _REGEX_EXONNO.search(fields[8]) is None:
                flag = True
    if not flag:
        return gtf_lines
    logging.warning("The entry exon_number was not present in the gtf file. "
                    "It will be inferred from the position.")
    min_info_minus: List[List] = []
    min_info_plus: List[List] = []
    for lin in gtf_lines:
        chrom, fclass, ftype, start_str, end_str, _j, strand, _j2, tags = \
            lin.split("\t")
        if ftype == "exon":
            m = _REGEX_TRID.search(tags)
            if m is None:
                raise AttributeError(
                    f"transcript_id entry not found in line: {lin}")
            trid = m.group(1)
            if strand == "-":
                min_info_minus.append([trid, int(start_str), int(end_str), lin])
            else:
                min_info_plus.append([trid, int(start_str), int(end_str), lin])
    min_info_minus = sorted(min_info_minus)
    min_info_plus = sorted(min_info_plus)
    current_trid = "None"
    exon_n = 1
    modified: List[str] = []
    for i in min_info_plus:
        if current_trid != i[0]:
            current_trid = i[0]
            exon_n = 1
        else:
            exon_n += 1
        modified.append(f'{i[3][:-1]} exon_number "{exon_n}";\n')
    exon_n = 1
    for i in min_info_minus[::-1]:
        if current_trid != i[0]:
            current_trid = i[0]
            exon_n = 1
        else:
            exon_n += 1
        modified.append(f'{i[3][:-1]} exon_number "{exon_n}";\n')
    return modified


def read_transcriptmodels(gtf_file: str,
                          geneid2ix: Dict[str, int],
                          genes: Dict[str, GeneInfo]
                          ) -> Dict[str, "OrderedDict[str, TranscriptModel]"]:
    """Parse a GTF into per-chromstrand TranscriptModel dicts, assigning
    gene indexes as new genes appear (reference counter.py:422-552).

    geneid2ix / genes are updated in place (matrix-column assignment).
    """
    gtf_lines = [line for line in open(gtf_file) if not line.startswith("#")]
    gtf_lines = peek_and_correct(gtf_lines)
    gtf_lines = sorted(gtf_lines, key=_sorting_key)

    annotations: Dict[str, OrderedDict] = {}

    def assign_indexes_to_genes(features: Dict[str, TranscriptModel]) -> None:
        for _name, trmodel in features.items():
            if trmodel.geneid in geneid2ix:
                if genes[trmodel.geneid].start > trmodel.start:
                    genes[trmodel.geneid].start = trmodel.start
                if genes[trmodel.geneid].end < trmodel.end:
                    genes[trmodel.geneid].end = trmodel.end
            else:
                geneid2ix[trmodel.geneid] = len(geneid2ix)
                genes[trmodel.geneid] = GeneInfo(
                    trmodel.genename, trmodel.geneid, trmodel.chromstrand,
                    trmodel.start, trmodel.end)

    curr_chromstrand: Optional[str] = None
    features: "OrderedDict[str, TranscriptModel]" = OrderedDict()
    nth_line = 0
    for nth_line, line in enumerate(gtf_lines):
        fields = line.rstrip().split("\t")
        chrom, feature_class, feature_type, start_str, end_str, _junk, \
            strand, _junk2, tags = fields
        if "chr" in chrom[:4]:
            chrom = chrom[3:]
        if chrom + strand != curr_chromstrand:
            if curr_chromstrand is not None:
                if chrom + strand in annotations:
                    raise IOError(
                        "Genome annotation gtf file is not sorted correctly! "
                        "Run: sort -k1,1 -k7,7 -k4,4n -o [OUT] [IN]")
                assign_indexes_to_genes(features)
                annotations[curr_chromstrand] = features
            features = OrderedDict()
            curr_chromstrand = chrom + strand
        if feature_type == "exon":
            trid = _REGEX_TRID.search(tags).group(1)
            _m = _REGEX_TRNAME.search(tags)
            trname = _m.group(1) if _m else trid
            geneid = _REGEX_GENEID.search(tags).group(1)
            _m = _REGEX_GENENAME.search(tags)
            genename = _m.group(1) if _m else geneid
            m = _REGEX_EXONNO.search(tags)
            if m is None:
                raise IOError(
                    "The genome annotation .gtf file provided does not "
                    "contain exon_number; it is required for counting")
            exonno = m.group(1)
            start = int(start_str)
            end = int(end_str)
            chromstrand = chrom + strand
            try:
                features[trid].append_exon(
                    Feature(start=start, end=end, kind=KIND_EXON,
                            exin_no=exonno))
            except KeyError:
                features[trid] = TranscriptModel(trid=trid, trname=trname,
                                                 geneid=geneid,
                                                 genename=genename,
                                                 chromstrand=chromstrand)
                features[trid].append_exon(
                    Feature(start=start, end=end, kind=KIND_EXON,
                            exin_no=exonno))
    # last chromosome
    assign_indexes_to_genes(features)
    if curr_chromstrand is not None:
        annotations[curr_chromstrand] = features

    # chop very long introns
    for tmodels_orddict in annotations.values():
        for tm in tmodels_orddict.values():
            tm.chop_if_long_intron()

    # restore sorted-by-start order
    for chromstrand in annotations.keys():
        tmp = OrderedDict((i.trid, i)
                          for i in sorted(annotations[chromstrand].values()))
        annotations[chromstrand] = tmp
    return annotations


def read_repeats(gtf_file: str, tolerance: int = 5,
                 keep_last_chromstrand: bool = False
                 ) -> Dict[str, List[Feature]]:
    """Parse a repeat-mask GTF, merging intervals closer than `tolerance`
    (reference counter.py:308-420).

    keep_last_chromstrand: the reference only stores a chromstrand's
    interval list on chromstrand CHANGE, so the final block of the
    sorted file (lexicographically last chromosome, e.g. chrX/chrY) is
    silently dropped, as is the still-open trailing interval; the open
    interval also leaks across chromstrand boundaries.  The default
    replicates all of that bit-for-bit (it is observable in the counts);
    pass True to repair the dropped final block.
    """
    mask_ivls_by_chromstrand: Dict[str, List[Feature]] = defaultdict(list)
    gtf_lines = [line for line in open(gtf_file) if not line.startswith("#")]
    gtf_lines = sorted(gtf_lines, key=_sorting_key)
    if not gtf_lines:
        return mask_ivls_by_chromstrand

    repeat_ivls_list: List[Feature] = []
    line = gtf_lines.pop(0)
    fields = line.rstrip().split("\t")
    chrom, _fc, _ft, start_str, end_str, _j, strand, _j2, _tags = fields
    if chrom[:3].lower() == "chr":
        chrom = chrom[3:]
    curr_start = int(start_str)
    curr_end = int(end_str)
    curr_n = 1
    curr_chromstrand = chrom + strand

    for line in gtf_lines:
        fields = line.rstrip().split("\t")
        chrom, _fc, _ft, start_str, end_str, _j, strand, _j2, _tags = fields
        if chrom[:3].lower() == "chr":
            chrom = chrom[3:]
        start = int(start_str)
        end = int(end_str)
        chromstrand = chrom + strand
        if chromstrand != curr_chromstrand:
            mask_ivls_by_chromstrand[curr_chromstrand] = repeat_ivls_list
            repeat_ivls_list = []
            curr_chromstrand = chromstrand
        if start > curr_end + tolerance:
            repeat_ivls_list.append(Feature(start=curr_start, end=curr_end,
                                            kind=KIND_REPEAT, exin_no=curr_n))
            curr_start = start
            curr_end = end
            curr_n = 1
        else:
            curr_end = end
            curr_n += 1
    if keep_last_chromstrand:
        mask_ivls_by_chromstrand[curr_chromstrand] = repeat_ivls_list

    n = 0
    for _chromstrand, feature_list in mask_ivls_by_chromstrand.items():
        feature_list.sort()
        n += len(feature_list)
    logging.debug(f"Generated {n} intervals to mask")
    return mask_ivls_by_chromstrand
