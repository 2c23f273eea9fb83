# Copy of velocyto_tpu/counting/reads.py; imports nothing of the JAX package.
"""Alignment-record model: the decoded read and the CIGAR->segments parse.

Semantics mirror the reference exactly (velocyto/read.py:5-48 for the
Read container; velocyto/counter.py:85-129 for parse_cigar_tuple),
including the reference's quirks that affect counting output:
  - soft clips ADVANCE the reference cursor (counter.py:107-112), so a
    leading soft clip shifts the first segment right of `pos`
  - deletions/insertions <= PATCH_INDELS flanked by M operations merge
    the neighboring segments into one
"""
from __future__ import annotations

from typing import Any, List, Tuple

from ..constants import PATCH_INDELS


class Read:
    """Container for a decoded alignment (reference read.py:5-48)."""
    __slots__ = ["bc", "umi", "chrom", "strand", "pos", "segments",
                 "clip5", "clip3", "ref_skipped"]

    def __init__(self, bc: str, umi: str, chrom: str, strand: str, pos: int,
                 segments: List[Tuple[int, int]], clip5: Any, clip3: Any,
                 ref_skipped: bool) -> None:
        self.bc, self.umi, self.chrom, self.strand = bc, umi, chrom, strand
        self.pos, self.segments = pos, segments
        self.clip5, self.clip3, self.ref_skipped = clip5, clip3, ref_skipped

    @property
    def is_spliced(self) -> bool:
        return self.ref_skipped

    @property
    def start(self) -> int:
        return self.segments[0][0]

    @property
    def end(self) -> int:
        return self.segments[-1][1]

    @property
    def span(self) -> int:
        return self.end - self.start + 1

    def __lt__(self, other: Any) -> bool:
        if self.chrom == other.chrom:
            if self.start == other.start:
                return self.end < other.end
            return self.start < other.start
        return self.chrom < other.chrom

    def __gt__(self, other: Any) -> bool:
        if self.chrom == other.chrom:
            if self.start == other.start:
                return self.end > other.end
            return self.start > other.start
        return self.chrom > other.chrom

    def __repr__(self) -> str:
        return (f"Read({self.bc}${self.umi} {self.chrom}{self.strand}"
                f":{self.pos} segs={self.segments})")


def parse_cigar_tuple(cigartuples: List[Tuple[int, int]], pos: int
                      ) -> Tuple[List[Tuple[int, int]], bool, int, int]:
    """CIGAR -> genomic segments (reference counter.py:85-129 semantics).

    Returns (segments, ref_skipped, clip5, clip3).
    """
    segments: List[Tuple[int, int]] = []
    hole_to_remove = set()
    ref_skip = False
    clip5 = clip3 = 0
    p = pos
    for i, (operation_id, length) in enumerate(cigartuples):
        if operation_id == 0:       # BAM_CMATCH
            segments.append((p, p + length - 1))
            p += length
        elif operation_id == 3:     # BAM_CREF_SKIP
            ref_skip = True
            p += length
        elif operation_id == 2:     # BAM_CDEL
            if length <= PATCH_INDELS:
                try:
                    if cigartuples[i + 1][0] == 0 and cigartuples[i - 1][0] == 0:
                        hole_to_remove.add(len(segments) - 1)
                except IndexError:
                    pass
            p += length
        elif operation_id == 4:     # BAM_CSOFT_CLIP (advances the cursor!)
            if p == pos:
                clip5 = length
            else:
                clip3 = length
            p += length
        elif operation_id == 1:     # BAM_CINS
            if length <= PATCH_INDELS:
                try:
                    if cigartuples[i + 1][0] == 0 and cigartuples[i - 1][0] == 0:
                        hole_to_remove.add(len(segments) - 1)
                except IndexError:
                    pass
        elif operation_id == 5:     # BAM_CHARD_CLIP
            pass  # hard clips: mappings assumed soft clipped
    # merge segments separated by small indels
    for a, b in enumerate(sorted(hole_to_remove)):
        segments[b - a] = (segments.pop(b - a)[0], segments[b - a][1])
    return segments, ref_skip, clip5, clip3


def normalize_chrom(chrom: str) -> str:
    """BAM chromosome-name normalization (reference counter.py:275-283):
    strip a leading 'chr'; 'chrM' becomes 'MT'; 'chrX_random'-style names
    keep the part after the underscore."""
    if chrom.startswith("chr"):
        if "_" in chrom:
            chrom = chrom.split("_")[1]
        else:
            chrom = chrom[3:]
            if chrom == "M":
                chrom = "MT"
    return chrom
