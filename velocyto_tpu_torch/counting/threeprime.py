# Copy of velocyto_tpu/counting/threeprime.py; imports nothing of the JAX package.
"""3'-distance utilities (reference velocyto/utils.py:6-144).

Transcript-coordinate walks to the 3' end of a model, used by logic
extensions and QC; not part of the main counting path.

NOTE: transcribed from the reference for semantic parity -- the index
arithmetic of the 3'-walk IS the specification (off-by-one choices in
exin_no stepping are behavior, not style), so this file intentionally
mirrors the reference line-by-line.
"""
from __future__ import annotations

from typing import Iterable, List

from ..constants import KIND_EXON, KIND_INTRON
from .gtf import Feature
from .molecules import SegmentMatch


def jump_next_3p_exon(feature: Feature) -> Feature:
    """Next exon following transcription direction (reference utils.py:6-29).
    Raises IndexError at the 3'-most feature."""
    if feature.transcript_model.chromstrand[-1] == "+":
        ix = feature.exin_no * 2
    else:
        ix = len(feature.transcript_model.list_features) - \
            2 * (feature.exin_no - 1) - 3
        if ix < 0:
            raise IndexError
    return feature.transcript_model.list_features[ix]


def closest_3prime(segment_match: SegmentMatch) -> int:
    """Distance in bp to the 3' end walking the transcript model, skipping
    introns other than the mapped one (reference utils.py:32-85)."""
    dist23prime = 0
    if segment_match.feature.transcript_model.chromstrand[-1] == "+":
        if segment_match.maps_to_exon:
            curr_exon = segment_match.feature
            to_end_of_exon = curr_exon.end - segment_match.segment[0] + 1
        else:
            curr_intron = segment_match.feature
            to_end_of_exon = curr_intron.end - segment_match.segment[0] + 1
            curr_exon = curr_intron.get_downstream_exon()
            to_end_of_exon += len(curr_exon)
        dist23prime += to_end_of_exon
        while True:
            try:
                curr_exon = jump_next_3p_exon(curr_exon)
                dist23prime += len(curr_exon)
            except IndexError:
                break
    else:
        if segment_match.maps_to_exon:
            curr_exon = segment_match.feature
            to_end_of_exon = segment_match.segment[-1] - curr_exon.start + 1
        else:
            curr_intron = segment_match.feature
            to_end_of_exon = segment_match.segment[-1] - curr_intron.start + 1
            curr_exon = curr_intron.get_upstream_exon()
            to_end_of_exon += len(curr_exon)
        dist23prime += to_end_of_exon
        while True:
            try:
                curr_exon = jump_next_3p_exon(curr_exon)
                dist23prime += len(curr_exon)
            except IndexError:
                break
    return dist23prime


def spliced_iter(segments_list: List[SegmentMatch],
                 read_len: int = 99) -> Iterable[SegmentMatch]:
    """Group spliced segment matches into synthetic ones compatible with
    closest_3prime (reference utils.py:88-144, including its heuristics)."""
    segments_list = list(segments_list)
    while len(segments_list):
        sm = segments_list.pop(0)
        if sm.is_spliced:
            sm_list = [sm]
            while segments_list and segments_list[0].is_spliced:
                sm_list.append(segments_list.pop(0))
                if not segments_list:
                    break
                covered = sum(s.segment[1] - s.segment[0] + 1
                              for s in sm_list)
                nxt = segments_list[0]
                if covered + (nxt.segment[1] - nxt.segment[0] + 1) > read_len:
                    break
            if len(segments_list) != 2:
                # reference utils.py:119-121: bail out of ambiguous cases
                continue
            if sm_list[0].feature.transcript_model.chromstrand[-1] == "+":
                if sm_list[-1].feature.kind == KIND_INTRON:
                    yield SegmentMatch(segment=sm_list[0].segment,
                                       feature=sm_list[-1].feature)
                else:
                    span = sm_list[0].segment[-1] - sm_list[0].segment[0]
                    yield SegmentMatch(
                        segment=(sm_list[-1].feature.start - span, -1),
                        feature=sm_list[-1].feature)
            else:
                if sm_list[0].feature.kind == KIND_INTRON:
                    yield SegmentMatch(segment=sm_list[-1].segment,
                                       feature=sm_list[0].feature)
                else:
                    span = sm_list[0].segment[-1] - sm_list[0].segment[0]
                    yield SegmentMatch(
                        segment=(-1, sm_list[-1].feature.end + span),
                        feature=sm_list[0].feature)
        else:
            yield sm
