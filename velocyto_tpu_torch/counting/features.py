# Copy of velocyto_tpu/counting/features.py; imports nothing of the JAX package.
"""Structure-of-arrays feature index + vectorized interval matching.

The reference walks a sorted Feature list per read with a monotonic
cursor (velocyto/indexes.py:63-269).  Here the features are flattened
into numpy arrays once, and reads are matched in *batches* with
searchsorted windows + vectorized predicates -- the array-native design
that the TPU/XLA classification pipeline consumes.

Semantic equivalences (proven, see notes inline):
  - the reference cursor (indexes.py:101-104,226-229) is a pure
    optimization: a feature skipped by the cursor can never satisfy any
    match predicate for later reads of the sorted stream, so a windowed
    superset + exact predicates reproduces the matching exactly;
  - the reference's scan loop runs `while i < maxiidx` and therefore
    never examines the LAST feature of each chromstrand list
    (indexes.py:111,162,236); we replicate that off-by-one for parity.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import (KIND_EXON, KIND_INTRON, MIN_FLANK, SPLIC_INACUR,
                         MATCH_INSIDE, MATCH_OVER5END, MATCH_OVER3END)
from .gtf import Feature, TranscriptModel


class FeatureArrays:
    """Flattened features of one chromosome+strand, sorted like the
    reference index (Feature.__lt__: by start then end)."""

    __slots__ = ["starts", "ends", "kind", "exin_no", "tm_idx", "gene_ix",
                 "is_validated", "is_last3", "down_exon", "up_exon",
                 "max_len", "n", "features", "tm_list", "tm_gene_ix"]

    def __init__(self, feature_list: List[Feature],
                 geneid2ix: Optional[Dict[str, int]] = None) -> None:
        feature_list = sorted(feature_list)
        self.features = feature_list
        n = len(feature_list)
        self.n = n
        self.starts = np.fromiter((f.start for f in feature_list),
                                  np.int64, n)
        self.ends = np.fromiter((f.end for f in feature_list), np.int64, n)
        self.kind = np.fromiter((f.kind for f in feature_list), np.uint8, n)
        self.exin_no = np.fromiter((f.exin_no for f in feature_list),
                                   np.int32, n)
        self.is_validated = np.zeros(n, dtype=bool)
        self.max_len = int((self.ends - self.starts + 1).max()) if n else 0

        # transcript-model table
        tm_seen: Dict[int, int] = {}
        self.tm_list: List[TranscriptModel] = []
        tm_idx = np.zeros(n, dtype=np.int32)
        for i, f in enumerate(feature_list):
            tm = f.transcript_model
            key = id(tm)
            if key not in tm_seen:
                tm_seen[key] = len(self.tm_list)
                self.tm_list.append(tm)
            tm_idx[i] = tm_seen[key]
        self.tm_idx = tm_idx
        if geneid2ix is not None:
            self.tm_gene_ix = np.array(
                [geneid2ix.get(tm.geneid, -1) for tm in self.tm_list],
                dtype=np.int64)
        else:
            self.tm_gene_ix = np.full(len(self.tm_list), -1, dtype=np.int64)
        self.gene_ix = (self.tm_gene_ix[tm_idx] if n
                        else np.zeros(0, dtype=np.int64))

        # intron -> neighbor-exon navigation + 3' flags, resolved to array
        # positions (reference feature.py:38-75)
        pos_of = {id(f): i for i, f in enumerate(feature_list)}
        self.down_exon = np.full(n, -1, dtype=np.int64)
        self.up_exon = np.full(n, -1, dtype=np.int64)
        self.is_last3 = np.zeros(n, dtype=bool)
        for i, f in enumerate(feature_list):
            if f.transcript_model is None:
                continue
            if f.kind == KIND_INTRON:
                try:
                    self.down_exon[i] = pos_of[id(f.get_downstream_exon())]
                    self.up_exon[i] = pos_of[id(f.get_upstream_exon())]
                except (KeyError, IndexError):
                    pass
            elif f.kind == KIND_EXON:
                self.is_last3[i] = f.is_last_3prime

    # -- vectorized predicates (reference feature.py:103-143) -------------

    def _window(self, seg_start: np.ndarray, seg_end: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Candidate windows [lo, hi) per segment: a superset of every
        feature that can satisfy any predicate.  hi excludes the last
        feature (reference off-by-one); lo uses the max feature length so
        no feature with end (or start) inside the segment is missed."""
        hi = np.searchsorted(self.starts, seg_end, side="left")
        hi = np.minimum(hi, max(self.n - 1, 0))
        lo = np.searchsorted(self.starts,
                             seg_start - self.max_len + 1, side="left")
        lo = np.minimum(lo, hi)
        return lo, hi

    def match_segments(self, seg_start: np.ndarray, seg_end: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """All (segment_row, feature_idx) pairs satisfying the reference's
        find_overlapping_ivls predicate:
        intersects(segment) and seg_len > MIN_FLANK (indexes.py:241).

        seg_start/seg_end: (S,) int64.  Returns (pair_seg_row, pair_feat).
        """
        if self.n == 0 or len(seg_start) == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64))
        lo, hi = self._window(seg_start, seg_end)
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64))
        seg_row = np.repeat(np.arange(len(seg_start)), counts)
        # flat candidate feature indices: lo[r] + offset within window
        offs = np.arange(total) - np.repeat(
            np.cumsum(counts) - counts, counts)
        feat = np.repeat(lo, counts) + offs
        s = seg_start[seg_row]
        e = seg_end[seg_row]
        ok = ((e - MIN_FLANK > self.starts[feat]) &
              (s + MIN_FLANK < self.ends[feat]) &
              ((e - s) > MIN_FLANK))
        return seg_row[ok], feat[ok]

    def segment_matchtype(self, seg_start: np.ndarray, seg_end: np.ndarray
                          ) -> np.ndarray:
        """OR of MATCH_* flags per segment over all candidate features
        (reference indexes.py:106-123, used by the repeat mask check)."""
        out = np.zeros(len(seg_start), dtype=np.int64)
        if self.n == 0 or len(seg_start) == 0:
            return out
        lo, hi = self._window(seg_start, seg_end)
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return out
        seg_row = np.repeat(np.arange(len(seg_start)), counts)
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
        feat = np.repeat(lo, counts) + offs
        s = seg_start[seg_row]
        e = seg_end[seg_row]
        fs = self.starts[feat]
        fe = self.ends[feat]
        # the reference loop only evaluates candidates with
        # doesnt_start_after == start < seg_end; window hi already enforces
        contains = ((s + MIN_FLANK >= fs) & (e - MIN_FLANK <= fe) &
                    ((e - s) > MIN_FLANK))
        over5 = (s + MIN_FLANK < fs) & (e - MIN_FLANK > fs)
        over3 = (s + MIN_FLANK < fe) & (e - MIN_FLANK > fe)
        mt = (contains * MATCH_INSIDE + over5 * MATCH_OVER5END +
              over3 * MATCH_OVER3END)
        np.bitwise_or.at(out, seg_row, mt)
        return out

    def mark_overlapping(self, seg_start: np.ndarray,
                         seg_end: np.ndarray) -> int:
        """Intron validation pass (reference indexes.py:131-193): an intron
        becomes validated when a segment straddles one of its exon-intron
        boundaries together with the neighboring exon.  Mutates
        self.is_validated; returns the number of introns newly marked."""
        if self.n == 0 or len(seg_start) == 0:
            return 0
        srow, feat = self._overlap_pairs(seg_start, seg_end)
        if len(feat) == 0:
            return 0
        intron = self.kind[feat] == KIND_INTRON
        srow, feat = srow[intron], feat[intron]
        s = seg_start[srow]
        e = seg_end[srow]
        fs = self.starts[feat]
        fe = self.ends[feat]
        # end boundary: intron.end_overlaps(seg) & downstream_exon.start_overlaps(seg)
        de = self.down_exon[feat]
        d_ok = de >= 0
        end_ov = (s + MIN_FLANK < fe) & (e - MIN_FLANK > fe)
        dn_start = np.where(d_ok, self.starts[np.clip(de, 0, None)], 0)
        dn_ov = d_ok & (s + MIN_FLANK < dn_start) & (e - MIN_FLANK > dn_start)
        hit_end = end_ov & dn_ov
        # start boundary: intron.start_overlaps(seg) & upstream_exon.end_overlaps(seg)
        ue = self.up_exon[feat]
        u_ok = ue >= 0
        start_ov = (s + MIN_FLANK < fs) & (e - MIN_FLANK > fs)
        up_end = np.where(u_ok, self.ends[np.clip(ue, 0, None)], 0)
        up_ov = u_ok & (s + MIN_FLANK < up_end) & (e - MIN_FLANK > up_end)
        hit_start = start_ov & up_ov
        hits = feat[hit_end | hit_start]
        before = int(self.is_validated.sum())
        self.is_validated[hits] = True
        # keep the object model in sync (used by reports / debugging)
        for i in np.unique(hits):
            self.features[i].is_validated = True
        return int(self.is_validated.sum()) - before

    def _overlap_pairs(self, seg_start, seg_end):
        """Candidate (segment, feature) pairs inside the scan windows
        (no intersect filtering -- markup checks its own predicates)."""
        lo, hi = self._window(seg_start, seg_end)
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64))
        seg_row = np.repeat(np.arange(len(seg_start)), counts)
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
        feat = np.repeat(lo, counts) + offs
        return seg_row, feat

    def exin_span_flags(self, srow: np.ndarray, feat: np.ndarray,
                        seg_start: np.ndarray, seg_end: np.ndarray
                        ) -> np.ndarray:
        """Per (segment, intron-feature) pair: does the segment straddle an
        exon/intron boundary of this intron (reference logic.py:121-128)?
        Pairs on non-intron features return False."""
        s = seg_start[srow]
        e = seg_end[srow]
        fs = self.starts[feat]
        fe = self.ends[feat]
        de = self.down_exon[feat]
        ue = self.up_exon[feat]
        end_ov = (s + MIN_FLANK < fe) & (e - MIN_FLANK > fe)
        dn_start = np.where(de >= 0, self.starts[np.clip(de, 0, None)], 0)
        dn_ov = (de >= 0) & (s + MIN_FLANK < dn_start) & \
                (e - MIN_FLANK > dn_start)
        start_ov = (s + MIN_FLANK < fs) & (e - MIN_FLANK > fs)
        up_end = np.where(ue >= 0, self.ends[np.clip(ue, 0, None)], 0)
        up_ov = (ue >= 0) & (s + MIN_FLANK < up_end) & \
                (e - MIN_FLANK > up_end)
        return (self.kind[feat] == KIND_INTRON) & \
               ((end_ov & dn_ov) | (start_ov & up_ov))

    def skip_makes_sense(self, srow: np.ndarray, feat: np.ndarray,
                         seg_start: np.ndarray, seg_end: np.ndarray,
                         is_spliced: np.ndarray) -> np.ndarray:
        """Reference segment_match.py:22-31: a SKIP-bearing read's segment
        must land within SPLIC_INACUR of a feature boundary."""
        sense = np.ones(len(srow), dtype=bool)
        sp = is_spliced[srow]
        near = (np.abs(self.starts[feat] - seg_start[srow]) <= SPLIC_INACUR) | \
               (np.abs(self.ends[feat] - seg_end[srow]) <= SPLIC_INACUR)
        sense[sp] = near[sp]
        return sense


def build_feature_arrays(annotations: Dict[str, Dict[str, TranscriptModel]],
                         geneid2ix: Dict[str, int]
                         ) -> Dict[str, FeatureArrays]:
    """Flatten per-chromstrand TranscriptModel dicts into FeatureArrays."""
    from itertools import chain
    out: Dict[str, FeatureArrays] = {}
    for chromstrand, tm_dict in annotations.items():
        feats = list(chain.from_iterable(tm.list_features
                                         for tm in tm_dict.values()))
        out[chromstrand] = FeatureArrays(feats, geneid2ix)
    return out


def build_mask_arrays(mask_ivls: Dict[str, List[Feature]]
                      ) -> Dict[str, FeatureArrays]:
    return {cs: FeatureArrays(fl) for cs, fl in mask_ivls.items()}
