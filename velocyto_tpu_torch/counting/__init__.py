# Copy of velocyto_tpu/counting/__init__.py; imports nothing of the JAX package.
from .gtf import Feature, TranscriptModel, GeneInfo
from .reads import Read, parse_cigar_tuple, normalize_chrom
from .logics import (Logic, Permissive10X, Intermediate10X,
                     ValidatedIntrons10X, Stricter10X, ObservedSpanning10X,
                     Discordant10X, SmartSeq2, Default, LOGICS)
from .molecules import Molitem, SegmentMatch
from .counter import ExInCounter
from . import bamio
from . import objectmode
from . import threeprime
from .threeprime import closest_3prime, jump_next_3p_exon, spliced_iter

__all__ = ["Feature", "TranscriptModel", "GeneInfo", "Read",
           "parse_cigar_tuple", "normalize_chrom", "Logic", "Permissive10X",
           "Intermediate10X", "ValidatedIntrons10X", "Stricter10X",
           "ObservedSpanning10X", "Discordant10X", "SmartSeq2", "Default",
           "LOGICS", "Molitem", "SegmentMatch", "ExInCounter", "bamio"]
