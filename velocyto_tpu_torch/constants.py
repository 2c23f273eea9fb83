# Copy of velocyto_tpu/constants.py; imports nothing of the JAX package.
"""Constants shared across the counting and estimation pipelines.

Semantics mirror the reference implementation's tunables
(reference: velocyto/constants.py:1-40) so that counting output is
comparable; values are part of the on-disk/loom contract.
"""

# Segment-vs-feature match classification bitflags (reference: constants.py:1-3)
MATCH_INSIDE = 1
MATCH_OVER5END = 2
MATCH_OVER3END = 4

# Geometry tolerances (reference: constants.py:5-9)
MIN_FLANK = 5           # minimum flanking bases for overlap predicates
PATCH_INDELS = 3        # indels <= this length get patched into one segment
SPLIC_INACUR = 6        # max distance of a SKIP end from a feature boundary
MIN_POLYT = 8
MAX_USHORT = 2 ** 16 - 1

LOOM_NUMERIC_DTYPE = "uint16"

EXTENSION5_LEN = 0
EXTENSION3_LEN = 0

BINSIZE_BP = 100_000
LONGEST_INTRON_ALLOWED = 1_000_000  # reference: constants.py:17
BAM_COMPRESSION = 7

# Feature kinds, stored as small ints in the feature SoA.
KIND_EXON = ord("e")     # 101
KIND_INTRON = ord("i")   # 105
KIND_REPEAT = ord("r")   # 114

PLACEHOLDER_UMI_LEN = 12

# BAM CIGAR operation codes (BAM spec)
CIGAR = {0: "BAM_CMATCH",
         1: "BAM_CINS",
         2: "BAM_CDEL",
         3: "BAM_CREF_SKIP",
         4: "BAM_CSOFT_CLIP",
         5: "BAM_CHARD_CLIP",
         6: "BAM_CPAD",
         7: "BAM_CEQUAL",
         8: "BAM_CDIFF",
         9: "BAM_CBACK"}

# Longest genomic span a read may cover before being trashed
# (reference: counter.py:291-297)
MAX_READ_SPAN = 3_000_000


def __getattr__(name):
    # lazy: the 10x GEM sample-index table (reference constants.py:42-233)
    if name == "GEM_codes":
        from .utils.tenx_indexes import GEM_codes
        return GEM_codes
    raise AttributeError(name)
