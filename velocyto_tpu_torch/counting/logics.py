# Copy of velocyto_tpu/counting/logics.py; imports nothing of the JAX package.
"""Counting logics: molecule classification decision tables.

The reference implements seven Logic classes as ~150-line nested-if
cascades that differ only in the treatment of a few cases
(reference: velocyto/logic.py:54-1145).  Here each logic is DATA: the
shared cascade is written once, per-logic outcomes live in a small
action table, and the whole thing evaluates either per-molecule (API
parity) or vectorized over a batch of molecules as boolean-array ops --
the form the TPU/segment-sum counting pipeline consumes.

Molecule flags (reference logic.py:96-148; OR over transcript models):
  OI   has_onlyintron_model        some TM matched only introns
  OS   has_only_span_exin_model    EVERY TM has an exon-intron spanning hit
  OIV  has_onlyintron_and_valid    some intron-only TM hit a validated intron
  VM   has_valid_mixed_model       exons+introns, validated, not spanning
  IM   has_invalid_mixed_model     exons+introns, not validated, not spanning
  OE   has_onlyexo_model           some TM matched only exons
  M    has_mixed_model = VM | IM
  singleton                        the molecule is supported by ONE segment

Return codes mirror Permissive10X telemetry (logic.py:91-222):
  0 counted, 1 multigene, 2 no-gene, 3 outer multigene, 4 unclassified.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# actions
NONE, SPLICED, UNSPLICED, AMBIGUOUS, SPANNING = 0, 1, 2, 3, 4
_LAYER_OF_ACTION = {SPLICED: "spliced", UNSPLICED: "unspliced",
                    AMBIGUOUS: "ambiguous", SPANNING: "spanning"}


class Logic:
    """Base logic (reference logic.py:7-51)."""
    name = "Logic"
    layers: List[str] = []
    stranded = True
    perform_validation_markup = True
    accept_discordant = False
    # whether the exon-intron span check only fires on validated introns
    # (True for the 10x logics, logic.py:119-128; SmartSeq2 checks the
    # span unconditionally, logic.py:1086-1093)
    span_gated_on_validation = True

    # per-logic outcome slots for the shared 10x cascade; see decide()
    #   a: validated-intron-only singleton      b: ... non-singleton
    #   c: non-validated-intron-only singleton  d: ... non-singleton
    #   e: invalid mixed   f: valid mixed       g: intron-only + mixed
    actions: Dict[str, int] = {}

    def count(self, molitem, cell_bcidx: int,
              dict_layers_columns: Dict[str, np.ndarray],
              geneid2ix: Dict[str, int]) -> Optional[int]:
        """Reference-parity single-molecule interface."""
        from .molecules import molitem_flags  # local import, avoids cycle
        n_records = len(molitem.mappings_record or {})
        if n_records == 0:
            return 2
        geneids = set(tm.geneid for tm in molitem.mappings_record.keys())
        if len(geneids) != 1:
            return 3
        flags, singleton = molitem_flags(
            molitem, gate_span_on_validation=self.span_gated_on_validation)
        action, code = self.decide(singleton=singleton, **flags)
        if action != NONE:
            gene_ix = geneid2ix[next(iter(geneids))]
            dict_layers_columns[_LAYER_OF_ACTION[action]][
                gene_ix, cell_bcidx] += 1
        return code

    def decide(self, OI: bool, OS: bool, OIV: bool, VM: bool, IM: bool,
               OE: bool, singleton: bool) -> Tuple[int, int]:
        """The shared 10x cascade (reference logic.py:158-219), with
        per-logic outcomes from self.actions.  Returns (action, code)."""
        a = self.actions
        M = VM or IM
        if OE and not OI and not M:
            return SPLICED, 0
        if OS:
            return a.get("spanning_target", UNSPLICED), 0
        if OIV and not M and not OE:
            act = a["a"] if singleton else a["b"]
            return act, 0
        if OI and not OIV and not M and not OE:
            act = a["c"] if singleton else a["d"]
            return act, 0
        if IM and not VM and not OI and not OE and not OS:
            return a["e"], 0
        if VM and not OI and not OE and not OS:
            return a["f"], 0
        if OI and OE and not M:
            return AMBIGUOUS, 0
        if OI and not OE and M:
            return a["g"], 0
        if not OI and OE and M:
            return AMBIGUOUS, 0
        if OI and OE and M:
            return AMBIGUOUS, 0
        return NONE, 4

    def decide_batch(self, OI, OS, OIV, VM, IM, OE, singleton) -> np.ndarray:
        """Vectorized cascade over molecule flag arrays -> action codes."""
        a = self.actions
        M = VM | IM
        sel = lambda s, ns: np.where(singleton, s, ns)
        conds = [
            OE & ~OI & ~M,
            OS,
            OIV & ~M & ~OE,
            OI & ~OIV & ~M & ~OE,
            IM & ~VM & ~OI & ~OE & ~OS,
            VM & ~OI & ~OE & ~OS,
            OI & OE & ~M,
            OI & ~OE & M,
            ~OI & OE & M,
            OI & OE & M,
        ]
        outs = [
            np.full_like(OI, SPLICED, dtype=np.int8),
            np.full_like(OI, a.get("spanning_target", UNSPLICED), dtype=np.int8),
            sel(a["a"], a["b"]).astype(np.int8),
            sel(a["c"], a["d"]).astype(np.int8),
            np.full_like(OI, a["e"], dtype=np.int8),
            np.full_like(OI, a["f"], dtype=np.int8),
            np.full_like(OI, AMBIGUOUS, dtype=np.int8),
            np.full_like(OI, a["g"], dtype=np.int8),
            np.full_like(OI, AMBIGUOUS, dtype=np.int8),
            np.full_like(OI, AMBIGUOUS, dtype=np.int8),
        ]
        return np.select(conds, outs, default=NONE).astype(np.int8)


class Permissive10X(Logic):
    """Intronic reads always count unspliced (reference logic.py:54-222)."""
    name = "Permissive10X"
    layers = ["spliced", "unspliced", "ambiguous"]
    actions = dict(a=UNSPLICED, b=UNSPLICED, c=UNSPLICED, d=UNSPLICED,
                   e=UNSPLICED, f=UNSPLICED, g=UNSPLICED)


class Intermediate10X(Logic):
    """Singletons in non-validated introns are discarded
    (reference logic.py:225-387)."""
    name = "Intermediate10X"
    layers = ["spliced", "unspliced", "ambiguous"]
    actions = dict(a=UNSPLICED, b=UNSPLICED, c=NONE, d=UNSPLICED,
                   e=NONE, f=UNSPLICED, g=AMBIGUOUS)


class ValidatedIntrons10X(Logic):
    """Only validated-intron evidence counts unspliced
    (reference logic.py:390-550)."""
    name = "ValidatedIntrons10X"
    layers = ["spliced", "unspliced", "ambiguous"]
    actions = dict(a=UNSPLICED, b=UNSPLICED, c=NONE, d=NONE,
                   e=NONE, f=UNSPLICED, g=AMBIGUOUS)


class Stricter10X(Logic):
    """Validated-intron NON-singletons only (reference logic.py:553-707)."""
    name = "Stricter10X"
    layers = ["spliced", "unspliced", "ambiguous"]
    actions = dict(a=NONE, b=UNSPLICED, c=NONE, d=NONE,
                   e=NONE, f=UNSPLICED, g=AMBIGUOUS)


class ObservedSpanning10X(Logic):
    """Only observed exon-intron spanning molecules count unspliced
    (reference logic.py:710-866)."""
    name = "ObservedSpanning10X"
    layers = ["spliced", "unspliced", "ambiguous"]
    actions = dict(a=NONE, b=NONE, c=NONE, d=NONE,
                   e=NONE, f=UNSPLICED, g=AMBIGUOUS)


class Discordant10X(Logic):
    """Permissive + discordant-strand rescue (reference logic.py:869-1028)."""
    name = "Discordant10X"
    layers = ["spliced", "unspliced", "ambiguous"]
    accept_discordant = True
    actions = dict(a=UNSPLICED, b=UNSPLICED, c=UNSPLICED, d=UNSPLICED,
                   e=UNSPLICED, f=UNSPLICED, g=AMBIGUOUS)


class SmartSeq2(Logic):
    """Unstranded, UMI-less plates; 4th layer 'spanning'
    (reference logic.py:1031-1142).  Flags use the UNGATED span (no intron
    validation) and its own shorter cascade."""
    name = "SmartSeq2"
    layers = ["spliced", "unspliced", "ambiguous", "spanning"]
    stranded = False
    perform_validation_markup = False
    span_gated_on_validation = False
    actions = dict(spanning_target=SPANNING)

    def decide(self, OI: bool, OS: bool, OIV: bool, VM: bool, IM: bool,
               OE: bool, singleton: bool) -> Tuple[int, int]:
        # here VM/IM carry "exons & introns & not span" (ungated mixed)
        M = VM or IM
        if OE and not OI and not M:
            return SPLICED, 0
        if OS:
            return SPANNING, 0
        if OI and not M and not OE:
            return UNSPLICED, 0
        if OI and OE and not M:
            return AMBIGUOUS, 0
        if not OI and OE and M:
            return AMBIGUOUS, 0
        return NONE, 4

    def decide_batch(self, OI, OS, OIV, VM, IM, OE, singleton) -> np.ndarray:
        M = VM | IM
        conds = [
            OE & ~OI & ~M,
            OS,
            OI & ~M & ~OE,
            OI & OE & ~M,
            ~OI & OE & M,
        ]
        outs = [
            np.full_like(OI, SPLICED, dtype=np.int8),
            np.full_like(OI, SPANNING, dtype=np.int8),
            np.full_like(OI, UNSPLICED, dtype=np.int8),
            np.full_like(OI, AMBIGUOUS, dtype=np.int8),
            np.full_like(OI, AMBIGUOUS, dtype=np.int8),
        ]
        return np.select(conds, outs, default=NONE).astype(np.int8)


Default = Permissive10X

LOGICS = {cls.name: cls for cls in
          (Permissive10X, Intermediate10X, ValidatedIntrons10X, Stricter10X,
           ObservedSpanning10X, Discordant10X, SmartSeq2)}
LOGICS["Default"] = Default
