"""Multi-host counting orchestration: feeder processes over barcode ranges.

Copy of velocyto_tpu/parallel/feeders.py (prepare_counter :35,
count_distributed :99); feeder_byte_ranges lives in
counting/soa_engine.py, whose pcount shares it, and is re-exported here.  The reference's
counting loop is single-threaded by design.  Here the valid barcode set
is split into contiguous ranges; one FEEDER per range decodes the
cell-sorted BAM with the native reader and counts only its own cells.
Because every feeder's non-owned columns are zero, the global matrix is
the elementwise SUM of the feeder partials -- merge_feeder_counts over
the mesh, or a host sum.

ONE preparation, N feeders: the GTF parse and the intron-validation
markup pass over the BAM run exactly once (in the caller or here), and
the marked-up counter is shipped to every feeder in pickled form
(counting.soa_engine.run_owner_pool), the mechanism ExInCounter.pcount
uses for ``velocyto run -p N``, so serial, -p and feeder counting
produce the same loom column order (serial first-encounter order),
bit-identically.  Feeders run as spawned processes (fork is unsafe in a
torch-threaded parent).  Host code: nothing here launches a kernel.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..counting.soa_engine import feeder_byte_ranges  # noqa: F401


def prepare_counter(bamfiles: Sequence[str], gtffile: str,
                    valid_bcs: Optional[Sequence[str]] = None,
                    logic_name: str = "Default",
                    maskfile: Optional[str] = None,
                    markup_bamfiles: Optional[Sequence[str]] = None,
                    umi_extension: str = "no",
                    onefilepercell: bool = False,
                    multimap: bool = False):
    """Build the fully-prepared (GTF-parsed, repeat-masked, intron-
    validated) counter ONCE; feeders are rebuilt from its pickle."""
    from ..counting.counter import ExInCounter
    from ..counting import logics as _logics

    logic = getattr(_logics, logic_name)
    counter = ExInCounter(sampleid="feeder", logic=logic,
                          valid_bcset=set(valid_bcs) if valid_bcs else None,
                          umi_extension=umi_extension,
                          onefilepercell=onefilepercell)
    counter.peek(str(bamfiles[0]))
    counter.read_transcriptmodels(gtffile)
    if maskfile:
        counter.read_repeats(maskfile)
    if counter.logic.perform_validation_markup:
        counter.mark_up_introns([str(b) for b in (markup_bamfiles
                                                  or bamfiles)], multimap)
    return counter


def count_distributed(bamfiles: Sequence[str], gtffile: Optional[str] = None,
                      valid_bcs: Optional[Sequence[str]] = None,
                      logic_name: str = "Default",
                      maskfile: Optional[str] = None,
                      markup_bamfiles: Optional[Sequence[str]] = None,
                      umi_extension: str = "no",
                      onefilepercell: bool = False, multimap: bool = False,
                      n_feeders: int = 2, cell_batch_size: int = 100,
                      mesh=None, in_process: bool = False,
                      counter=None
                      ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Count `bamfiles` with `n_feeders` feeders, merging partials on the
    device mesh.

    Returns (layers dict of (genes, n_cells) arrays, cell order) where
    the order is the serial pass's first-encounter order -- the result
    is bit-identical (values AND columns) to ExInCounter.count.

    counter: an already-prepared ExInCounter (skips GTF/markup here);
    otherwise gtffile is required and preparation runs once.
    valid_bcs: explicit whitelist -> contiguous barcode-range ownership
    (the multi-host layout for a cell-sorted BAM); None -> stable-hash
    ownership.  mesh: a parallel.Mesh for the merge (merge_feeder_counts;
    None -> host-side sum, identical result).  in_process=True runs
    feeders sequentially in this process (dryruns / tests).
    """
    from ..counting import soa_engine

    bamfiles = [str(b) for b in bamfiles]
    if counter is None:
        if gtffile is None:
            raise ValueError("either `counter` or `gtffile` is required")
        counter = prepare_counter(bamfiles, gtffile, valid_bcs, logic_name,
                                  maskfile, markup_bamfiles, umi_extension,
                                  onefilepercell, multimap)

    if valid_bcs is not None:
        valid_bcs = list(valid_bcs)
        n_feeders = max(1, min(n_feeders, len(valid_bcs)))
        ranges = np.array_split(np.arange(len(valid_bcs)), n_feeders)
        owners: List = [frozenset(valid_bcs[i] for i in r) for r in ranges]
    else:
        n_feeders = max(1, n_feeders)
        owners = [(w, n_feeders) for w in range(n_feeders)]

    # .vtx cell index (written by the native sorter): each feeder seeks
    # straight to its barcode range and decodes ONLY its slice, so the
    # BGZF inflate + record parse scale with the feeder count instead of
    # being repeated in full per feeder
    byte_ranges = name_order = None
    # (onefilepercell cell names are FILE labels, not tag values -- the
    # index keys can never match them, so ranged decode must not apply)
    if valid_bcs is not None and len(bamfiles) == 1 \
            and not counter.onefilepercell:
        plan = soa_engine.feeder_byte_ranges(bamfiles[0], owners)
        if plan is not None:
            byte_ranges, name_order = plan

    results = soa_engine.run_owner_pool(counter, bamfiles, multimap,
                                        cell_batch_size, owners,
                                        in_process=in_process,
                                        byte_ranges=byte_ranges)
    layer_names = list(counter.logic.layers)
    n_genes = len(counter.geneid2ix)
    col_of, final, global_order = soa_engine.assemble_owner_results(
        results, name_order=name_order)

    # per-feeder partials scattered into the global frame (non-owned
    # columns zero), stacked per layer; summed on the mesh or the host
    merged: Dict[str, np.ndarray] = {}
    for layer in layer_names:
        stack = np.zeros((len(results), n_genes, len(final)),
                         dtype=np.uint32)
        for k, key in enumerate(final):
            w, j = col_of[key]
            m = results[w][0][layer]
            if m.shape[1]:
                stack[w, :, k] = m[:, j]
        if mesh is not None:
            from .counts import merge_feeder_counts
            merged[layer] = merge_feeder_counts(mesh, stack).cpu().numpy()
        else:
            merged[layer] = stack.sum(axis=0)
    logging.debug(f"count_distributed: {len(results)} feeders, "
                  f"{len(final)} cells")
    return merged, global_order
