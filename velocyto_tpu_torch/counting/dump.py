# Copy of velocyto_tpu/counting/dump.py; imports nothing of the JAX package.
"""Molecular mapping reports (`--dump`), the counting pipeline's
ground-truth debugging artifact (reference counter.py:866-944).

Layouts match the reference:
  hdf5 mode ("N"):  info/{tr_id,features_gene,is_last3prime,is_intron,
                    start_end,exino,strandplus,chrm} +
                    cells/<sample>_<cell>/{pos,ixs,mol}
  pickle mode ("pN"): molitems + reads pickles per dumped batch.

h5py is imported only when an hdf5 report is written, so ExInCounter
(which always builds a DumpWriter) constructs where h5py is missing.
"""
from __future__ import annotations

import logging
import os
import pickle
from collections import defaultdict
from typing import Dict

import numpy as np


class DumpWriter:
    def __init__(self, dump_option: str, sampleid: str,
                 outputfolder: str) -> None:
        dump_option = str(dump_option)
        if dump_option.startswith("p"):
            self.kind = "p"
            self.every_n = int(dump_option[1:] or 0)
        else:
            self.kind = "h"
            self.every_n = int(dump_option or 0)
        self.state = 0
        self.sampleid = sampleid
        self.outputfolder = outputfolder
        self._info_written = False
        self.inv_tridstart2ix: Dict[str, int] = {}

    @property
    def active(self) -> bool:
        return self.every_n > 0

    def maybe_dump(self, molitems, reads, annotations) -> None:
        if not self.active:
            return
        due = (self.state % self.every_n) == 0
        self.state += 1
        if not due or not molitems:
            return
        if self.kind == "p":
            first_cell = next(iter(molitems.keys())).split("$")[0]
            os.makedirs("pickle_dump", exist_ok=True)
            pickle.dump(molitems, open(
                f"pickle_dump/molitems_dump_{first_cell}.pickle", "wb"))
            pickle.dump(reads, open(
                f"pickle_dump/reads_to_count{first_cell}.pickle", "wb"))
            return
        os.makedirs(os.path.join(self.outputfolder, "dump"), exist_ok=True)
        path = os.path.join(self.outputfolder, "dump",
                            f"{self.sampleid}.hdf5")
        import h5py
        with h5py.File(path, "a") as f:
            if "info/tr_id" not in f:
                self._write_info(f, annotations)
            self._write_cells(f, molitems)

    def _write_info(self, f, annotations) -> None:
        tr_id, gene, last3, is_intron, start_end, exino, strandplus, chrm = \
            [], [], [], [], [], [], [], []
        for _cs, tm_dict in annotations.items():
            for tm in tm_dict.values():
                for ivl in tm:
                    tr_id.append(tm.trid)
                    gene.append(tm.genename)
                    last3.append(ivl.is_last_3prime)
                    is_intron.append(ivl.kind == ord("i"))
                    start_end.append((ivl.start, ivl.end))
                    exino.append(ivl.exin_no)
                    strandplus.append(tm.chromstrand[-1:] == "+")
                    chrm.append(tm.chromstrand[:-1])
        for i in range(len(tr_id)):
            self.inv_tridstart2ix[f"{tr_id[i]}_{start_end[i][0]}"] = i

        def ds(name, data, dtype):
            f.create_dataset(name, data=np.array(data, dtype=dtype),
                             compression="gzip", shuffle=False,
                             compression_opts=4)
        ds("info/tr_id", tr_id, "S24")
        ds("info/features_gene", gene, "S15")
        ds("info/is_last3prime", last3, bool)
        ds("info/is_intron", is_intron, bool)
        ds("info/start_end", start_end, np.int64)
        ds("info/exino", exino, np.uint8)
        ds("info/strandplus", strandplus, bool)
        ds("info/chrm", chrm, "S6")

    def _write_cells(self, f, molitems) -> None:
        pos = defaultdict(list)
        mol = defaultdict(list)
        ixs = defaultdict(list)
        count_i = 0
        for mol_bc, molitem in molitems.items():
            cell_name = mol_bc.split("$")[0]
            if not molitem.mappings_record:
                continue
            try:
                matches = next(iter(molitem.mappings_record.items()))[1]
            except StopIteration:
                continue
            for match in matches:
                key = (f"{match.feature.transcript_model.trid}_"
                       f"{match.feature.start}")
                if key not in self.inv_tridstart2ix:
                    continue
                mol[cell_name].append(count_i)
                pos[cell_name].append(tuple(match.segment))
                ixs[cell_name].append(self.inv_tridstart2ix[key])
            count_i += 1
        for cell_name in mol.keys():
            base = f"cells/{self.sampleid}_{cell_name}"
            if base in f:
                continue
            f.create_dataset(f"{base}/pos",
                             data=np.array(pos[cell_name], dtype=np.int32),
                             compression="gzip", compression_opts=4)
            f.create_dataset(f"{base}/ixs",
                             data=np.array(ixs[cell_name], dtype=np.intp),
                             compression="gzip", compression_opts=4)
            f.create_dataset(f"{base}/mol",
                             data=np.array(mol[cell_name], dtype=np.uint32),
                             compression="gzip", compression_opts=4)
