# Copy of velocyto_tpu/commands/_run.py; imports nothing of the JAX package.
"""Counting orchestrator: the "main" behind every run subcommand.

Mirrors reference commands/_run.py:26-298: resolve inputs, peek barcode
protocol, start `samtools sort -t CB` concurrently with GTF parsing, run
the two BAM passes, write the 4-layer loom.
"""
from __future__ import annotations

import glob
import gzip
import logging
import multiprocessing
import os
import random
import string
import subprocess
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .. import _version
from ..constants import BAM_COMPRESSION
from ..counting.counter import ExInCounter
from ..counting.logics import LOGICS, Logic
from ..io import loom as loomio
from ..metadata import MetadataCollection


def id_generator(size: int = 6,
                 chars: str = string.ascii_uppercase + string.digits) -> str:
    return "".join(random.choice(chars) for _ in range(size))


def _run(*, bamfile: Tuple[str, ...], gtffile: str, bcfile: Optional[str],
         outputfolder: Optional[str], sampleid: Optional[str],
         metadatatable: Optional[str], repmask: Optional[str],
         onefilepercell: bool, logic: str, without_umi: bool,
         umi_extension: str, multimap: bool, test: bool,
         samtools_threads: int, samtools_memory: int,
         loom_numeric_dtype: str, dump: str, verbose: int,
         processes: int = 0, additional_ca: dict = {}) -> None:
    """Run the counting pipeline, outputting a loom file."""
    logging.basicConfig(
        stream=sys.stdout,
        format="%(asctime)s - %(levelname)s - %(message)s",
        level=[logging.ERROR, logging.WARNING, logging.INFO,
               logging.DEBUG][min(verbose, 3)])

    if isinstance(bamfile, tuple) and len(bamfile) > 1 and \
            bamfile[-1][-4:] in (".bam", ".sam"):
        multi = True
    elif isinstance(bamfile, tuple) and len(bamfile) == 1:
        multi = False
    else:
        raise IOError(f"Something went wrong in the argument parsing. "
                      f"You passed as bamfile: {bamfile}")

    if onefilepercell and multi:
        if bcfile is not None:
            raise ValueError("Inputs incompatibility. --bcfile/-b option "
                             "was used together with --onefilepercell/-c")
        logging.warning("Each bam file will be interpreted as a "
                        "DIFFERENT cell")
    elif not onefilepercell and multi:
        logging.warning("Several input files but --onefilepercell is False. "
                        "Each bam file will be interpreted as containing a "
                        "SET of cells!!!")

    if sampleid is None:
        assert metadatatable is None, \
            "--metadatatable was specified but cannot fetch sample metadata " \
            "without valid sampleid"
        if multi and not onefilepercell:
            full_name = "_".join(os.path.basename(bamfile[i]).split(".")[0]
                                 for i in range(len(bamfile)))
            if len(full_name) > 50:
                sampleid = (f"multi_input_"
                            f"{os.path.basename(bamfile[0]).split('.')[0]}"
                            f"_{id_generator(5)}")
            else:
                sampleid = f"multi_input_{full_name}_and_others_{id_generator(5)}"
        elif multi and onefilepercell:
            sampleid = (f"onefilepercell_"
                        f"{os.path.basename(bamfile[0]).split('.')[0]}"
                        f"_and_others_{id_generator(5)}")
        else:
            sampleid = (f"{os.path.basename(bamfile[0]).split('.')[0]}"
                        f"_{id_generator(5)}")
        logging.info(f"No SAMPLEID specified, the sample will be called "
                     f"{sampleid}")

    if outputfolder is None:
        outputfolder = os.path.join(os.path.split(bamfile[0])[0], "velocyto")
        logging.info(f"No OUTPUTFOLDER specified, find output files inside "
                     f"{outputfolder}")
    if not os.path.exists(outputfolder):
        os.makedirs(outputfolder, exist_ok=True)

    logic_class = LOGICS.get(logic)
    if logic_class is None:
        # extension point (reference _run.py:86-91 resolves by reflection
        # on the package namespace, the pattern doc/tutorial/cli.rst
        # advertises for user-defined Logic subclasses)
        import velocyto_tpu_torch as _vt
        logic_class = getattr(_vt, logic, None)
    if logic_class is None or not (isinstance(logic_class, type) and
                                   issubclass(logic_class, Logic)):
        raise ValueError(f"{logic} is not a valid logic. Choose one among "
                         f"{', '.join(sorted(LOGICS))}")
    logic_obj = logic_class()
    logging.debug(f"Using logic: {logic}")

    if bcfile is None:
        logging.debug("Cell barcodes will be determined while reading "
                      "the .bam file")
        valid_bcset = None
        gem_grp = ""
    else:
        valid_bcs_list = (gzip.open(bcfile).read().decode()
                          if bcfile.endswith(".gz")
                          else open(bcfile).read()).rstrip().split()
        if len(set(bc.split("-")[0] for bc in valid_bcs_list)) == 1 and \
                "-" in valid_bcs_list[0]:
            gem_grp = f"-{valid_bcs_list[0].split('-')[-1]}"
        else:
            gem_grp = "x" if any("-" in b for b in valid_bcs_list) else ""
        valid_bcset = set(bc.split("-")[0] for bc in valid_bcs_list)
        logging.info(f"Read {len(valid_bcs_list)} cell barcodes from {bcfile}")

    if metadatatable:
        try:
            sample_metadata = MetadataCollection(metadatatable)
            sample = sample_metadata.where("SampleID", sampleid)
            if len(sample) == 0:
                logging.error(f"Sample ID {sampleid} not found in sample sheet")
                sample = {}
            elif len(sample) > 1:
                logging.error(f"Sample ID {sampleid} has multiple lines in "
                              f"sample sheet")
                sys.exit(1)
            else:
                sample = sample[0].dict
        except (NameError, TypeError):
            logging.warning("SAMPLEFILE was not specified")
            sample = {}
    else:
        sample = {}

    if without_umi:
        if umi_extension != "no":
            logging.warning("--umi-extension was specified but incompatible "
                            "with --without-umi, it will be ignored!")
        umi_extension = "without_umi"

    exincounter = ExInCounter(sampleid=sampleid, logic=logic_class,
                              valid_bcset=valid_bcset,
                              umi_extension=umi_extension,
                              onefilepercell=onefilepercell,
                              dump_option=dump, outputfolder=outputfolder,
                              loom_numeric_dtype=loom_numeric_dtype)

    # samtools resources heuristic (reference _run.py:141-148)
    try:
        mb_available = int(subprocess.check_output(
            "grep MemAvailable /proc/meminfo".split()).split()[1]) / 1000
    except (subprocess.CalledProcessError, FileNotFoundError):
        mb_available = 32000
    threads_to_use = min(samtools_threads, multiprocessing.cpu_count())
    mb_to_use = int(min(samtools_memory,
                        mb_available / (len(bamfile) * threads_to_use)))

    if onefilepercell and without_umi:
        tagname = "NOTAG"
    elif onefilepercell:
        tagname = "NOTAG"
        exincounter.peek_umi_only(bamfile[0])
    else:
        exincounter.peek(bamfile[0])
        tagname = exincounter.cellbarcode_str

    if multi and onefilepercell:
        bamfile_cellsorted = list(bamfile)
    elif onefilepercell:
        bamfile_cellsorted = [bamfile[0]]
    else:
        bamfile_cellsorted = [
            os.path.join(os.path.dirname(bmf),
                         "cellsorted_" + os.path.basename(bmf))
            for bmf in bamfile]

    sorting_processes: Dict[int, Any] = {}
    check_end_process = False
    for ni, bmf_cellsorted in enumerate(bamfile_cellsorted):
        if bmf_cellsorted == bamfile[ni]:
            continue
        command = (f"samtools sort -l {BAM_COMPRESSION} -m {mb_to_use}M "
                   f"-t {tagname} -O BAM -@ {threads_to_use} "
                   f"-o {bmf_cellsorted} {bamfile[ni]}")
        if os.path.exists(bmf_cellsorted):
            logging.warning(f"The file {bmf_cellsorted} already exists. "
                            "The sorting step will be skipped.")
        else:
            try:
                sorting_processes[ni] = subprocess.Popen(
                    command.split(), stdout=subprocess.PIPE)
                logging.info(f"Sorting {bamfile[ni]} -> {bmf_cellsorted}")
                check_end_process = True
            except FileNotFoundError:
                # no samtools: the native external sorter (parallel BGZF
                # compression, spill runs above the memory limit), run in
                # a thread so it overlaps GTF parsing like the samtools
                # subprocess does; pure-python as last resort
                from .. import native
                if native.available():
                    logging.info(f"Sorting {bamfile[ni]} -> "
                                 f"{bmf_cellsorted} (native sorter)")
                    import threading

                    handle = _ThreadHandle()

                    def _sort(src=bamfile[ni], dst=bmf_cellsorted,
                              handle=handle):
                        try:
                            native.bam_sort_by_tag(
                                src, dst, tagname,
                                mem_limit=mb_to_use * threads_to_use << 20,
                                n_threads=threads_to_use)
                        except (IOError, RuntimeError) as e:
                            handle.error = e

                    handle.thread = threading.Thread(target=_sort,
                                                     daemon=True)
                    handle.thread.start()
                    sorting_processes[ni] = handle
                    check_end_process = True
                else:
                    logging.warning("samtools not found; using the "
                                    "internal cell-barcode sorter")
                    _internal_cellsort(bamfile[ni], bmf_cellsorted, tagname)

    logging.info(f"Load the annotation from {gtffile}")
    exincounter.read_transcriptmodels(gtffile)

    if repmask is not None:
        logging.info(f"Load the repeat masking annotation from {repmask}")
        exincounter.read_repeats(repmask)

    logging.info(f"Scan {' '.join(bamfile)} to validate intron intervals")
    if test:
        # developer escape hatch (reference _run.py:200-210): cache the
        # parsed+marked-up counter so repeated debugging runs skip the
        # GTF/markup passes
        logging.warning("This place is for developer only!")
        import pickle
        if os.path.exists("exincounter_dump.pickle"):
            logging.debug("exincounter_dump.pickle is being loaded")
            with open("exincounter_dump.pickle", "rb") as f:
                exincounter = pickle.load(f)
        else:
            logging.debug("exincounter_dump.pickle was not found")
            logging.debug("Dumping exincounter_dump.pickle BEFORE markup")
            with open("exincounter_dump.pickle", "wb") as f:
                pickle.dump(exincounter, f)
            exincounter.mark_up_introns(bamfile=bamfile, multimap=multimap,
                                        n_workers=processes or 1)
    else:
        exincounter.mark_up_introns(bamfile=bamfile, multimap=multimap,
                                    n_workers=processes or 1)

    if check_end_process:
        logging.info("Waiting for the bam sorting to finish")
        for k, proc in sorting_processes.items():
            returncode = proc.wait()
            if returncode != 0:
                raise MemoryError(
                    f"bam file #{k} could not be sorted by cells. Install "
                    "samtools >= 1.6 or raise --samtools-memory")

    logging.debug("Start molecule counting!")
    if processes and processes > 1:
        dict_list_arrays, cell_bcs_order = exincounter.pcount(
            bamfile_cellsorted, multimap=multimap, n_processes=processes)
    else:
        dict_list_arrays, cell_bcs_order = exincounter.count(
            bamfile_cellsorted, multimap=multimap)

    if not exincounter.filter_mode:
        gem_grp = ""

    ca = {"CellID": np.array([f"{sampleid}:{v_bc}{gem_grp}"
                              for v_bc in cell_bcs_order])}
    ca.update(additional_ca)
    for key, value in sample.items():
        ca[key] = np.full(len(cell_bcs_order), value)

    outfile = os.path.join(outputfolder, f"{sampleid}.loom")
    logging.debug(f"Generating output file {outfile}")

    atr_table = (("Gene", "genename", str), ("Accession", "geneid", str),
                 ("Chromosome", "chrom", str), ("Strand", "strand", str),
                 ("Start", "start", int), ("End", "end", int))
    ra = {}
    for name_col_attr, name_obj_attr, dtyp in atr_table:
        tmp_array = np.zeros((len(exincounter.genes),), dtype=object)
        for gene_id, gene_info in exincounter.genes.items():
            tmp_array[exincounter.geneid2ix[gene_id]] = getattr(
                gene_info, name_obj_attr)
        ra[name_col_attr] = tmp_array.astype(dtyp)

    layers: Dict[str, np.ndarray] = {}
    n_cells = len(cell_bcs_order)
    for layer_name in logic_obj.layers:
        if dict_list_arrays[layer_name]:
            layers[layer_name] = np.concatenate(
                dict_list_arrays[layer_name], axis=1)
        else:
            layers[layer_name] = np.zeros((len(exincounter.genes), 0),
                                          dtype=loom_numeric_dtype)
        del dict_list_arrays[layer_name]
    total = np.zeros(layers[logic_obj.layers[0]].shape, dtype="float32")
    for layer_name in logic_obj.layers:
        total += layers[layer_name]

    tmp_layers = {"": total.astype("float32", order="C", copy=False)}
    tmp_layers.update({name: layers[name].astype(loom_numeric_dtype,
                                                 order="C", copy=False)
                       for name in logic_obj.layers})
    loomio.create(filename=outfile, layers=tmp_layers, row_attrs=ra,
                  col_attrs=ca,
                  file_attrs={"velocyto.__version__": _version.__version__,
                              "velocyto.logic": logic})
    logging.debug("Terminated Successfully!")
    return outfile


class _ThreadHandle:
    """Popen-like wrapper over a sorter thread: wait() returns 0, or 1
    and logs the error when the sort raised (the JAX package's handle
    returns 0 either way, and counting then fails on a missing file)."""

    def __init__(self) -> None:
        self.thread = None
        self.error: Optional[BaseException] = None

    def wait(self) -> int:
        self.thread.join()
        if self.error is not None:
            logging.error(f"native cell sort failed: {self.error}")
            return 1
        return 0


def _internal_cellsort(src: str, dst: str, tagname: str) -> None:
    """samtools-free `sort -t CB`: native external sorter when libvtpu
    is available (60x the python path), else a stable in-memory python
    sort by the cell tag (both order no-tag records first)."""
    from .. import native
    if tagname != "NOTAG" and native.available():
        native.bam_sort_by_tag(src, dst, tagname)
        return
    from ..counting import bamio
    reader = bamio.BamReader(src)
    recs = list(reader)
    if tagname != "NOTAG":
        recs.sort(key=lambda r: str(r.tags.get(tagname, "")))
    bamio.write_bam(dst, list(zip(reader.references, reader.lengths)), recs,
                    reader.header_text)
