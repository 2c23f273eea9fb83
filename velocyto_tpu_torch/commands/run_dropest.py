# Copy of velocyto_tpu/commands/run_dropest.py; imports nothing of the JAX package.
"""`velocyto run-dropest` (reference commands/run_dropest.py)."""
import logging
import os
from typing import Optional

import click

from ._run import _run


@click.command(short_help="Runs the velocity analysis on DropEst "
                          "preprocessed data")
@click.argument("bamfile",
                type=click.Path(exists=True, file_okay=True, dir_okay=False,
                                readable=True, resolve_path=True))
@click.argument("gtffile",
                type=click.Path(exists=True, file_okay=True, dir_okay=False,
                                readable=True, resolve_path=True))
@click.option("--bcfile", "-b", default=None, show_default=True,
              type=click.Path(resolve_path=True, file_okay=True,
                              dir_okay=False, readable=True),
              help="Valid barcodes file to filter the bam.")
@click.option("--logic", "-l", default="Default",
              help="The logic to use for the filtering")
@click.option("--outputfolder", "-o", default=None,
              type=click.Path(exists=False),
              help="Output folder")
@click.option("--sampleid", "-e", default=None, type=click.Path(exists=False),
              help="The sample name used for the output")
@click.option("--repmask", "-m", default=None,
              type=click.Path(resolve_path=True, file_okay=True,
                              dir_okay=False, readable=True),
              help=".gtf file containing intervals to mask")
@click.option("--samtools-threads", "-@", default=16,
              help="Threads used for samtools sort")
@click.option("--samtools-memory", default=2048,
              help="MB used per samtools sort thread")
@click.option("--dtype", "-t", default="uint32",
              help="The dtype of the loom file layers")
@click.option("--dump", "-d", default="0",
              help="For debugging purposes only")
@click.option("--verbose", "-v", count=True, default=1,
              help="Set the verbosity level")
def run_dropest(bamfile: str, gtffile: str, bcfile: Optional[str],
                logic: str, outputfolder: Optional[str],
                sampleid: Optional[str], repmask: Optional[str],
                samtools_threads: int, samtools_memory: int, dtype: str,
                dump: str, verbose: int, additional_ca: dict = {}) -> None:
    """Runs the velocity analysis on DropEst preprocessed data

    BAMFILE bam files to be analyzed

    GTFFILE genome annotation file
    """
    if bcfile is None:
        parentpath, bamfilename = os.path.split(bamfile)
        bcfile = os.path.join(parentpath,
                              f"barcodes_{bamfilename.split('_')[0]}.tsv")
        logging.info(f"Attempting to find automatically the valid barcode "
                     f"list file {bcfile}")
        if os.path.exists(bcfile):
            logging.info(f"{bcfile} found ")
        else:
            logging.info(f"{bcfile} not found!")
            logging.error("In run_dropest specifying --bcfile/-b is "
                          "required. Use `run` for more custom usage.")
            return
    if "correct" not in bamfile:
        logging.warning("The file you are using does not start with the "
                        "prefix `correct_` so it might not be the output of "
                        "`velocyto tools dropest_bc_correct`.")
    return _run(bamfile=(bamfile,), gtffile=gtffile, bcfile=bcfile,
                outputfolder=outputfolder, sampleid=sampleid,
                metadatatable=None, repmask=repmask, onefilepercell=False,
                logic=logic, without_umi=False, umi_extension="chr",
                multimap=False, test=False,
                samtools_threads=samtools_threads,
                samtools_memory=samtools_memory, loom_numeric_dtype=dtype,
                dump=dump, verbose=verbose, additional_ca=additional_ca)
