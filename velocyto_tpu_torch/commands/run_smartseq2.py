# Copy of velocyto_tpu/commands/run_smartseq2.py; imports nothing of the JAX package.
"""`velocyto run-smartseq2` (reference commands/run_smartseq2.py)."""
from typing import Optional, Tuple

import click

from ._run import _run


@click.command(short_help="Runs the velocity analysis on SmartSeq2 data "
                          "(independent bam file per cell)")
@click.argument("bamfiles", nargs=-1, required=True,
                type=click.Path(exists=True, file_okay=True, dir_okay=False,
                                readable=True, resolve_path=True))
@click.argument("gtffile",
                type=click.Path(exists=True, file_okay=True, dir_okay=False,
                                readable=True, resolve_path=True))
@click.option("--outputfolder", "-o", default=None,
              type=click.Path(exists=False),
              help="Output folder, if it does not exist it will be created.")
@click.option("--sampleid", "-e", default=None, type=click.Path(exists=False),
              help="The sample name used as the filename of the output.")
@click.option("--repmask", "-m", default=None,
              type=click.Path(resolve_path=True, file_okay=True,
                              dir_okay=False, readable=True),
              help=".gtf file containing intervals to mask")
@click.option("--dtype", "-t", default="uint32",
              help="The dtype of the loom file layers")
@click.option("--dump", "-d", default="0",
              help="For debugging purposes only")
@click.option("--verbose", "-v", count=True, default=1,
              help="Set the verbosity level")
def run_smartseq2(bamfiles: Tuple[str, ...], gtffile: str,
                  outputfolder: Optional[str], sampleid: Optional[str],
                  repmask: Optional[str], dtype: str, dump: str,
                  verbose: int, additional_ca: dict = {}) -> None:
    """Runs the velocity analysis on SmartSeq2 data (independent bam file
    per cell)

    [BAMFILES, ...] a sequence of bam files to be analyzed

    GTFFILE genome annotation file
    """
    return _run(bamfile=bamfiles, gtffile=gtffile, bcfile=None,
                outputfolder=outputfolder, sampleid=sampleid,
                metadatatable=None, repmask=repmask, onefilepercell=True,
                logic="SmartSeq2", without_umi=True, umi_extension="no",
                multimap=False, test=False, samtools_threads=1,
                samtools_memory=1, dump=dump, loom_numeric_dtype=dtype,
                verbose=verbose, additional_ca=additional_ca)
