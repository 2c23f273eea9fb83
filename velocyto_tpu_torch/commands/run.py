# Copy of velocyto_tpu/commands/run.py; imports nothing of the JAX package.
"""`velocyto run`: generic counting entry (reference commands/run.py)."""
from typing import Optional, Tuple

import click

from ._run import _run


@click.command(short_help="Runs the velocity analysis outputting a loom file")
@click.argument("bamfile", nargs=-1, required=True,
                type=click.Path(exists=True, file_okay=True, dir_okay=False,
                                readable=True, resolve_path=True))
@click.argument("gtffile",
                type=click.Path(exists=True, file_okay=True, dir_okay=False,
                                readable=True, resolve_path=True))
@click.option("--bcfile", "-b", default=None, show_default=True,
              type=click.Path(resolve_path=True, file_okay=True,
                              dir_okay=False, readable=True),
              help="Valid barcodes file, to filter the bam. If --bcfile is "
                   "not specified all the cell barcodes will be included.")
@click.option("--outputfolder", "-o", default=None,
              type=click.Path(exists=False),
              help="Output folder, if it does not exist it will be created.")
@click.option("--sampleid", "-e", default=None, type=click.Path(exists=False),
              help="The sample name that will be used to retrieve "
                   "informations from metadatatable")
@click.option("--metadatatable", "-s", default=None,
              type=click.Path(resolve_path=True, file_okay=True,
                              dir_okay=False, readable=True),
              help="Table containing metadata of the various samples")
@click.option("--mask", "-m", default=None,
              type=click.Path(resolve_path=True, file_okay=True,
                              dir_okay=False, readable=True),
              help=".gtf file containing intervals to mask")
@click.option("--onefilepercell", "-c", default=False, is_flag=True,
              help="Every bamfile passed is interpreted as an independent "
                   "cell.")
@click.option("--logic", "-l", default="Default",
              help="The logic to use for the filtering")
@click.option("--without-umi", "-U", default=False, is_flag=True,
              help="foreach read count instead of molecule count")
@click.option("--umi-extension", "-u", default="no",
              help="In case UMI is too short to guarantee uniqueness set "
                   "this to `chr`, `Gene` or `[N]bp`")
@click.option("--multimap", "-M", default=False, is_flag=True,
              help="Consider not unique mappings (not recommended)")
@click.option("--samtools-threads", "-@", default=16,
              help="Threads used for samtools sort")
@click.option("--samtools-memory", default=2048,
              help="MB used per samtools sort thread")
@click.option("--dtype", "-t", default="uint32",
              help="The dtype of the loom file layers")
@click.option("--dump", "-d", default="0",
              help="For debugging purposes only: molecular mapping report")
@click.option("--processes", "-p", default=0,
              help="Worker processes for parallel molecule counting "
                   "(0 = serial). velocyto_tpu extension: the reference "
                   "declares pcount but never implemented it.")
@click.option("--verbose", "-v", count=True, default=1,
              help="Set the verbosity level")
def run(bamfile: Tuple[str, ...], gtffile: str, bcfile: Optional[str],
        outputfolder: Optional[str], sampleid: Optional[str],
        metadatatable: Optional[str], mask: Optional[str],
        onefilepercell: bool, logic: str, without_umi: bool,
        umi_extension: str, multimap: bool, samtools_threads: int,
        samtools_memory: int, dtype: str, dump: str, processes: int,
        verbose: int,
        additional_ca: dict = {}) -> None:
    """Runs the velocity analysis outputting a loom file

    BAMFILE bam file with sorted reads

    GTFFILE genome annotation file
    """
    return _run(bamfile=bamfile, gtffile=gtffile, bcfile=bcfile,
                outputfolder=outputfolder, sampleid=sampleid,
                metadatatable=metadatatable, repmask=mask,
                onefilepercell=onefilepercell, logic=logic,
                without_umi=without_umi, umi_extension=umi_extension,
                multimap=multimap, test=False,
                samtools_threads=samtools_threads,
                samtools_memory=samtools_memory, dump=dump,
                processes=processes,
                loom_numeric_dtype=dtype, verbose=verbose,
                additional_ca=additional_ca)
