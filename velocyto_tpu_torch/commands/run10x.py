# Copy of velocyto_tpu/commands/run10x.py; imports nothing of the JAX package.
"""`velocyto run10x`: cellranger sample wrapper (reference commands/run10x.py)."""
import glob
import logging
import os
from typing import Optional

import click
import numpy as np

from ._run import _run


@click.command(short_help="Runs the velocity analysis for a Chromium Sample")
@click.argument("samplefolder",
                type=click.Path(exists=True, file_okay=False, dir_okay=True,
                                readable=True, writable=True,
                                resolve_path=True))
@click.argument("gtffile",
                type=click.Path(exists=True, file_okay=True, dir_okay=False,
                                readable=True, resolve_path=True))
@click.option("--metadatatable", "-s", default=None,
              type=click.Path(resolve_path=True, file_okay=True,
                              dir_okay=False, readable=True),
              help="Table containing metadata of the various samples")
@click.option("--mask", "-m", default=None,
              type=click.Path(resolve_path=True, file_okay=True,
                              dir_okay=False, readable=True),
              help=".gtf file containing intervals to mask")
@click.option("--logic", "-l", default="Default",
              help="The logic to use for the filtering")
@click.option("--multimap", "-M", default=False, is_flag=True,
              help="Consider not unique mappings (not recommended)")
@click.option("--samtools-threads", "-@", default=16,
              help="Threads used for samtools sort")
@click.option("--samtools-memory", default=2048,
              help="MB used per samtools sort thread")
@click.option("--dtype", "-t", default="uint16",
              help="The dtype of the loom file layers")
@click.option("--dump", "-d", default="0",
              help="For debugging purposes only")
@click.option("--verbose", "-v", count=True, default=1,
              help="Set the verbosity level")
def run10x(samplefolder: str, gtffile: str, metadatatable: Optional[str],
           mask: Optional[str], logic: str, multimap: bool,
           samtools_threads: int, samtools_memory: int, dtype: str,
           dump: str, verbose: int) -> None:
    """Runs the velocity analysis for a Chromium 10X Sample

    10XSAMPLEFOLDER specifies the cellranger sample folder

    GTFFILE genome annotation file
    """
    # Check that the 10X analysis was run successfully
    if not os.path.isfile(os.path.join(samplefolder, "_log")):
        logging.error("This is an older version of cellranger, cannot check "
                      "if the output are ready, make sure of this yourself")
    elif "Pipestance completed successfully!" not in \
            open(os.path.join(samplefolder, "_log")).read():
        logging.error("The outputs are not ready")
    bamfile = os.path.join(samplefolder, "outs", "possorted_genome_bam.bam")

    bcmatches = glob.glob(os.path.join(samplefolder, os.path.normcase(
        "outs/filtered_gene_bc_matrices/*/barcodes.tsv")))
    if len(bcmatches) == 0:
        bcmatches = glob.glob(os.path.join(samplefolder, os.path.normcase(
            "outs/filtered_feature_bc_matrix/barcodes.tsv.gz")))
    if len(bcmatches) == 0:
        logging.error("Can not locate the barcodes.tsv file!")
    bcfile = bcmatches[0]

    outputfolder = os.path.join(samplefolder, "velocyto")
    sampleid = os.path.basename(samplefolder.rstrip("/").rstrip("\\"))
    assert not os.path.exists(os.path.join(outputfolder,
                                           f"{sampleid}.loom")), \
        "The output already exist. Aborted!"
    additional_ca = {}
    try:
        tsne_file = os.path.join(samplefolder, "outs", "analysis", "tsne",
                                 "2_components", "projection.csv")
        if os.path.exists(tsne_file):
            tsne = np.loadtxt(tsne_file, usecols=(1, 2), delimiter=",",
                              skiprows=1)
            additional_ca["_X"] = tsne[:, 0].astype("float32")
            additional_ca["_Y"] = tsne[:, 1].astype("float32")
        clusters_file = os.path.join(samplefolder, "outs", "analysis",
                                     "clustering", "graphclust",
                                     "clusters.csv")
        if os.path.exists(clusters_file):
            labels = np.loadtxt(clusters_file, usecols=(1,), delimiter=",",
                                skiprows=1)
            additional_ca["Clusters"] = labels.astype("int") - 1
    except Exception:
        logging.error("Some IO problem in loading cellranger "
                      "tsne/pca/kmeans files occurred!")

    return _run(bamfile=(bamfile,), gtffile=gtffile, bcfile=bcfile,
                outputfolder=outputfolder, sampleid=sampleid,
                metadatatable=metadatatable, repmask=mask,
                onefilepercell=False, logic=logic, without_umi=False,
                umi_extension="no", multimap=multimap, test=False,
                samtools_threads=samtools_threads,
                samtools_memory=samtools_memory, dump=dump,
                loom_numeric_dtype=dtype, verbose=verbose,
                additional_ca=additional_ca)
