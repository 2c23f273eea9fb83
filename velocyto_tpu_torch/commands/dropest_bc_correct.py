# Copy of velocyto_tpu/commands/dropest_bc_correct.py; imports nothing of the JAX package.
"""`velocyto tools dropest_bc_correct` (reference
commands/dropest_bc_correct.py:40-91), R-free.

The reference shells out to R via rpy2 to read the dropEst `.rds`; here
the `merge_targets` map is extracted with the built-in RDS reader
(velocyto_tpu_torch.utils.rds) and the CB tags are rewritten with the
built-in BAM codec.
"""
import logging
import os
from typing import Optional

import click

from ..counting import bamio
from ..utils.rds import read_rds


@click.command(short_help="Corrects barcodes in a DropEst bam and emits the "
                          "valid barcode list")
@click.argument("bamfilepath",
                type=click.Path(exists=True, resolve_path=True,
                                file_okay=True, dir_okay=False))
@click.argument("dropest-out",
                type=click.Path(exists=True, resolve_path=True,
                                file_okay=True, dir_okay=False))
@click.option("--corrected-output", "-o", default=None,
              type=click.Path(resolve_path=True, file_okay=True,
                              dir_okay=False))
def dropest_bc_correct(bamfilepath: str, dropest_out: str,
                       corrected_output: Optional[str]) -> None:
    """Using the output of DropEst:
    (1) Corrects barcodes directly in the bam file
    (2) Produces a valid barcodes list

    BAMFILEPATH - bam file with sorted reads obtained running DropEst

    DROPEST-OUT - R dump `rds` file generated by DropEst
    """
    parentpath, bamfilename = os.path.split(bamfilepath)
    logging.info(f"Loading `merge_targets` from {dropest_out} "
                 "(built-in RDS reader, no R required)")
    rds = read_rds(dropest_out)
    if not isinstance(rds, dict) or "merge_targets" not in rds:
        raise ValueError(
            f"{dropest_out} does not contain a `merge_targets` entry "
            f"(found: {list(rds)[:10] if isinstance(rds, dict) else type(rds)})")
    mapping = rds["merge_targets"]
    if not isinstance(mapping, dict):
        raise ValueError("merge_targets is not a named character vector")

    output_path = os.path.join(parentpath,
                               f"barcodes_{bamfilename.split('_')[0]}.tsv")
    logging.info(f"Generating {output_path}")
    with open(output_path, "w") as fout:
        unique_bcs = set(mapping.values())
        fout.write("\n".join(unique_bcs))

    if corrected_output is None:
        bam_out_path = os.path.join(parentpath, f"correct_{bamfilename}")
    else:
        bam_out_path = corrected_output

    reader = bamio.BamReader(bamfilepath)
    recs = []
    for rec in reader:
        cb = rec.tags.get("CB")
        if cb in mapping:
            rec.tags["CB"] = mapping[cb]
        recs.append(rec)
    bamio.write_bam(bam_out_path, list(zip(reader.references,
                                           reader.lengths)), recs,
                    reader.header_text)
    logging.info("Done")
