# Copy of velocyto_tpu/commands/velocyto.py; imports nothing of the JAX package.
"""CLI entry point: the `velocyto` command group
(reference commands/velocyto.py:14-52)."""
import logging
import sys
from collections import OrderedDict
from typing import Any

import click

from .._version import __version__
from .run import run
from .run10x import run10x
from .run_smartseq2 import run_smartseq2
from .run_dropest import run_dropest
from .dropest_bc_correct import dropest_bc_correct


class NaturalOrderGroup(click.Group):
    """List subcommands in insertion order."""

    def list_commands(self, ctx: Any) -> Any:
        return self.commands.keys()


@click.version_option(version=__version__)
@click.group(cls=NaturalOrderGroup, commands=OrderedDict(),
             context_settings=dict(max_content_width=300, terminal_width=300))
def cli() -> None:
    logging.basicConfig(stream=sys.stdout,
                        format="%(asctime)s - %(levelname)s - %(message)s",
                        level=logging.DEBUG)
    return


@click.group(cls=NaturalOrderGroup, commands=OrderedDict(),
             context_settings=dict(max_content_width=300, terminal_width=300))
def tools() -> None:
    """helper tools for velocyto"""
    return


tools.add_command(dropest_bc_correct)
cli.add_command(run)
cli.add_command(run10x)
cli.add_command(run_dropest)
cli.add_command(run_smartseq2)
cli.add_command(tools)

if __name__ == "__main__":
    cli()
