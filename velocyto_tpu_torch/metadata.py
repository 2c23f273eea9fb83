# Copy of velocyto_tpu/metadata.py; imports nothing of the JAX package.
"""CSV sample-sheet metadata.

Behavior parity with the reference's MetadataCollection
(velocyto/metadata.py:14-45): the sheet's dialect is sniffed, a header
of ``name:type`` pairs declares per-column types (plain names mean
untyped), and every subsequent non-empty row becomes a record whose
fields are attribute-accessible.  Re-designed here around an explicit
header parse + record factory instead of the reference's mutating
loader loop.
"""
from __future__ import annotations

import csv
from typing import Any, List, Sequence, Tuple


class Metadata:
    """One sample-sheet row; columns are attributes.  ``dict`` and
    ``types`` keep the reference's introspection surface."""

    def __init__(self, keys: Sequence[str], values: Sequence[Any],
                 types: Sequence[str]) -> None:
        self.types = dict(zip(keys, types))
        self.dict = dict(zip(keys, values))
        for key, value in zip(keys, values):
            setattr(self, key, value)


def _parse_header(row: Sequence[str]) -> Tuple[List[str], List[str]]:
    """Split an optional ``name:type`` header into (names, types).
    Typed headers are detected from the first cell, as the reference
    does (velocyto/metadata.py:31-37)."""
    if len(row[0].split(":")) == 2:
        pairs = [cell.split(":", 1) for cell in row]
        return ([p[0] for p in pairs],
                [p[1] if len(p) == 2 else "None" for p in pairs])
    return list(row), ["None"] * len(row)


class MetadataCollection:
    """All rows of a sample sheet, with a simple equality query."""

    def __init__(self, filename: str) -> None:
        self.items: List[Metadata] = []
        self.load(filename)

    def load(self, filename: str) -> None:
        with open(filename, newline="") as f:
            dialect = csv.Sniffer().sniff(f.read())
            f.seek(0)
            rows = (r for r in csv.reader(f, dialect) if r)
            try:
                keys, types = _parse_header(next(rows))
            except StopIteration:
                return
            self.items = [Metadata(keys, row, types) for row in rows]

    def where(self, key: str, value: Any) -> List[Metadata]:
        return [item for item in self.items
                if getattr(item, key) == value]
