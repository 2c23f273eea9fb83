"""Loom (HDF5) file reader.

Copied from the read half of velocyto_tpu/io/loom.py; the JAX package
cannot be imported here, because its package import loads jax.  h5py is
imported when a file is opened, so the port imports on machines that
lack it.

Reads the loom v2/v3 on-disk layout: root dataset ``matrix`` (genes x
cells), groups ``layers/``, ``row_attrs/`` and ``col_attrs/``
(reference: analysis.py:56-64).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _decode(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind in ("S", "O"):
        return np.array([v.decode() if isinstance(v, bytes) else v
                         for v in arr])
    return arr


class LoomConnection:
    """Read-mode view of a loom file: layers, row and column attributes."""

    def __init__(self, path: str) -> None:
        import h5py
        self._f = h5py.File(path, "r")
        self.filename = path

    class _LayerView:
        def __init__(self, f):
            self._f = f

        def __getitem__(self, name):
            if name == "" or name is None:
                return self._f["matrix"]
            return self._f["layers"][name]

    @property
    def layer(self):
        return LoomConnection._LayerView(self._f)

    @property
    def row_attrs(self) -> Dict[str, np.ndarray]:
        grp = self._f.get("row_attrs", {})
        return {k: _decode(grp[k][...]) for k in grp}

    @property
    def col_attrs(self) -> Dict[str, np.ndarray]:
        grp = self._f.get("col_attrs", {})
        return {k: _decode(grp[k][...]) for k in grp}

    def close(self) -> None:
        self._f.close()


def connect(path: str) -> LoomConnection:
    return LoomConnection(path)
