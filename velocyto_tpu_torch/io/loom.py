"""Loom (HDF5) file I/O.

Copied from velocyto_tpu/io/loom.py (the reader, lines 32-114, and
``create``, the writer); the JAX package cannot be imported here, because its package
import loads jax.  h5py is imported when a file is opened or written, so
the port imports on machines that lack it.

The loom v2/v3 on-disk layout: root dataset ``matrix`` (genes x cells),
groups ``layers/``, ``row_attrs/``, ``col_attrs/`` and file attributes.
The counting half writes it (reference: commands/_run.py:284-297) and
the analysis half reads it (reference: analysis.py:56-64).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np


def _decode(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind in ("S", "O"):
        return np.array([v.decode() if isinstance(v, bytes) else v
                         for v in arr])
    return arr


def _encodable(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype.kind == "U" or arr.dtype == object:
        return arr.astype("S")
    return arr


class LoomConnection:
    """Read-mode view of a loom file with loompy-like accessors: shape,
    layer / layers, row_attrs / ra, col_attrs / ca, attrs, and use in a
    ``with`` block."""

    def __init__(self, path: str) -> None:
        import h5py
        self._f = h5py.File(path, "r")
        self.filename = path

    @property
    def shape(self):
        return self._f["matrix"].shape

    class _LayerView:
        def __init__(self, f):
            self._f = f

        def __getitem__(self, name):
            if name == "" or name is None:
                return _Layer(self._f["matrix"])
            return _Layer(self._f["layers"][name])

        def keys(self):
            out = [""]
            if "layers" in self._f:
                out += list(self._f["layers"].keys())
            return out

    @property
    def layer(self):
        return LoomConnection._LayerView(self._f)

    # loompy 2 naming
    layers = layer

    @property
    def row_attrs(self) -> Dict[str, np.ndarray]:
        grp = self._f.get("row_attrs", {})
        return {k: _decode(grp[k][...]) for k in grp}

    @property
    def col_attrs(self) -> Dict[str, np.ndarray]:
        grp = self._f.get("col_attrs", {})
        return {k: _decode(grp[k][...]) for k in grp}

    @property
    def ra(self):
        return self.row_attrs

    @property
    def ca(self):
        return self.col_attrs

    @property
    def attrs(self) -> Dict[str, Any]:
        out = dict(self._f.attrs)
        if "attrs" in self._f:  # loom v3 stores file attrs as scalar datasets
            for k in self._f["attrs"]:
                out[k] = self._f["attrs"][k][()]
        return out

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Layer:
    """One layer (or the main matrix): slicing reads it, as h5py does."""

    def __init__(self, ds) -> None:
        self._ds = ds

    def __getitem__(self, key):
        return self._ds[key]

    @property
    def shape(self):
        return self._ds.shape

    @property
    def dtype(self):
        return self._ds.dtype


def connect(path: str) -> LoomConnection:
    return LoomConnection(path)


def create(filename: str, layers: Dict[str, np.ndarray],
           row_attrs: Dict[str, np.ndarray],
           col_attrs: Dict[str, np.ndarray],
           file_attrs: Optional[Dict[str, Any]] = None) -> None:
    """Create a loom file.  ``layers[""]`` is the main matrix; other keys
    become named layers.  Matches the loompy.create(layers=...) contract
    used by the reference writer (commands/_run.py:295-297)."""
    import h5py
    if os.path.exists(filename):
        os.remove(filename)
    main = np.asarray(layers[""])
    with h5py.File(filename, "w") as f:
        f.create_dataset("matrix", data=main,
                         chunks=_chunks(main.shape), compression="gzip",
                         compression_opts=2)
        lg = f.create_group("layers")
        for name, mat in layers.items():
            if name == "":
                continue
            mat = np.asarray(mat)
            if mat.shape != main.shape:
                raise ValueError(f"layer {name} shape {mat.shape} != "
                                 f"main matrix {main.shape}")
            lg.create_dataset(name, data=mat, chunks=_chunks(mat.shape),
                              compression="gzip", compression_opts=2)
        ra = f.create_group("row_attrs")
        for k, v in row_attrs.items():
            ra.create_dataset(k, data=_encodable(v))
        ca = f.create_group("col_attrs")
        for k, v in col_attrs.items():
            ca.create_dataset(k, data=_encodable(v))
        f.create_group("attrs")
        for k, v in (file_attrs or {}).items():
            f.attrs[k] = v


def _chunks(shape):
    if len(shape) != 2 or 0 in shape:
        return None
    return (min(64, shape[0]), min(64, shape[1]))
