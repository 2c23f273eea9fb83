"""HDF5 object snapshotting (checkpoint/resume for the analysis pipeline).

Copied from velocyto_tpu/serialization.py; the JAX package cannot be
imported here, because its package import loads jax.  Two changes: h5py
is imported when a file is opened, so the port imports on machines that
lack it; and a pickled object of a class of the JAX package (its PCA)
loads as the port's class of the same module path, so reading a JAX
snapshot imports nothing of the JAX package.

Same on-disk contract as the reference (velocyto/serialization.py:44-115):
ndarray attributes become gzip'd datasets, anything else becomes a zlib'd
pickle stored in a '&'-prefixed dataset, so snapshots interoperate.
"""
from __future__ import annotations

import io
import os
import pickle
import zlib
from typing import Tuple, Type

import numpy as np

_JAX_PACKAGE = "velocyto_tpu"


class _PortUnpickler(pickle.Unpickler):
    """Resolves velocyto_tpu.<module> to velocyto_tpu_torch.<module>."""

    def find_class(self, module: str, name: str):
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
            module = "velocyto_tpu_torch" + module[len(_JAX_PACKAGE):]
        return super().find_class(module, name)


def _obj2uint(obj: object, compression: int = 9, protocol: int = 2) -> np.ndarray:
    zstr = zlib.compress(pickle.dumps(obj, protocol=protocol), compression)
    return np.frombuffer(zstr, dtype=np.uint8)


def _uint2obj(uint: np.ndarray) -> object:
    return _PortUnpickler(io.BytesIO(zlib.decompress(uint.tobytes()))).load()


def dump_hdf5(obj: object, filename: str,
              data_compression: int = 7, chunks: Tuple = (2048, 2048),
              noarray_compression: int = 9, pickle_protocol: int = 2) -> None:
    """Dump all attributes of a python object to hdf5."""
    import h5py
    if os.path.isfile(filename):
        os.remove(filename)
    with h5py.File(filename, "w") as f:
        for k in obj.__dict__.keys():
            attribute = getattr(obj, k)
            # unicode/object ndarrays have no native hdf5 mapping: they go
            # through the pickled '&' path like non-array attributes
            if type(attribute) is not np.ndarray or \
                    attribute.dtype.kind in ("U", "O"):
                serialized = _obj2uint(attribute,
                                       compression=noarray_compression,
                                       protocol=pickle_protocol)
                f.create_dataset(
                    f"&{k}", data=serialized,
                    chunks=(min(1024, max(1, len(serialized))),),
                    compression="gzip", compression_opts=data_compression,
                    fletcher32=False, shuffle=False)
            else:
                if attribute.ndim == 0 or attribute.size == 0:
                    f.create_dataset(k, data=attribute)
                    continue
                chunk_size = tuple(min(chunks[i] if i < len(chunks) else 2048,
                                       max(1, attribute.shape[i]))
                                   for i in range(attribute.ndim))
                f.create_dataset(k, data=attribute, chunks=chunk_size,
                                 compression="gzip",
                                 compression_opts=data_compression,
                                 fletcher32=False, shuffle=False)


def load_hdf5(filename: str, obj_class: Type[object]) -> object:
    """Recreate an object of type obj_class from a dump_hdf5 snapshot."""
    import h5py
    obj = obj_class.__new__(obj_class)
    with h5py.File(filename, "r") as f:
        for k in f.keys():
            if k.startswith("&"):
                setattr(obj, k[1:], _uint2obj(f[k][:]))
            else:
                setattr(obj, k, f[k][...])
    return obj
