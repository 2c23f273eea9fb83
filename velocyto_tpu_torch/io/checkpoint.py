"""Checkpointing of analysis state on torch.distributed.checkpoint.

Port of velocyto_tpu/io/checkpoint.py, with torch's distributed
checkpoint (DCP) in place of orbax.  Arrays and tensors go into a DCP
checkpoint directory, written and read by this one process (no process
group); every other value (cluster labels, scalars, strings, and numpy
arrays of a dtype torch has no tensor for) goes into a zlib-pickled
side-car file in the same directory, as in the JAX package.  Numpy
arrays come back as numpy arrays of the same dtype; tensors come back on
``device=``.  DCP checkpoints belong to this package, as orbax ones
belong to the JAX package; the hdf5 snapshot (``VelocytoLoom.to_hdf5``)
is the format the two exchange.
"""
from __future__ import annotations

import os
import pickle
import shutil
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed.checkpoint as dcp

from ..parallel.mesh import place

_META_KEY = "velocyto_tpu_meta"
# numpy dtypes that go into the checkpoint as tensors (and come back as
# the same numpy dtype); arrays of any other dtype go into the side-car
_TENSOR_DTYPES = {np.dtype(t) for t in (
    np.bool_, np.uint8, np.int8, np.int16, np.int32, np.int64, np.float16,
    np.float32, np.float64, np.complex64, np.complex128)}


def save_state(path: str, state: Dict[str, Any], force: bool = True) -> None:
    """Checkpoint a dict of numpy arrays, tensors (on any device) and other
    values into the directory `path` (replaced when force, else it must
    not exist)."""
    tensors, numpy_keys, meta = {}, [], {}
    for key, val in state.items():
        if isinstance(val, torch.Tensor):
            tensors[key] = val
        elif isinstance(val, np.ndarray) and val.dtype in _TENSOR_DTYPES:
            tensors[key] = torch.from_numpy(np.ascontiguousarray(val))
            numpy_keys.append(key)
        else:
            meta[key] = val
    path = os.path.abspath(path)
    if os.path.exists(path):
        if not force:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.makedirs(path)
    dcp.save(tensors, checkpoint_id=path, no_dist=True)
    with open(os.path.join(path, _META_KEY), "wb") as f:
        f.write(zlib.compress(pickle.dumps(
            {"meta": meta, "numpy": numpy_keys})))


def load_state(path: str, device="cuda",
               shardings: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Restore a save_state checkpoint: tensors on `device` (the card
    unless the caller asks for another), numpy arrays as numpy arrays,
    other values as they were saved.

    shardings: optional {name: parallel.cells_sharding(mesh, ...) or
    parallel.replicated(mesh)}; each such array (tensor or numpy) comes
    back as a list of tensors, one per cells shard of the mesh on the
    shard's device: its piece along the cell axis (their concatenation is
    the unsharded load) or the whole array.

    DCP loads in place, so the tensors are allocated first from the
    shapes and dtypes in the checkpoint's metadata."""
    path = os.path.abspath(path)
    shardings = shardings or {}
    with open(os.path.join(path, _META_KEY), "rb") as f:
        side = pickle.loads(zlib.decompress(f.read()))
    numpy_keys = set(side["numpy"])
    entries = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    host = numpy_keys | set(shardings)
    out = {key: torch.empty(md.size, dtype=md.properties.dtype,
                            device="cpu" if key in host else device)
           for key, md in entries.items()}
    dcp.load(out, checkpoint_id=path, no_dist=True)
    for key in numpy_keys - set(shardings):
        out[key] = out[key].numpy()
    for key, sharding in shardings.items():
        if key in out:
            out[key] = place(sharding, out[key])
    out.update(side["meta"])
    return out


def save_vlm(path: str, vlm, attributes: Optional[list] = None) -> None:
    """Checkpoint the array state of a VelocytoLoom: by default every numpy
    attribute and what each lazy attribute's entry gives to a checkpoint
    (a device-backed stage output its tensor, a value built from a plan
    its host array, built here, probability rows their dense float32
    tensor)."""
    if attributes is None:
        state = {}
        for name, entry in list(vlm._table().items()):
            value = entry.saved(vlm, name)
            if value is not None:
                state[name] = value
        state.update((k, v) for k, v in vlm.__dict__.items()
                     if isinstance(v, np.ndarray))
    else:
        state = {k: getattr(vlm, k) for k in attributes}
    save_state(path, state)


def load_vlm(path: str, vlm=None, device="cuda"):
    """Restore arrays onto a VelocytoLoom (created bare on `device` if
    None): tensors become its device-backed attributes, on its device."""
    from ..analysis import VelocytoLoom
    if vlm is None:
        vlm = VelocytoLoom.__new__(VelocytoLoom)
        vlm.device = torch.device(device)
    for k, v in load_state(path, device=vlm.device).items():
        if isinstance(v, torch.Tensor):
            vlm._set_dev(k, v)
        else:
            setattr(vlm, k, v)
    return vlm
