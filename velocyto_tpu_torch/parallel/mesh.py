"""Device mesh for the port: a (cells, genes) grid of shards.

Port of velocyto_tpu/parallel/mesh.py.  The estimation pipeline shards
the cells axis (the data axis of single-cell data) and keeps expression
replicated; the ring schedule (ops/coldeltacor.py) shards expression as
well.

In torch's idiom a mesh is a grid of shards, each a (device, stream)
slot: a device may appear more than once, and each of its shards then
has its own ``torch.cuda.Stream``, so shards on one card can overlap.
That mirrors the JAX package's ``--xla_force_host_platform_device_count``
and lets one card (or the CPU, where a shard is just a device) run P > 1.

Across processes (``initialize_distributed``), each process holds a mesh
of its own local shards; the global shard index is rank * local + i and
``shape`` counts the shards of every process.  Collectives that cross
the process boundary use the default process group: ``all_reduce`` for
sums, ``batch_isend_irecv`` for the ring, ``all_to_all_single`` for the
sharded velocity step and ``all_gather`` for results returned whole.

Axis names:
  - "cells": data-parallel axis (rows of a cell-sharded table);
  - "genes": available for very wide gene panels.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

CELLS = "cells"
GENES = "genes"


class Shard(NamedTuple):
    """One slot of a mesh: its global index along the split, its device
    and, on a card, its own stream (None on the CPU)."""
    index: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"]


def _process() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A (cells, genes) grid of this process's shards.

    devices: (cells, genes) numpy object array of torch.device, repeats
    allowed.  shape: {CELLS: p, GENES: q} over every process (p = world
    size x local cell shards); size: p x q."""

    def __init__(self, devices: np.ndarray) -> None:
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size < 1:
            raise ValueError(f"devices must be a non-empty (cells, genes) "
                             f"array, got shape {devices.shape}")
        self.devices = devices
        self.rank, self.world = _process()
        p, q = devices.shape
        self.shape = {CELLS: p * self.world, GENES: q}
        self.size = self.shape[CELLS] * q
        self._streams = {}

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}/{self.world}, "
                f"devices={[str(d) for d in self.devices.ravel()]})")

    @property
    def first_device(self) -> torch.device:
        """Where the _dev forms leave their gathered results."""
        return self.devices.flat[0]

    def _shard(self, index: int, device: torch.device, slot) -> Shard:
        stream = None
        if device.type == "cuda":
            if slot not in self._streams:
                self._streams[slot] = torch.cuda.Stream(device)
            stream = self._streams[slot]
        return Shard(index, device, stream)

    def cell_shards(self) -> List[Shard]:
        """This process's shards of the cells axis (each replicated over
        the genes axis, held by its first device)."""
        p = self.devices.shape[0]
        return [self._shard(self.rank * p + i, self.devices[i, 0], (i, 0))
                for i in range(p)]

    def flat_shards(self) -> List[Shard]:
        """Every shard of this process, cells major; global indices run
        over the ``size`` shards of all processes."""
        p, q = self.devices.shape
        return [self._shard(self.rank * p * q + i * q + j, self.devices[i, j],
                            (i, j))
                for i in range(p) for j in range(q)]

    def describe(self) -> str:
        """The shard -> device map, one shard a line."""
        return "\n".join(
            f"shard {s.index}: {s.device}"
            + (f" stream {s.stream.cuda_stream:#x}" if s.stream else "")
            for s in self.flat_shards())


def make_mesh(n_cell_shards: Optional[int] = None, n_gene_shards: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (cells, genes) mesh over `devices` (default: every visible CUDA
    device).  By default every shard goes on the cells axis.  A device
    may repeat: each repeat is a shard with its own stream."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device visible; pass "
                               "devices= (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = np.array([torch.device(d) for d in devices], dtype=object)
    if n_cell_shards is None:
        n_cell_shards = devices.size // n_gene_shards
    if n_cell_shards * n_gene_shards != devices.size:
        raise ValueError(
            f"mesh {n_cell_shards}x{n_gene_shards} does not cover "
            f"{devices.size} devices")
    return Mesh(devices.reshape(n_cell_shards, n_gene_shards))


def single_device_mesh() -> Mesh:
    """A 1 x 1 mesh on the first CUDA device."""
    return make_mesh(devices=[torch.device("cuda", 0)])


class Sharding(NamedTuple):
    """Where a table goes on a mesh: split along ``cell_axis`` over the
    cells shards, or replicated on every shard (cell_axis None)."""
    mesh: Mesh
    ndim: int
    cell_axis: Optional[int]


def cells_sharding(mesh: Mesh, ndim: int = 2, cell_axis: int = 0) -> Sharding:
    """A table of `ndim` dimensions split along `cell_axis` over the
    mesh's cells shards (uneven np.array_split pieces)."""
    if not 0 <= cell_axis < ndim:
        raise ValueError(f"cell_axis {cell_axis} outside {ndim} dimensions")
    return Sharding(mesh, ndim, cell_axis)


def replicated(mesh: Mesh) -> Sharding:
    """A table held whole by every cells shard."""
    return Sharding(mesh, -1, None)


def place(sharding: Sharding, t: torch.Tensor) -> List[torch.Tensor]:
    """`t` laid out as `sharding` says: one tensor per cells shard of this
    process, on the shard's device (its np.array_split piece along the
    cell axis, or the whole of `t`)."""
    shards = sharding.mesh.cell_shards()
    if sharding.cell_axis is None:
        return replicas(shards, t)
    if t.dim() != sharding.ndim:
        raise ValueError(f"a {sharding.ndim}-D sharding for a "
                         f"{t.dim()}-D tensor")
    spans = bounds(t.shape[sharding.cell_axis],
                   sharding.mesh.shape[CELLS])
    return [t.narrow(sharding.cell_axis, spans[s.index][0],
                     spans[s.index][1] - spans[s.index][0])
            .to(s.device).contiguous() for s in shards]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join a multi-process run: torch.distributed.init_process_group at
    `coordinator_address` ("host:port" or "tcp://host:port"), gloo for
    CPU tensors and nccl for CUDA ones.  A no-op for one process."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address "
                         "and process_id")
    addr = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id))


# ---------------------------------------------------------------------------
# helpers of the sharded functions
# ---------------------------------------------------------------------------

def bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """The (lo, hi) rows of each of `parts` np.array_split pieces of n."""
    edges = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(n),
                                                            parts)])
    return [(int(edges[i]), int(edges[i + 1])) for i in range(parts)]


@contextlib.contextmanager
def on_shard(shard: Shard, *inputs: torch.Tensor) -> Iterator[None]:
    """Run the body on the shard's device and stream.  The stream first
    waits for the device's current stream (the inputs were made there),
    and each CUDA input is marked as used by it."""
    if shard.stream is None:
        yield
        return
    cur = torch.cuda.current_stream(shard.device)
    shard.stream.wait_stream(cur)
    for t in inputs:
        if t.is_cuda and t.device == shard.device:
            t.record_stream(shard.stream)
    with torch.cuda.device(shard.device), torch.cuda.stream(shard.stream):
        yield


def join(shards: Sequence[Shard], outputs: Sequence) -> None:
    """Make each shard's device's current stream wait for the shard's
    stream, and mark what the shard made (a tensor or a tuple of them)
    as used by the current stream."""
    for shard, out in zip(shards, outputs):
        if shard.stream is None:
            continue
        cur = torch.cuda.current_stream(shard.device)
        cur.wait_stream(shard.stream)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(cur)


def replicas(shards: Sequence[Shard], t: torch.Tensor) -> List[torch.Tensor]:
    """`t` on each shard's device (one copy per distinct device; a device
    that repeats shares it)."""
    copies = {}
    out = []
    for s in shards:
        if s.device not in copies:
            copies[s.device] = t if t.device == s.device else t.to(s.device)
        out.append(copies[s.device])
    return out


def gather_rows(mesh: Mesh, parts: Sequence[torch.Tensor],
                counts: Sequence[int]) -> torch.Tensor:
    """The row blocks of every shard of every process, concatenated in
    global shard order on the mesh's first device.  parts: this process's
    blocks; counts: the rows of every global shard (to trim the padding
    all_gather needs)."""
    first = mesh.first_device
    local = torch.cat([p.to(first) for p in parts]) if len(parts) > 1 \
        else parts[0].to(first)
    if mesh.world == 1:
        return local
    per_rank = len(parts)
    rank_rows = [sum(counts[r * per_rank:(r + 1) * per_rank])
                 for r in range(mesh.world)]
    pad = max(rank_rows)
    buf = torch.zeros((pad,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    buf[:local.shape[0]] = local
    got = [torch.empty_like(buf) for _ in range(mesh.world)]
    dist.all_gather(got, buf)
    return torch.cat([g[:r] for g, r in zip(got, rank_rows)])


def map_rows(mesh: Mesh, fn, shared: Sequence[torch.Tensor],
             rows: Sequence[torch.Tensor]):
    """fn(*shared, *rows[lo:hi]) on each cells shard of the mesh, on its
    device and stream, over that shard's np.array_split rows; the row
    blocks it returns (a tensor or a tuple of them) are gathered on the
    mesh's first device (the whole result on every process).  shared:
    tables every shard reads whole (replicated on its device)."""
    shards = mesh.cell_shards()
    spans = bounds(rows[0].shape[0], mesh.shape[CELLS])
    reps = [replicas(shards, t) for t in shared]
    outs = []
    for i, s in enumerate(shards):
        lo, hi = spans[s.index]
        mine = [r[i] for r in reps] + \
            [t[lo:hi].to(s.device).contiguous() for t in rows]
        with on_shard(s, *mine):
            outs.append(fn(*mine))
    join(shards, outs)
    counts = [hi - lo for lo, hi in spans]
    if isinstance(outs[0], tuple):
        return tuple(gather_rows(mesh, [o[k] for o in outs], counts)
                     for k in range(len(outs[0])))
    return gather_rows(mesh, outs, counts)
