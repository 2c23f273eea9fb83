"""The system under test: one pipeline of a traffic mix through the public
velocyto_tpu_torch.analysis.VelocytoLoom methods, and the reading of its
outputs for the comparison.

A traffic mix is a data file, benchmark/traffic/<name>.json: the stages
of one pipeline in order, each `{"stage": <name>, ...}`, and `options`
that hold for every stage; a stage's options, then the mix's, override
the configuration's keys of the same name. A stage is a
module of its own, benchmark/stages/<name>.py, found by its name:

    names(p)              the numbers it compares, in order
    run(v, p)             the program's call(s) on the loom `v`
    read(v, p, cells)     the loom's outputs it compares, as host arrays
    recompute(r, p, got)  the plain reference's outputs (reference.State)
    numbers(got, ref, p)  {name: number}

where p is the configuration updated by the stage's entry. Each stage
runs in a span of its own: a host-clock interval, and a torch.profiler
range "stage:<name>" for a traced run. Each stage ends in a device
synchronisation, so a span holds its stage's device work.
"""
import importlib.util
import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
_MODULES = {}


class Stage(NamedTuple):
    name: str
    mod: object
    p: dict


def load_module(path: Path):
    """The module of the file `path` under benchmark/ (a stage, a metric),
    whose name may hold dots."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + "_".join(path.relative_to(HERE).with_suffix("").parts)
        .replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stage_module(name: str):
    """benchmark/stages/<name>.py, loaded once."""
    if name not in _MODULES:
        _MODULES[name] = load_module(HERE / "stages" / f"{name}.py")
    return _MODULES[name]


def stages(traffic: str, cfg: dict) -> list:
    """The stages of one pipeline of benchmark/traffic/<traffic>.json."""
    with open(HERE / "traffic" / f"{traffic}.json") as f:
        return sequence(json.load(f), cfg)


def sequence(mix: dict, cfg: dict) -> list:
    """The stages of one pipeline of the traffic mix `mix`."""
    common = {**cfg, **mix.get("options", {})}
    return [Stage(e["stage"], stage_module(e["stage"]), {**common, **e})
            for e in mix["stages"]]


def compared(seq: list) -> list:
    """The stages whose outputs are compared: the last entry of each
    stage name (the state the loom holds when the pipeline ends), in
    order."""
    last = {s.name: i for i, s in enumerate(seq)}
    return [s for i, s in enumerate(seq) if last[s.name] == i]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def load(S: np.ndarray, U: np.ndarray, names: dict, device):
    """A VelocytoLoom holding its own copy of the raw host counts S, U
    (genes, cells), as the loom's reader would leave it."""
    from velocyto_tpu_torch.analysis import VelocytoLoom

    v = VelocytoLoom.__new__(VelocytoLoom)
    v.device = torch.device(device)
    v.mesh = None
    v.S, v.U, v.A = S.copy(), U.copy(), np.zeros_like(S)
    v.ca, v.ra = dict(names["ca"]), dict(names["ra"])
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    return v


def run(v, seq: list, device, spans: list) -> None:
    """One pipeline on the loom `v`; appends (stage, start, end) on the
    host clock to spans."""
    for s in seq:
        t0 = time.perf_counter()
        with torch.profiler.record_function("stage:" + s.name):
            s.mod.run(v, s.p)
            _sync(device)
        spans.append((s.name, t0, time.perf_counter()))


COUNTERS = ("dense_launches", "partial_launches", "flat_launches",
            "balance_launches", "balance_decode_launches")


def launches() -> dict:
    """The port's kernel launch counters (velocyto_tpu_torch.kernels): a
    check of the path a cell went through, printed, never a metric."""
    from velocyto_tpu_torch import kernels
    return {name: getattr(kernels, name) for name in COUNTERS}


def outputs(v, seq: list, cells: np.ndarray) -> dict:
    """The loom's outputs that the comparison reads, as host arrays."""
    out = {"cells": cells}
    for s in compared(seq):
        out.update(s.mod.read(v, s.p, cells))
    return out


def rows(t: torch.Tensor, cells: np.ndarray) -> np.ndarray:
    """The rows `cells` of a device tensor the loom holds, as float64."""
    return t[torch.as_tensor(cells, device=t.device)].cpu().numpy() \
        .astype(np.float64)
