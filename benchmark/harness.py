"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell is benchmark/workloads/<cell>.json (its configuration's name, its
traffic's name, its limits); a configuration is
benchmark/configs/<name>.json; a traffic mix is
benchmark/traffic/<name>.json, the stages of one pipeline, each a module
benchmark/stages/<stage>.py (see pipeline.py); a per-layer metric is
benchmark/metrics/<name>.py (a `read(trace)` that returns a number, or
None where the trace holds nothing for it). The harness finds each by
name, so a new cell, configuration, traffic, stage or metric is new
files only.

The traffic is a closed loop of one analyst: pipelines back to back on
the same data, each on a loom of its own loaded from the raw host
counts. The window is the pipelines' time: it runs from the first
pipeline's start to the end of the last one that started before
--seconds of pipelines had run. The harness's work between two
pipelines (the last loom released, a garbage collection, the next loom
loaded) is timed apart and left out of it. The last pipeline's outputs
are compared with the reference after the window, at cells drawn from
the seed.
"""
import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import compare, pipeline, reference, synth, trace

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "velocyto_tpu")


def load_json(root: Path, kind: str, name: str) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def load_metrics() -> dict:
    """name -> module of every per-layer metric file."""
    return {path.stem: pipeline.load_module(path)
            for path in sorted((HERE / "metrics").glob("*.py"))}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


CHECK_CELLS = 256       # cells whose columns and rows are compared


def check_cells(n: int, seed: int) -> np.ndarray:
    """The cells compared, drawn from the seed."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=min(CHECK_CELLS, n), replace=False))


def _device_info(device):
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def measure(S, U, names, seq, device, seconds, traced):
    """The window: pipelines back to back until `seconds` of pipelines
    have run. Returns (last loom, pipelines, window seconds, spans,
    seconds between pipelines, profile)."""
    spans, between = [], []
    prof_ctx = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if traced
        else contextlib.nullcontext())
    v, count, window = None, 0, 0.0
    with prof_ctx as prof:
        while count == 0 or window < seconds:
            t0 = time.perf_counter()
            v = None
            gc.collect()
            v = pipeline.load(S, U, names, device)
            t1 = time.perf_counter()
            with torch.profiler.record_function("pipeline"):
                pipeline.run(v, seq, device, spans)
            window += time.perf_counter() - t1
            between.append(t1 - t0)
            count += 1
    return v, count, window, spans, between, prof


def main(argv=None, root: Path = HERE, device=None, t_start=None,
         out=sys.stdout, err=sys.stderr) -> int:
    """A run; returns the exit code. device=None asks for the card and
    refuses to run without one; tests pass "cpu"."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell = load_json(root, "workloads", args.workload)
    cfg = load_json(root, "configs", cell["config"])
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA device(s): "
                  f"is_available={torch.cuda.is_available()}", file=err)
            return 2
        device = "cuda"
    seq = pipeline.stages(cell["traffic"], cfg)
    checked = pipeline.compared(seq)
    metrics = load_metrics() if args.trace else {}

    # set-up: the data, the kernels' builds, one pipeline at the cell's
    # own shapes
    S, U = synth.counts(cfg, args.seed, device)
    names = synth.names(cfg["cells"], cfg["genes"])
    warm = pipeline.load(S, U, names, device)
    pipeline.run(warm, seq, device, [])
    del warm
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    before = pipeline.launches()
    v, count, window, spans, between, prof = measure(
        S, U, names, seq, device, args.seconds, bool(args.trace))
    path = {k: n - before[k] for k, n in pipeline.launches().items()}
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    dev_info = dict(_device_info(device), memory_peak_bytes=int(peak))
    result = {}
    if args.trace:
        tr = trace.reduce(prof, spans, [st.p for st in seq], count)
        del prof
        vals = {}
        for name, mod in metrics.items():
            value = mod.read(tr)
            if value is None:
                print(f"# {name}: nothing to read in this trace", file=err)
            else:
                vals[name] = {"value": float(value), "unit": mod.UNIT}
        dev_info.update(busy_s=tr.busy_seconds(),
                        window_s=tr.window_seconds())
        result["metrics"] = vals
        result["breakdown"] = trace.breakdown(tr)
    else:
        result["metrics"] = {
            "pipeline_s": {"value": window / count, "unit": "s"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}

    # the comparison, once the program's state is freed
    t_cmp = time.perf_counter()
    cells = check_cells(cfg["cells"], args.seed)
    got = pipeline.outputs(v, seq, cells)
    del v
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference.run(S, U, got, checked, cfg, cells, device)
    t_num = time.perf_counter()
    values = compare.numbers(got, ref, checked)
    correct, rows = compare.judge(values, cell["limits"])
    print(f"# outputs read in {t_ref - t_cmp!r} s, reference "
          f"{t_num - t_ref!r} s, numbers {time.perf_counter() - t_num!r} s",
          file=err)

    bad = forbidden_modules()
    if bad:
        print("modules of JAX or the JAX package were loaded: "
              + " ".join(bad), file=err)
        return 3
    first, last = seq[0].name, seq[-1].name
    starts = [s for name, s, _ in spans if name == first]
    ends = [e for name, _, e in spans if name == last]
    print("# pipeline seconds: " + " ".join(
        f"{e - s:.3f}" for s, e in zip(starts, ends)), file=err)
    print("# between pipelines, outside the window (loom released, gc, "
          "next loom loaded), seconds: " + " ".join(
              f"{b:.3f}" for b in between), file=err)
    print("# kernel launches in the window: " + " ".join(
        f"{k}={n}" for k, n in path.items()), file=err)
    print(f"# {args.workload} seed {args.seed}: {count} pipelines in "
          f"{window!r} s, set-up {setup_s!r} s, peak {peak} B on "
          f"{dev_info['kind']}", file=err)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=err)
    err.flush()
    line = {"correct": bool(correct), "attempted": count, "failed": 0,
            **result, "device": dev_info,
            "checks": {name: {"value": value, "limit": limit}
                       for name, value, limit in rows}}
    print(json.dumps(line), file=out, flush=True)
    return 0
