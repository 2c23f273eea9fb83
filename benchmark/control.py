"""The control of the comparison, and the readings its limits are set
from.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed: one pipeline of the program at the cell's size, the plain
reference, and the reference again at the control's precision (each
stage one step below the precision the configuration states for it, see
reference.Precision) put in the program's place. Prints one JSON line a
seed: the program's numbers (the lower readings) and the control's (the
upper readings), each against the reference. The benchmark's own runs do
not run it; it needs a card unless a test passes a device.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import compare, harness, pipeline, reference, synth  # noqa

def readings(cfg: dict, seq: list, seed: int, device) -> dict:
    """{"program": numbers, "control": numbers} at one seed of one
    pipeline of the stages `seq` (pipeline.stages)."""
    S, U = synth.counts(cfg, seed, device)
    names = synth.names(cfg["cells"], cfg["genes"])
    checked = pipeline.compared(seq)
    v = pipeline.load(S, U, names, device)
    pipeline.run(v, seq, device, [])
    cells = harness.check_cells(cfg["cells"], seed)
    got = pipeline.outputs(v, seq, cells)
    del v
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference.run(S, U, got, checked, cfg, cells, device)
    ctl = reference.run(S, U, got, checked, cfg, cells, device,
                        prec="control")
    return {"program": compare.numbers(got, ref, checked),
            "control": compare.numbers(ctl, ref, checked)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_json(harness.HERE, "workloads", args.workload)
    cfg = harness.load_json(harness.HERE, "configs", cell["config"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(cfg, pipeline.stages(cell["traffic"], cfg), seed,
                     "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
