"""The neighbour-sampling replay (native/sampler.cpp) of this checkout
against that of another checkout of the port: both built, run on the same
rows, held to bit equality and timed in turns.

Loads the other checkout's velocyto_tpu_torch package under its own name,
builds both sampler libraries (each checkout's own flags), and runs each
whole replay (native.choice_noreplace_rows_state: np.random.seed(SEED),
then one choice(3501, 1750, replace=False, p) per row, p the normalised
linspace(0.5, 0.1), the default sampled transition at n_neighbors 3,500)
at 20,000 and 65,877 rows, the cells of the dg20k and pbmc68k
configurations, in turns: other, this, this, other.  Exits non-zero when
the rows, the doubles drawn or numpy's end state differ in one bit.

    git archive <commit> velocyto_tpu_torch | tar -x -C _archive/other
    python3 tools/replay_against_checkout.py _archive/other

Prints one JSON line: the host's CPU, the card's name and power limit
where the machine has one (the replay itself runs on the host), and per
row count each checkout's seconds in turn order, the rounds and doubles
a row (this checkout's native.sampler_replays) and whether every run
matched the first.  --rows takes other row counts (comma-separated), for
a short rehearsal.  Run from the repo root.
"""
import argparse
import importlib.util
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from velocyto_tpu_torch import native as ours              # noqa: E402

SEED = 15071990
POP, SIZE = 3501, 1750       # nn_k = n_neighbors + 1, int(0.5 nn_k)
ROWS = (20000, 65877)


def _load(checkout: str):
    """The other checkout's velocyto_tpu_torch package, as other_vtt (its
    modules import each other relatively)."""
    path = Path(checkout) / "velocyto_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_vtt", path / "__init__.py",
        submodule_search_locations=[str(path)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_vtt"] = mod
    spec.loader.exec_module(mod)
    return mod


def _cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def _card():
    """(name, 'name, power limit') of the machine's first card, or
    (None, None)."""
    try:
        import torch
        name = torch.cuda.get_device_name(0) if torch.cuda.is_available() \
            else None
    except ImportError:
        name = None
    if name is None:
        return None, None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    return name, smi


def _same(a, b) -> bool:
    (rows_a, draws_a, st_a), (rows_b, draws_b, st_b) = a, b
    return (np.array_equal(rows_a, rows_b) and draws_a == draws_b
            and np.array_equal(st_a[1], st_b[1]) and st_a[2] == st_b[2])


def main(checkout: str, rows=ROWS) -> dict:
    other = _load(checkout).native
    ours.build()
    other.build()
    p = np.linspace(0.5, 0.1, POP)
    p = p / p.sum()
    replays = {"other": other.choice_noreplace_rows_state,
               "this": ours.choice_noreplace_rows_state}
    res = {}
    for n in rows:
        got = {"other_s": [], "this_s": []}
        ref, same = None, True
        before = dict(ours.sampler_replays)
        for key in ("other", "this", "this", "other"):
            t0 = time.perf_counter()
            out = replays[key](SEED, n, POP, SIZE, p)
            got[f"{key}_s"].append(time.perf_counter() - t0)
            if ref is None:
                ref = out
            else:
                same = same and _same(out, ref)
            del out
        counted = {k: ours.sampler_replays[k] - before[k] for k in before}
        got["rounds_per_row"] = counted["rounds"] / counted["rows"]
        got["doubles_per_row"] = counted["doubles"] / counted["rows"]
        got["bitwise"] = same
        res[str(n)] = got
        del ref
    name, smi = _card()
    print(json.dumps({"cpu": _cpu(), "cpus": os.cpu_count(), "card": name,
                      "smi": smi, "pop": POP, "size": SIZE, "seed": SEED,
                      "rows": res}))
    bad = [n for n, v in res.items() if not v["bitwise"]]
    if bad:
        sys.exit(f"replays differ at {bad} rows")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkout")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)))
    args = ap.parse_args()
    main(args.checkout, tuple(int(r) for r in args.rows.split(",")))
