"""The benchmark's one command: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints the run's result as the last line of standard output and the
numbers compared, each beside its limit, as the last lines of standard
error. See benchmark/README.md.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
