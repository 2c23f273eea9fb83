"""Host seconds per pipeline in the full-mode transition's randomized
control: the self time (benchmark/program.py) of the program's span
transition.control (delta_S copied to the host, numpy's
permute_rows_nsign on it). Nothing to read, and no value, where the
window holds no such span."""
from benchmark import program

UNIT = "s"
LAYER = "host stages"
MOVES = "pipeline_s"


def read(t):
    return program.self_seconds(t, lambda n: n == "transition.control")
