"""Host seconds per pipeline in the embedding shift's expression
scaling: the self time (benchmark/program.py) of the program's span
shift.scaling (each field's estimated expression change gathered over
the neighbours, its projection, and the scaling's copy to the host,
which waits for them). Nothing to read, and no value, where the window
holds no such span."""
from benchmark import program

UNIT = "s"
LAYER = "device ops"
MOVES = "pipeline_s"


def read(t):
    return program.self_seconds(t, lambda n: n == "shift.scaling")
