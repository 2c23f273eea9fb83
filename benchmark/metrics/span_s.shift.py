"""Host seconds per pipeline in the embedding shift's device work: the
self time (benchmark/program.py) of the program's spans shift.gather
(the full mode's correlations gathered at the embedding neighbours),
shift.softmax (the row softmax of the compact correlations) and
shift.project (the unit-vector contraction, which ends in its copy to
the host and so holds the device work queued before it). Nothing to
read, and no value, where the window holds none of them."""
from benchmark import program

UNIT = "s"
LAYER = "device ops"
MOVES = "pipeline_s"


def read(t):
    return program.self_seconds(
        t, lambda n: n in ("shift.gather", "shift.softmax", "shift.project"))
