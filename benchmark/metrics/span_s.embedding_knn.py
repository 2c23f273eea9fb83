"""Host seconds per pipeline in the full mode's round trip of the
embedding's neighbour graph: the self time (benchmark/program.py) of the
program's spans transition.knn_csr (the (N, n_neighbors) ids copied to
the host, the scipy csr built from them) and shift.dense_k (that csr
made a dense (N, N) matrix on the device again). Nothing to read, and
no value, where the window holds neither."""
from benchmark import program

UNIT = "s"
LAYER = "host stages"
MOVES = "pipeline_s"


def read(t):
    return program.self_seconds(
        t, lambda n: n in ("transition.knn_csr", "shift.dense_k"))
