"""Host seconds per pipeline in PCA's BLAS and LAPACK calls: the self
time (benchmark/program.py) of the program's spans pca.gram (the syrk of
the centered cells) and pca.eigh (the top components of the Gram
matrix). Nothing to read, and no value, where the window holds
neither."""
from benchmark import program

UNIT = "s"
LAYER = "host stages"
MOVES = "pipeline_s"


def read(t):
    return program.self_seconds(t, lambda n: n in ("pca.gram", "pca.eigh"))
