"""Seconds per pipeline in the host stages normalize and perform_PCA
(float32 numpy normalizations, ops/pca.py's LAPACK PCA): the
benchmark's host-clock spans around the two calls."""
UNIT = "s"
LAYER = "host stages"
MOVES = "pipeline_s"


def read(t):
    return t.stage_seconds("normalize", "pca")
