"""Seconds per pipeline in VelocytoLoom.knn_imputation's stage: the benchmark's
host-clock span around the call, which ends in a device synchronisation."""
UNIT = "s"
LAYER = "entry point"
MOVES = "pipeline_s"


def read(t):
    return t.stage_seconds("knn_imputation")
