"""Host seconds per pipeline in which the sampled transition's calling
thread waits for its workers: the self time (benchmark/program.py) of
the program's spans transition.wait.* (the control's plan, each chunk of
the neighbour replay, the replay's end). Nothing to read, and no value,
where the window holds no such span."""
from benchmark import program

UNIT = "s"
LAYER = "host stages"
MOVES = "pipeline_s"


def read(t):
    return program.self_seconds(
        t, lambda n: n.startswith("transition.wait."))
