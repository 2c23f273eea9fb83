"""Host seconds per pipeline in the Markov diffusion: the self time
(benchmark/program.py) of the program's spans markov.* (prepare_markov's
dense transition_prob, markov.tp, and its matrix, markov.matrix;
run_markov's steps, markov.steps, which end in the result's copy to the
host and so hold the steps' device time). Nothing to read, and no value,
where the window holds none of them."""
from benchmark import program

UNIT = "s"
LAYER = "device ops"
MOVES = "pipeline_s"


def read(t):
    return program.self_seconds(t, lambda n: n.startswith("markov."))
