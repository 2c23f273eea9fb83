"""Share, in percent, of the HBM bound of the Markov steps' compulsory
bytes (benchmark/roofline_markov.py: directions x markov_n_steps x N^2 x
4 B a pipeline, at roofline.PEAK_BYTES) in the device time of the
activities inside the program's markov.steps spans (run_markov's
float32 copy of tr, the steps and the result's copy to the host; the
span ends in that copy, so it holds the steps' device time). Nothing to
read, and no value, where the window holds no such span or no Markov
stage."""
from benchmark import program, roofline_markov

UNIT = "%"
LAYER = "device ops"
MOVES = "pipeline_s"


def read(t):
    steps = program.ranges(t).get("markov.steps")
    work = sum(roofline_markov.markov_steps_bound_s(p) for p in t.stages
               if p["stage"] == "markov")
    if not steps or work == 0.0:
        return None
    sec = roofline_markov.seconds_inside(t.device, steps)
    if sec == 0.0:
        return None
    return 100.0 * work * t.pipelines / sec
