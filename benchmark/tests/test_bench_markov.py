"""The tutorial's stages (stages/embedding_shift_scaled.py,
stages/markov.py) on the tiny fixture on the CPU: a cell of them is
correct end to end; each new number is 0 for the reference against
itself and within its limit for the program; the control fails each of
them. The three metrics that read the new spans (span_s.markov,
span_s.shift.scaling, markov_roofline) on synthetic traces."""
import io
import json
from pathlib import Path

import pytest

from benchmark import compare, control, harness, pipeline, reference, synth
from test_bench_spans import METRICS, _trace, record  # noqa: F401

FIXTURE = Path(__file__).resolve().parent / "fixture"
NEW = ("scaling_gap", "shift_gap", "markov_tr_gap", "diffused_gap")


def _cell():
    cell = harness.load_json(FIXTURE, "workloads", "tiny.tutorial")
    return cell, harness.load_json(FIXTURE, "configs", cell["config"])


@pytest.fixture(scope="module")
def readings():
    """One pipeline of the tiny tutorial cell at a large seed: the
    program's outputs, the reference's and the control's."""
    cell, cfg = _cell()
    seq = pipeline.stages(cell["traffic"], cfg)
    checked = pipeline.compared(seq)
    seed = 2999999929
    S, U = synth.counts(cfg, seed, "cpu")
    v = pipeline.load(S, U, synth.names(cfg["cells"],
                                                cfg["genes"]), "cpu")
    pipeline.run(v, seq, "cpu", [])
    cells = harness.check_cells(cfg["cells"], seed)
    got = pipeline.outputs(v, seq, cells)
    ref = reference.run(S, U, got, checked, cfg, cells, "cpu")
    ctl = reference.run(S, U, got, checked, cfg, cells, "cpu",
                        prec="control")
    return cell, checked, got, ref, ctl


def test_the_tutorial_cell_is_correct():
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", "tiny.tutorial", "--seed", "3000000019",
                       "--seconds", "0.5", "--trace", "0"], root=FIXTURE,
                      device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().splitlines()[-1])
    assert line["correct"] is True, err.getvalue()
    assert set(NEW) <= set(line["checks"])


@pytest.mark.parametrize("name", NEW)
def test_a_new_number_is_zero_against_itself(name, readings):
    _cell_, checked, _got, ref, _ctl = readings
    assert compare.numbers(ref, ref, checked)[name] == 0.0


@pytest.mark.parametrize("name", NEW)
def test_the_program_passes_and_the_control_fails(name, readings):
    cell, checked, got, ref, ctl = readings
    limit = cell["limits"][name]
    assert compare.numbers(got, ref, checked)[name] <= limit
    assert not compare.numbers(ctl, ref, checked)[name] <= limit


def test_the_mix_keeps_each_diffused_vector(readings):
    _cell_, _checked, got, _ref, _ctl = readings
    n = _cell()[1]["cells"]
    for direction in ("forward", "backwards"):
        x = got["diffused_" + direction]
        assert x.shape == (n,) and abs(float(x.sum()) - 1.0) < 1e-3


def test_control_fails_the_cell():
    cell, cfg = _cell()
    r = control.readings(cfg, pipeline.stages(cell["traffic"], cfg), 5,
                         "cpu")
    assert compare.judge(r["program"], cell["limits"])[0], r["program"]
    assert not compare.judge(r["control"], cell["limits"])[0]


# synthetic traces: test_bench_spans.py's two pipelines of 1,000 µs, with
# a Markov stage's spans inside the second pipeline's "transition" stage
# (1000-2000 µs); the device busy 1500-1600 there
STEPS = {"markov.tp": [(1100.0, 1150.0)],
         "markov.matrix": [(1150.0, 1250.0)],
         "markov.steps": [(1400.0, 1700.0)],
         "shift.scaling": [(1050.0, 1090.0)],
         "upload.tr": [(1160.0, 1170.0)]}


def _markov_trace(cells=100, steps=10, directions=("forward",)):
    t = _trace()
    t.stages.append({"stage": "markov", "cells": cells,
                     "markov_n_steps": steps,
                     "markov_directions": list(directions)})
    return t


def test_span_s_markov_reads_the_markov_spans(record):  # noqa: F811
    read = METRICS["span_s.markov"].read
    assert read(_trace()) is None
    record(STEPS)
    assert read(_trace()) == pytest.approx((50 + 90 + 300) / 2e6)
    record({"shift.scaling": [(1050.0, 1090.0)]})
    assert read(_trace()) is None


def test_span_s_shift_scaling_reads_its_span(record):  # noqa: F811
    read = METRICS["span_s.shift.scaling"].read
    assert read(_trace()) is None
    record(STEPS)
    assert read(_trace()) == pytest.approx(40 / 2e6)
    record(STEPS, thread=-1)
    assert read(_trace()) is None


def test_markov_roofline(record):  # noqa: F811
    from benchmark import roofline
    read = METRICS["markov_roofline"].read
    assert read(_markov_trace()) is None
    record(STEPS)
    assert read(_trace()) is None               # no Markov stage
    # 100 µs of the device inside markov.steps (1500-1600)
    bound = 4.0 * 100 * 100 * 2 * 10 / roofline.PEAK_BYTES
    assert read(_markov_trace(directions=("forward", "backwards"))) == \
        pytest.approx(100.0 * bound * 2 / 100e-6)


def test_seconds_inside_clips_each_activity():
    from benchmark import roofline_markov
    device = [("a", 0.0, 10.0), ("b", 5.0, 25.0), ("c", 30.0, 40.0)]
    assert roofline_markov.seconds_inside(device, [(8.0, 20.0),
                                                   (15.0, 22.0)]) == \
        pytest.approx((2.0 + 14.0) / 1e6)
    assert roofline_markov.seconds_inside([], [(0.0, 1.0)]) == 0.0
