"""span_s.shift on synthetic traces (test_bench_spans.py's): the self
time of the embedding shift's spans, in either mode's set, and nothing
of a span outside that set."""
import pytest
from test_bench_spans import METRICS, _trace, record  # noqa: F401

SHIFT = METRICS["span_s.shift"]
# inside the second pipeline's transition stage, 1000-2000 µs
FULL = {"shift.gather": [(1700.0, 1750.0)],
        "shift.softmax": [(1750.0, 1760.0)],
        "shift.project": [(1760.0, 1900.0)],
        "transition.knn_csr": [(1200.0, 1290.0)]}
SAMPLED = {"shift.softmax": [(1750.0, 1760.0)],
           "shift.project": [(1760.0, 1900.0)],
           "shift.scaling": [(1900.0, 1950.0)]}
# a program whose full mode still builds the dense mask
DENSE_K = {"shift.dense_k": [(1600.0, 1750.0)],
           "shift.softmax": [(1750.0, 1760.0)],
           "shift.project": [(1760.0, 1900.0)]}


@pytest.mark.parametrize("prog,want", [
    (FULL, (50 + 10 + 140) / 2e6),
    (SAMPLED, (10 + 140) / 2e6),
    (DENSE_K, (10 + 140) / 2e6),
    ({"shift.project": [(1760.0, 1900.0)],
      "upload.delta_S": [(1800.0, 1850.0)]}, (140 - 50) / 2e6),
], ids=["full", "sampled", "dense_k", "nested"])
def test_span_s_shift_reads_the_shift_spans(prog, want, record):  # noqa: F811
    assert SHIFT.read(_trace()) is None
    record(prog)
    assert SHIFT.read(_trace()) == pytest.approx(want)
    record(prog, thread=-1)
    assert SHIFT.read(_trace()) is None
    record({"shift.scaling": [(1900.0, 1950.0)]})
    assert SHIFT.read(_trace()) is None
