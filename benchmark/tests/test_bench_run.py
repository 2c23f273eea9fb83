"""A cell end to end at a tiny size on the CPU, through the harness's
test path (device="cpu" in place of its look for a card): its result
line, the control that has to come out incorrect, and faults planted in
the timed path that have to make `correct` false."""
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, control, harness, pipeline

FIXTURE = Path(__file__).resolve().parent / "fixture"
REPO = Path(__file__).resolve().parents[2]
ARGS = ["--seed", "3000000019", "--seconds", "0.5", "--trace", "0"]


def _run(workload, argv=ARGS):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", workload] + argv, root=FIXTURE,
                      device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("workload", ["tiny.sampled", "tiny.full"])
def test_result_line(workload):
    line, err = _run(workload)
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, err
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"pipeline_s", "peak_mem_gib", "setup_s"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    cell = harness.load_json(FIXTURE, "workloads", workload)
    cfg = harness.load_json(FIXTURE, "configs", cell["config"])
    seq = pipeline.compared(pipeline.stages(cell["traffic"], cfg))
    assert list(line["checks"]) == list(compare.names(seq))
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert [r.split()[1] for r in last] == list(line["checks"])


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dg20k.sampled",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                             "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.parametrize("workload", ["tiny.sampled", "tiny.full"])
def test_control_fails(workload):
    cell = harness.load_json(FIXTURE, "workloads", workload)
    cfg = harness.load_json(FIXTURE, "configs", cell["config"])
    r = control.readings(cfg, pipeline.stages(cell["traffic"], cfg), 5,
                         "cpu")
    assert compare.judge(r["program"], cell["limits"])[0]
    assert not compare.judge(r["control"], cell["limits"])[0]


def test_a_mix_of_repeated_stages_is_data_alone():
    """The analyst's re-run loop, transition and embedding shift again
    with fewer neighbours, needs no code: the stage's entry carries its
    own settings and the digest of its sampling, and the last entry of
    each stage is the one compared."""
    from benchmark import reference
    cell = harness.load_json(FIXTURE, "workloads", "tiny.sampled")
    cfg = harness.load_json(FIXTURE, "configs", cell["config"])
    mix = json.loads((harness.HERE / "traffic" / "sampled.json").read_text())
    nn_k = 60 + 1
    digest = reference.replay_digest(reference.replay(
        cfg["cells"], nn_k, int(cfg["sampled_fraction"] * nn_k),
        cfg["random_seed"]))
    mix["stages"] += [{"stage": "transition", "n_neighbors": 60,
                       "replay_sha256": digest},
                      {"stage": "embedding_shift"}, {"stage": "grid_arrows"}]
    seq = pipeline.sequence(mix, cfg)
    assert [s.p["n_neighbors"] for s in pipeline.compared(seq)
            if s.name == "transition"] == [60]
    r = control.readings(cfg, seq, 7, "cpu")
    assert compare.judge(r["program"], cell["limits"])[0], r["program"]
    assert not compare.judge(r["control"], cell["limits"])[0]


def _unsmoothed(monkeypatch):
    """The smoothing step hands back its input unchanged."""
    from velocyto_tpu_torch.analysis import VelocytoLoom
    real = VelocytoLoom.knn_imputation

    def fake(self, *a, **kw):
        real(self, *a, **kw)
        for x in ("S", "U"):
            self._set_dev(f"{x}x_sz", self._get_dev(f"{x}_sz"))
    monkeypatch.setattr(VelocytoLoom, "knn_imputation", fake)


def _half_cells(monkeypatch):
    """The gamma fit leaves out half of the cells and averages over the
    rest."""
    from velocyto_tpu_torch import analysis
    real = analysis.fit_slope_weighted_offset

    def fake(Y, X, W, *a, **kw):
        h = Y.shape[1] // 2
        return real(Y[:, :h], X[:, :h], W[:, :h], *a, **kw)
    monkeypatch.setattr(analysis, "fit_slope_weighted_offset", fake)


def _scaled_shift(monkeypatch):
    """The shift delta_S that the transition consumes is half the
    velocity: correlations recomputed from it would agree."""
    from velocyto_tpu_torch.analysis import VelocytoLoom
    real = VelocytoLoom.calculate_shift

    def fake(self, *a, **kw):
        real(self, *a, **kw)
        self._set_dev("delta_S", 0.5 * self._get_dev("delta_S"))
    monkeypatch.setattr(VelocytoLoom, "calculate_shift", fake)


def _altered_corr(monkeypatch):
    """One correlation of every row altered where it is produced."""
    from velocyto_tpu_torch.analysis import VelocytoLoom
    real = VelocytoLoom.estimate_transition_prob

    def fake(self, *a, **kw):
        real(self, *a, **kw)
        if self.corr_calc == "knn_random":
            self._corr_dev[:, 0] += 0.01
        else:
            c = self._get_dev("corrcoef")
            c[:, 0] += 0.01
    monkeypatch.setattr(VelocytoLoom, "estimate_transition_prob", fake)


def _altered_sample(monkeypatch):
    """One sampled neighbour position altered where it is produced."""
    from velocyto_tpu_torch.analysis import VelocytoLoom
    real = VelocytoLoom.estimate_transition_prob

    def fake(self, *a, **kw):
        real(self, *a, **kw)
        ixs = np.array(self.sampling_ixs)
        ixs[0, 0] = (ixs[0, 0] + 1) % 50
        self.sampling_ixs = ixs
    monkeypatch.setattr(VelocytoLoom, "estimate_transition_prob", fake)


def _altered_control(monkeypatch):
    """One entry of the randomized control's permuted velocity altered
    where it is produced."""
    from velocyto_tpu_torch.analysis import VelocytoLoom
    real = VelocytoLoom.estimate_transition_prob

    def fake(self, *a, **kw):
        real(self, *a, **kw)
        d = np.array(self.delta_S_rndm)
        d[0, 0] = -d[0, 0] + 1.0
        self.delta_S_rndm = d
    monkeypatch.setattr(VelocytoLoom, "estimate_transition_prob", fake)


@pytest.mark.parametrize("fault", [_unsmoothed, _half_cells, _scaled_shift,
                                   _altered_corr, _altered_sample,
                                   _altered_control],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("workload", ["tiny.sampled", "tiny.full"])
def test_fault_is_incorrect(workload, fault, monkeypatch):
    if fault is _altered_sample and workload == "tiny.full":
        pytest.skip("full mode samples no neighbours")
    fault(monkeypatch)
    line, err = _run(workload)
    assert line["correct"] is False, err


@pytest.mark.card
def test_cell_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dg20k.sampled",
         "--seed", "4000000003", "--seconds", "5", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.splitlines()[-1])["correct"] is True
