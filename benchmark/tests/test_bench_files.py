"""Every cell, configuration, traffic mix, stage and metric that
BENCHMARK.json names is a file of its own under benchmark/, found by its
name."""
import json
from pathlib import Path

import pytest

from benchmark import compare, harness, pipeline

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = harness.load_metrics()
FIXTURE = (harness.HERE / "tests" / "fixture" / "configs" / "tiny.json"
           ).relative_to(ROOT)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_file(cell):
    got = harness.load_json(harness.HERE, "workloads", cell["name"])
    cfg = harness.load_json(harness.HERE, "configs", cell["config"])
    assert got["name"] == cell["name"] and got["config"] == cell["config"]
    assert got["traffic"] == cell["traffic"]
    assert got["chips"] == cell["chips"] == 1
    assert cfg["name"] == cell["config"]
    seq = pipeline.stages(got["traffic"], cfg)
    assert list(got["limits"]) and set(got["limits"]) == set(
        compare.names(pipeline.compared(seq)))


TRAFFIC = sorted((harness.HERE / "traffic").glob("*.json"))


@pytest.mark.parametrize("path", TRAFFIC, ids=lambda p: p.stem)
def test_traffic_file(path):
    """A traffic mix names itself and stages that each have a module with
    the five functions of pipeline.py's docstring."""
    mix = json.loads(path.read_text())
    assert mix["name"] == path.stem and mix["why"] and mix["stages"]
    for entry in mix["stages"]:
        mod = pipeline.stage_module(entry["stage"])
        for fn in ("names", "run", "read", "recompute", "numbers"):
            assert callable(getattr(mod, fn)), (entry["stage"], fn)


def test_every_traffic_is_used():
    used = {c["traffic"] for c in SPEC["workloads"]}
    assert used <= {p.stem for p in TRAFFIC}


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    got = json.loads((ROOT / cfg["file"]).read_text())
    assert got["name"] == cfg["name"] and got["source"] == cfg["source"]
    assert set(got["precision"]) >= {"normalize", "pca_gram", "knn_rescore",
                                     "smoothing", "gamma_fit", "velocity",
                                     "correlation", "softmax",
                                     "embedding_shift", "grid"}
    assert len(got["replay_sha256"]) == 64
    assert any(c["config"] == cfg["name"] for c in SPEC["workloads"])


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_file(metric):
    mod = METRICS[metric["name"]]
    assert mod.UNIT == metric["unit"]
    assert mod.LAYER == metric["layer"]
    assert mod.MOVES == metric["moves"]
    assert callable(mod.read)


def test_no_metric_file_left_out():
    assert set(METRICS) == {m["name"] for m in SPEC["per_layer"]}


@pytest.mark.parametrize("cfg", [str(FIXTURE)] + [c["file"] for c in
                                                   SPEC["configs"]])
def test_replay_digest(cfg):
    """Each configuration's stored digest is that of the reference's
    replay of velocyto's neighbour sampling at its sizes."""
    from benchmark import reference
    c = json.loads((ROOT / cfg).read_text())
    n = c["cells"]
    nn_k = min(c["n_neighbors"] + 1, n - 1)
    assert c["replay_sha256"] == reference.replay_digest(reference.replay(
        n, nn_k, int(c["sampled_fraction"] * nn_k), c["random_seed"]))
