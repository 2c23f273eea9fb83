"""The port's bench harnesses (bench_pipeline, bench_knn50k, bench_attr,
bench_common) on the CPU, against the JAX package's scripts of the same
names.

bench_pipeline.run_once runs at 300 cells x 80 genes with k=10, sight 30,
maxl 15 and nn=40, set through the module globals as the JAX harness's
are; it gives the JAX harness's stage names and a delta_embedding that
matches the JAX VelocytoLoom the JAX harness drives through the same
steps (rtol 1e-3 / atol 1e-5, test_torch_sampled.py's embedding-shift
tolerance; the sampled positions exact).  The run statistics are checked
on fixed run lists; the attribution tables' keys map one-to-one onto the
JAX scripts' keys (bench_attr.RENAMED lists the renamed ones); the
harnesses write no file and refuse to measure without a card."""
import os

import numpy as np
import pytest
import torch

import bench_attr as jbench_attr
import bench_pipeline as jbench_pipeline
import velocyto_tpu as vt

from velocyto_tpu_torch import (bench_attr, bench_common, bench_knn50k,
                                bench_pipeline, kernels)
from velocyto_tpu_torch.ops import knn_device as tkd

SMALL = {"K": 10, "B_SIGHT": 30, "B_MAXL": 15, "N_NEIGHBORS": 40}
CELLS, GENES = 300, 80


@pytest.fixture
def small(monkeypatch):
    for mod in (bench_pipeline, jbench_pipeline):
        for name, value in SMALL.items():
            monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(jbench_pipeline, "CELLS", CELLS)
    monkeypatch.setattr(jbench_pipeline, "GENES", GENES)
    return bench_pipeline.synth(np.random.RandomState(0), CELLS, GENES)


def test_synth_is_the_jax_harness_generator(small):
    S, U = small
    jS, jU = jbench_pipeline.synth(np.random.RandomState(0), CELLS, GENES)
    np.testing.assert_array_equal(S, jS)
    np.testing.assert_array_equal(U, jU)


def test_run_once_matches_the_jax_harness(small, monkeypatch, tmp_path):
    S, U = small
    monkeypatch.chdir(tmp_path)
    total, stages, v = bench_pipeline.run_once(S, U, device="cpu")
    made = []
    grid = vt.VelocytoLoom.calculate_grid_arrows

    def capture(self, *args, **kwargs):          # the harness's last stage
        made.append(self)
        return grid(self, *args, **kwargs)
    monkeypatch.setattr(vt.VelocytoLoom, "calculate_grid_arrows", capture)
    _jtotal, jstages = jbench_pipeline.run_once(S, U)
    assert list(stages) == list(jstages)
    assert total > 0 and all(t >= 0 for t in stages.values())
    (jv,) = made
    np.testing.assert_array_equal(v.sampling_ixs, jv.sampling_ixs)
    np.testing.assert_allclose(v.delta_embedding, jv.delta_embedding,
                               rtol=1e-3, atol=1e-5)
    assert v.corr_calc == "knn_random"
    assert kernels.partial_launches == 0       # CPU tensors: plain version
    assert os.listdir(tmp_path) == []


def test_run_once_full_mode(small):
    S, U = small
    _total, stages, v = bench_pipeline.run_once(S, U, device="cpu",
                                                knn_random=False)
    assert list(stages)[5].startswith("transition_prob(")
    assert v.corr_calc == "full" and np.isfinite(v.delta_embedding).all()


def _runs(totals, clean, first=0.5):
    """Runs with the given totals and clean flags after a warm-up run
    whose total is `first`."""
    return [{"total": first, "clean": True, "warmup": True}] + [
        {"total": t, "clean": c, "warmup": False}
        for t, c in zip(totals, clean)]


def test_summarize_excludes_the_warmup_and_takes_the_true_median():
    median, totals, n_clean, label, med = bench_common.summarize(
        _runs([3.0, 1.0, 4.0, 2.0], [True] * 4, first=0.1))
    assert median == 2.5 and totals == [1.0, 2.0, 3.0, 4.0]
    assert n_clean == 4 and "true median of 4 clean runs" in label
    assert med["total"] in (2.0, 3.0)


def test_summarize_keeps_only_clean_runs():
    median, totals, n_clean, label, _med = bench_common.summarize(
        _runs([3.0, 10.0, 5.0], [True, False, True]))
    assert (median, totals, n_clean) == (4.0, [3.0, 5.0], 2)


def test_summarize_labels_an_all_contended_session():
    median, totals, n_clean, label, _med = bench_common.summarize(
        _runs([6.0, 2.0, 4.0], [False] * 3))
    assert n_clean == 0 and median == 4.0 and totals == [2.0, 4.0, 6.0]
    assert "CONTENDED" in label and "not representative" in label


def test_summarize_needs_a_measured_run():
    with pytest.raises(ValueError, match="no measured run"):
        bench_common.summarize(_runs([], []))


@pytest.mark.parametrize("main", [bench_pipeline.main, bench_knn50k.main,
                                  bench_attr.main],
                         ids=["bench_pipeline", "bench_knn50k", "bench_attr"])
def test_harness_refuses_to_run_without_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        main()


def test_attribution_keys_map_onto_the_jax_scripts(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    small_t = {"n": 300, "g": 40, "nn": 50}
    small_k = {"n": 400, "d": 10, "k": 10, "sight": 30, "maxl": 15}
    port_t = bench_attr.attr_transition(**small_t, device="cpu")
    port_k = bench_attr.attr_knn50k(**small_k, device="cpu")
    jax_t = jbench_attr.attr_transition(**small_t)
    jax_k = jbench_attr.attr_knn50k(**small_k)
    rename = bench_attr.RENAMED
    assert set(port_t) == {rename.get(k, k) for k in jax_t} | \
        set(bench_attr.ADDED)
    assert set(port_k) == {rename.get(k, k) for k in jax_k}
    for table in (port_t, port_k):
        assert all(v > 0 for k, v in table.items() if isinstance(v, float)
                   and not k.startswith("idle_share"))
        assert table["probe_ms"] == [None, None]      # no card: no probe
    assert port_t["idle_share(whole)"] is None
    assert os.listdir(tmp_path) == []


KNN_STAGES = ["candidate_sort", "rescore_f64", "reorder_truncate",
              "hub_order", "balance_scan"]


def test_knn50k_stages_give_the_balanced_graph():
    x = bench_knn50k.points(400, 10)
    x64 = torch.as_tensor(x.astype(np.float64))
    _total, stages, (dist, idx, l) = bench_knn50k.run_once(
        x, x64, "cpu", k=10, sight=30, maxl=15)
    assert list(stages) == KNN_STAGES
    g = tkd.balanced_knn_graph_dev(x, k=10, sight_k=30, maxl=15,
                                   device="cpu")
    np.testing.assert_array_equal(idx.numpy(), g.idx.numpy())
    np.testing.assert_array_equal(dist.numpy(), g.dist.numpy())
    np.testing.assert_array_equal(l.numpy(), g.indeg.numpy())


def test_attr_knn20k_times_the_host_loop_beside_the_scan(monkeypatch,
                                                        tmp_path):
    """The 20k split at a small size: the path's five stages, the host
    loop on the same candidates beside them (left out of the sum), and
    the host loop's graph equal to the scan's."""
    monkeypatch.chdir(tmp_path)
    graphs = []
    loop = bench_knn50k.balance_knn_loop_plain

    def recorded(*args):
        graphs.append(loop(*args))
        return graphs[-1]
    monkeypatch.setattr(bench_knn50k, "balance_knn_loop_plain", recorded)
    table = bench_attr.attr_knn20k(n=400, d=10, k=10, sight=30, maxl=15,
                                   device="cpu")
    assert list(table) == KNN_STAGES + ["balance_loop(host)", "probe_ms",
                                        "sum"]
    assert table["probe_ms"] == [None, None]
    assert all(table[s] > 0 for s in KNN_STAGES + ["balance_loop(host)"])
    assert table["sum"] == pytest.approx(sum(table[s] for s in KNN_STAGES))
    assert len(graphs) == 2           # the untimed run and the timed one
    g = tkd.balanced_knn_graph_dev(bench_knn50k.points(400, 10), k=10,
                                   sight_k=30, maxl=15, device="cpu")
    for got, want in zip(graphs[-1], (g.dist, g.idx, g.indeg)):
        np.testing.assert_array_equal(got, want.numpy())
    assert os.listdir(tmp_path) == []
