"""The full mode's randomized control (estimate_transition_prob(
knn_random=False, calculate_randomized=True)) on the CPU: its plan drawn
on a worker from a snapshot of numpy's stream and applied on the device,
with delta_S authoritative on the device (float32, as calculate_shift
leaves it) or on the host (float64, as state_from_numpy or an assignment
leaves it).

Every comparison is exact: delta_S_rndm against permute_rows_nsign on the
same rows and against the JAX package's; numpy's state after the call
against the host loop's; the view after delta_S is edited and reassigned;
the device state and the threads after a call, and after a failed one."""
import threading
import time

import numpy as np
import pytest
import torch

import velocyto_tpu as vt
import velocyto_tpu_torch as vtt
from velocyto_tpu_torch import analysis as tanalysis
from velocyto_tpu_torch.io.checkpoint import load_vlm, save_vlm

from test_torch_pipeline import GOLDEN
from test_torch_sampled import _state

SEED = 15071990
KW = dict(hidim="Sx_sz", embed="ts", knn_random=False, n_neighbors=20,
          calculate_randomized=True, random_seed=SEED)
AUTHORITY = ["device_f32", "host_f64"]


def _port(golden, authority):
    """The port at the transition stage, delta_S held as `authority`
    says."""
    v = _state(vtt, golden)
    if authority == "device_f32":
        v._set_dev("delta_S", torch.from_numpy(
            golden["delta_S"].astype(np.float32)))
    return v


def _rows(v, authority):
    """delta_S as the call reads it, in float64."""
    if authority == "device_f32":
        return v._get_dev("delta_S", None).numpy().astype(np.float64)
    return np.array(v.delta_S, dtype=np.float64)


def _host_loop(rows):
    """permute_rows_nsign of a copy of rows from the call's seed: the
    permuted rows and numpy's state after them."""
    np.random.seed(SEED)
    out = rows.copy()
    tanalysis.permute_rows_nsign(out)
    return out, np.random.get_state()


@pytest.fixture(scope="module")
def calls():
    """{authority: (loom after the call, its rows, numpy's state after
    the call)}."""
    golden = np.load(GOLDEN)
    out = {}
    for authority in AUTHORITY:
        v = _port(golden, authority)
        rows = _rows(v, authority)
        np.random.seed(1)          # the call must set numpy's state itself
        v.estimate_transition_prob(**KW)
        out[authority] = (v, rows, np.random.get_state())
    return out


def _same_state(a, b):
    return a[0] == b[0] and np.array_equal(a[1], b[1]) and a[2:] == b[2:]


@pytest.mark.parametrize("authority", AUTHORITY)
def test_control_equals_the_host_loop_and_the_jax_package(calls, authority):
    v, rows, _ = calls[authority]
    golden = np.load(GOLDEN)
    jax_v = _state(vt, golden)
    jax_v.delta_S = rows.copy()
    jax_v.estimate_transition_prob(**KW)
    want, _ = _host_loop(rows)
    got = v.delta_S_rndm
    assert got.dtype == np.float64
    for other in (want, np.asarray(jax_v.delta_S_rndm)):
        np.testing.assert_array_equal(got.view(np.uint64),
                                      other.view(np.uint64))


@pytest.mark.parametrize("authority", AUTHORITY)
def test_numpy_stream_after_the_call_is_the_host_loops(calls, authority):
    _v, rows, after = calls[authority]
    _, want = _host_loop(rows)
    assert _same_state(after, want)


@pytest.mark.parametrize("authority", AUTHORITY)
def test_control_is_not_kept_on_the_device(authority):
    v = _port(np.load(GOLDEN), authority)
    v.estimate_transition_prob(**KW)
    plan = v._table()["delta_S_rndm"]
    assert type(plan) is tanalysis._Permuted
    assert "delta_S_rndm" not in v.__dict__         # built on first read
    assert all(isinstance(a, np.ndarray) for a in (plan.perms,
                                                   plan.sign_bits))
    assert isinstance(plan.src, torch.Tensor) == (authority == "device_f32")
    assert isinstance(v.delta_S_rndm, np.ndarray)
    assert "delta_S_rndm" not in v._table()


@pytest.mark.parametrize("authority", AUTHORITY)
def test_view_reads_the_calls_delta_s(authority):
    """Edited in place and then reassigned, delta_S no longer reaches the
    call's control (reference fault R3 not inherited)."""
    v = _port(np.load(GOLDEN), authority)
    rows = _rows(v, authority)
    v.estimate_transition_prob(**KW)
    want, _ = _host_loop(rows)
    v.delta_S[:] = 0.0
    v.delta_S = np.ones_like(rows)
    np.testing.assert_array_equal(v.delta_S_rndm, want)
    # an assignment replaces the view
    v2 = _port(np.load(GOLDEN), authority)
    v2.estimate_transition_prob(**KW)
    v2.delta_S_rndm = np.zeros(3)
    v2._drop("delta_S_rndm")
    assert not hasattr(v2, "delta_S_rndm")


@pytest.mark.parametrize("authority", AUTHORITY)
def test_checkpoint_keeps_the_control(authority, tmp_path):
    v = _port(np.load(GOLDEN), authority)
    rows = _rows(v, authority)
    v.estimate_transition_prob(**KW)
    save_vlm(str(tmp_path / "ckpt"), v)
    back = load_vlm(str(tmp_path / "ckpt"), device="cpu")
    np.testing.assert_array_equal(back.delta_S_rndm, _host_loop(rows)[0])


def _fail_plan(monkeypatch):
    def failing(*args, **kw):
        raise RuntimeError("the control's plan failed")
    monkeypatch.setattr(tanalysis, "_permute_rows_nsign_plan", failing)


def _fail_knn(monkeypatch):
    """The kNN fails while the worker still draws its plan."""
    plan = tanalysis._permute_rows_nsign_plan

    def slow_plan(*args, **kw):
        time.sleep(0.5)
        return plan(*args, **kw)

    def failing(*args, **kw):
        raise RuntimeError("the embedding kNN failed")
    monkeypatch.setattr(tanalysis, "_permute_rows_nsign_plan", slow_plan)
    monkeypatch.setattr(tanalysis.kd, "knn_search_dev", failing)


@pytest.mark.parametrize("fault", [_fail_plan, _fail_knn],
                         ids=["control_plan", "embedding_knn"])
@pytest.mark.parametrize("authority", AUTHORITY)
def test_failed_call_leaves_no_thread_and_no_control(monkeypatch, authority,
                                                     fault):
    v = _port(np.load(GOLDEN), authority)
    threads = threading.active_count()
    fault(monkeypatch)
    with pytest.raises(RuntimeError, match="failed"):
        v.estimate_transition_prob(**KW)
    assert threading.active_count() == threads
    assert "delta_S_rndm" not in v._table()
    assert not hasattr(v, "delta_S_rndm")
