"""The parts of the sampled transition path that run it the way the JAX
package does, on the CPU: the resumable neighbour-sampling replay in row
chunks, the chunked sampled colDeltaCor, the randomized control's plan
and its device apply, and a failed call leaving nothing behind
(reference fault R2 not inherited).

Inputs are made with numpy from a seed, or are tests/golden/golden.npz's
stage outputs.  Every comparison is exact: the replay's rows, numpy's
state and the callbacks' chunk bounds against the JAX package's
velocyto_tpu.native.choice_noreplace_rows_chunked; the plan against
velocyto_tpu.analysis._permute_rows_nsign_plan; the apply (floats moved
and their sign flipped, never rounded) against the JAX package's
_permute_apply_dev and against permute_rows_nsign; the chunks of the
sampled colDeltaCor against one unchunked call (the rows are
independent and the center order changes no output)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocyto_tpu import analysis as janalysis
from velocyto_tpu import native as jnative

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch import analysis as tanalysis
from velocyto_tpu_torch import kernels, native
from velocyto_tpu_torch.ops.coldeltacor import (_check_permutation,
                                                chunk_order,
                                                col_delta_cor_partial_compact,
                                                locality_order,
                                                make_partial_compact_chunked)

from test_torch_pipeline import GOLDEN
from test_torch_sampled import _partial_inputs, _state

SEED = 15071990


def _weights(nn_k):
    p = np.linspace(0.5, 0.1, nn_k)
    return p / p.sum()


# --- the resumable replay ---------------------------------------------

@pytest.mark.parametrize("n_chunks", [1, 3, 4, "n_rows+1"])
def test_chunked_replay_matches_jax_and_whole_replay(n_chunks):
    n, nn_k, n_samp = 301, 61, 30
    chunks = n + 1 if n_chunks == "n_rows+1" else n_chunks
    p = _weights(nn_k)
    got_calls, jax_calls = [], []
    rows, draws, state = native.choice_noreplace_rows_chunked(
        SEED, n, nn_k, n_samp, p, n_chunks=chunks,
        on_chunk=lambda lo, hi, r: got_calls.append((lo, hi, r.copy())))
    j_rows, j_draws, j_state = jnative.choice_noreplace_rows_chunked(
        SEED, n, nn_k, n_samp, p, n_chunks=chunks,
        on_chunk=lambda lo, hi, r: jax_calls.append((lo, hi)))
    w_rows, w_draws, w_state = native.choice_noreplace_rows_state(
        SEED, n, nn_k, n_samp, p)
    for other, other_draws, other_state in ((j_rows, j_draws, j_state),
                                            (w_rows, w_draws, w_state)):
        np.testing.assert_array_equal(rows, other)
        assert draws == other_draws
        assert state[0] == other_state[0] and state[2:] == other_state[2:]
        np.testing.assert_array_equal(state[1], other_state[1])
    assert [c[:2] for c in got_calls] == jax_calls
    assert len(got_calls) == min(chunks, n)
    for lo, hi, r in got_calls:            # each view holds its own rows
        np.testing.assert_array_equal(r, rows[lo:hi])
    np.random.seed(SEED)                   # numpy's own loop, its state
    want = np.stack([np.random.choice(nn_k, n_samp, replace=False, p=p)
                     for _ in range(n)])
    np.testing.assert_array_equal(rows, want)
    np.testing.assert_array_equal(state[1], np.random.get_state()[1])
    assert state[2] == np.random.get_state()[2]


def test_chunked_replay_refuses_before_any_chunk():
    calls = []
    p = np.array([0.5, 0.5, 0.0, 0.0])
    with pytest.raises(ValueError, match="non-zero"):
        native.choice_noreplace_rows_chunked(
            SEED, 8, 4, 3, p, on_chunk=lambda *a: calls.append(a))
    assert calls == []


# --- the chunked sampled colDeltaCor ------------------------------------

@pytest.mark.parametrize("n", [10, 97])
def test_chunk_order_is_the_global_order_within_the_chunk(n):
    order = torch.from_numpy(
        np.random.RandomState(n).permutation(n).astype(np.int32))
    bounds = np.linspace(0, n, 5).astype(np.int64)
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        got = chunk_order(order, lo, hi)
        want = order[(order >= lo) & (order < hi)] - lo
        assert got.dtype == torch.int32 and torch.equal(got, want)
        _check_permutation(got, hi - lo)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("transform,psc", [("sqrt", 1e-10), ("log10", 1.0),
                                           ("linear", 0.0)])
def test_chunked_run_equals_one_unchunked_call(transform, psc, dual):
    """Four chunks (in locality order within each), concatenated, equal
    col_delta_cor_partial_compact over all rows bitwise; the CPU tensors
    take the plain version, no kernel is built or launched."""
    g, n, nn = 37, 103, 13
    e, d, ixs = _partial_inputs(g, n, nn)
    d2 = np.random.RandomState(5).randn(n, g).astype(np.float32)
    E, D, D2 = (torch.from_numpy(np.ascontiguousarray(a.T))
                for a in (e, d, d2))
    ix = torch.from_numpy(ixs).to(torch.int32)
    order = locality_order(torch.from_numpy(
        np.random.RandomState(6).randn(n, 2)))
    want = col_delta_cor_partial_compact(E, D, ix, transform, psc,
                                         dmat_random=D2 if dual else None,
                                         order=order)
    prep_d, run = make_partial_compact_chunked(E, transform, psc)
    d_rows = prep_d(D)
    d2_rows = prep_d(D2) if dual else None
    outs = []
    bounds = np.linspace(0, n, tanalysis.SAMPLER_CHUNKS + 1).astype(np.int64)
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        outs.append(run(d_rows, lo, hi, ix[lo:hi], d2_rows,
                        order=chunk_order(order, lo, hi)))
    got = [torch.cat([o[i] for o in outs]) for i in range(2)] if dual \
        else [torch.cat(outs)]
    for a, b in zip(got, want if dual else [want]):
        # the duplicate cells' pairs are 0/0: NaN in both
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert kernels.partial_launches == 0 and kernels._lib is None
    with pytest.raises(ValueError, match="permutation"):
        run(d_rows, 0, 10, ix[:10], order=order[:10])


# --- the randomized control: plan and device apply -----------------------

@pytest.mark.parametrize("g,n", [(7, 13), (30, 64), (5, 1001)])
def test_permutation_plan_matches_jax(g, n):
    np.random.seed(11)
    np.random.rand(3)
    state = np.random.get_state()
    perms, bits = tanalysis._permute_rows_nsign_plan(g, n, rng=_at(state))
    j_perms, j_bits = janalysis._permute_rows_nsign_plan(g, n,
                                                         rng=_at(state))
    assert perms.dtype == j_perms.dtype == np.uint16
    np.testing.assert_array_equal(perms, j_perms)
    np.testing.assert_array_equal(bits, j_bits)
    # a RandomState at the snapshot draws; the global stream does not move
    after = np.random.get_state()
    assert after[2] == state[2]
    np.testing.assert_array_equal(after[1], state[1])


@pytest.mark.parametrize("g,n", [(7, 13), (30, 64), (5, 1001)])
def test_permutation_apply_matches_jax_and_host(g, n):
    """From one numpy state: the apply on CPU tensors, the JAX package's
    sort-based apply, and permute_rows_nsign on the same float32 rows
    give the same bits (zeros of both signs included)."""
    rng = np.random.RandomState(g + n)
    delta = rng.randn(g, n).astype(np.float32)
    delta[0, :3] = 0.0
    delta[1, :2] = -0.0
    np.random.seed(SEED)
    state = np.random.get_state()
    got = tanalysis._permute_rows_nsign_dev(torch.from_numpy(delta), state)
    perms, bits = tanalysis._permute_rows_nsign_plan(
        g, n, rng=_at(state))
    got2 = tanalysis._permute_apply_dev(torch.from_numpy(delta),
                                        torch.from_numpy(perms),
                                        torch.from_numpy(bits))
    want_jax = np.asarray(janalysis._permute_apply_dev(
        jnp.asarray(delta), jnp.asarray(janalysis._invert_rows(perms)),
        jnp.asarray(bits)))
    host = delta.astype(np.float64)
    np.random.set_state(state)
    tanalysis.permute_rows_nsign(host)
    for want in (want_jax, host.astype(np.float32)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
    np.testing.assert_array_equal(got2.numpy().view(np.uint32),
                                  got.numpy().view(np.uint32))


def _at(state):
    rs = np.random.RandomState()
    rs.set_state(state)
    return rs


# --- a failed call leaves nothing behind (R2) ----------------------------

def _fail_second_chunk(monkeypatch):
    real = native.choice_noreplace_rows_chunked

    def failing(*args, on_chunk=None, **kw):
        def on(lo, hi, rows):
            if lo > 0:
                raise RuntimeError("sampler failed on its second chunk")
            on_chunk(lo, hi, rows)
        return real(*args, on_chunk=on, **kw)
    monkeypatch.setattr(tanalysis.native, "choice_noreplace_rows_chunked",
                        failing)


def _fail_plan(monkeypatch):
    def failing(*args, **kw):
        raise RuntimeError("the control's plan failed")
    monkeypatch.setattr(tanalysis, "_permute_rows_nsign_plan", failing)


@pytest.mark.parametrize("fault", [_fail_second_chunk, _fail_plan],
                         ids=["sampler_second_chunk", "control_plan"])
def test_failed_sampled_call_keeps_the_earlier_state(monkeypatch, fault):
    """A sampled call that fails part way raises, and the loom keeps the
    sampled state of its earlier call (tensors and host arrays alike) and
    numpy's stream where it was before the failing call."""
    golden = np.load(GOLDEN)
    v = _state(vtt, golden)
    kw = dict(hidim="Sx_sz", embed="ts", knn_random=True, n_neighbors=20,
              sampled_fraction=0.5, calculate_randomized=True)
    v.estimate_transition_prob(**kw)
    names = ("_corr_dev", "_corr_rndm_dev", "_compact_ixs_dev")
    before = {name: v.__dict__[name] for name in names}
    ixs_before = v.sampling_ixs.copy()
    rndm_before = v._get_dev("delta_S_rndm", None)
    np.random.seed(3)
    np.random.rand(5)
    rng_before = np.random.get_state()
    fault(monkeypatch)
    with pytest.raises(RuntimeError, match="failed"):
        v.estimate_transition_prob(random_seed=7, **kw)
    for name in names:
        assert v.__dict__[name] is before[name], name
    np.testing.assert_array_equal(v.sampling_ixs, ixs_before)
    assert v._get_dev("delta_S_rndm", None) is rndm_before
    rng_after = np.random.get_state()
    assert rng_after[2] == rng_before[2]
    np.testing.assert_array_equal(rng_after[1], rng_before[1])
    # the worker threads are done: a later call runs and gives the same
    # result as a fresh object
    monkeypatch.undo()
    v.estimate_transition_prob(**kw)
    assert torch.equal(v._corr_dev, before["_corr_dev"])
