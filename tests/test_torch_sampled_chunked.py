"""The parts of the sampled transition path that run it the way the JAX
package does, on the CPU: the resumable neighbour-sampling replay in row
chunks, the chunked sampled colDeltaCor, the randomized control's plan
and its device apply, and a failed call leaving nothing behind
(reference fault R2 not inherited).

Inputs are made with numpy from a seed, or are tests/golden/golden.npz's
stage outputs.  Every comparison is exact: the replay's rows, numpy's
state and the callbacks' chunk bounds against the JAX package's
velocyto_tpu.native.choice_noreplace_rows_chunked, and with the doubles
drawn and the rounds native.sampler_replays counts against numpy's own
loop and mtrand's loop written out (_mtrand_rows), the C entry resumed
from numpy states anywhere in a block against RandomState; the plan against
velocyto_tpu.analysis._permute_rows_nsign_plan; the apply (floats moved
and their sign flipped, never rounded) against the JAX package's
_permute_apply_dev and against permute_rows_nsign; the chunks of the
sampled colDeltaCor against one unchunked call (the rows are
independent and the center order changes no output)."""
import ctypes

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

@pytest.mark.parametrize("n_chunks", [1, 3, 4, 7, "n_rows+1"])
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


def _mtrand_rows(seed, n, pop, size, p):
    """numpy/random/mtrand.pyx's rejection loop for choice(pop, size,
    replace=False, p=p), written out, once per row after
    np.random.seed(seed): (rows, rounds of the loop, doubles drawn,
    numpy's state after)."""
    np.random.seed(seed)
    rows, rounds, doubles = [], 0, 0
    for _ in range(n):
        q = p.copy()
        found = np.zeros(size, np.int64)
        n_uniq = 0
        while n_uniq < size:
            x = np.random.rand(size - n_uniq)
            rounds += 1
            doubles += x.size
            q[found[:n_uniq]] = 0
            cdf = np.cumsum(q)
            cdf /= cdf[-1]
            new = cdf.searchsorted(x, side="right")
            _, first = np.unique(new, return_index=True)
            new = new.take(np.sort(first))
            found[n_uniq:n_uniq + new.size] = new
            n_uniq += new.size
        rows.append(found)
    return np.stack(rows), rounds, doubles, np.random.get_state()


def _ramp_with_zeros(pop, zeros):
    p = np.linspace(0.5, 0.1, pop)
    p[zeros] = 0.0
    return p / p.sum()


def _exactly_positive(pop, size):
    p = np.zeros(pop)
    p[np.random.RandomState(pop).choice(pop, size, replace=False)] = \
        np.linspace(1.0, 3.0, size)
    return p / p.sum()


# (pop, size, p): the loop's corners
REPLAY_CASES = {
    "size_095_pop": (40, 38, _weights(40)),       # many rounds a row
    "size_pop_minus_1": (40, 39, _weights(40)),
    "zeros_at_start": (50, 20, _ramp_with_zeros(50, slice(0, 15))),
    "zeros_in_middle": (50, 20, _ramp_with_zeros(50, slice(20, 35))),
    "zeros_at_end": (50, 20, _ramp_with_zeros(50, slice(35, 50))),
    "exactly_size_positive": (50, 20, _exactly_positive(50, 20)),
    "pop_1": (1, 1, _weights(1)),
    "pop_2": (2, 2, _weights(2)),
    "pop_3": (3, 2, _weights(3)),
    "cells_shape": (3501, 1750, _weights(3501)),  # the cells' pop and size
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_replay_cases_match_numpy_and_jax(case):
    """The rows, the doubles drawn, the rounds counted and numpy's end
    state against numpy's loop, the loop written out and the JAX
    package's replay."""
    pop, size, p = REPLAY_CASES[case]
    n = 20 if pop > 1000 else 57
    before = dict(native.sampler_replays)
    rows, draws, state = native.choice_noreplace_rows_chunked(
        SEED, n, pop, size, p, n_chunks=3)
    counted = {k: native.sampler_replays[k] - before[k] for k in before}
    want, want_state = native.choice_rows_plain(SEED, n, pop, size, p)
    loop, rounds, doubles, loop_state = _mtrand_rows(SEED, n, pop, size, p)
    j_rows, j_draws, j_state = jnative.choice_noreplace_rows_chunked(
        SEED, n, pop, size, p, n_chunks=3)
    np.testing.assert_array_equal(loop, want)
    for other, other_state in ((want, want_state), (j_rows, j_state),
                               (loop, loop_state)):
        np.testing.assert_array_equal(rows, other)
        np.testing.assert_array_equal(state[1], other_state[1])
        assert state[2] == other_state[2]
    assert draws == j_draws == doubles
    assert counted == {"calls": 1, "rows": n, "rounds": rounds,
                       "doubles": doubles}
    np.random.seed(SEED)                   # numpy's stream, draws doubles on
    np.random.random_sample(draws)
    np.testing.assert_array_equal(np.random.get_state()[1], state[1])
    assert np.random.get_state()[2] == state[2]


def _resume(state, n, pop, size, p):
    """sampler.cpp's entry from a numpy state: (rows, the advanced state
    (625,), doubles drawn, rounds)."""
    lib = native._load_sampler()
    st = np.empty(625, np.uint32)
    st[:624] = state[1]
    st[624] = state[2]
    out = np.empty((n, size), np.int64)
    rounds = ctypes.c_int64(0)
    draws = lib.vtt_choice_noreplace_resume(
        st.ctypes.data, n, pop, size, p.ctypes.data, out.ctypes.data,
        ctypes.byref(rounds))
    return out, st, draws, rounds.value


@pytest.mark.parametrize("pos", [0, 1, 623, 624])
def test_replay_resumes_anywhere_in_a_block(pos):
    """From numpy states at positions 0 (the block's first word, not yet
    drawn), 623 (a double across two blocks) and 624 (the block used
    up), two chunks give numpy's rows and, after each, numpy's state."""
    pop, size = 61, 30
    p = _weights(pop)
    np.random.seed(pos)
    np.random.randint(0, 2, size=pos or 624)
    state = ("MT19937", np.random.get_state()[1], pos, 0, 0.0)
    rs = np.random.RandomState()
    rs.set_state(state)
    first, st, _, _ = _resume(state, 5, pop, size, p)
    want = np.stack([rs.choice(pop, size, replace=False, p=p)
                     for _ in range(5)])
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(st[:624], rs.get_state()[1])
    assert st[624] == rs.get_state()[2]
    second, st, _, _ = _resume(("MT19937", st[:624], int(st[624])), 6, pop,
                               size, p)
    want = np.stack([rs.choice(pop, size, replace=False, p=p)
                     for _ in range(6)])
    np.testing.assert_array_equal(second, want)
    np.testing.assert_array_equal(st[:624], rs.get_state()[1])
    assert st[624] == rs.get_state()[2]


def test_replay_draws_the_double_across_two_blocks():
    """From position 623 the first double takes word 623 of one block and
    word 0 of the next.  Weights whose cdf is [x, next(x), 1] for numpy's
    x there make the row 1 for that double and 0 or 2 for any other."""
    for seed in range(100):
        np.random.seed(seed)
        np.random.randint(0, 2, size=623)
        state = np.random.get_state()
        x = np.random.random_sample()
        if x >= 0.5:              # 1 - x and its sums below are exact
            break
    ulp = np.spacing(x)
    p = np.array([x, ulp, 1.0 - x - ulp])
    assert np.array_equal(np.cumsum(p), [x, np.nextafter(x, 2.0), 1.0])
    rs = np.random.RandomState()
    rs.set_state(state)
    want = np.stack([rs.choice(3, 1, replace=False, p=p) for _ in range(3)])
    assert want[0, 0] == 1
    got, st, _, _ = _resume(state, 3, 3, 1, p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(st[:624], rs.get_state()[1])
    assert st[624] == rs.get_state()[2]


def test_chunk_boundary_at_a_used_up_block():
    """At SEED, pop 61 and size 30 the first 284 rows draw a multiple of
    312 doubles: the chunk boundary of 568 rows in two chunks leaves
    numpy's position at 624, and the second chunk resumes from it."""
    pop, size, k = 61, 30, 284
    p = _weights(pop)
    _, _, state = native.choice_noreplace_rows_chunked(SEED, k, pop, size, p,
                                                       n_chunks=1)
    assert state[2] == 624
    rows, _, state = native.choice_noreplace_rows_chunked(
        SEED, 2 * k, pop, size, p, n_chunks=2)
    want, want_state = native.choice_rows_plain(SEED, 2 * k, pop, size, p)
    np.testing.assert_array_equal(rows, want)
    np.testing.assert_array_equal(state[1], want_state[1])
    assert state[2] == want_state[2]


@pytest.mark.parametrize("bad", ["negative", "nan", "inf", "sum_overflows"])
def test_replay_refuses_weights_numpy_would_not_sample(bad):
    p = np.full(8, 0.125)
    if bad == "negative":
        p[3] = -0.125
    elif bad == "nan":
        p[3] = np.nan
    elif bad == "inf":
        p[3] = np.inf
    else:
        p[:] = 1e308
    calls = []
    with pytest.raises(ValueError, match="finite"):
        native.choice_noreplace_rows_chunked(
            SEED, 8, 8, 3, p, on_chunk=lambda *a: calls.append(a))
    assert calls == []


def test_sampled_call_counts_one_replay():
    """One sampled transition is one replay: one call and a row a cell,
    with the rounds and doubles of numpy's loop on its neighbour
    weights."""
    golden = np.load(GOLDEN)
    v = _state(vtt, golden)
    before = dict(native.sampler_replays)
    v.estimate_transition_prob(hidim="Sx_sz", embed="ts", knn_random=True,
                               n_neighbors=30, sampled_fraction=0.5,
                               calculate_randomized=False)
    counted = {k: native.sampler_replays[k] - before[k] for k in before}
    n = golden["S"].shape[1]
    nn_k = min(30 + 1, n - 1)
    rows, rounds, doubles, _ = _mtrand_rows(SEED, n, nn_k, nn_k // 2,
                                            _weights(nn_k))
    np.testing.assert_array_equal(v.sampling_ixs, rows)
    assert counted == {"calls": 1, "rows": n, "rounds": rounds,
                       "doubles": doubles}
    assert n < rounds < doubles


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
