"""The randomized control's plan drawn in C++ (native/permute.cpp,
native.permute_rows_nsign_plan behind analysis._permute_rows_nsign_plan),
on the CPU.

Every comparison is exact: the permutations and their dtype, the packed
sign bits and numpy's whole end state (key, position, has_gauss, the
cached gaussian) against numpy's loop (_permute_rows_nsign_plan_plain)
and against the JAX package's velocyto_tpu.analysis.
_permute_rows_nsign_plan, from fresh, resumed and part-drawn states, on a
RandomState and on the np.random module; and, through a whole
estimate_transition_prob call in each mode, one plan a call and as many
MT19937 words as numpy's loop draws."""
import numpy as np
import pytest

from velocyto_tpu import analysis as janalysis

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch import analysis as tanalysis
from velocyto_tpu_torch import native

from test_torch_pipeline import GOLDEN
from test_torch_sampled import _state

SEED = 15071990


def _fresh(rs):
    """A seeded stream, at the end of its block (position 624)."""


def _odd_draws(rs):
    """Part way through a block, after an odd number of words."""
    rs.randint(0, 2 ** 32, size=333, dtype=np.uint32)


def _gauss(rs):
    """A cached gaussian (has_gauss 1), which the plan must carry."""
    rs.standard_normal()


def _block_start(rs):
    """Position 0: a block generated and none of its words drawn."""
    rs.randint(0, 2 ** 32, size=624, dtype=np.uint32)
    state = rs.get_state()
    rs.set_state(state[:2] + (0,) + state[3:])


# (g, n, how the stream is positioned, whether it is the np.random module)
CASES = {
    "n1": (5, 1, _fresh, False),
    "n2": (5, 2, _fresh, False),
    "n7": (5, 7, _odd_draws, False),
    "n8": (5, 8, _fresh, False),
    "n9": (5, 9, _odd_draws, False),
    "n20000": (3, 20000, _fresh, False),
    "n65536_uint16": (2, 65536, _odd_draws, False),
    "n65537_int32": (2, 65537, _fresh, False),
    "n65877": (2, 65877, _odd_draws, False),
    "fresh_seed": (6, 1001, _fresh, False),
    "odd_draws": (6, 1001, _odd_draws, False),
    "position_0": (6, 1001, _block_start, False),
    "has_gauss": (6, 1001, _gauss, False),
    "global_module": (6, 1001, _odd_draws, True),
    "global_module_gauss": (4, 77, _gauss, True),
}
PLAIN = {"plain": tanalysis._permute_rows_nsign_plan_plain,
         "jax": janalysis._permute_rows_nsign_plan}


def _start(seed, position):
    rs = np.random.RandomState(seed)
    position(rs)
    return rs.get_state()


def _draw(plan, g, n, state, on_module):
    """plan(g, n, rng) from state: (perms, sign bits, the end state)."""
    if on_module:
        np.random.set_state(state)
        perms, bits = plan(g, n)
        return perms, bits, np.random.get_state()
    rs = np.random.RandomState()
    rs.set_state(state)
    perms, bits = plan(g, n, rng=rs)
    return perms, bits, rs.get_state()


@pytest.mark.parametrize("reference", list(PLAIN))
@pytest.mark.parametrize("case", list(CASES))
def test_native_plan_is_numpy_loops(case, reference):
    g, n, position, on_module = CASES[case]
    state = _start(SEED + n, position)
    if position is _fresh:
        assert state[2] == 624
    if position is _gauss:
        assert state[3] == 1
    if position is _block_start:
        assert state[2] == 0
    saved = np.random.get_state()
    try:
        plans = native.permute_plans["plans"]
        got = _draw(tanalysis._permute_rows_nsign_plan, g, n, state,
                    on_module)
        assert native.permute_plans["plans"] == plans + 1
        want = _draw(PLAIN[reference], g, n, state, on_module)
    finally:
        np.random.set_state(saved)
    perms, bits, end = got
    w_perms, w_bits, w_end = want
    assert perms.dtype == w_perms.dtype == (np.uint16 if n <= 65536
                                            else np.int32)
    assert perms.shape == (g, n) and bits.shape == (g, (n + 7) // 8)
    np.testing.assert_array_equal(perms, w_perms)
    np.testing.assert_array_equal(bits, w_bits)
    assert end[0] == w_end[0] == "MT19937"
    assert end[1].dtype == w_end[1].dtype
    np.testing.assert_array_equal(end[1], w_end[1])
    assert end[2:] == w_end[2:]


def _words_from(state, words):
    """numpy's state after `words` 32-bit words drawn from state."""
    rs = np.random.RandomState()
    rs.set_state(state)
    rs.randint(0, 2 ** 32, size=words, dtype=np.uint32)
    return rs.get_state()


@pytest.mark.parametrize("knn_random", [True, False],
                         ids=["sampled", "full"])
def test_one_plan_a_call_drawing_numpys_words(knn_random):
    """One randomized call adds one plan; the words it drew take numpy's
    stream from the call's seed to where permute_rows_nsign leaves it,
    and the control equals the host loop's bitwise."""
    v = _state(vtt, np.load(GOLDEN))
    before = dict(native.permute_plans)
    v.estimate_transition_prob(hidim="Sx_sz", embed="ts",
                               knn_random=knn_random, n_neighbors=20,
                               sampled_fraction=0.5,
                               calculate_randomized=True, random_seed=SEED)
    assert native.permute_plans["plans"] == before["plans"] + 1
    words = native.permute_plans["words"] - before["words"]
    rows = v._get_dev("delta_S").numpy()
    g, n = rows.shape
    assert words >= g * (2 * n - 1)     # a word a column, one a swap
    np.random.seed(SEED)
    start = np.random.get_state()
    want = rows.copy()
    tanalysis.permute_rows_nsign(want)
    end = np.random.get_state()
    drawn = _words_from(start, words)
    np.testing.assert_array_equal(drawn[1], end[1])
    assert drawn[2] == end[2]
    got = v._get_dev("delta_S_rndm", None).numpy() if knn_random \
        else v.delta_S_rndm
    np.testing.assert_array_equal(got.astype(want.dtype).view(np.uint8),
                                  want.view(np.uint8))


@pytest.mark.parametrize("state,match", [
    (("MT19937", np.zeros(624, np.uint32), 625, 0, 0.0), "position"),
    (("PCG64", np.zeros(624, np.uint32), 0, 0, 0.0), "MT19937"),
    (("MT19937", np.zeros(623, np.uint32), 0, 0, 0.0), "MT19937"),
])
def test_native_plan_refuses_a_bad_state(state, match):
    plans = native.permute_plans["plans"]
    with pytest.raises(ValueError, match=match):
        native.permute_rows_nsign_plan(3, 10, state)
    assert native.permute_plans["plans"] == plans
