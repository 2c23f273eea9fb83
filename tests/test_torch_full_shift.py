"""The full mode's embedding shift (calculate_embedding_shift after
estimate_transition_prob(knn_random=False)) on the CPU, in plain torch.

The call gathers the two correlation fields at the embedding neighbours
and works on the compact (N, nn) form.  It is held to velocyto's dense
arithmetic written out here in float64 (the masked softmax over
embedding_knn, the unit-vector shift, the expression scaling) on the
loom's own correlations; with its neighbour ids on the device, with the
ids read from an embedding_knn csr, with a mesh of CPU shards and with
expression scaling; embedding_knn built on first read against the JAX
package's.  The call makes no (N, N) tensor, and the dense transition
probabilities exist only once read; a checkpoint carries them either
way."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import velocyto_tpu as vt

from velocyto_tpu_torch import analysis
from velocyto_tpu_torch.io.checkpoint import load_vlm, save_vlm
from velocyto_tpu_torch.parallel import make_mesh

CPU = torch.device("cpu")
CELLS, GENES, NN = 300, 50, 40
SIGMA = 0.05
TP_NAMES = ("transition_prob", "transition_prob_random")


def _session(seed=0):
    """A loom after a full-mode transition of NN neighbours a cell."""
    rng = np.random.RandomState(seed)
    rate = rng.gamma(2.0, 1.0, (GENES, 3)) @ rng.gamma(2.0, 1.0, (3, CELLS))
    v = analysis.VelocytoLoom.__new__(analysis.VelocytoLoom)
    v.device, v.mesh = CPU, None
    v.S = rng.poisson(rate).astype(np.float64)
    v.U = rng.poisson(0.4 * rate).astype(np.float64)
    v.A = np.zeros_like(v.S)
    v.ca = {"CellID": np.array([f"c{i}" for i in range(CELLS)])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(GENES)])}
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    v.normalize("both")
    v.perform_PCA(which="S_norm", n_components=10)
    v.knn_imputation(k=10, balanced=True, b_sight=30, b_maxl=15)
    v.fit_gammas()
    v.predict_U()
    v.calculate_velocity()
    v.calculate_shift(assumption="constant_velocity", delta_t=1)
    v.extrapolate_cell_at_t(delta_t=1)
    v.ts = np.ascontiguousarray(v.pcs[:, :2])
    v.estimate_transition_prob(hidim="Sx_sz", embed="ts", transform="sqrt",
                               psc=1e-10, knn_random=False,
                               n_neighbors=NN - 1, calculate_randomized=True,
                               random_seed=15071990)
    return v


@pytest.fixture(scope="module")
def session():
    return _session()


def _dense_reference(v, scaling):
    """velocyto's dense embedding shift in float64 from the loom's own
    correlations: {name: value} of the transition probabilities, the
    shifts and, with `scaling`, the scaling factors."""
    f64 = torch.float64
    K = torch.as_tensor(v.embedding_knn.toarray(), dtype=f64)
    emb = torch.as_tensor(np.asarray(v.embedding), dtype=f64)
    diff = emb[None, :, :] - emb[:, None, :]             # (N, N, D): j - i
    nrm = torch.sqrt((diff * diff).sum(-1, keepdim=True))
    unit = torch.where(nrm > 0, diff / torch.where(nrm > 0, nrm, 1.0), 0.0)
    mean_k = (K[..., None] * unit).sum(1) / K.sum(1, keepdim=True)
    hi = torch.as_tensor(np.asarray(getattr(v, v.which_hidim)), dtype=f64)
    out = {}
    for corr, tp_name, tag, d_name in (
            ("corrcoef", "transition_prob", "", "delta_S"),
            ("corrcoef_random", "transition_prob_random", "_random",
             "delta_S_rndm")):
        C = torch.as_tensor(np.asarray(getattr(v, corr)), dtype=f64)
        tp = torch.exp(C / SIGMA) * K
        tp = tp / tp.sum(1, keepdim=True)
        shift = (tp[..., None] * unit).sum(1) - mean_k
        if scaling:
            estim = hi @ tp.T - hi @ (K / K.sum(1, keepdim=True)).T
            dS = torch.as_tensor(np.asarray(getattr(v, d_name)), dtype=f64)
            cos = (dS * estim).sum(0) / torch.sqrt((estim ** 2).sum(0))
            s = torch.clamp(cos, 0, 1)
            out["scaling" + ("_rndm" if tag else "")] = s.numpy()
            shift = shift * s[:, None]
        out[tp_name] = tp.numpy()
        out["delta_embedding" + tag] = shift.numpy()
    return out


def _gap(got, want):
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _from_numpy(v):
    """A loom holding v's full-mode state as host arrays, so the shift
    reads its neighbour ids from the embedding_knn csr."""
    names = ("corrcoef", "corrcoef_random", "embedding_knn", "embedding",
             "corr_calc", "which_hidim", "Sx_sz", "delta_S", "delta_S_rndm")
    return analysis.state_from_numpy({n: getattr(v, n) for n in names}, "cpu")


def _jax_embedding_knn(v):
    """The JAX package's full-mode embedding_knn on v's inputs."""
    jax_v = vt.VelocytoLoom.__new__(vt.VelocytoLoom)
    for name in ("S", "Sx_sz", "delta_S", "ts", "used_delta_t"):
        setattr(jax_v, name, np.array(getattr(v, name)))
    jax_v.estimate_transition_prob(hidim="Sx_sz", embed="ts",
                                   transform="sqrt", psc=1e-10,
                                   knn_random=False, n_neighbors=NN - 1,
                                   calculate_randomized=False)
    return jax_v.embedding_knn


CASES = {
    "device_ids": dict(scaling=False, mesh=False, csr=False),
    "csr_ids": dict(scaling=False, mesh=False, csr=True),
    "mesh": dict(scaling=False, mesh=True, csr=False),
    "expression_scaling": dict(scaling=True, mesh=False, csr=False),
    "expression_scaling_mesh": dict(scaling=True, mesh=True, csr=True),
    "embedding_knn_read": dict(scaling=False, mesh=False, csr=False,
                               read=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_full_shift_matches_the_dense_reference(session, case):
    """Shifts and scalings to 1e-5 of their scale, transition
    probabilities to 1e-5 relative: the port's float32 softmax and
    contraction on the same float32 correlations as the reference.  The
    call keeps its neighbour ids on the device and builds embedding_knn
    from them on first read: the JAX package's csr, to the index dtype;
    the shift then reads its ids from that csr."""
    c = CASES[case]
    v = _from_numpy(session) if c["csr"] else _session()
    assert ("embedding_knn" in v._table()) != c["csr"]
    if c.get("read"):
        assert "embedding_knn" not in v.__dict__
        got, want = v.embedding_knn, _jax_embedding_knn(v)
        assert v.__dict__["embedding_knn"] is got
        assert "embedding_knn" not in v._table()
        assert got.shape == want.shape
        for part in ("indptr", "indices", "data"):
            a, b = getattr(got, part), getattr(want, part)
            assert a.dtype == b.dtype, part
            np.testing.assert_array_equal(a, b, err_msg=part)
    if c["mesh"]:
        v.mesh = make_mesh(devices=[CPU] * 2)
    want = _dense_reference(v, c["scaling"])
    v.calculate_embedding_shift(sigma_corr=SIGMA,
                                expression_scaling=c["scaling"])
    for name in ("delta_embedding", "delta_embedding_random") + \
            (("scaling", "scaling_rndm") if c["scaling"] else ()):
        assert _gap(getattr(v, name), want[name]) < 1e-5, name
    for name in TP_NAMES:
        tp = getattr(v, name)
        assert tp.dtype == np.float32
        np.testing.assert_allclose(tp, want[name], rtol=1e-5, atol=1e-9)
    if c["mesh"]:
        v.mesh = None
        de = v.delta_embedding.copy(), v.delta_embedding_random.copy()
        v.calculate_embedding_shift(sigma_corr=SIGMA,
                                    expression_scaling=c["scaling"])
        np.testing.assert_array_equal(v.delta_embedding, de[0])
        np.testing.assert_array_equal(v.delta_embedding_random, de[1])


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an aten op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def _square(shape):
    return sum(n == CELLS for n in shape) >= 2


def test_full_shift_makes_no_dense_matrix_and_builds_views_on_read():
    """No op of the call returns a tensor with two cells axes; afterwards
    the loom holds no dense K or transition probability, each of which a
    read builds: _get_dev a float32 device tensor, not kept; the
    attribute a float32 host array, kept; prepare_markov's float64
    tensor the same numbers."""
    v = _session()
    with _Shapes() as rec:
        v.calculate_embedding_shift(sigma_corr=SIGMA,
                                    expression_scaling=False)
    assert rec.shapes and not [s for s in rec.shapes if _square(s)]
    d, table = v.__dict__, v._table()
    dense = [n for n, e in table.items()
             if isinstance(e, analysis._Device) and _square(e.t.shape)]
    assert sorted(dense) == ["corrcoef", "corrcoef_random"]
    for name in TP_NAMES + ("K",):
        assert name not in d
        assert not isinstance(table.get(name), analysis._Device)
    for name in TP_NAMES:
        rows = table[name]
        assert type(rows) is analysis._ProbRows
        assert tuple(rows.ixs.shape) == tuple(rows.rows.shape) == (CELLS, NN)

    dev = {n: v._get_dev(n) for n in TP_NAMES}
    assert all(t.dtype == torch.float32 and t.shape == (CELLS, CELLS)
               for t in dev.values())
    assert not any(n in d or not isinstance(table[n], analysis._ProbRows)
                   for n in TP_NAMES)
    assert torch.equal(v._stage_input("transition_prob", torch.float64),
                       dev["transition_prob"].double())
    for name in TP_NAMES:
        host = getattr(v, name)
        assert d[name] is host and host.dtype == np.float32
        assert name not in table
        np.testing.assert_array_equal(host, dev[name].numpy())
    # an edit of the host view reaches the next device read
    v.transition_prob[:, :5] = 0.0
    assert float(v._get_dev("transition_prob")[:, :5].abs().sum()) == 0.0


@pytest.mark.parametrize("host_view", ["unread", "read"])
def test_full_shift_survives_a_checkpoint(tmp_path, host_view):
    """save_vlm keeps both transition probabilities, whether still rows
    or handed out as host arrays; the restored loom gives the same
    values and prepare_markov the same Markov matrix."""
    v = _session()
    v.calculate_embedding_shift(sigma_corr=SIGMA, expression_scaling=False)
    want = {n: v._get_dev(n).numpy() for n in TP_NAMES}
    if host_view == "read":
        for name in TP_NAMES:
            getattr(v, name)
    save_vlm(str(tmp_path / "ckpt"), v)
    back = load_vlm(str(tmp_path / "ckpt"), device="cpu")
    for name in TP_NAMES:
        np.testing.assert_array_equal(getattr(back, name), want[name])
    v.prepare_markov(sigma_D=1.0, sigma_W=0.5)
    back.prepare_markov(sigma_D=1.0, sigma_W=0.5)
    np.testing.assert_array_equal(back.tr.toarray(), v.tr.toarray())


def test_shift_refuses_an_uneven_embedding_knn(session):
    """Ids read from a csr need the same number of unit entries a row."""
    v = _from_numpy(session)
    knn = v.embedding_knn.tolil()
    knn[0, knn.rows[0][0]] = 0.0
    v.embedding_knn = knn.tocsr()
    v.embedding_knn.eliminate_zeros()
    with pytest.raises(ValueError, match="embedding_knn"):
        v.calculate_embedding_shift(sigma_corr=SIGMA,
                                    expression_scaling=False)
