"""The port's persistence surface on the CPU: the hdf5 snapshot
(VelocytoLoom.to_hdf5 / load_velocyto_hdf5, serialization.py),
reload_raw and the DCP checkpoint (io/checkpoint.py), against the JAX
package.

Inputs: tests/golden/golden.npz through test_golden.py's calls (120 cells
x 80 genes), in the sampled (knn_random) and the full mode, or arrays made
from a seed.  The round trip and reload_raw are exact; a snapshot loaded
by the other package is followed by calculate_embedding_shift and
calculate_grid_arrows there and compared with the writer's own results at
test_torch_sampled.py's tolerances: embedding shifts and scalings rtol
1e-3 / atol 1e-5, the grid flow at test_torch_pipeline.py's rtol 1e-3 /
atol 1e-5."""
import io
import pickle
import zlib

import h5py
import numpy as np
import pytest
import torch
from scipy import sparse

import velocyto_tpu as vt
from velocyto_tpu.io import loom as jloom

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch.io.checkpoint import (load_state, load_vlm,
                                              save_state, save_vlm)

from test_torch_pipeline import CPU, GOLDEN, _fresh, _front


def _session(v, golden, knn_random):
    """test_golden.py's front stages, the velocity chain and the
    transition stage (randomized control on) in the given mode."""
    _front(v, balanced=False)
    v.fit_gammas()
    v.gammas = golden["gammas"].copy()
    v.q = golden["q"].copy()
    v.predict_U()
    v.calculate_velocity()
    v.calculate_shift(assumption="constant_velocity")
    v.extrapolate_cell_at_t(delta_t=1.)
    v.ts = golden["ts"].copy()
    v.estimate_transition_prob(hidim="Sx_sz", embed="ts", transform="sqrt",
                               knn_random=knn_random, n_neighbors=30,
                               sampled_fraction=0.5,
                               calculate_randomized=True)
    return v


def _downstream(v):
    """The stages after the transition stage; returns their outputs."""
    v.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=True)
    v.calculate_grid_arrows(smooth=0.5, steps=(10, 10), n_neighbors=20)
    return {name: np.array(getattr(v, name)) for name in (
        "delta_embedding", "delta_embedding_random", "scaling",
        "scaling_rndm", "flow", "flow_rndm")}


DOWNSTREAM_TOL = {"delta_embedding": (1e-3, 1e-5),
                  "delta_embedding_random": (1e-3, 1e-5),
                  "scaling": (1e-3, 1e-5), "scaling_rndm": (1e-3, 1e-5),
                  "flow": (1e-3, 1e-5), "flow_rndm": (1e-3, 1e-5)}


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module", params=[True, False],
                ids=["sampled", "full"])
def snapshots(request, golden, tmp_path_factory):
    """Both packages' sessions in one mode, each snapshotted by its own
    to_hdf5 after the transition stage."""
    knn_random = request.param
    d = tmp_path_factory.mktemp("snap")
    port = _session(_fresh(vtt, golden, device=CPU), golden, knn_random)
    jax_v = _session(_fresh(vt, golden), golden, knn_random)
    port.to_hdf5(str(d / "port.hdf5"))
    jax_v.to_hdf5(str(d / "jax.hdf5"))
    return {"port": port, "jax": jax_v, "dir": d, "knn_random": knn_random}


def _same(a, b):
    """Exact equality of two snapshot values, numpy dtypes included."""
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and \
            np.array_equal(a, b)
    if sparse.issparse(a):
        return sparse.issparse(b) and a.shape == b.shape and \
            (a != b).nnz == 0
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and \
            all(_same(a[k], b[k]) for k in a)
    if hasattr(a, "__dict__") and not isinstance(a, type):
        return type(a) is type(b) and _same(vars(a), vars(b))
    return type(a) is type(b) and a == b


class _NoTorchUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "torch":
            raise AssertionError(f"torch object in the snapshot: "
                                 f"{module}.{name}")
        return super().find_class(module, name)


def test_snapshot_round_trip_is_exact(snapshots):
    port = snapshots["port"]
    path = str(snapshots["dir"] / "port.hdf5")
    with h5py.File(path, "r") as f:
        for key in f:
            if key.startswith("&"):
                _NoTorchUnpickler(io.BytesIO(zlib.decompress(
                    f[key][:].tobytes()))).load()
        dumped = {k.lstrip("&") for k in f}
    loaded = vtt.load_velocyto_hdf5(path, device="cpu")
    runtime = set(vtt.VelocytoLoom._RUNTIME)
    assert dumped == (set(port.__dict__) | set(port._table())) - runtime
    assert set(loaded.__dict__) == dumped | {"device"}
    assert loaded.device == CPU
    bad = [k for k in dumped if not _same(getattr(port, k),
                                          getattr(loaded, k))]
    assert not bad, bad
    # the dense views the snapshot carries, as the JAX package dumps them
    for name in ("corrcoef", "corrcoef_random", "knn", "knn_smoothing_w",
                 "embedding_knn", "Sx_sz", "delta_S"):
        assert name in dumped, name
    if snapshots["knn_random"]:
        assert {"_compact_ixs", "_compact_corr", "sampling_ixs"} <= dumped


@pytest.mark.parametrize("knn_random", [True, False],
                         ids=["sampled", "full"])
def test_snapshot_holds_the_jax_packages_attribute_set(golden, tmp_path,
                                                       knn_random):
    """After the transition and the shift, each package's snapshot holds
    the same attributes; the full mode's no _compact_ixs, since its
    neighbour ids are kept on the device and embedding_knn is built from
    them."""
    dumped = {}
    for tag, v in (("port", _fresh(vtt, golden, device=CPU)),
                   ("jax", _fresh(vt, golden))):
        _downstream(_session(v, golden, knn_random))
        v.to_hdf5(str(tmp_path / f"{tag}.hdf5"))
        with h5py.File(str(tmp_path / f"{tag}.hdf5"), "r") as f:
            dumped[tag] = {k.lstrip("&") for k in f}
    assert dumped["port"] == dumped["jax"]
    assert ("_compact_ixs" in dumped["port"]) == knn_random
    assert {"embedding_knn", "transition_prob",
            "transition_prob_random"} <= dumped["port"]


def test_to_hdf5_keeps_the_object_running(snapshots, tmp_path):
    """The runtime state comes back after the dump, and a stage run after
    it gives what a stage on a loaded snapshot gives."""
    port = snapshots["port"]
    assert port.device == CPU and port._table()
    loaded = vtt.load_velocyto_hdf5(str(snapshots["dir"] / "port.hdf5"),
                                    device="cpu")
    a, b = _downstream(port), _downstream(loaded)
    for name, (rtol, atol) in DOWNSTREAM_TOL.items():
        np.testing.assert_allclose(b[name], a[name], rtol=rtol, atol=atol)


def test_to_hdf5_refuses_a_torch_attribute(golden, tmp_path):
    v = _fresh(vtt, golden, device=CPU)
    v.stray = {"t": torch.zeros(3)}
    path = tmp_path / "x.hdf5"
    with pytest.raises(TypeError, match="stray"):
        v.to_hdf5(str(path))
    assert not path.exists() and v.device == CPU


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_loads_in_the_other_package(snapshots, writer):
    """A snapshot written by one package, loaded by the other, gives the
    writer's own embedding shift and grid field."""
    if writer == "port":
        reader = vt.load_velocyto_hdf5(str(snapshots["dir"] / "port.hdf5"))
    else:
        reader = vtt.load_velocyto_hdf5(str(snapshots["dir"] / "jax.hdf5"),
                                        device="cpu")
    got = _downstream(reader)
    want = _downstream(snapshots[writer])
    for name, (rtol, atol) in DOWNSTREAM_TOL.items():
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def test_jax_snapshot_pca_loads_as_the_port_class(snapshots):
    """The JAX package's pickled PCA comes back as the port's class."""
    v = vtt.load_velocyto_hdf5(str(snapshots["dir"] / "jax.hdf5"),
                               device="cpu")
    assert type(v.pca) is vtt.PCA
    np.testing.assert_array_equal(v.pca.explained_variance_ratio_,
                                  snapshots["jax"].pca.explained_variance_ratio_)


# --- reload_raw --------------------------------------------------------

@pytest.fixture(scope="module")
def loom_file(tmp_path_factory):
    """A loom written by the JAX package's writer."""
    rng = np.random.RandomState(5)
    g, n = 40, 30
    layers = {name: rng.poisson(lam, (g, n)).astype(np.float32)
              for name, lam in (("spliced", 2.0), ("unspliced", 1.0),
                                ("ambiguous", 0.2))}
    layers[""] = layers["spliced"]
    path = str(tmp_path_factory.mktemp("loom") / "raw.loom")
    jloom.create(path, layers,
                 {"Gene": np.array([f"g{i}" for i in range(g)])},
                 {"CellID": np.array([f"c{i}" for i in range(n)]),
                  "_Valid": np.ones(n, dtype=np.int64)})
    return path


@pytest.mark.parametrize("substitute", [False, True])
def test_reload_raw_matches_jax(loom_file, substitute):
    vs = {"port": vtt.VelocytoLoom(loom_file, device="cpu"),
          "jax": vt.VelocytoLoom(loom_file)}
    for v in vs.values():
        v.filter_cells(np.arange(30) % 3 > 0)
        v.S = v.S * 2
        v.reload_raw(substitute=substitute)
    prefix = "" if substitute else "raw_"
    names = [prefix + n for n in ("S", "U", "A", "initial_cell_size",
                                  "initial_Ucell_size", "ca", "ra")]
    for name in names:
        assert _same(getattr(vs["port"], name), getattr(vs["jax"], name)), \
            name
    if not substitute:                   # the working matrices stay edited
        assert vs["port"].S.shape == (40, 20)
        np.testing.assert_array_equal(vs["port"].S, vs["jax"].S)


# --- the DCP checkpoint (tests/test_checkpoint.py's cases) --------------

def test_save_load_state(tmp_path):
    state = {"S": np.arange(12.0).reshape(3, 4),
             "mask": np.array([True, False, True]),
             "ids": np.arange(5, dtype=np.int32),
             "u16": np.arange(4, dtype=np.uint16),   # no tensor dtype
             "names": np.array(["a", "bb"]),
             "gammas": torch.ones(5),
             "idx": torch.arange(6).reshape(2, 3),
             "empty": np.zeros((0, 3)),
             "labels": ["a", "b"],
             "k": 7}
    path = str(tmp_path / "ckpt")
    save_state(path, state)
    got = load_state(path, device="cpu")
    assert got.keys() == state.keys()
    for key, want in state.items():
        if isinstance(want, torch.Tensor):
            assert isinstance(got[key], torch.Tensor)
            assert got[key].dtype == want.dtype and \
                got[key].device == CPU and torch.equal(got[key], want), key
        else:
            assert _same(want, got[key]), key


def test_save_state_refuses_to_overwrite_unless_forced(tmp_path):
    path = str(tmp_path / "ckpt")
    save_state(path, {"a": np.zeros(2)})
    with pytest.raises(FileExistsError):
        save_state(path, {"a": np.ones(2)}, force=False)
    save_state(path, {"a": np.ones(2)})
    np.testing.assert_array_equal(load_state(path, device="cpu")["a"],
                                  np.ones(2))


def test_save_load_vlm(tmp_path):
    vlm = vtt.VelocytoLoom.__new__(vtt.VelocytoLoom)
    vlm.device = CPU
    vlm.S = np.random.rand(5, 9)
    vlm.gammas = np.random.rand(5)
    vlm._set_dev("Sx", torch.rand(5, 9))
    path = str(tmp_path / "vckpt")
    save_vlm(path, vlm)
    v2 = load_vlm(path, device="cpu")
    np.testing.assert_array_equal(v2.S, vlm.S)
    np.testing.assert_array_equal(v2.gammas, vlm.gammas)
    assert torch.equal(v2._get_dev("Sx"), vlm._get_dev("Sx"))
    np.testing.assert_array_equal(v2.Sx, vlm.Sx)
