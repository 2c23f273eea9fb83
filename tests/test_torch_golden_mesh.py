"""Mesh-mode golden parity through the port's public API: the four tests of
tests/test_golden_mesh.py on velocyto_tpu_torch, with a mesh of 8 CPU
shards (VelocytoLoom(..., mesh=make_mesh(devices=[cpu] * 8))).  Asserts
(a) reference-golden parity at the JAX test's tolerances and (b)
agreement with the port's mesh-free path, so a user on a sliced mesh gets
the single-device results.
"""
import os

import numpy as np
import pytest
import torch

import velocyto_tpu_torch as vtt
from velocyto_tpu_torch.ops import coldeltacor as tcdc
from velocyto_tpu_torch.parallel import make_mesh

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def golden():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden.npz not generated (tests/golden/generate.py)")
    return np.load(GOLDEN)


def _mesh():
    return make_mesh(devices=[CPU] * 8)


def _fresh_vlm(golden, mesh):
    v = vtt.VelocytoLoom.__new__(vtt.VelocytoLoom)
    v.mesh = mesh
    v.device = CPU
    v.S = golden["S"].copy()
    v.U = golden["U"].copy()
    v.A = np.zeros_like(v.S)
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    n, g = v.S.shape[1], v.S.shape[0]
    v.ca = {"CellID": np.array([f"c{i}" for i in range(n)])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(g)])}
    return v


def _run_pipeline(v, golden, knn_random, balanced=True):
    v._normalize_S(relative_size=v.initial_cell_size,
                   target_size=np.mean(v.initial_cell_size))
    v._normalize_U(relative_size=v.initial_Ucell_size,
                   target_size=np.mean(v.initial_Ucell_size))
    v.S_norm = np.log2(v.S_sz + 1)
    v.perform_PCA(which="S_norm", n_components=20)
    if balanced:
        v.knn_imputation(k=10, balanced=True, b_sight=30, b_maxl=15,
                         n_jobs=1)
    else:
        v.knn_imputation(k=10, balanced=False, n_jobs=1,
                         metric="euclidean")
    # decouple from gamma-fit optimizer tolerance: reference gammas
    v.gammas = golden["gammas"].copy()
    v.q = golden["q"].copy()
    v.which_gamma = "gammas"
    v.predict_U()
    v.calculate_velocity()
    v.calculate_shift(assumption="constant_velocity")
    v.extrapolate_cell_at_t(delta_t=1.)
    v.ts = golden["ts"].copy()
    v.estimate_transition_prob(hidim="Sx_sz", embed="ts", transform="sqrt",
                               knn_random=knn_random, sampled_fraction=0.5,
                               calculate_randomized=False)
    v.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=False)


def test_mesh_pipeline_matches_golden_and_single_device(golden):
    vm = _fresh_vlm(golden, _mesh())
    v1 = _fresh_vlm(golden, None)
    for v in (vm, v1):
        _run_pipeline(v, golden, knn_random=True)

    # (a) reference-golden parity through the mesh path
    np.testing.assert_array_equal(vm.knn.toarray() > 0,
                                  golden["bal_knn"] > 0)
    np.testing.assert_allclose(vm.Sx, golden["bal_Sx"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(vm.sampling_ixs,
                                  golden["knnr_sampling_ixs"])
    np.testing.assert_array_equal(vm.embedding_knn.toarray(),
                                  golden["knnr_embedding_knn"])

    # (b) mesh == single-device through the public API
    np.testing.assert_array_equal(vm.knn.toarray(), v1.knn.toarray())
    np.testing.assert_allclose(vm.Sx, v1.Sx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vm.corrcoef, v1.corrcoef, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(vm.transition_prob, v1.transition_prob,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(vm.delta_embedding, v1.delta_embedding,
                               rtol=1e-3, atol=1e-5)


def test_mesh_full_mode_matches_golden(golden):
    """knn_random=False (dense colDeltaCor) through the sharded dense
    kernel's plain twin.  Unbalanced imputation to match the golden
    corrcoef's inputs."""
    vm = _fresh_vlm(golden, _mesh())
    _run_pipeline(vm, golden, knn_random=False, balanced=False)
    np.testing.assert_allclose(vm.corrcoef, golden["corrcoef"],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(vm.transition_prob,
                               golden["transition_prob"],
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(vm.delta_embedding,
                               golden["delta_embedding"],
                               rtol=1e-3, atol=1e-5)


def test_mesh_survives_hdf5_roundtrip(golden, tmp_path):
    """The mesh is runtime state: to_hdf5 skips it and keeps it attached
    afterwards; loading gives mesh=None."""
    mesh = _mesh()
    v = _fresh_vlm(golden, mesh)
    path = str(tmp_path / "vlm.hdf5")
    v.to_hdf5(path)
    assert v.mesh is mesh
    v2 = vtt.load_velocyto_hdf5(path, device=CPU)
    assert getattr(v2, "mesh", None) is None
    np.testing.assert_array_equal(v2.S, v.S)


def test_mesh_ring_schedule_matches_single_device(golden, monkeypatch):
    """Force the ring schedule (expression split, chunks handed round the
    shards) through the public API: single-device results."""
    monkeypatch.setattr(tcdc, "_REPLICATION_BYTES", 1)
    vm = _fresh_vlm(golden, _mesh())
    v1 = _fresh_vlm(golden, None)
    for v in (vm, v1):
        _run_pipeline(v, golden, knn_random=True)
    np.testing.assert_allclose(vm.corrcoef, v1.corrcoef, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(vm.delta_embedding, v1.delta_embedding,
                               rtol=1e-3, atol=1e-5)


def test_mesh_device_rules(tmp_path, golden):
    """VelocytoLoom(..., mesh=) takes the mesh's first device; an explicit,
    different device raises."""
    from velocyto_tpu.io import loom as jloom
    path = str(tmp_path / "m.loom")
    S = golden["S"]
    jloom.create(path, {"": S, "spliced": S, "unspliced": golden["U"],
                        "ambiguous": np.zeros_like(S)},
                 {"Gene": np.array([f"g{i}" for i in range(S.shape[0])])},
                 {"CellID": np.array([f"c{i}" for i in range(S.shape[1])])})
    mesh = _mesh()
    v = vtt.VelocytoLoom(path, mesh=mesh)
    assert v.device == CPU and v.mesh is mesh
    assert vtt.VelocytoLoom(path, device="cpu", mesh=mesh).device == CPU
    with pytest.raises(ValueError, match="first device"):
        vtt.VelocytoLoom(path, device="cuda", mesh=mesh)
    assert vtt.VelocytoLoom(path, device="cpu").mesh is None
