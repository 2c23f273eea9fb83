"""The port's estimation pipeline (velocyto_tpu_torch.VelocytoLoom on the
CPU) against the realistic-scale estimation golden: the reference
velocyto.py analysis layer's per-stage outputs at 5,000 cells x 1,000
genes (tests/golden/estimation_realistic_golden.npz, provenance
tests/golden/generate_estimation_realistic.py).

The six tests of tests/test_golden_estimation_realistic.py, which hold
the JAX package to the same file, run on the port in the same order on
one shared VelocytoLoom (module-scoped fixture), with the same input
guards (the digests of S and U, the meta row), the same sampling_ixs
digest (the sampled positions and so the chunked neighbour-sampling
replay are exact), and the same tolerances and assert_mostly_close
fractions.  The sampled transition probabilities run through the port's
chunk-pipelined path (four replay chunks, the randomized control
permuted on the device) with the plain colDeltaCor on CPU tensors.
"""
import hashlib
import os

import numpy as np
import pytest

import torch

import velocyto_tpu_torch as vtt

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden", "estimation_realistic_golden.npz")

N, G, PCA_DIMS, K, B_SIGHT, B_MAXL, NN = 5000, 1000, 50, 125, 750, 375, 1000


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def golden():
    if not os.path.exists(GOLDEN):
        pytest.skip("estimation_realistic_golden.npz not generated "
                    "(tests/golden/generate_estimation_realistic.py)")
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def vlm(golden):
    import sys
    sys.path.insert(0, os.path.join(HERE, "golden"))
    from generate_estimation_realistic import synth_structured
    S, U, _gamma_true, _t, _branch = synth_structured()
    # guard against RNG drift: the test must see the exact reference input
    assert _sha(S) == bytes(golden["sha_S"]).hex()
    assert _sha(U) == bytes(golden["sha_U"]).hex()
    meta = golden["meta"]
    assert tuple(meta) == (N, G, PCA_DIMS, K, B_SIGHT, B_MAXL, NN)

    v = vtt.VelocytoLoom.__new__(vtt.VelocytoLoom)
    v.device = torch.device("cpu")
    v.S, v.U, v.A = S.copy(), U.copy(), np.zeros_like(S)
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    v.ca = {"CellID": np.array([f"c{i}" for i in range(N)])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(G)])}
    return v



def assert_mostly_close(a, b, rtol, atol, frac=0.995, loose_rtol=0.05,
                        loose_atol=0.02):
    """Parity assertion shaped for a known, bounded divergence source:
    the PCA-tail rotations swap a handful of near-tied kNN candidate
    ranks (8/5000 cells observed), and that perturbation cascades
    through smoothing, the per-gene fits, and the softmax-amplified
    projection.  So: an overwhelming fraction of entries must match at
    the tight tolerance (catching any systematic error), and EVERY
    entry must stay inside a loose bound (catching gross errors in the
    affected cells too)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = np.abs(a - b)
    ok = err <= atol + rtol * np.abs(b)
    assert ok.mean() >= frac, \
        f"only {ok.mean():.4f} within rtol={rtol}/atol={atol} (need {frac})"
    loose = loose_atol + loose_rtol * np.abs(b)
    worst = float((err - loose).max())
    assert np.all(err <= loose), f"loose bound exceeded by {worst:.4g}"


def test_normalize_pca(vlm, golden):
    vlm._normalize_S(relative_size=vlm.initial_cell_size,
                     target_size=np.mean(vlm.initial_cell_size))
    vlm._normalize_U(relative_size=vlm.initial_Ucell_size,
                     target_size=np.mean(vlm.initial_Ucell_size))
    vlm.S_norm = np.log2(vlm.S_sz + 1)
    vlm.perform_PCA(which="S_norm", n_components=PCA_DIMS)
    np.testing.assert_allclose(vlm.pca.explained_variance_ratio_,
                               golden["pca_explained"], rtol=1e-4,
                               atol=1e-9)
    rsub = golden["rsub"]
    # the tail eigenvalues of this fixture are near-degenerate noise
    # (relative gaps ~1e-5; only ~6 components rise above the noise
    # floor), so f32-level input differences rotate the tail
    # eigenvectors by ~1%: pin the well-separated top components
    # elementwise and the (rotation-invariant) per-cell energy of the
    # full 50-dim representation
    np.testing.assert_allclose(vlm.pcs[rsub, :6], golden["pcs_sub"][:, :6],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        np.linalg.norm(vlm.pcs[rsub, :PCA_DIMS], axis=1),
        np.linalg.norm(golden["pcs_sub"], axis=1), rtol=1e-4)


def test_balanced_knn_imputation(vlm, golden):
    vlm.knn_imputation(k=K, balanced=True, b_sight=B_SIGHT, b_maxl=B_MAXL,
                       n_jobs=2)
    # the balanced graph itself: in-degree equality for essentially all
    # cells.  The PCA-tail eigenvector rotations (see test_normalize_pca)
    # perturb pairwise distances by ~1e-4 relative, which swaps a
    # handful of near-tied candidate ranks at the sight boundary; the
    # greedy balance then shifts in-degree for those few cells (8/5000
    # observed).  Integer-exactness of the balancing itself given the
    # same ordering is covered bit-level by tests/test_knn_device.py.
    indeg = np.asarray((vlm.knn > 0).sum(0)).ravel().astype(np.int32)
    mismatched = int((indeg != golden["knn_indeg"]).sum())
    assert mismatched <= N // 500, \
        f"{mismatched} cells with diverging balanced-kNN in-degree"
    gsub, csub = golden["gsub"], golden["csub"]
    assert_mostly_close(vlm.Sx[np.ix_(gsub, csub)], golden["Sx_sub"],
                        rtol=2e-4, atol=2e-4)
    assert_mostly_close(vlm.Ux[np.ix_(gsub, csub)], golden["Ux_sub"],
                        rtol=2e-4, atol=2e-4)
    assert_mostly_close(vlm.Sx.sum(1), golden["Sx_rowsum"], rtol=1e-4,
                        atol=0.0, frac=0.99, loose_rtol=1e-2,
                        loose_atol=1.0)
    assert_mostly_close(vlm.Ux.sum(1), golden["Ux_rowsum"], rtol=1e-4,
                        atol=0.0, frac=0.99, loose_rtol=1e-2,
                        loose_atol=1.0)


def test_fit_gammas_clustered_regimes(vlm, golden):
    vlm.fit_gammas()
    assert_mostly_close(vlm.gammas, golden["gammas"], rtol=5e-3, atol=5e-4,
                        frac=0.99, loose_rtol=0.05, loose_atol=5e-3)
    # per-gene offsets are the least-conditioned fit outputs: a few
    # weak genes swing visibly under the 8-cell perturbation
    assert_mostly_close(vlm.q, golden["q"], rtol=5e-3, atol=5e-4,
                        frac=0.97, loose_rtol=0.1, loose_atol=0.45)
    assert_mostly_close(vlm.R2, golden["R2"], rtol=5e-3, atol=5e-4,
                        frac=0.98, loose_rtol=0.05, loose_atol=0.03)
    # the fixture has 4 true gamma modules; the fitted values must
    # actually separate them (sanity that the fixture carries signal)
    gt = golden["gamma_true"]
    fitted = vlm.gammas
    assert np.corrcoef(np.log(np.maximum(fitted, 1e-6)),
                       np.log(gt))[0, 1] > 0.7


def test_velocity_and_transition_prob(vlm, golden):
    vlm.predict_U()
    vlm.calculate_velocity()
    vlm.calculate_shift(assumption="constant_velocity")
    vlm.extrapolate_cell_at_t(delta_t=1.)
    gsub, csub, rsub = golden["gsub"], golden["csub"], golden["rsub"]
    assert_mostly_close(vlm.velocity[np.ix_(gsub, csub)],
                        golden["velocity_sub"], rtol=2e-3, atol=2e-3,
                        frac=0.98, loose_rtol=0.1, loose_atol=0.25)
    # (no delta_S row-sum pin: the signed per-gene sums sit near zero,
    # where the 8-cell cascade + the fitted-gamma shifts dominate any
    # meaningful tolerance; the elementwise velocity subset above is
    # the real pin)

    vlm.ts = np.ascontiguousarray(vlm.pcs[:, :2])
    np.testing.assert_allclose(vlm.ts, golden["ts"], rtol=1e-4, atol=5e-5)
    vlm.estimate_transition_prob(hidim="Sx_sz", embed="ts",
                                 transform="sqrt", knn_random=True,
                                 n_neighbors=NN, sampled_fraction=0.5,
                                 calculate_randomized=True)
    # RNG parity is exact: the sampled column positions must be
    # bit-identical to the reference's np.random.choice loop
    assert _sha(vlm.sampling_ixs.astype(np.int64)) == \
        bytes(golden["sampling_ixs_sha"]).hex()
    assert_mostly_close(vlm.corrcoef[rsub], golden["corrcoef_sub"],
                        rtol=1e-3, atol=1e-3, frac=0.99,
                        loose_rtol=0.0, loose_atol=1.0)
    assert_mostly_close(vlm.corrcoef_random[rsub],
                        golden["corrcoef_random_sub"], rtol=1e-3,
                        atol=1e-3, frac=0.98, loose_rtol=0.0,
                        loose_atol=0.15)


def test_embedding_shift_and_grid(vlm, golden):
    rsub = golden["rsub"]
    vlm.calculate_embedding_shift(sigma_corr=0.05, expression_scaling=False)
    assert_mostly_close(vlm.transition_prob[rsub],
                        golden["transition_prob_sub"], rtol=1e-3,
                        atol=1e-5, frac=0.98, loose_rtol=0.0,
                        loose_atol=0.05)
    # the exp(corr/0.05) softmax amplifies corr tolerance ~20x, so the
    # projected field is pinned by absolute bound + field correlation
    # (elementwise rtol is meaningless near the field's zero crossings)
    for ours, ref, rmin in (
            (vlm.delta_embedding, golden["delta_embedding"], 0.998),
            (vlm.delta_embedding_random,
             golden["delta_embedding_random"], 0.97)):
        assert np.all(np.abs(ours - ref) <= 0.08)
        for c in range(2):
            r = np.corrcoef(ours[:, c], ref[:, c])[0, 1]
            assert r >= rmin, f"field corr {r} < {rmin}"
    vlm.calculate_grid_arrows(smooth=0.5, steps=(30, 30), n_neighbors=100)
    np.testing.assert_allclose(vlm.flow_grid, golden["flow_grid"],
                               rtol=1e-4, atol=1e-6)
    assert np.all(np.abs(vlm.flow - golden["flow"]) <= 0.01)


def test_velocity_field_tracks_trajectory(vlm, golden):
    """The projected field must point along the embedded trajectory:
    correlation between delta_embedding and the local pseudotime
    gradient direction (the fixture's ground truth) must be strongly
    positive -- this is the scientific sanity check the reference's
    randomized control formalizes, evaluated against known truth."""
    t = golden["pseudotime"]
    emb = vlm.ts
    # local pseudotime gradient via kNN regression of t on the embedding
    from sklearn.neighbors import NearestNeighbors
    nn = NearestNeighbors(n_neighbors=50).fit(emb)
    _d, ix = nn.kneighbors(emb)
    # direction toward higher-t neighbors
    dt = t[ix] - t[:, None]
    dx = emb[ix] - emb[:, None, :]
    grad = (dt[:, :, None] * dx).mean(1)
    gn = np.linalg.norm(grad, axis=1, keepdims=True)
    gn[gn == 0] = 1
    de = vlm.delta_embedding
    dn = np.linalg.norm(de, axis=1, keepdims=True)
    dn[dn == 0] = 1
    cosine = ((grad / gn) * (de / dn)).sum(1)
    assert cosine.mean() > 0.3, f"field/trajectory cosine {cosine.mean()}"
    # and the randomized control must NOT track the trajectory
    der = vlm.delta_embedding_random
    drn = np.linalg.norm(der, axis=1, keepdims=True)
    drn[drn == 0] = 1
    cos_r = ((grad / gn) * (der / drn)).sum(1)
    assert abs(cos_r.mean()) < 0.1, f"random control cosine {cos_r.mean()}"
