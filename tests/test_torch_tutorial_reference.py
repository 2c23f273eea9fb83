"""The port's expression scaling and Markov diffusion against the
benchmark's plain float64 reference (benchmark/stages/
embedding_shift_scaled.py and benchmark/stages/markov.py, loaded through
benchmark.pipeline.stage_module as the harness loads them), on the CPU
at 400 cells x 60 genes (the benchmark's tiny tutorial fixture: sampled
mode, n_neighbors 100), two seeds of the cells' and genes' order.

Tolerances, each with its reason:
- scaling and scaling_rndm, absolute 2e-5 on values in [0, 1]: the port
  computes the sampled form in float32 (the estimated expression change
  sums 50 neighbours' rows of 60 genes), the reference in float64 from
  the same probabilities; float32's 6e-8 per operation, a few hundred
  operations deep.
- tr, 1e-12 of its largest entry: both float64, from the same float32
  correlations, summed in another order.
- diffused, 1e-4 of its largest entry: 2,500 float32 steps (each
  product's blocks added in float64) against float64 ones.
A float16 tr fails both Markov tolerances: the tests compute it."""
import numpy as np
import pytest
import torch

from benchmark import compare, harness, pipeline, reference, synth

FIXTURE = harness.HERE / "tests" / "fixture"
SCALED = pipeline.stage_module("embedding_shift_scaled")
MARKOV = pipeline.stage_module("markov")
EXACT = reference.Precision({}, False)
F64 = torch.float64
SCALING_ATOL = 2e-5
TR_GAP = 1e-12
DIFFUSED_GAP = 1e-4


def _cfg():
    return harness.load_json(FIXTURE, "configs", "tiny_tutorial")


@pytest.fixture(scope="module", params=[2999999929, 4294967311],
                ids=["seed0", "seed1"])
def session(request):
    """A loom through the tutorial's stages up to the grid (the scaled
    shift included), and the Markov reference's inputs: the float64
    probabilities over the compact neighbours and the embedding."""
    cfg = _cfg()
    seq = [s for s in pipeline.stages("tutorial", cfg) if s.name != "markov"]
    S, U = synth.counts(cfg, request.param, "cpu")
    v = pipeline.load(S, U, synth.names(cfg["cells"], cfg["genes"]), "cpu")
    pipeline.run(v, seq, "cpu", [])
    d = v.__dict__
    ixs = d["_compact_ixs_dev"].to(torch.int64)
    prob = MARKOV.probabilities(d["_corr_dev"].to(F64), ixs,
                                cfg["sigma_corr"], EXACT)
    emb = torch.as_tensor(np.asarray(v.embedding), dtype=F64)
    return cfg, v, ixs, prob, emb


@pytest.mark.parametrize("field", ["", "_rndm"])
def test_scaling_matches_the_reference(session, field):
    cfg, v, ixs, _prob, _emb = session
    d = v.__dict__
    corr = d["_corr_dev" if field == "" else "_corr_rndm_dev"].to(F64)
    tp = torch.softmax(corr / cfg["sigma_corr"], 1)
    hi = torch.as_tensor(np.asarray(v.Sx_sz), dtype=F64)
    dS = torch.as_tensor(np.asarray(
        v.delta_S if field == "" else v.delta_S_rndm), dtype=F64)
    want = np.array([float(SCALED.scaling(
        hi[:, ixs[c]], dS[:, c], tp[c], cfg["scaling_penalty"], EXACT))
        for c in range(ixs.shape[0])])
    got = np.asarray(getattr(v, "scaling" + field))
    inside = (want > 0) & (want < 1)
    # the comparison is not carried by the clip alone
    assert inside.mean() > 0.02, inside.mean()
    np.testing.assert_allclose(got, want, rtol=0, atol=SCALING_ATOL)
    shift = np.asarray(getattr(v, "delta_embedding" + (
        "_random" if field else "")))
    assert np.all(shift[want == 0] == 0)


@pytest.mark.parametrize("direction", ["forward", "backwards"])
def test_markov_matches_the_reference(session, direction):
    cfg, v, _ixs, prob, emb = session
    sd, sw = MARKOV.sigmas(np.asarray(v.embedding), cfg["markov_grid_steps"],
                           cfg["markov_sigma_w_ratio"])
    v.prepare_markov(sigma_D=sd, sigma_W=sw, direction=direction)
    v.run_markov(n_steps=cfg["markov_n_steps"])
    want = MARKOV.markov_matrix(prob if direction == "forward" else prob.T,
                                emb, sd, sw, EXACT)
    got = v._get_dev("tr", None)
    assert got.dtype == F64
    assert compare.gap([(got.numpy(), want.numpy())]) <= TR_GAP
    x = MARKOV.diffuse(want, cfg["markov_n_steps"], EXACT).numpy()
    assert compare.gap([(v.diffused, x)]) <= DIFFUSED_GAP
    # a float16 tr fails both
    half = want.to(torch.float16).to(F64)
    assert compare.gap([(half.numpy(), want.numpy())]) > TR_GAP
    x16 = MARKOV.diffuse(half, cfg["markov_n_steps"], EXACT).numpy()
    assert compare.gap([(x16, x)]) > DIFFUSED_GAP


@pytest.mark.parametrize("seed", [0, 1])
def test_sigma_grid_rule(seed):
    """markov.sigmas is the notebook's diag_step_dist of a 100 x 100
    meshgrid over the embedding, each axis padded as
    calculate_grid_arrows pads it, and sigma_W its half."""
    emb = np.random.RandomState(seed).randn(500, 2) * [3.0, 0.5]
    grs = []
    for dim in range(2):
        m, M = emb[:, dim].min(), emb[:, dim].max()
        m = m - 0.025 * np.abs(M - m)
        M = M + 0.025 * np.abs(M - m)
        grs.append(np.linspace(m, M, 100))
    mesh = np.meshgrid(*grs)
    diag = np.sqrt((mesh[0][0, 0] - mesh[0][0, 1]) ** 2
                   + (mesh[1][0, 0] - mesh[1][1, 0]) ** 2)
    sd, sw = MARKOV.sigmas(emb, [100, 100], 0.5)
    assert sd == pytest.approx(diag, rel=1e-15) and sw == sd / 2
