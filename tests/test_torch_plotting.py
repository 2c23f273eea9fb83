"""The port's plotting surface (Agg backend) against the JAX package's.

Mirrors each test of tests/test_plotting.py on the port, on the same
small synthetic state (N = 60, G = 30, drawn from a seed with numpy and
fed to both packages), and holds the port's figure to the JAX
package's: after each plot the data of the drawn artists (scatter
offsets and colours, quiver X/Y/U/V and scale, bars and error bars, line
data, arrows) must match, artist by artist in drawing order, at the
tolerance test_torch_pipeline.py uses for the attribute each plot draws
from.  plot_arrows_embedding draws its subset from numpy's global
stream; from the same state both packages draw the same subset.
"""
import matplotlib
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib.collections import LineCollection  # noqa: E402
from matplotlib.quiver import Quiver  # noqa: E402

import velocyto_tpu as vt  # noqa: E402
import velocyto_tpu_torch as vtt  # noqa: E402

CPU = torch.device("cpu")


def _state(mod, **extra):
    """tests/test_plotting.py's fixture, for either package."""
    rng = np.random.default_rng(0)
    N, G = 60, 30
    base = rng.gamma(2.0, 2.0, (G, N))
    v = mod.VelocytoLoom.__new__(mod.VelocytoLoom)
    for name, value in extra.items():
        setattr(v, name, value)
    v.S = rng.poisson(base).astype(np.float32) + 1
    v.U = rng.poisson(0.4 * base).astype(np.float32)
    v.A = np.zeros_like(v.S)
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    v.ca = {"CellID": np.array([f"c{i}" for i in range(N)])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(G)])}
    v.set_clusters(np.array([f"k{i % 3}" for i in range(N)]))
    v.normalize("both")
    v.perform_PCA(n_components=10)
    v.knn_imputation(k=5, balanced=False, n_jobs=1)
    v.fit_gammas()
    v.predict_U()
    v.calculate_velocity()
    v.calculate_shift()
    v.extrapolate_cell_at_t()
    v.ts = np.ascontiguousarray(v.pcs[:, :2])
    v.estimate_transition_prob(hidim="Sx_sz", embed="ts",
                               transform="sqrt", knn_random=False,
                               calculate_randomized=True)
    v.calculate_embedding_shift(expression_scaling=False)
    v.calculate_grid_arrows(steps=(6, 6), n_neighbors=10)
    return v


@pytest.fixture(scope="module")
def pair():
    return {"jax": _state(vt), "port": _state(vtt, device=CPU)}


def _drawn(fig):
    """(kind, arrays) of every artist of fig's axes, in drawing order."""
    out = []
    for ax in fig.axes:
        for c in ax.collections:
            if isinstance(c, Quiver):
                out.append(("quiver", [c.X, c.Y, c.U, c.V, [c.scale]]))
            elif isinstance(c, LineCollection):
                out.append(("segments", [np.concatenate(c.get_segments())]))
            elif hasattr(c, "_offsets3d"):
                out.append(("points3d", [np.asarray(a) for a in c._offsets3d]
                            + [c.get_facecolors()]))
            else:
                out.append(("points", [c.get_offsets(), c.get_facecolors()]))
        for line in ax.lines:
            out.append(("line", [line.get_xydata()]))
        for p in ax.patches:
            out.append(("patch", [p.get_patch_transform().transform(
                p.get_path().vertices)]))
    return out


def _draw_both(pair, draw):
    """draw(v, mod) for each package on a fresh figure; returns the two
    artist lists."""
    got = {}
    for tag, mod in (("jax", vt), ("port", vtt)):
        plt.close("all")
        plt.figure()
        draw(pair[tag], mod)
        got[tag] = _drawn(plt.gcf())
        plt.close("all")
    return got["port"], got["jax"]


def _assert_same_figure(port, jax_, rtol, atol):
    assert [k for k, _ in port] == [k for k, _ in jax_]
    assert port, "nothing was drawn"
    for (kind, ours), (_, theirs) in zip(port, jax_):
        assert len(ours) == len(theirs), kind
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=rtol, atol=atol, err_msg=kind)


def _check(pair, draw, rtol, atol):
    port, jax_ = _draw_both(pair, draw)
    _assert_same_figure(port, jax_, rtol, atol)


# the plots, in tests/test_plotting.py's order, each with the tolerance
# of the attribute it draws from (test_torch_pipeline.py)

def test_plot_fractions(pair):
    # raw counts: exact
    _check(pair, lambda v, m: v.plot_fractions(), 0, 0)


def test_plot_pca(pair):
    _check(pair, lambda v, m: v.plot_pca(), 1e-5, 1e-6)


def test_plot_pca_imputed(pair):
    def draw(v, m):
        v.normalize("imputed")
        v._perform_PCA_imputed(n_components=5)
        v._plot_pca_imputed()
    # Sx_norm is smoothed (Sx's 1e-4), then projected
    _check(pair, draw, 1e-4, 1e-4)
    np.testing.assert_allclose(np.abs(pair["port"].pcsx),
                               np.abs(pair["jax"].pcsx), rtol=1e-4,
                               atol=1e-4)


def test_plot_phase_portraits(pair):
    # Sx_sz / Ux_sz (1e-4) and the gamma fit (rtol 1e-4, atol 1e-5)
    _check(pair, lambda v, m: v.plot_phase_portraits(["g0", "g1"]),
           1e-4, 1e-4)


def test_plot_grid_arrows(pair):
    # flow_grid, flow and flow_rndm (rtol 1e-3, atol 1e-5)
    _check(pair, lambda v, m: v.plot_grid_arrows(), 1e-3, 1e-5)


@pytest.mark.parametrize("plot_random", [True, False])
def test_plot_arrows_embedding(pair, plot_random):
    def draw(v, m):
        np.random.seed(7)
        v.plot_arrows_embedding(quiver_scale=1.0, plot_random=plot_random)
        draw.state = np.random.get_state()
    port, jax_ = _draw_both(pair, draw)
    # delta_embedding(_random) (rtol 1e-3, atol 1e-5); the subset (the
    # arrows' tails) drawn from numpy's stream is the same: the same
    # rows of each package's own embedding (the embeddings, the PCs, agree
    # to the PCs' tolerance, not bitwise: the port's S_norm is built on
    # its device)
    _assert_same_figure(port, jax_, 1e-3, 1e-5)

    def drawn_rows(figure, v):
        x, y = [k for k in figure if k[0] == "quiver"][-1][1][:2]
        emb = np.asarray(v.embedding)
        rows = [np.flatnonzero((emb[:, 0] == a) & (emb[:, 1] == b))
                for a, b in zip(x, y)]
        assert all(len(r) == 1 for r in rows)
        return np.concatenate(rows)
    tails = drawn_rows(port, pair["port"])
    np.testing.assert_array_equal(tails, drawn_rows(jax_, pair["jax"]))
    assert len(tails) == pair["port"].S.shape[1] // 3


def test_plot_cell_transitions(pair):
    _check(pair, lambda v, m: v.plot_cell_transitions(cell_ix=0), 1e-3,
           1e-5)


def test_plot_velocity_as_color(pair):
    # Sx_sz_t - Sx_sz (1e-5) through the RdBu_r map
    _check(pair, lambda v, m: v.plot_velocity_as_color(gene_name="g0"),
           1e-5, 1e-5)


def test_plot_expression_as_color(pair):
    _check(pair, lambda v, m: v.plot_expression_as_color(gene_name="g0"),
           1e-4, 1e-4)


def test_scatter_viz(pair):
    _check(pair, lambda v, m: m.scatter_viz(v.ts[:, 0], v.ts[:, 1],
                                            c=v.colorandum), 1e-5, 1e-6)


def test_ixs_thatsort_a2b():
    rng = np.random.RandomState(0)
    a = rng.permutation(50)
    b = rng.permutation(50)
    ix = vtt.ixs_thatsort_a2b(a, b)
    np.testing.assert_array_equal(ix, vt.ixs_thatsort_a2b(a, b))
    np.testing.assert_array_equal(a[ix], b)
    with pytest.raises(AssertionError, match="not matching"):
        vtt.ixs_thatsort_a2b(a, b + 100)


def test_score_cv_vs_mean_plot(pair):
    """The scatter of both gene sets and the curve of the fitted SVR's
    predict, against the JAX package's (sklearn's SVR)."""
    def draw(v, m):
        v.score_cv_vs_mean(N=10, max_expr_avg=50, plot=True)
    port, jax_ = _draw_both(pair, draw)
    assert [k for k, _ in port] == ["points", "points", "line"]
    _assert_same_figure(port, jax_, 1e-6, 1e-8)
    np.testing.assert_array_equal(pair["port"].cv_mean_selected,
                                  pair["jax"].cv_mean_selected)
