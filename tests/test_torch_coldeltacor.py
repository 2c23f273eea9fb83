"""The port's dense colDeltaCor (velocyto_tpu_torch.ops.coldeltacor) against
the JAX package's Pallas kernel (interpret mode on the CPU) and the numpy
oracle, plus the CPU behaviour of the CUDA kernel's wrapper.

Inputs are made with numpy from a seed.  Both sides are float32; the
tolerance (rtol 2e-3, atol 2e-4, off the diagonal) is the JAX tests':
f32 moment cancellation in S2 - S1^2/G differs with summation order."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from velocyto_tpu.ops.coldeltacor import (_TRANSFORMS,
                                          _col_delta_cor_dense_pallas)
from velocyto_tpu_torch import kernels
from velocyto_tpu_torch.ops.coldeltacor import (_col_delta_cor_dense_plain,
                                                col_delta_cor)

from oracles import col_delta_cor_dense as oracle_dense
from oracles import col_delta_cor_partial as oracle_partial

# test_coldeltacor.py's transform/psc pairs (dense and pad-masking cases)
PAIRS = [("linear", 0.0), ("sqrt", 0.0), ("sqrt", 1e-10), ("log10", 1.0),
         ("log10", 1e-10)]


def _inputs(g, n, seed=0):
    rng = np.random.RandomState(seed)
    e = (rng.rand(g, n) * 10).astype(np.float32)
    e[:, 5] = e[:, 3]                    # exact duplicate cells: delta == 0
    e[: g // 2, 7] = e[: g // 2, 2]      # delta == 0 on half the genes
    d = rng.randn(g, n).astype(np.float32)
    # compare off the diagonal and off the duplicate pair, whose
    # correlation is 0/0 (a constant transform) like the diagonal's
    mask = ~np.eye(n, dtype=bool)
    mask[3, 5] = mask[5, 3] = False
    return e, d, mask


@pytest.mark.parametrize("partial", [False, True],
                         ids=["full", "partial"])
@pytest.mark.parametrize("transform,psc", PAIRS)
@pytest.mark.parametrize("g,n", [(37, 29), (260, 530)])
def test_dense_plain_matches_pallas_and_oracle(g, n, transform, psc,
                                               partial):
    e, d, mask = _inputs(g, n)
    tcode = _TRANSFORMS[transform]
    got = _col_delta_cor_dense_plain(torch.from_numpy(e), torch.from_numpy(d),
                                     tcode, psc, partial).numpy()
    pallas = np.asarray(_col_delta_cor_dense_pallas(
        jnp.asarray(e), jnp.asarray(d), tcode, psc, interpret=True,
        partial_semantics=partial))
    e64, d64 = e.astype(np.float64), d.astype(np.float64)
    if partial:
        every = np.tile(np.arange(n), (n, 1))
        oracle = oracle_partial(e64, d64, every, transform, psc)
    else:
        oracle = oracle_dense(e64, d64, transform, psc)
    np.testing.assert_allclose(got[mask], pallas[mask], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got[mask], oracle[mask], rtol=2e-3, atol=2e-4)


def test_partial_semantics_sign_quirks():
    """delta == 0 genes: partial sqrt maps them to 0 and partial log10 to
    +log10(psc), where the full variants give -sqrt(psc) / -log10(psc);
    the correlations of a pair with such genes must therefore differ."""
    e, d, _ = _inputs(37, 29)
    et, dt = torch.from_numpy(e), torch.from_numpy(d)
    for transform, psc in (("sqrt", 1.0), ("log10", 1e-10)):
        full = col_delta_cor(et, dt, transform, psc)
        part = col_delta_cor(et, dt, transform, psc, partial_semantics=True)
        assert abs(float(full[2, 7] - part[2, 7])) > 1e-3
        # pairs without any delta == 0 gene agree between the semantics
        np.testing.assert_allclose(full[0, 1:3].numpy(),
                                   part[0, 1:3].numpy(), rtol=1e-6)


def test_col_delta_cor_cpu_tensor_uses_plain_version():
    e, d, mask = _inputs(37, 29)
    got = col_delta_cor(torch.from_numpy(e), torch.from_numpy(d), "sqrt",
                        1e-10)
    plain = _col_delta_cor_dense_plain(torch.from_numpy(e),
                                       torch.from_numpy(d), 1, 1e-10)
    assert got.dtype == torch.float32 and got.shape == (29, 29)
    np.testing.assert_array_equal(got.numpy()[mask], plain.numpy()[mask])
    assert kernels.dense_launches == 0
    assert kernels._lib is None          # nothing was built or loaded


def test_kernels_import_without_cuda():
    """The kernels module imports on a machine without CUDA, builds
    nothing at import, and its wrapper refuses CPU tensors instead of
    falling back."""
    assert kernels.dense_launches == 0
    assert kernels._lib is None
    assert [s.name for s in kernels.SOURCES] == [
        "coldeltacor_dense.cu", "coldeltacor_partial.cu", "fma_probe.cu",
        "knn_balance.cu", "svr_smo.cu", "tsne_grad.cu"]
    e = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.coldeltacor_dense(e, e, 0, 0.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.coldeltacor_dense(e, e, 1, 1e-10, dmat2=e)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.coldeltacor_partial(e, e, e, torch.zeros((4, 2),
                                                         dtype=torch.int64),
                                    1, 1e-10)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.coldeltacor_partial(
            e, e, e, torch.zeros((4, 2), dtype=torch.int32), 1, 1e-10,
            d_ctr2=e, order=torch.arange(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.fma_probe(e)
    x = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.svr_smo(x, x, 1.0, 0.1, 1.0, 1e-3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.tsne_grad(torch.zeros((4, 2)), torch.zeros(5, dtype=torch.int64),
                          torch.zeros(0, dtype=torch.int32), torch.zeros(0))
    i64 = torch.zeros((4, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.knn_balance(i64, i64.double(), i64[:, 0].contiguous(), None,
                            2, 2)
    assert kernels.dense_launches == kernels.partial_launches == \
        kernels.fma_launches == kernels.svr_launches == \
        kernels.tsne_launches == kernels.balance_launches == 0
    assert kernels._lib is None
