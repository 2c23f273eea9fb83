"""The port's kernel bench (velocyto_tpu_torch.bench) on the CPU: the plain
version of the FMA-chain probe against the JAX bench's Pallas kernel in
interpret mode, the HBM table and the refusal to run without a card.

bench.py's ``_fma_kern`` is nested in its main() and cannot be imported,
so it is re-created here as written there.  Tolerance rtol 1e-5: both
sides round after each multiply and each add in f32, but XLA and torch
may contract or order the sum differently."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from velocyto_tpu_torch import bench, kernels

VPU_CHAIN, VPU_W = 128, 8              # bench.py's constants


def _fma_kern(x_ref, o_ref):           # bench.py:192-200, verbatim
    x = x_ref[...]
    ys = [x * (0.1 + 0.1 * i) for i in range(VPU_W)]
    for _k in range(VPU_CHAIN):
        ys = [y * x + 0.25 for y in ys]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    o_ref[...] = acc


def _fma_run(x):                       # bench.py:204-212, in interpret mode
    return pl.pallas_call(
        _fma_kern,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(x.shape[0] // 512,),
        in_specs=[pl.BlockSpec((512, 512), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((512, 512), lambda i: (i, 0)),
        interpret=True)(x)


@pytest.mark.parametrize("lo,hi", [(0.4, 0.4), (-0.9, 0.9)],
                         ids=["bench_input", "spread"])
def test_fma_plain_matches_pallas_kernel(lo, hi):
    x = np.random.RandomState(0).uniform(lo, hi, (1024, 512)).astype(
        np.float32)
    got = bench._fma_plain(torch.from_numpy(x)).numpy()
    want = np.asarray(_fma_run(jnp.asarray(x)))
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fma_plain_counts_the_bench_flops():
    """The probe's fixed point: y* = 0.25 / (1 - x) per chain, so the
    sum tends to 8 * 0.25 / 0.6 at x = 0.4 after 128 steps."""
    x = torch.full((2, 3), 0.4)
    np.testing.assert_allclose(bench._fma_plain(x).numpy(), 8 * 0.25 / 0.6,
                               rtol=1e-6)
    assert (bench.FMA_CHAINS, bench.FMA_STEPS) == (VPU_W, VPU_CHAIN)


@pytest.mark.parametrize("name,gbps", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 2000.0),
    ("NVIDIA H100 NVL", 3900.0), ("NVIDIA H200", 4800.0),
    ("TPU v5 lite", None)])
def test_peak_hbm_table_is_keyed_by_cuda_device_name(name, gbps):
    assert bench.peak_hbm_gbps(name) == gbps


def test_bench_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.main()
    assert kernels.fma_launches == kernels.partial_launches == 0
