"""The cell's data: velocyto_tpu_torch/bench_pipeline.py's generator
(spliced counts S ~ Poisson(base), unspliced U ~ Poisson(0.4 gamma base +
0.05), base a rank-12 product of Gamma(2, 1) factors scaled per gene),
drawn on the device with a torch.Generator in a few large calls; Gamma(2,
1) is drawn as the sum of two unit exponentials.

The counts come from the configuration's fixed `data_seed`; the run's
seed draws the order of the cells and of the genes. So every seed gives
the same work in another order: the data's spectrum, and with it the
time of the host eigensolver, does not change with the seed."""
import numpy as np
import torch


def names(n_cells: int, n_genes: int) -> dict:
    """The loom's column and row attributes: cell and gene ids."""
    return {"ca": {"CellID": np.array([f"c{i}" for i in range(n_cells)])},
            "ra": {"Gene": np.array([f"g{i}" for i in range(n_genes)])}}


def counts(cfg: dict, seed: int, device):
    """(S, U): host float32 (genes, cells) counts of the configuration,
    cells and genes in the order `seed` draws; the same for the same seed
    on the same kind of device."""
    n, g, r = cfg["cells"], cfg["genes"], cfg["latent_rank"]
    gen = torch.Generator(device=device).manual_seed(cfg["data_seed"])

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float32)

    def gamma2(*shape):
        return -(torch.log1p(-uniform(*shape)) + torch.log1p(-uniform(*shape)))

    gamma_true = 0.2 + uniform(g)
    zl, wl = gamma2(n, r), gamma2(r, g)
    scale = 0.05 + 0.55 * uniform(g)
    base_t = (wl * scale[None, :]).T @ zl.T                    # (genes, cells)
    S = torch.poisson(base_t, generator=gen)
    U = torch.poisson(0.4 * gamma_true[:, None] * base_t + 0.05, generator=gen)
    order = torch.Generator(device=device).manual_seed(int(seed))
    genes = torch.randperm(g, generator=order, device=device)
    cells = torch.randperm(n, generator=order, device=device)
    return tuple(M[genes][:, cells].cpu().numpy() for M in (S, U))
