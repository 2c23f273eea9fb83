"""The dense and sampled colDeltaCor kernels of this checkout against those
of another checkout of the port, bitwise, on one card.

Loads the other checkout's velocyto_tpu_torch/kernels module under its
own name, builds both kernel sets, and runs the dense kernel (every
transform, full and partial semantics, both fields) and the sampled
kernel (every transform, both fields) of each on the same inputs at three
shapes, one with G % 4 != 0.  Exits non-zero when any output differs
in one bit.  Use it to show that a change to a kernel source left the
launches it did not mean to change as they were:

    git archive <commit> velocyto_tpu_torch | tar -x -C _archive/other
    python3 tools/kernels_against_checkout.py _archive/other

Run from the repo root, on a machine with a card and nvcc.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from velocyto_tpu_torch import kernels as ours             # noqa: E402

SHAPES = ((37, 29), (2000, 4096), (1999, 3001))            # (G, N)
DENSE_CASES = ((0, 0.0, False), (1, 1e-10, False), (1, 1.0, True),
               (2, 1.0, False), (2, 1.0, True))   # (transform, psc, partial)
SAMPLED_CASES = ((0, 0.0), (1, 1e-10), (2, 1.0))
NN = 300


def _load(checkout: str):
    path = Path(checkout) / "velocyto_tpu_torch" / "kernels" / "__init__.py"
    spec = importlib.util.spec_from_file_location("other_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(a, b):
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))


def main(checkout: str) -> dict:
    other = _load(checkout)
    ours.build()
    other.build()
    res = {}
    for g, n in SHAPES:
        rng = np.random.RandomState(g)
        e, d, d2 = (torch.tensor(a, dtype=torch.float32, device="cuda")
                    for a in (rng.rand(g, n) * 10, rng.randn(g, n),
                              rng.randn(g, n)))
        for tf, psc, partial in DENSE_CASES:
            a = ours.coldeltacor_dense(e, d, tf, psc, partial, dmat2=d2)
            b = other.coldeltacor_dense(e, d, tf, psc, partial, dmat2=d2)
            res[f"dense G={g} N={n} transform={tf} psc={psc} "
                f"partial={partial}"] = _bits(a[0], b[0]) and \
                _bits(a[1], b[1])
        er, dr, d2r = (t.T.contiguous() for t in (e, d, d2))
        gen = torch.Generator().manual_seed(g)
        nn = min(NN, n - 1)
        ixs = torch.stack([torch.randperm(n, generator=gen)[:nn]
                           for _ in range(n)]).to(torch.int32).cuda()
        for tf, psc in SAMPLED_CASES:
            a = ours.coldeltacor_partial(er, er, dr, ixs, tf, psc,
                                         d_ctr2=d2r)
            b = other.coldeltacor_partial(er, er, dr, ixs, tf, psc,
                                          d_ctr2=d2r)
            res[f"sampled G={g} N={n} transform={tf}"] = \
                _bits(a[0], b[0]) and _bits(a[1], b[1])
    torch.cuda.synchronize()
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "bitwise": res}))
    if not all(res.values()):
        sys.exit(f"outputs differ: {[k for k, v in res.items() if not v]}")
    return res


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python3 tools/kernels_against_checkout.py CHECKOUT")
    main(sys.argv[1])
