"""Two-process test of the port's mesh (CPU, gloo), mirroring
tests/test_distributed.py: the one layer no other test exercises,
collectives crossing a process boundary.  Two subprocesses each hold 4
CPU shards of an 8-shard mesh and run, across that boundary, the count
merge, the sharded sampled colDeltaCor, the ring (each step's hand-over
of an expression chunk goes from one process to the other by send/recv)
and the sharded velocity step (its all_to_all, then an all_gather).  Results
must equal the single-process results computed here, and each other.

The workers join through parallel.initialize_distributed, the entry
point a multi-host run uses."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_collectives(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["OMP_NUM_THREADS"] = "1"
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_distributed_worker.py"),
         str(i), "2", str(port), str(outs[i])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    assert all(p.returncode == 0 for p in procs), "\n\n".join(logs)

    results = [json.loads(o.read_text()) for o in outs]
    for r in results:
        assert (r["world"], r["global_shards"], r["local_shards"]) == \
            (2, 8, 4)

    # single-process results (the same seeds, no mesh)
    from velocyto_tpu_torch.ops.coldeltacor import \
        col_delta_cor_partial_compact
    from velocyto_tpu_torch.models.velocity import (example_inputs,
                                                    velocity_step)
    rng = np.random.RandomState(0)
    stacked = rng.poisson(1.0, (5, 16, 24)).astype(np.float32)
    n, g, nn = 48, 12, 8
    emat = rng.rand(g, n).astype(np.float32)
    dmat = rng.randn(g, n).astype(np.float32)
    ixs = np.stack([rng.choice(n, nn, replace=False)
                    for _ in range(n)]).astype(np.int32)
    expected_corr = col_delta_cor_partial_compact(
        torch.from_numpy(emat), torch.from_numpy(dmat),
        torch.from_numpy(ixs), "sqrt", 1e-10).numpy()
    step = velocity_step(*example_inputs(g=32, n=64, k=8, nn=16, seed=3,
                                         device="cpu"))

    for r in results:
        np.testing.assert_array_equal(np.asarray(r["merged"], np.float32),
                                      stacked.sum(0))
        np.testing.assert_allclose(np.asarray(r["corr"], np.float32),
                                   expected_corr, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(np.asarray(r["ring"], np.float32),
                                   expected_corr, rtol=2e-5, atol=2e-6)
        for name, want in step._asdict().items():
            np.testing.assert_allclose(
                np.asarray(r["vstep"][name], np.float32), want.numpy(),
                rtol=5e-3, atol=5e-5, err_msg=name)
    # both processes hold the same whole result
    for key in ("merged", "corr", "ring", "vstep"):
        assert results[0][key] == results[1][key], key
