"""Worker of the two-process test of the port's mesh (CPU, gloo).

Each process holds 4 CPU shards of an 8-shard mesh and takes part in
collectives that cross the process boundary:

  * merge_feeder_counts -- the count merge's all_reduce
    (velocyto_tpu_torch/parallel/counts.py)
  * the sharded sampled colDeltaCor and the gather of its rows
    (ops/coldeltacor.py col_delta_cor_partial_sharded)
  * the ring sampled colDeltaCor: every step hands a chunk of expression
    from one process to the other by send/recv
    (ops/coldeltacor.py col_delta_cor_partial_ring)
  * make_sharded_velocity_step: the all_to_all that regroups its
    gene-split results by cells, then the all_gather of the smoothed
    expression (velocyto_tpu_torch/models/velocity.py)

Every result comes back whole on both processes and is written to a JSON
file per process; tests/test_torch_distributed.py holds them to the
single-process results.  Run as:

  python torch_distributed_worker.py <pid> <nproc> <port> <outfile>
"""
import json
import sys


def main() -> None:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    port, outfile = sys.argv[3], sys.argv[4]
    sys.modules["jax"] = None            # the port never needs it

    from velocyto_tpu_torch.parallel import initialize_distributed
    initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
    import numpy as np
    import torch
    import torch.distributed as dist

    from velocyto_tpu_torch.parallel import (CELLS, make_mesh,
                                             merge_feeder_counts)
    from velocyto_tpu_torch.ops.coldeltacor import (
        col_delta_cor_partial_ring, col_delta_cor_partial_sharded)
    from velocyto_tpu_torch.models.velocity import (
        example_inputs, make_sharded_velocity_step)

    cpu = torch.device("cpu")
    mesh = make_mesh(devices=[cpu] * 4)
    assert dist.get_world_size() == nproc and mesh.rank == pid

    rng = np.random.RandomState(0)
    stacked = rng.poisson(1.0, (5, 16, 24)).astype(np.float32)
    merged = merge_feeder_counts(mesh, stacked)

    n, g, nn = 48, 12, 8
    emat = rng.rand(g, n).astype(np.float32)
    dmat = rng.randn(g, n).astype(np.float32)
    ixs = np.stack([rng.choice(n, nn, replace=False)
                    for _ in range(n)]).astype(np.int32)
    corr = col_delta_cor_partial_sharded(mesh, emat, dmat, ixs, "sqrt",
                                         1e-10)
    ring = col_delta_cor_partial_ring(mesh, emat, dmat, ixs, "sqrt", 1e-10)

    args = example_inputs(g=32, n=64, k=8, nn=16, seed=3, device=cpu)
    outs = make_sharded_velocity_step(mesh)(*args)

    with open(outfile, "w") as f:
        json.dump({"world": dist.get_world_size(),
                   "global_shards": mesh.shape[CELLS],
                   "local_shards": len(mesh.cell_shards()),
                   "merged": merged.numpy().tolist(),
                   "corr": corr.tolist(), "ring": ring.tolist(),
                   "vstep": {k: v.numpy().tolist()
                             for k, v in outs._asdict().items()}}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
