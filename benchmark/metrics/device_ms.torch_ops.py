"""Device milliseconds per pipeline in kernels that are not the port's
hand kernels (velocyto_tpu_torch/kernels/*.cu): the plain torch
operations. Copies and memsets are not kernels and are left out."""
from benchmark.trace import is_copy

UNIT = "ms"
LAYER = "device ops"
MOVES = "pipeline_s"

# the __global__ functions of velocyto_tpu_torch/kernels/*.cu
HAND_KERNELS = ("coldeltacor_dense_kernel", "coldeltacor_partial_kernel",
                "coldeltacor_flat_kernel", "fma_probe_kernel", "walk_kernel",
                "decode_kernel", "balance_probe_kernel", "svr_smo_kernel",
                "svr_sync_probe_kernel", "tsne_pairs_kernel",
                "tsne_attract_kernel")


def read(t):
    return 1e3 * t.kernel_seconds(
        lambda n: not is_copy(n) and not any(h in n for h in HAND_KERNELS)
    ) / t.pipelines
