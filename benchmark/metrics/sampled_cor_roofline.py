"""Share, in percent, of the roofline bound of colDeltaCor's work
(benchmark/roofline.py, from the cell's shapes) in the device time of
coldeltacor_partial_kernel (kernels/coldeltacor_partial.cu): the work of
the sampled launches of each sampled-mode transition stage of the
traffic. Nothing to read, and no value,
where the trace holds no such launch."""
from benchmark import roofline

UNIT = "%"
LAYER = "hand kernels"
MOVES = "pipeline_s"


def read(t):
    sec = t.kernel_seconds(lambda n: "coldeltacor_partial_kernel" in n)
    work = sum(roofline.sampled_cor_bound_s(p) for p in t.stages
               if p["stage"] == "transition" and p["knn_random"])
    if sec == 0.0 or work == 0.0:
        return None
    return 100.0 * work * t.pipelines / sec
