"""Share, in percent, of the roofline bound of colDeltaCor's work
(benchmark/roofline.py, from the cell's shapes) in the device time of
coldeltacor_dense_kernel (kernels/coldeltacor_dense.cu): the work of
one dual dense launch for each full-mode transition stage of the
traffic. Nothing to read, and no value, where the
trace holds no such launch."""
from benchmark import roofline

UNIT = "%"
LAYER = "hand kernels"
MOVES = "pipeline_s"


def read(t):
    sec = t.kernel_seconds(lambda n: "coldeltacor_dense_kernel" in n)
    work = sum(roofline.dense_cor_bound_s(p) for p in t.stages
               if p["stage"] == "transition" and not p["knn_random"])
    if sec == 0.0 or work == 0.0:
        return None
    return 100.0 * work * t.pipelines / sec
