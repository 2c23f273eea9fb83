"""Device milliseconds per pipeline in copies from the device to the
host."""
UNIT = "ms"
LAYER = "device"
MOVES = "pipeline_s"


def read(t):
    return 1e3 * t.kernel_seconds(
        lambda n: n.startswith("Memcpy DtoH")) / t.pipelines
