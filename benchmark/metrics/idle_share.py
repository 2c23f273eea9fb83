"""Share of the measured window, in percent, in which no kernel, copy or
memset ran on the device."""
UNIT = "%"
LAYER = "device"
MOVES = "pipeline_s"


def read(t):
    return 100.0 * (1.0 - t.busy_seconds() / t.window_seconds())
