"""Share, in percent, of the window's device-idle time that some program
span (a host range "vtt.<name>" on the calling thread,
benchmark/program.py) holds: how much of the idle time the program
names. Nothing to read, and no value, where the program records no span
or the device was never idle."""
from benchmark import program

UNIT = "%"
LAYER = "device"
MOVES = "pipeline_s"


def read(t):
    return program.named_share(t)
