"""Percent of the traced slice in which no operation ran on the device:
one minus the union of device intervals over the slice."""
from lib import readers

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "tpot_p95_ms"


def read(run):
    return readers.idle(run)
