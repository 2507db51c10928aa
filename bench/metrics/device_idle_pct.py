"""Share of the traced window in which no operation ran on the card:
1 - (union of the device events' intervals) / window."""

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "edges_per_s"


def read(r):
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
