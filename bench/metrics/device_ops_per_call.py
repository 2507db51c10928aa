"""Device kernels launched per call: the kernel events of the traced
window (copies and fills left out) over its calls."""

UNIT = "ops"
SOURCE = "device_trace"
LAYER = "engine"
MOVES = "call_ms_p90"


def read(r):
    return len(r.trace.kernels()) / r.calls
