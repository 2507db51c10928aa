"""Device milliseconds of the device-to-host copies per call (the edges
and the counts the session reads back), from the trace."""

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "session and result"
MOVES = "edges_per_s"


def read(r):
    copies = [e for e in r.trace.device if e.name.startswith("Memcpy DtoH")]
    if not copies:
        return None
    return sum(e.end - e.start for e in copies) * 1e3 / r.calls
