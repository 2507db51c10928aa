"""Engine rounds per call, from the program's dispatch counters: first
device rounds, device top-up rounds and host top-up rounds."""

UNIT = "rounds"
SOURCE = "program_counter"
LAYER = "engine"
MOVES = "call_ms_p90"
COUNTERS = ("device_rounds", "device_topup_rounds", "host_topup_rounds")


def read(r):
    if r.counters is None or not all(c in r.counters for c in COUNTERS):
        return None
    return sum(r.counters[c] for c in COUNTERS) / r.calls
