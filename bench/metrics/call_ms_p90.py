"""90th percentile (nearest rank), over every call of the window, of the
host-clock time from the call's issue (closed loop: when the previous one
returned) until its edges are in host memory."""

from bench.harness import stats

UNIT = "ms"
SOURCE = "host_clock"


def read(r):
    return stats.percentile(r.call_ms, 90)
