"""Distinct edges delivered to host memory by the calls completed in the
window, over the window's seconds (host clock)."""

from bench.harness import stats

UNIT = "edges/s"
SOURCE = "host_clock"


def read(r):
    return stats.rate(r.units, r.window_s)
