"""Seconds from the start of the run's process until the warm-up calls
have returned: importing, CUDA start-up, loading (and, in a fresh
checkout, compiling) the kernels, building the session and warming up the
cell's shapes."""

UNIT = "s"
SOURCE = "host_clock"


def read(r):
    return r.setup_s
