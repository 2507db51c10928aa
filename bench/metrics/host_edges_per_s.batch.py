"""``edges_per_s`` in the cells that sample graphs in batches
(``sample_batch``), read in the traced run as a per-layer metric: distinct
edges delivered to host memory by the calls completed in the window, over
the window's seconds (host clock).  The host's work between launches
spreads these cells' runs too widely for an end-to-end bound, so the
throughput is recorded here and the cell holds its memory and set-up."""

from bench.harness import spec

_SAME = spec.reader("edges_per_s")
UNIT = _SAME.UNIT
SOURCE = _SAME.SOURCE
LAYER = "session and result"
MOVES = "peak_mem_gib"
read = _SAME.read
