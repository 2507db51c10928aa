"""``dedup_stream_ms_per_call``, read alike in the cells that sample graphs in batches.
There it is recorded beside ``host_edges_per_s.batch``: those cells hold
no throughput end to end, and ``MOVES`` names the end-to-end metric they
report besides ``setup_s``."""

from bench.harness import spec

_SAME = spec.reader("dedup_stream_ms_per_call")
UNIT = _SAME.UNIT
SOURCE = _SAME.SOURCE
LAYER = _SAME.LAYER
MOVES = "peak_mem_gib"
read = _SAME.read
