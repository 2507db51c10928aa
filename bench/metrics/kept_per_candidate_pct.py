"""Edges handed to the host per candidate drawn, in percent, over the
traced window: the program's counters ``edges_out`` (rows that
``QuiltRun.edges`` and ``.edges_per_sample`` returned) over
``candidates`` (rows the engine's device rounds drew, every graph's slots
a round).  The share of the round's work that the exact thinning, the
lookup misses and the dedup keep.  It holds only where every round ran on
the device, as in this benchmark's cells (``rounds_per_call`` 1): edges a
host top-up or the host path drew count as kept but not as drawn, and a
second ``.edges()`` of one run counts its rows again.  Nothing to read
where the program has no such counters or drew no candidate."""

UNIT = "%"
SOURCE = "program_counter"
LAYER = "engine"
MOVES = "edges_per_s"


def read(r):
    counters = r.counters or {}
    drawn, kept = counters.get("candidates"), counters.get("edges_out")
    if not drawn or not kept:
        return None
    return 100.0 * kept / drawn
