"""Share of the whole call's roofline: the least time for one call's work
(every candidate through descent and lookup, counted from the cell's
shapes by the frozen count whatever implements it, plus each delivered
edge written once at 16 B) over the card's busy time per call in the
trace (the union of the traced window's device intervals, over its calls).
The host's work and the card's idle gaps are not in it: the end-to-end
rate holds those."""

from bench.harness import roofline

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "edges_per_s"


def read(r):
    if r.work is None or r.trace is None or r.trace.busy_s <= 0:
        return None
    bound_ms = roofline.call_bound_ms(edges=r.units / r.calls, **r.work)
    return 100.0 * bound_ms / (r.trace.busy_s * 1e3 / r.calls)
