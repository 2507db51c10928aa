"""Host milliseconds a call in the program's ``result.edges`` span
(``QuiltRun.edges`` and ``.edges_per_sample``: the kept rows gathered,
copied to the host and split by sample) less the spans nested in it: its
self time on the host clock, summed over the traced window, over its
calls.  It includes the host's waits on the device there.  Nothing to read
where the program has no such span."""

UNIT = "ms"
SOURCE = "program_span"
LAYER = "session and result"
MOVES = "edges_per_s"
KEY = "span.result.edges.self_host_ms"


def read(r):
    total = (r.counters or {}).get(KEY)
    return total / r.calls if total else None
