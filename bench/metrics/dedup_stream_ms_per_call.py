"""Stream milliseconds a call inside the program's ``engine.dedup`` span
(the round's ``core/dedup.py::segmented_unique_mask``: its sorts and
gathers), read as ``alpha_stream_ms_per_call`` reads alpha's."""

UNIT = "ms"
SOURCE = "program_span"
LAYER = "engine"
MOVES = "edges_per_s"
KEY = "span.engine.dedup.stream_ms"


def read(r):
    total = (r.counters or {}).get(KEY)
    return total / r.calls if total else None
