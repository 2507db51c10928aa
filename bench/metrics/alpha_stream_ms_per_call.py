"""Stream milliseconds a call inside the program's ``engine.alpha`` span
(``repro_torch/core/quilt.py::_exact_alpha``, the exact round's acceptance
alpha): the time on the current CUDA stream between the span's entry and
exit events (``repro_torch/obs.py``), summed over the traced window, over
its calls.  Nothing to read where the program has no such span or ran no
span on a card."""

UNIT = "ms"
SOURCE = "program_span"
LAYER = "engine"
MOVES = "edges_per_s"
KEY = "span.engine.alpha.stream_ms"


def read(r):
    total = (r.counters or {}).get(KEY)
    return total / r.calls if total else None
