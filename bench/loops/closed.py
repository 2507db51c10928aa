"""A closed loop with one client: call ``i + 1`` is issued when call ``i``
has returned, from call 0 until the first call that returns at or after
``seconds`` into the window.  A call's latency runs from its issue until
it returns (its outputs in host memory)."""

from __future__ import annotations

import time
from typing import Callable, List, Tuple


def drive(call: Callable[[int], object], seconds: float, traffic: dict, seed: int,
          done: Callable[[int, object], None]) -> Tuple[List[float], float]:
    """``(latency ms of each call, window seconds)``; ``done(i, outputs)``
    takes each call's outputs as it returns."""
    if int(traffic.get("clients", 1)) != 1:
        raise ValueError("the closed loop drives one client")
    lat: List[float] = []
    start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        out = call(i)
        end = time.perf_counter()
        lat.append((end - t) * 1e3)
        done(i, out)
        del out
        i += 1
        if end - start >= seconds:
            return lat, end - start
