"""Arithmetic of the end-to-end and per-layer numbers: percentiles, rates,
and the union and gaps of device intervals."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the ceil(q / 100 * N)-th smallest value."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    rank = max(math.ceil(q / 100.0 * len(xs)), 1)
    return xs[rank - 1]


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("the window has no length")
    return count / seconds


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The merged, sorted union of (start, end) intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps(merged: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi) that the merged intervals leave uncovered."""
    out, t = [], lo
    for s, e in merged:
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out
