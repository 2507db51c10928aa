"""The output check's common parts: the seed-drawn sample of the window's
calls that the reference recomputes, and the exact comparison of edge rows.

A reference (``bench/reference/<engine>.py``) recomputes the kept calls
from the same seed-made inputs and returns, from ``compare(kept)``, the
numbers compared, each with its limit, and the count of calls that failed.
The quilting engine's sampler is exact and deterministic in its key, so
its comparison is exact: the number compared is the count of edge rows
that differ (rows at the same position that differ, plus the difference
in length), and its limit is 0."""

from __future__ import annotations

import itertools
import random
from typing import Callable, Dict, List, Tuple

import numpy as np

LIMIT = 0  # rows that may differ: the comparison is exact
Numbers = Dict[str, Tuple[float, float]]  # name -> (value, limit)


class Reservoir:
    """A uniform sample of ``k`` of the window's calls, drawn from the seed
    (reservoir sampling): keeps ``(call index, outputs)``."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = random.Random(int(seed))
        self.kept: List[Tuple[int, object]] = []
        self.seen = 0

    def offer(self, i: int, outputs) -> None:
        if len(self.kept) < self.k:
            self.kept.append((i, outputs))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = (i, outputs)
        self.seen += 1


def rows_differing(got: List[np.ndarray], want: List[np.ndarray]) -> int:
    """Edge rows of ``got`` that differ from ``want``, graph by graph: rows
    at one position that differ, the difference in length, and every row
    of a graph that one side lacks."""
    out = 0
    for g, w in itertools.zip_longest(got, want):
        g = np.zeros((0, 2), np.int64) if g is None else np.asarray(g).reshape(-1, 2)
        w = np.zeros((0, 2), np.int64) if w is None else np.asarray(w).reshape(-1, 2)
        m = min(g.shape[0], w.shape[0])
        out += int(np.any(g[:m] != w[:m], axis=1).sum()) + abs(g.shape[0] - w.shape[0])
    return out


def compare_rows(outputs: Callable[[int], List[np.ndarray]], kept, unsupported=()) -> Tuple[Numbers, int]:
    """``(numbers, failed)`` over the kept calls, ``outputs(i)`` giving the
    edge arrays call ``i`` has to deliver.  The numbers, each with the
    limit 0: ``rows_differing``, and ``calls_short``, the kept calls that
    were not compared because ``outputs`` raised ``unsupported`` (the
    reference cannot follow a host round).  ``failed`` counts the kept
    calls that differ or were not compared."""
    diff = short = wrong = 0
    for i, got in kept:
        try:
            want = outputs(i)
        except unsupported:
            short += 1
            continue
        rows = rows_differing(got, want)
        diff += rows
        wrong += rows > 0
    return {"rows_differing": (diff, LIMIT), "calls_short": (short, LIMIT)}, wrong + short


def holds(numbers: Numbers) -> bool:
    """Every number within its limit."""
    return all(value <= limit for value, limit in numbers.values())
