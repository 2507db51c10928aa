"""What the harness asks of a system under test, and the ``record_function``
ranges it puts around the program's functions in a traced run.

An engine (``bench/engines/<engine>.py``), or a traffic mix written in
code, builds a ``Work`` with ``build(config, traffic, seed, device)``.
The harness calls it as its loop offers the load, counts what each call
delivers, hands a seed-drawn sample of the outputs to the reference, and
reads the program's counters around the window.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple


def _no_counters() -> Dict[str, int]:
    return {}


def _no_ranges(launches: List[dict]):
    return contextlib.nullcontext()


class Work(NamedTuple):
    """One cell's session and its calls."""

    call: Callable[[int], object]  # call i -> its outputs, as the reference's compare reads them
    units: Callable[[object], int]  # what one call's outputs deliver (edges, rows, tokens)
    close: Callable[[], None]  # drops the session
    counters: Callable[[], Dict[str, int]] = _no_counters  # the program's own counters, read around the window
    ranges: Callable[[List[dict]], object] = _no_ranges  # launches -> the traced run's ranges (a context manager)
    labels: Tuple[str, ...] = ()  # the names of those ranges


# one range: (module, attribute, range name, a logger of the call's arguments or None)
Span = Tuple[str, str, str, Optional[Callable]]


@contextlib.contextmanager
def ranges(spans: Iterable[Span]):
    """Wrap each ``module.attribute`` of ``spans`` in a ``record_function``
    range of its name while the block runs (a module or attribute that is
    missing is skipped); the module may name a class, as ``pkg.mod:Class``."""
    from torch.profiler import record_function

    undo = []
    for where, attr, label, log in spans:
        module, _, cls = where.partition(":")
        try:
            owner = importlib.import_module(module)
        except ImportError:
            continue
        owner = getattr(owner, cls, None) if cls else owner
        fn = getattr(owner, attr, None)
        if fn is None:
            continue

        def spanned(*a, _fn=fn, _label=label, _log=log, **k):
            if _log is not None:
                _log(*a, **k)
            with record_function(_label):
                return _fn(*a, **k)

        setattr(owner, attr, functools.wraps(fn)(spanned))
        undo.append((owner, attr, fn))
    try:
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)
