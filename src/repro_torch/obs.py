"""Spans and counters of the port: where a call's time goes, stage by
stage, and how much the engine drew against what it kept.

One registry, :data:`COUNTERS`, holds everything (``quilt.DISPATCH_COUNTERS``
names the same dict):

- the quilting engine's round counters (``core/quilt.py`` lists them);
- ``candidates``: candidate rows the quilting engine's device rounds drew,
  ``gtot * a_tot`` a round over the whole run's graphs, so every rank of a
  mesh counts what an unsharded run counts;
- ``edges_out``: edge rows that ``QuiltRun.edges`` and
  ``QuiltRun.edges_per_sample`` handed to the host (either engine's run;
  each call hands them again and counts again).  Host-drawn rows (the host
  path, a host top-up) count here but not under ``candidates``, so
  ``edges_out / candidates`` is the share kept only where every round of
  the run ran on the device;
- once tracing has been on, each span's totals:
  ``span.<name>.count``, ``span.<name>.host_ms`` (host clock, entry to
  exit), ``span.<name>.self_host_ms`` (that, less the time of the spans
  nested directly inside it) and, where CUDA is initialized,
  ``span.<name>.stream_ms`` (the current stream's time between the span's
  entry and exit, from two timing events).

The counters only add integers the host already holds, and are always on.

:func:`span` marks a stage, as a ``with`` block or a decorator.  Tracing is
on while a ``torch.profiler`` records or after :func:`enable`.  While it is
off a span costs two flag reads and a dict lookup and does nothing else.
While it is on a span opens a ``record_function`` range of its name, so the
profiler's trace carries the program's stage names, adds its host times to
the totals and, on a card, records a timing event on the current stream at
entry and at exit.  Those events are read only when the outermost span of
the thread closes: a span opened with ``host_result=True`` (a session's
call, the edges to the host) has its results in host memory by then, so
waiting for its exit event waits for nothing else; any other outermost
span leaves its events until they have completed, to be read when a later
outermost span closes.  No span waits on the device inside a call.

The outermost span of one request is ``session.sample`` or
``session.sample_batch``; every other span of the call nests inside it on
the same thread.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List

import torch
from torch.autograd import profiler as _profiler

__all__ = ["COUNTERS", "disable", "enable", "span", "tracing"]

COUNTERS: Dict[str, float] = {"candidates": 0, "edges_out": 0}

_ENABLED = False
_LOCK = threading.Lock()  # the span totals are added to from any thread
_LOCAL = threading.local()  # this thread's open spans and unread events


def enable() -> None:
    """Turn tracing on without a profiler."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Turn off what :func:`enable` turned on (a recording profiler still
    turns tracing on)."""
    global _ENABLED
    _ENABLED = False


def tracing() -> bool:
    """Whether spans record: :func:`enable` was called or a profiler records."""
    return _ENABLED or _profiler._is_profiler_enabled


def _add(*items) -> None:
    """Add each ``(key, value)`` of ``items`` to its total."""
    with _LOCK:
        for key, value in items:
            COUNTERS[key] = COUNTERS.get(key, 0) + value


class _Off:
    """A span while tracing is off: enters and leaves nothing.  One object
    per name and kind, shared by every use."""

    __slots__ = ("name", "host_result")

    def __init__(self, name: str, host_result: bool):
        self.name = name
        self.host_result = host_result

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn):
        """``fn`` inside this span at every call (tracing tested per call)."""
        name, host_result = self.name, self.host_result

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not (_ENABLED or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _On(name, host_result):
                return fn(*args, **kwargs)

        return spanned


class _On(_Off):
    """A span while tracing is on."""

    __slots__ = ("_range", "_start", "_t0", "_nested_s")

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._start = None
        if torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._nested_s = 0.0
        _stack().append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        took = time.perf_counter() - self._t0
        stack = _stack()
        stack.pop()
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _pending().append((self.name, self._start, end))
        if stack:
            stack[-1]._nested_s += took
        prefix = "span." + self.name
        _add((prefix + ".count", 1), (prefix + ".host_ms", took * 1e3),
             (prefix + ".self_host_ms", (took - self._nested_s) * 1e3))
        self._range.__exit__(*exc)
        if not stack and _pending():
            _read_events(wait=self.host_result)
        return False


def _stack() -> List[_On]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _pending() -> list:
    pending = getattr(_LOCAL, "pending", None)
    if pending is None:
        pending = _LOCAL.pending = []
    return pending


def _read_events(wait: bool) -> None:
    """Add the stream time of every unread span of this thread, once its
    last exit event has completed.  With ``wait`` the outermost span that
    just closed holds its results in host memory, so the stream has
    nothing before its exit event left to run, and waiting costs the
    event's own record only; without it the events stay for a later
    outermost span."""
    pending = _pending()
    last = pending[-1][2]
    if wait:
        # after the call's last host read, outside every step (the linter's
        # call graph reaches no function of this module's on path)
        last.synchronize()
    elif not last.query():
        return
    _add(*(("span." + name + ".stream_ms", start.elapsed_time(end)) for name, start, end in pending))
    pending.clear()


_OFF: Dict[tuple, _Off] = {}


def span(name: str, *, host_result: bool = False) -> _Off:
    """The span ``name``: a context manager, or a decorator that opens it
    around each call.  ``host_result=True`` says that when the span closes
    its results are in host memory (see the module's docstring)."""
    if _ENABLED or _profiler._is_profiler_enabled:
        return _On(name, host_result)
    off = _OFF.get((name, host_result))
    if off is None:
        off = _OFF.setdefault((name, host_result), _Off(name, host_result))
    return off
