"""Deterministic fault injection + retry combinators for the sampler runtime.

The paper-scale run (8M nodes / 20B edges, < 6h) cannot treat a device
drop, a straggling host, or a transient dispatch error as fatal: at that
scale *something* fails before edge 20e9.  This module is the harness the
resilience layer is tested (and operated) with:

- :class:`FaultSchedule` — a seeded, serializable schedule of faults that
  fire at named SITES threaded through the runtime (one
  :func:`maybe_fail` call per round / dispatch / chunk / request).  A
  schedule is deterministic: the same schedule against the same code path
  fires the same faults in the same places, so chaos runs are replayable
  and CI can pin them.
- :func:`with_retries` — run a callable under a :class:`RetryPolicy`
  (exponential backoff + deterministic jitter, overall deadline, typed
  retryable-vs-fatal classification).
- :class:`InjectedFault` / :class:`DeviceLoss` — the canonical typed
  faults.  ``DeviceLoss`` carries the lost device's index (a sampler mesh is
  rebuilt over the survivors; without a mesh it is fatal);
  plain ``InjectedFault`` models a transient, retryable failure.

Known sites (each checked once per event)::

    quilt.round        every engine round (quilt + balldrop), before work
    quilt.dispatch     every device round's dispatch, before its first
                       launch (a DeviceLoss here degrades the mesh, and
                       is fatal without one)
    stream.chunk       every emitted sample_stream chunk
    serve.request      every serve-request attempt (retried by policy)
    checkpoint.write   dist/checkpoint.save, before the temp write
    checkpoint.rename  dist/checkpoint.save, between temp write and rename

A copy of the reference's ``repro.dist.chaos`` (schedules, sites, JSON
schema and retry semantics are the same, so one schedule fires at the same
visits in both packages and each reads the other's JSON), with one
deliberate difference: :meth:`RetryPolicy.backoff` seeds its jitter with an
int derived from ``(seed, attempt)``, where the reference passes the tuple,
which Python 3.12's ``random.Random`` rejects.  It imports nothing else of
``repro_torch``: ``dist.checkpoint`` and the engines import it.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import random
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

__all__ = [
    "InjectedFault",
    "DeviceLoss",
    "DeadlineExceeded",
    "FaultSpec",
    "FaultSchedule",
    "RetryPolicy",
    "with_retries",
    "is_retryable",
    "maybe_fail",
    "install",
    "uninstall",
    "active_schedule",
    "active",
]


class InjectedFault(RuntimeError):
    """A simulated failure (tests / chaos drills).

    The canonical *retryable* fault: the default
    :class:`RetryPolicy` classifies it as transient, and
    a server retries the request.
    """


class DeviceLoss(InjectedFault):
    """A fault attributed to one device of the dispatch mesh.

    ``device`` is the index of the lost device in the mesh's flattened
    device list.  The default :class:`RetryPolicy` treats it as fatal (a
    retry of the same program would fail identically); the engines rebuild
    a sampler mesh over the survivors and re-run the round, and without a
    mesh (or on a 1-rank one) a loss ends the sample.
    """

    def __init__(self, message: str = "device lost", device: int = 0):
        super().__init__(message)
        self.device = int(device)


class DeadlineExceeded(RuntimeError):
    """A retry loop (or request) ran past its deadline budget."""


class FaultSpec(NamedTuple):
    """One deterministic fault: fire at the given visit counts of a site.

    ``hits`` are 0-based visit indices (the k-th time the site is checked).
    ``kind`` selects the raised type: ``"fault"`` -> :class:`InjectedFault`,
    ``"device_loss"`` -> :class:`DeviceLoss` carrying ``device``.
    """

    site: str
    hits: Tuple[int, ...]
    kind: str = "fault"
    device: int = 0
    message: str = ""


_KINDS = ("fault", "device_loss")


class FaultSchedule:
    """Seeded, serializable schedule of injected faults at named sites.

    Two trigger modes, combinable:

    - **Explicit** ``specs``: :class:`FaultSpec` entries firing at exact
      visit counts — fully deterministic regardless of seed.
    - **Probabilistic** ``rates``: ``{site: p}`` fires each visit with
      probability ``p`` under a counter-keyed hash of ``seed`` — still
      deterministic for a fixed seed (visit k of a site either always or
      never fires), but scattered like real faults.

    ``check(site)`` increments the site's visit counter and raises the
    scheduled fault, recording it in ``fired``.  Thread-safe: the serving
    worker and the main thread may hit sites concurrently.

    Examples
    --------
    >>> sched = FaultSchedule([FaultSpec("stream.chunk", (1,))])
    >>> sched.check("stream.chunk")  # visit 0: clean
    >>> try:
    ...     sched.check("stream.chunk")  # visit 1: scheduled
    ... except InjectedFault as e:
    ...     print("fired:", sched.fired[0]["site"])
    fired: stream.chunk
    >>> sched2 = FaultSchedule.from_json(sched.to_json())  # round-trips
    >>> sched2.specs == sched.specs and sched2.seed == sched.seed
    True
    """

    def __init__(
        self,
        specs: Sequence[FaultSpec] = (),
        *,
        seed: int = 0,
        rates: Optional[Dict[str, float]] = None,
    ):
        self.specs: Tuple[FaultSpec, ...] = tuple(
            FaultSpec(*s) if not isinstance(s, FaultSpec) else s
            for s in specs
        )
        for s in self.specs:
            if s.kind not in _KINDS:
                raise ValueError(
                    f"FaultSpec.kind must be one of {_KINDS}, got {s.kind!r}"
                )
        self.seed = int(seed)
        self.rates: Dict[str, float] = dict(rates or {})
        self.counters: Dict[str, int] = {}
        self.fired: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_site.setdefault(s.site, []).append(s)

    # -- trigger -------------------------------------------------------

    def _rate_fires(self, site: str, visit: int) -> bool:
        rate = self.rates.get(site)
        if not rate:
            return False
        h = hashlib.sha256(
            f"{self.seed}:{site}:{visit}".encode()
        ).digest()
        u = int.from_bytes(h[:8], "big") / float(1 << 64)
        return u < rate

    def check(self, site: str) -> None:
        """Visit ``site``; raise the scheduled fault for this visit, if any."""
        with self._lock:
            visit = self.counters.get(site, 0)
            self.counters[site] = visit + 1
            spec = None
            for s in self._by_site.get(site, ()):
                if visit in s.hits:
                    spec = s
                    break
            if spec is None and self._rate_fires(site, visit):
                spec = FaultSpec(site, (visit,), "fault", 0, "rate-scheduled")
            if spec is None:
                return
            self.fired.append(
                {"site": site, "visit": visit, "kind": spec.kind}
            )
        msg = spec.message or f"injected {spec.kind} at {site}#{visit}"
        if spec.kind == "device_loss":
            raise DeviceLoss(msg, device=spec.device)
        raise InjectedFault(msg)

    def reset(self) -> None:
        """Zero the visit counters and the fired log (specs/seed kept)."""
        with self._lock:
            self.counters = {}
            self.fired = []

    # -- serialization -------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "schema": "fault-schedule-v1",
                "seed": self.seed,
                "rates": self.rates,
                "specs": [
                    {
                        "site": s.site,
                        "hits": list(s.hits),
                        "kind": s.kind,
                        "device": s.device,
                        "message": s.message,
                    }
                    for s in self.specs
                ],
            }
        )

    @classmethod
    def from_json(cls, payload: str) -> "FaultSchedule":
        obj = json.loads(payload)
        if obj.get("schema") != "fault-schedule-v1":
            raise ValueError(
                f"not a fault schedule: schema={obj.get('schema')!r}"
            )
        return cls(
            [
                FaultSpec(
                    s["site"],
                    tuple(int(h) for h in s["hits"]),
                    s.get("kind", "fault"),
                    int(s.get("device", 0)),
                    s.get("message", ""),
                )
                for s in obj.get("specs", ())
            ],
            seed=int(obj.get("seed", 0)),
            rates={k: float(v) for k, v in obj.get("rates", {}).items()},
        )


# ---------------------------------------------------------------------------
# Active schedule: one process-wide injection point
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultSchedule] = None


def install(schedule: FaultSchedule) -> FaultSchedule:
    """Make ``schedule`` the process-wide active schedule (returns it)."""
    global _ACTIVE
    _ACTIVE = schedule
    return schedule


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_schedule() -> Optional[FaultSchedule]:
    return _ACTIVE


@contextlib.contextmanager
def active(schedule: FaultSchedule):
    """Scope ``schedule`` as the active schedule for a ``with`` block."""
    prev = _ACTIVE
    install(schedule)
    try:
        yield schedule
    finally:
        install(prev) if prev is not None else uninstall()


def maybe_fail(site: str) -> None:
    """Production-side hook: a near-no-op unless a schedule is installed.

    The runtime calls this at every named site; with no active schedule
    the cost is one global read and one None check.
    """
    if _ACTIVE is not None:
        _ACTIVE.check(site)


# ---------------------------------------------------------------------------
# Retry combinator
# ---------------------------------------------------------------------------


class RetryPolicy(NamedTuple):
    """Typed retry semantics for :func:`with_retries`.

    ``retryable`` faults are retried with exponential backoff
    (``base_delay * 2^attempt``, capped at ``max_delay``) plus
    deterministic jitter (a seeded uniform fraction of the delay, so two
    runs of the same policy sleep identically); anything matching
    ``fatal`` — or not matching ``retryable`` at all — propagates
    immediately.  ``deadline`` bounds the WHOLE loop: when the next sleep
    would cross it, :class:`DeadlineExceeded` is raised with the last
    fault chained.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.1
    deadline: Optional[float] = None
    retryable: Tuple[type, ...] = (InjectedFault,)
    fatal: Tuple[type, ...] = (DeviceLoss, DeadlineExceeded)
    seed: int = 0

    def classify(self, exc: BaseException) -> str:
        """``"retryable"`` or ``"fatal"`` for this exception under the
        policy (fatal wins over retryable when both match)."""
        if isinstance(exc, self.fatal):
            return "fatal"
        if isinstance(exc, self.retryable):
            return "retryable"
        return "fatal"

    def backoff(self, attempt: int) -> float:
        """Deterministic sleep before retry ``attempt`` (0-based).

        The jitter's generator is seeded with an int hashed from ``(seed,
        attempt)``: the reference seeds it with the tuple itself, which
        Python 3.12 rejects, so the two packages' jitter differs."""
        delay = min(self.base_delay * (2.0**attempt), self.max_delay)
        if self.jitter > 0:
            h = hashlib.sha256(f"{self.seed}:{attempt}".encode()).digest()
            u = random.Random(int.from_bytes(h[:8], "big")).random()
            delay *= 1.0 + self.jitter * u
        return delay


def is_retryable(exc: BaseException, policy: RetryPolicy) -> bool:
    return policy.classify(exc) == "retryable"


def with_retries(
    fn: Callable[[], Any],
    policy: RetryPolicy = RetryPolicy(),
    *,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
) -> Any:
    """Run ``fn()`` under ``policy``; returns its result.

    ``on_retry(attempt, exc, delay)`` is invoked before each backoff sleep
    (metrics / logging hook).  ``sleep`` and ``clock`` are injectable so
    tests assert the exact backoff sequence without wall-clock waits.

    Examples
    --------
    >>> calls = []
    >>> def flaky():
    ...     calls.append(1)
    ...     if len(calls) < 3:
    ...         raise InjectedFault("transient")
    ...     return "ok"
    >>> with_retries(flaky, RetryPolicy(max_attempts=5), sleep=lambda s: None)
    'ok'
    >>> len(calls)
    3
    """
    t0 = clock()
    last: Optional[BaseException] = None
    for attempt in range(max(int(policy.max_attempts), 1)):
        if policy.deadline is not None and clock() - t0 > policy.deadline:
            raise DeadlineExceeded(
                f"retry loop exceeded {policy.deadline}s deadline"
            ) from last
        try:
            return fn()
        except BaseException as exc:  # noqa: B036 - classified below
            if policy.classify(exc) != "retryable":
                raise
            last = exc
            if attempt == policy.max_attempts - 1:
                raise
            delay = policy.backoff(attempt)
            if (
                policy.deadline is not None
                and clock() - t0 + delay > policy.deadline
            ):
                raise DeadlineExceeded(
                    f"next backoff ({delay:.3f}s) would cross the "
                    f"{policy.deadline}s deadline"
                ) from exc
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
