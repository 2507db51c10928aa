"""Fault injection in the port (``repro_torch.dist.chaos``) against the
reference's ``repro.dist.chaos``: the same schedules, exact and rate, fire
at the same visits in both packages, each package reads the other's JSON,
and the retry combinator keeps the reference's semantics (retry, fatal,
deadline, ``on_retry``).

The one deliberate difference is the backoff's jitter: the reference seeds
``random.Random`` with the tuple ``(seed, attempt)``, which Python 3.12
rejects, so the reference's ``backoff`` is never called here; the port's
own sequence is pinned (equal for equal seeds, different across seeds).
Everything here is deterministic: equality is exact.
"""

from __future__ import annotations

import threading

import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch.dist import chaos

SITES = ("quilt.round", "quilt.dispatch", "stream.chunk", "serve.request")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several worker processes share one host: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _visits(mod, sched, visits: int):
    """Visit each of SITES ``visits`` times; the (site, visit, type) of every
    fault raised, and the schedule's fired log."""
    raised = []
    for v in range(visits):
        for site in SITES:
            try:
                sched.check(site)
            except mod.InjectedFault as exc:
                raised.append((site, v, type(exc).__name__, getattr(exc, "device", None)))
    return raised, sched.fired, sched.counters


@pytest.mark.parametrize(
    "specs",
    [
        [("stream.chunk", (1,))],
        [("quilt.round", (0, 3)), ("quilt.dispatch", (2,), "device_loss", 3)],
        [("serve.request", (0, 1, 2), "fault", 0, "boom"), ("serve.request", (1, 5))],
    ],
    ids=["one", "two-sites", "overlapping"],
)
def test_exact_schedule_fires_at_the_same_visits(ref, specs):
    got = _visits(chaos, chaos.FaultSchedule([chaos.FaultSpec(*s) for s in specs]), 8)
    want = _visits(ref.chaos, ref.chaos.FaultSchedule([ref.chaos.FaultSpec(*s) for s in specs]), 8)
    assert got == want
    assert got[0]  # something fired


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_rate_schedule_fires_at_the_same_visits(ref, seed):
    rates = {"stream.chunk": 0.3, "quilt.round": 0.05}
    got = _visits(chaos, chaos.FaultSchedule(seed=seed, rates=rates), 200)
    want = _visits(ref.chaos, ref.chaos.FaultSchedule(seed=seed, rates=rates), 200)
    assert got == want
    assert 20 < len(got[0]) < 120


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_json_loads_in_the_other_package(ref, direction):
    specs = [("stream.chunk", (1, 4)), ("quilt.dispatch", (0,), "device_loss", 2, "lost")]
    src, dst = (chaos, ref.chaos) if direction == "port-to-ref" else (ref.chaos, chaos)
    sched = src.FaultSchedule([src.FaultSpec(*s) for s in specs], seed=9, rates={"serve.request": 0.25})
    back = dst.FaultSchedule.from_json(sched.to_json())
    assert [tuple(s) for s in back.specs] == [tuple(s) for s in sched.specs]
    assert (back.seed, back.rates) == (sched.seed, sched.rates)
    assert back.to_json() == sched.to_json()
    assert _visits(dst, back, 30)[:2] == _visits(src, sched, 30)[:2]


def test_schedule_rejects_bad_kind_and_schema():
    with pytest.raises(ValueError, match="kind"):
        chaos.FaultSchedule([chaos.FaultSpec("stream.chunk", (0,), "meteor")])
    with pytest.raises(ValueError, match="schema"):
        chaos.FaultSchedule.from_json('{"schema": "other"}')


def test_active_scopes_and_restores():
    outer = chaos.FaultSchedule([chaos.FaultSpec("stream.chunk", (0,))])
    inner = chaos.FaultSchedule()
    chaos.maybe_fail("stream.chunk")  # nothing installed: a no-op
    with chaos.active(outer):
        with chaos.active(inner):
            chaos.maybe_fail("stream.chunk")
            assert chaos.active_schedule() is inner
        with pytest.raises(chaos.InjectedFault):
            chaos.maybe_fail("stream.chunk")
    assert chaos.active_schedule() is None
    assert inner.counters == {"stream.chunk": 1} and outer.fired[0]["visit"] == 0
    outer.reset()
    assert outer.counters == {} and outer.fired == []


def test_check_is_thread_safe():
    sched = chaos.FaultSchedule([chaos.FaultSpec("serve.request", tuple(range(0, 400, 4)))])
    fired = []

    def worker():
        for _ in range(100):
            try:
                sched.check("serve.request")
            except chaos.InjectedFault:
                fired.append(1)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sched.counters["serve.request"] == 400 and len(fired) == len(sched.fired) == 100


def _flaky(fails, exc=chaos.InjectedFault):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise exc("transient")
        return "ok"

    return fn, calls


def test_retries_then_succeeds_with_the_policy_backoff():
    fn, calls = _flaky(2)
    sleeps, hooks = [], []
    policy = chaos.RetryPolicy(max_attempts=5, base_delay=0.1, seed=3)
    out = chaos.with_retries(fn, policy, sleep=sleeps.append, on_retry=lambda *a: hooks.append(a))
    assert out == "ok" and len(calls) == 3
    assert sleeps == [policy.backoff(0), policy.backoff(1)]
    assert [(a, type(e).__name__, d) for a, e, d in hooks] == [
        (0, "InjectedFault", sleeps[0]), (1, "InjectedFault", sleeps[1])
    ]
    assert 0.1 <= sleeps[0] <= 0.11 and 0.2 <= sleeps[1] <= 0.22


def test_exhausted_retries_raise_the_last_fault():
    fn, calls = _flaky(10)
    with pytest.raises(chaos.InjectedFault):
        chaos.with_retries(fn, chaos.RetryPolicy(max_attempts=3), sleep=lambda s: None)
    assert len(calls) == 3


@pytest.mark.parametrize("exc", [chaos.DeviceLoss, chaos.DeadlineExceeded, KeyError])
def test_fatal_faults_propagate_immediately(exc):
    fn, calls = _flaky(1, exc)
    with pytest.raises(exc):
        chaos.with_retries(fn, chaos.RetryPolicy(max_attempts=5), sleep=lambda s: None)
    assert len(calls) == 1


def test_deadline_cuts_the_loop():
    now = [0.0]
    fn, calls = _flaky(10)
    policy = chaos.RetryPolicy(max_attempts=10, base_delay=1.0, jitter=0.0, deadline=2.5)
    with pytest.raises(chaos.DeadlineExceeded) as info:
        chaos.with_retries(fn, policy, sleep=lambda s: now.__setitem__(0, now[0] + s), clock=lambda: now[0])
    # sleeps 1 then 2 would reach 3 > 2.5: cut before the second sleep
    assert len(calls) == 2 and now[0] == 1.0
    assert isinstance(info.value.__cause__, chaos.InjectedFault)


def test_classify_matches_reference(ref):
    port, theirs = chaos.RetryPolicy(), ref.chaos.RetryPolicy()
    for p, r in ((chaos.InjectedFault("x"), ref.chaos.InjectedFault("x")),
                 (chaos.DeviceLoss("x", 2), ref.chaos.DeviceLoss("x", 2)),
                 (chaos.DeadlineExceeded("x"), ref.chaos.DeadlineExceeded("x")),
                 (ValueError("x"), ValueError("x"))):
        assert port.classify(p) == theirs.classify(r)
        assert chaos.is_retryable(p, port) == ref.chaos.is_retryable(r, theirs)


def test_backoff_is_seeded_and_differs_across_seeds():
    a, b, c = chaos.RetryPolicy(seed=5), chaos.RetryPolicy(seed=5), chaos.RetryPolicy(seed=6)
    seq = [a.backoff(k) for k in range(6)]
    assert seq == [b.backoff(k) for k in range(6)]
    assert seq != [c.backoff(k) for k in range(6)]
    for k, delay in enumerate(seq):
        base = min(a.base_delay * 2.0**k, a.max_delay)
        assert base <= delay <= base * (1 + a.jitter)
    assert chaos.RetryPolicy(jitter=0.0).backoff(2) == 0.2
