"""The port's spans and counters (``repro_torch/obs.py``): every span of the
sampler's stages lands in a ``torch.profiler`` trace inside the span it
belongs to, tracing off enters no ``record_function`` and adds no span
total, and the always-on counters count what the engine drew and what it
handed to the host.  The ``cuda`` case reads the stream times on the card
at the exact benchmark cell's shapes."""

from __future__ import annotations

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.configs.magm_paper import THETA_1
from repro_torch.core import magm, prng, quilt

# each span of the sampler's stages, and the spans it may sit directly inside
# (None: the outermost span of a request)
PARENTS = {
    "session.sample": {None},
    "session.sample_batch": {None},
    "engine.run": {"session.sample", "session.sample_batch"},
    "engine.targets": {"engine.run"},
    "engine.round": {"engine.run"},
    "kernels.lookup": {"engine.round"},
    "engine.salt": {"engine.round"},
    "engine.alpha": {"engine.round"},
    "engine.accept_hash": {"engine.round"},
    "engine.dedup": {"engine.round"},
    "result.edges": {"session.sample", "session.sample_batch"},
}
# the three calls: the exact round, the ranked round, a fused batch of 4;
# and the spans each call opens
ROUND = {"engine.run", "engine.round", "kernels.lookup", "engine.dedup", "result.edges"}
MODES = {
    "exact": dict(kw={}, batch=None,
                  spans=ROUND | {"session.sample", "engine.salt", "engine.alpha", "engine.accept_hash"}),
    "ranked": dict(kw={"exact_cells": False}, batch=None, spans=ROUND | {"session.sample", "engine.targets"}),
    "batch": dict(kw={"backend": "device", "exact_cells": False}, batch=4,
                  spans=ROUND | {"session.sample_batch", "engine.targets"}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _restore_counters():
    """The registry is process-wide: put it back after each test."""
    saved = dict(quilt.DISPATCH_COUNTERS)
    yield
    obs.disable()
    quilt.DISPATCH_COUNTERS.clear()
    quilt.DISPATCH_COUNTERS.update(saved)


def _session(mode: str, d: int = 8, device: str = "cpu") -> MAGMSampler:
    cfg = SamplerConfig(params=magm.make_params(THETA_1, 0.5, d), num_nodes=1 << d, device=device,
                        **MODES[mode]["kw"])
    return MAGMSampler(cfg)


def _call(session: MAGMSampler, mode: str, key):
    """The mode's call: its (E, 2) edge arrays."""
    n = MODES[mode]["batch"]
    if n is None:
        return [session.sample(key).edges]
    return [g.edges for g in session.sample_batch(n, key)]


def _spans(prof):
    """(name, start, end, thread) of every span of PARENTS in the trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name() in PARENTS and e.device_type() == torch.autograd.DeviceType.CPU:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()))
    return out


def _parents(spans):
    """name -> the set of names of the spans each of its ranges sits
    directly inside (None for none), ranges of one thread nesting."""
    found = {}
    for thread in {s[3] for s in spans}:
        stack = []
        for name, lo, hi, _ in sorted((s for s in spans if s[3] == thread), key=lambda s: (s[1], -s[2])):
            while stack and stack[-1][2] <= lo:
                stack.pop()
            found.setdefault(name, set()).add(stack[-1][0] if stack else None)
            stack.append((name, lo, hi))
    return found


@pytest.fixture(scope="module")
def traced():
    """Each mode's call under a profiler of its own, after one untraced
    warm call: ``({mode: name -> parents}, counters before, after)``."""
    sessions = {m: _session(m) for m in MODES}
    for m, s in sessions.items():
        _call(s, m, prng.PRNGKey(1))
    before, found = dict(quilt.DISPATCH_COUNTERS), {}
    for m, s in sessions.items():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _call(s, m, prng.PRNGKey(2))
        found[m] = _parents(_spans(prof))
    after = dict(quilt.DISPATCH_COUNTERS)
    for k in list(quilt.DISPATCH_COUNTERS):
        if k.startswith("span."):
            del quilt.DISPATCH_COUNTERS[k]  # leave no totals to the other tests
    return found, before, after


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_each_span_is_traced_inside_its_parent(traced, name):
    found, _, _ = traced
    parents = [f[name] for f in found.values() if name in f]
    assert parents, f"span {name!r} is missing from the trace"
    for p in parents:
        assert p <= PARENTS[name], (name, p)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_each_call_traces_its_stages(traced, mode):
    found, _, _ = traced
    assert set(found[mode]) == MODES[mode]["spans"]


def test_alpha_nests_in_round_run_and_the_session_call(traced):
    parents = traced[0]["exact"]
    chain = ["engine.alpha", "engine.round", "engine.run", "session.sample"]
    for child, parent in zip(chain, chain[1:]):
        assert parent in parents[child], (child, parents[child])


def test_span_totals_self_time_within_host_time(traced):
    _, before, after = traced
    names = {k.rsplit(".", 1)[0] for k in after if k.startswith("span.")}
    assert names == {"span." + n for n in PARENTS}
    for n in names:
        took = after[n + ".host_ms"] - before.get(n + ".host_ms", 0)
        own = after[n + ".self_host_ms"] - before.get(n + ".self_host_ms", 0)
        assert 0 <= own <= took, n
        assert after[n + ".count"] - before.get(n + ".count", 0) >= 1
        assert n + ".stream_ms" not in after  # no card: no stream time
    rounds = sum(after[k] - before[k] for k in ("device_rounds", "device_topup_rounds"))
    assert after["span.engine.round.count"] - before.get("span.engine.round.count", 0) == rounds


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tracing_off_enters_no_range_and_adds_no_total(mode, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    session = _session(mode)
    before = {k: v for k, v in quilt.DISPATCH_COUNTERS.items() if k.startswith("span.")}
    _call(session, mode, prng.PRNGKey(3))
    assert entered == []
    assert {k: v for k, v in quilt.DISPATCH_COUNTERS.items() if k.startswith("span.")} == before
    obs.enable()  # the patched function is the one a traced span enters
    try:
        _call(session, mode, prng.PRNGKey(3))
    finally:
        obs.disable()
    outer = "session.sample_batch" if MODES[mode]["batch"] else "session.sample"
    assert {outer, "engine.run", "result.edges"} <= set(entered)


def test_an_idle_span_is_one_shared_object():
    assert not obs.tracing()
    assert obs.span("engine.alpha") is obs.span("engine.alpha")
    assert obs.span("session.sample", host_result=True) is obs.span("session.sample", host_result=True)
    assert quilt.DISPATCH_COUNTERS is obs.COUNTERS
    obs.enable()
    try:
        assert obs.tracing() and obs.span("engine.alpha") is not obs.span("engine.alpha")
    finally:
        obs.disable()


def test_the_decorated_functions_keep_their_names():
    from repro_torch.api import session

    for fn in (quilt.quilt_run, quilt._round_body, quilt._exact_alpha, quilt.accept_salt, quilt._accept_u01,
               quilt.QuiltRun.edges, quilt.QuiltRun.edges_per_sample, session.MAGMSampler.sample,
               session.KPGMSampler.sample, session.MAGMSampler.sample_batch):
        assert fn.__wrapped__.__name__ == fn.__name__


def test_reference_round_counters_are_unchanged():
    assert quilt.ROUND_COUNTERS == ("device_rounds", "device_topup_rounds", "host_topup_rounds",
                                    "mesh_degrades", "degraded_fallbacks", "exact_fallbacks")
    assert set(quilt.ROUND_COUNTERS) | {"candidates", "edges_out"} <= set(quilt.DISPATCH_COUNTERS)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_candidates_and_edges_out_count_a_run(mode):
    session = _session(mode)
    key = prng.PRNGKey(4)
    samples = MODES[mode]["batch"] or 1
    kw = dict(MODES[mode]["kw"])
    before = dict(quilt.DISPATCH_COUNTERS)
    run = quilt.quilt_run(key, session.plan, num_samples=samples, oversample=session.config.oversample,
                          max_rounds=session.config.max_rounds, **kw)
    mid = dict(quilt.DISPATCH_COUNTERS)
    assert mid["device_rounds"] - before["device_rounds"] == 1
    assert mid["device_topup_rounds"] == before["device_topup_rounds"]  # one round: gtot * a_tot rows
    gtot = samples * session.plan.num_graphs
    assert mid["candidates"] - before["candidates"] == gtot * run.slots_per_graph
    assert mid["edges_out"] == before["edges_out"]  # nothing handed to the host yet
    rows = run.edges().shape[0] if samples == 1 else sum(e.shape[0] for e in run.edges_per_sample())
    assert quilt.DISPATCH_COUNTERS["edges_out"] - mid["edges_out"] == rows
    # the session's call counts alike: its edges are the run's
    mid = dict(quilt.DISPATCH_COUNTERS)
    edges = _call(session, mode, key)
    assert quilt.DISPATCH_COUNTERS["edges_out"] - mid["edges_out"] == sum(e.shape[0] for e in edges) == rows
    assert quilt.DISPATCH_COUNTERS["candidates"] - mid["candidates"] == gtot * run.slots_per_graph


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return "cuda"


def _busy_ms(prof, span=None) -> float:
    """Union of the trace's device intervals, in ms; with ``span``, of their
    parts inside the device-side ranges of that span (the profiler's device
    user annotations)."""
    device = [e for e in prof.profiler.kineto_results.events() if e.device_type() != torch.autograd.DeviceType.CPU]
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in device
              if e.is_user_annotation() and e.name() == span] if span else [(-math.inf, math.inf)]
    spans = sorted(
        (max(e.start_ns(), lo), min(e.start_ns() + e.duration_ns(), hi))
        for e in device if not e.is_user_annotation()
        for lo, hi in ranges if e.start_ns() < hi and e.start_ns() + e.duration_ns() > lo
    )
    busy, top = 0, None
    for s, e in spans:
        if top is None or s > top:
            busy += e - s
            top = e
        elif e > top:
            busy += e - top
            top = e
    return busy * 1e-6


@pytest.mark.cuda
def test_cuda_stream_times_nest_at_the_exact_cell(cuda_device):
    """The benchmark's exact cell (THETA_1, mu = 0.5, n = 2^15, attributes
    of PRNGKey(0)): the stages' stream times nest, the dedup's stream time a
    call is within 10% of the trace's device busy time inside the dedup's
    range, and the spans' events launch no kernel (103 kernels a call, the
    acceptance one of them, exact_accept).  The dedup is the round's longest
    device stage; the run's stream time also holds the host's gaps between
    the stages, 1-6 ms of a ~14 ms busy call by the host's speed, so it is
    no busy time (PERF.md)."""
    session = MAGMSampler(SamplerConfig(params=magm.make_params(THETA_1, 0.5, 15), num_nodes=1 << 15,
                                        attribute_key=prng.PRNGKey(0), device=cuda_device))
    for i in range(2):
        session.sample(prng.fold_in(prng.PRNGKey(7), 1000 + i))
    torch.cuda.synchronize()
    calls = 5
    before = dict(quilt.DISPATCH_COUNTERS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            session.sample(prng.fold_in(prng.PRNGKey(7), i))
    got = {k: v - before.get(k, 0) for k, v in quilt.DISPATCH_COUNTERS.items() if k.endswith(".stream_ms")}
    ms = {k[len("span."):-len(".stream_ms")]: v / calls for k, v in got.items()}
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() != torch.autograd.DeviceType.CPU and not e.is_user_annotation()]
    kernels = sum(not e.name().startswith(("Memcpy", "Memset")) for e in device) / calls
    busy_ms = _busy_ms(prof) / calls
    inside = {k: _busy_ms(prof, k) / calls for k in ms}
    print(f"stream ms a call {ms}; busy ms a call {busy_ms:.3f}; busy ms inside each span a call {inside}; "
          f"kernels a call {kernels}")
    assert ms["engine.alpha"] + ms["engine.dedup"] + ms["kernels.lookup"] <= ms["engine.round"]
    assert ms["engine.round"] <= ms["engine.run"] <= ms["session.sample"]
    assert abs(ms["engine.dedup"] - inside["engine.dedup"]) <= 0.1 * inside["engine.dedup"]
    assert kernels == 103


@pytest.mark.cuda
def test_cuda_off_path_costs_no_event(cuda_device, monkeypatch):
    """With tracing off a call on the card creates no timing event."""
    made = []
    real = torch.cuda.Event

    def counting(*a, **k):
        made.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", counting)
    edges = _call(_session("exact", device=cuda_device), "exact", prng.PRNGKey(5))
    assert made == [] and edges[0].shape[0] > 0
