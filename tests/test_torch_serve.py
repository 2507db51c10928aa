"""The graph server of the port (``repro_torch.launch.serve``) against the
reference's ``repro.launch.serve``: an ``ok`` response carries the
reference server's edges for the same seed; a table of garbage payloads
gets the reference's typed ``(status, code)`` pairs; overload sheds with
``429`` and a bounded p99; an expired deadline is ``408`` with nothing
sampled; a transient fault is retried to success, exhausted retries and a
``DeviceLoss`` are a typed ``500`` and the loop survives; a closed server
refuses; ``_validate_chunk`` agrees with the reference's; the CLI serves
on ``--device cpu``.

Sizes are small (n = 128, d = 7, chunks of 64); edges are held to exact
equality.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from test_torch_reference import SRC, ref  # noqa: F401  (fixture)

from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.configs.magm_paper import THETA_1
from repro_torch.core import magm, prng
from repro_torch.dist import chaos
from repro_torch.launch import serve

LG = 7
CHUNK = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several worker processes share one host: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def sampler():
    cfg = SamplerConfig(params=magm.make_params(THETA_1, 0.5, LG), num_nodes=1 << LG, device="cpu")
    return MAGMSampler(cfg)


@pytest.fixture(scope="module")
def servers(ref, sampler):
    """A port server and a reference server over the same configuration."""
    rs = ref.api.MAGMSampler(ref.api.SamplerConfig(params=ref.magm.make_params(THETA_1, 0.5, LG), num_nodes=1 << LG))
    with serve.GraphServer(sampler, chunk_edges=CHUNK) as mine, ref.serve.GraphServer(rs, chunk_edges=CHUNK) as theirs:
        yield mine, theirs


class _Gated:
    """A stand-in session whose streams wait on ``release``: holds the
    worker busy so that queueing is deterministic."""

    n = 16
    config = types.SimpleNamespace(dtype=np.int64)
    device = torch.device("cpu")

    def __init__(self):
        self.started, self.release, self.calls = threading.Event(), threading.Event(), 0

    def sample_stream(self, key, chunk_edges):
        self.calls += 1
        self.started.set()
        assert self.release.wait(30)
        yield np.zeros((1, 2), np.int64)


@pytest.mark.parametrize("seed", [0, 5])
def test_ok_response_equals_the_reference_servers(servers, sampler, seed):
    mine, theirs = servers
    got = mine.handle({"seed": seed, "chunk_edges": CHUNK}).result()
    want = theirs.handle({"seed": seed, "chunk_edges": CHUNK}).result()
    assert (got.status, got.code, got.chunks) == ("ok", 0, want.chunks) and want.ok
    assert np.array_equal(got.edges, np.asarray(want.edges))
    assert np.array_equal(got.edges, sampler.sample(prng.PRNGKey(seed)).edges)
    serve._validate_chunk(got.edges, sampler.n)


@pytest.mark.parametrize(
    "payload",
    [
        None, 42, [1, 2, 3], "sample please", {"kind": "train"}, {"bogus_field": 1},
        {"chunk_edges": 0}, {"chunk_edges": -4}, {"chunk_edges": "many"}, {"chunk_edges": [64]},
        {"seed": "not-a-seed"}, {"seed": [1]}, {"deadline_s": -1.0}, {"deadline_s": 0}, {"deadline_s": "soon"},
        {"num_edges": 10}, {"num_edges": -1}, {"num_edges": "x"},
        {"kind": "sample"}, {"seed": 3, "chunk_edges": 100.7},
    ],
    ids=lambda p: repr(p)[:40],
)
def test_payload_gets_the_references_status(servers, payload):
    mine, theirs = servers
    got, want = mine.handle(payload).result(), theirs.handle(payload).result()
    assert isinstance(got, serve.ServeResponse)
    assert (got.status, got.code) == (want.status, want.code)
    assert got.ok or got.message  # an error says what was wrong
    assert mine.stats["errors"] == 0


def test_overload_sheds_with_typed_responses():
    gated = _Gated()
    with serve.GraphServer(gated, max_queue=4) as srv:
        first = srv.submit()
        assert gated.started.wait(30)  # the worker holds the first request
        rest = [srv.submit() for _ in range(12)]
        shed = [f.result() for f in rest if f.done()]
        gated.release.set()
        responses = [first.result()] + [f.result() for f in rest]
        stats = dict(srv.stats)
    assert len(shed) == 8 and all((r.status, r.code) == ("overloaded", 429) for r in shed)
    assert all("queue full" in r.message for r in shed)
    ok = [r for r in responses if r.ok]
    assert len(ok) == 5 and stats["accepted"] == 5 and stats["shed"] == 8 and stats["completed"] == 5


def test_burst_on_a_real_session_bounds_the_p99(sampler):
    """12 seeds at once against a queue of 4: every response typed, accepted
    + shed = 12, every ok response the session's own sample, and the p99 of
    the accepted requests' latency within (max_queue + 1) x the longest
    service."""
    max_queue = 4
    with serve.GraphServer(sampler, max_queue=max_queue, chunk_edges=CHUNK) as srv:
        futures = [srv.submit(key=prng.PRNGKey(s)) for s in range(12)]
        responses = [f.result() for f in futures]
        stats = dict(srv.stats)
    ok = [(s, r) for s, r in enumerate(responses) if r.ok]
    assert all(r.ok or (r.status, r.code) == ("overloaded", 429) for r in responses)
    assert stats["accepted"] + stats["shed"] == 12 and stats["accepted"] == len(ok) >= 1
    for s, r in ok:
        assert np.array_equal(r.edges, sampler.sample(prng.PRNGKey(s)).edges)
    lat = sorted(r.wait_s + r.service_s for _, r in ok)
    p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    # host bookkeeping between two requests (a future set, a queue get) is
    # outside every service time: 10 ms of slack for a loaded CPU
    assert p99 <= (max_queue + 1) * max(r.service_s for _, r in ok) + 0.01


def test_expired_deadline_is_408_and_nothing_is_sampled():
    gated = _Gated()
    with serve.GraphServer(gated) as srv:
        srv.submit()
        assert gated.started.wait(30)
        late = srv.submit(deadline_s=1e-3)
        time.sleep(0.02)
        gated.release.set()
        resp = late.result()
    assert (resp.status, resp.code, resp.service_s) == ("deadline_exceeded", 408, 0.0)
    assert gated.calls == 1 and srv.stats["deadline_expired"] == 1


def test_transient_fault_is_retried_to_success(sampler):
    key = prng.PRNGKey(5)
    with serve.GraphServer(sampler, chunk_edges=CHUNK) as srv:
        with chaos.active(chaos.FaultSchedule([chaos.FaultSpec("serve.request", (0,))])):
            resp = srv.submit(key=key).result()
        assert resp.ok and srv.stats["retries"] == 1 and srv.stats["errors"] == 0
    assert np.array_equal(resp.edges, sampler.sample(key).edges)


@pytest.mark.parametrize(
    "spec, name",
    [
        (chaos.FaultSpec("serve.request", (0, 1, 2, 3, 4)), "InjectedFault"),
        (chaos.FaultSpec("quilt.dispatch", (0,), "device_loss", 1), "DeviceLoss"),
    ],
    ids=["exhausted-retries", "device-loss"],
)
def test_fatal_fault_is_a_typed_500_and_the_loop_survives(sampler, spec, name):
    with serve.GraphServer(sampler, chunk_edges=CHUNK) as srv:
        with chaos.active(chaos.FaultSchedule([spec])):
            resp = srv.submit(key=prng.PRNGKey(5)).result()
        assert (resp.status, resp.code) == ("error", 500) and name in resp.message
        assert srv.stats["errors"] == 1
        assert srv.submit(key=prng.PRNGKey(6)).result().ok


def test_submit_after_close_is_refused(sampler):
    srv = serve.GraphServer(sampler, chunk_edges=CHUNK)
    srv.close()
    resp = srv.submit().result()
    assert (resp.status, resp.code) == ("error", 500) and "closed" in resp.message
    srv.close()  # idempotent


@pytest.mark.parametrize(
    "chunk",
    [
        np.zeros((3, 2), np.int64), np.zeros((3, 3), np.int64), np.zeros((0, 2), np.int64),
        np.zeros((3, 2), np.float32), np.full((3, 2), 10, np.int64), np.full((3, 2), -1, np.int32),
        np.full((2, 2), 9, np.uint8), np.zeros(4, np.int64),
    ],
    ids=["ok", "shape", "empty", "float", "too-big", "negative", "uint8", "flat"],
)
def test_validate_chunk_agrees_with_the_reference(ref, chunk):
    def outcome(fn):
        try:
            fn(chunk, 10)
        except AssertionError as exc:
            return str(exc)
        return None

    assert outcome(serve._validate_chunk) == outcome(ref.serve._validate_chunk)


def test_cli_serves_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--magm", "--graph-d", str(LG), "--requests", "3",
         "--chunk-edges", str(CHUNK), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "[serve] OK" in out.stdout and "'errors': 0" in out.stdout and "'completed': 3" in out.stdout


# meshes name their item in both modes (every LM family is served: tests/test_torch_families_cli.py)
@pytest.mark.parametrize(
    "argv, item", [(["--magm", "--mesh"], "7b"), (["--arch", "mixtral-8x22b", "--smoke", "--device", "cpu", "--mesh"], "7b")]
)
def test_cli_unported_modes_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        serve.main(argv)
