"""Streams and batches in the port against the reference: the chunking
helpers, fused quilting batches (``quilt_run(num_samples=S)``) in the
exact and the ranked rounds, and ``sample_stream`` / ``sample_batch`` of
both sessions on every path (fused, host loop, split).

Edges, stats and targets are held to bit equality.  To turn the exact
round of a fused batch off at test sizes, ``DEVICE_MAX_CANDIDATES`` is
lowered in both packages' ``kpgm`` modules for the duration of a test
(monkeypatch; nothing in the reference is edited).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import cuda_device, ref  # noqa: F401  (fixtures)

from repro_torch import interop
from repro_torch.api import KPGMSampler, MAGMSampler, SamplerConfig
from repro_torch.configs import magm_paper
from repro_torch.core import dedup, kpgm, quilt

LG = 8  # B = 5 at THETA_1, mu = 0.5: fused batches of 4 x 25 graphs stay small


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on one host: one intra-op
    thread a worker keeps the port's CPU ops from spinning against each
    other (results do not depend on it)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _restore_dispatch_counters():
    """The port's dispatch counters are process-wide: put them back after
    each test (the reference's go with its modules when ``ref`` ends)."""
    saved = dict(quilt.DISPATCH_COUNTERS)
    yield
    quilt.DISPATCH_COUNTERS.update(saved)


def _keys(seed):
    import jax

    key = jax.random.PRNGKey(seed)
    return key, interop._key(np.asarray(jax.random.key_data(key)))


_SESSIONS: dict = {}


def _magm(ref, **kw):
    """Reference and port MAGM sessions (THETA_1, mu = 0.5, n = 2^LG) over
    the reference's attributes, built once a module per config."""
    key = tuple(sorted(kw.items()))
    if key not in _SESSIONS:
        p = ref.magm.make_params(magm_paper.THETA_1, 0.5, LG)
        rs = ref.api.MAGMSampler(ref.api.SamplerConfig(params=p, num_nodes=1 << LG, **kw))
        params, F, _ = interop.from_reference(np.asarray(p.thetas), rs.F, np.zeros(2), np.asarray(p.mu))
        _SESSIONS[key] = rs, MAGMSampler(SamplerConfig(params=params, F=F, device="cpu", **kw))
    return _SESSIONS[key]


@pytest.fixture(scope="module", autouse=True)
def _drop_sessions(ref):
    """The cached sessions hold the reference's objects: drop them with it."""
    yield
    _SESSIONS.clear()


def _kpgm(ref, lg=LG, **kw):
    import jax.numpy as jnp

    th = np.broadcast_to(np.asarray(magm_paper.THETA_1, np.float32), (lg, 2, 2)).copy()
    rs = ref.api.KPGMSampler(ref.api.SamplerConfig(params=ref.kpgm.KPGMParams(jnp.asarray(th)), **kw))
    params, _ = interop.kpgm_from_reference(th, np.zeros(2))
    return rs, KPGMSampler(SamplerConfig(params=params, device="cpu", **kw))


def _same_samples(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert np.array_equal(w.edges, g.edges) and w.edges.dtype == g.edges.dtype
        assert (w.stats is None) == (g.stats is None)
        assert w.stats is None or tuple(w.stats) == tuple(g.stats)
        assert (w.key is None) == (g.key is None)
        assert w.key is None or np.array_equal(np.asarray(w.key).astype(np.int64), g.key.numpy())


def _same_chunks(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape and np.array_equal(a, b)


# --- the chunking helpers ---


@pytest.mark.parametrize("chunk", [1, 3, 4, 7, 1000])
def test_rechunk_edges_matches_reference(ref, chunk):
    pieces = [np.arange(6).reshape(3, 2), np.zeros((0, 2), np.int64), np.arange(8).reshape(4, 2) + 100, [[7, 9]]]
    want, got = list(ref.dedup.rechunk_edges(pieces, chunk)), list(dedup.rechunk_edges(pieces, chunk))
    _same_chunks(want, got)
    assert all(c.dtype == np.int64 for c in got)
    with pytest.raises(ValueError):
        list(dedup.rechunk_edges(pieces, 0))


@pytest.mark.parametrize("chunk", [1000, 1 << 15, (1 << 15) + 1, 100_000])
def test_iter_edge_chunks_matches_reference(ref, chunk):
    """Kept rows of a candidate buffer longer than the reference's 2^15
    window, then the tail, at chunk sizes across the window."""
    rng = np.random.default_rng(chunk)
    n = 90_001
    src = rng.integers(0, 1 << 20, n).astype(np.int32)
    dst = rng.integers(0, 1 << 20, n).astype(np.int32)
    keep = rng.random(n) < 0.7
    keep[40_000:75_000] = False  # a window with nothing kept
    tail = [rng.integers(0, 99, (5, 2)), rng.integers(0, 99, (0, 2)), rng.integers(0, 99, (3, 2))]
    want = list(ref.dedup.iter_edge_chunks(src, dst, keep, chunk, tail=tail))
    got = list(dedup.iter_edge_chunks(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(keep), chunk, tail=tail))
    _same_chunks(want, got)


# --- fused quilting batches ---


def _same_runs(want, got):
    assert got.num_samples == want.num_samples
    assert np.array_equal(want.targets, got.targets) and np.array_equal(want.counts, got.counts)
    wp, gp = want.edges_per_sample(), got.edges_per_sample()
    _same_chunks(wp, gp)
    sizes = [e.shape[0] for e in gp]
    assert [tuple(s) for s in want.stats_per_sample(sizes)] == [tuple(s) for s in got.stats_per_sample(sizes)]
    assert np.array_equal(want.edges(), got.edges())


def _fallbacks(ref):
    return ref.quilt.DISPATCH_COUNTERS["exact_fallbacks"], quilt.DISPATCH_COUNTERS["exact_fallbacks"]


@pytest.mark.parametrize("S", [2, 4])
def test_fused_batch_exact_matches_reference(ref, S):
    rs, ps = _magm(ref)
    rkey, pkey = _keys(20 + S)
    before = _fallbacks(ref)
    want, got = ref.quilt.quilt_run(rkey, rs.plan, num_samples=S), quilt.quilt_run(pkey, ps.plan, num_samples=S)
    _same_runs(want, got)
    assert _fallbacks(ref) == before
    assert got.targets.size == S * ps.plan.num_graphs and all(e.shape[0] for e in got.edges_per_sample())


@pytest.mark.parametrize("S", [2, 4])
def test_fused_batch_ranked_matches_reference(ref, monkeypatch, S):
    """S x B^2 x budget over the cap turns the exact round off (counted in
    exact_fallbacks); backend="device" keeps the fused ranked rounds on the
    device, where every graph meets its drawn target."""
    rs, ps = _magm(ref)
    budget = quilt._exact_budget(ps.plan.p_max, ps.plan.mean_edges)
    cap = S * ps.plan.num_graphs * budget - 1
    monkeypatch.setattr(ref.kpgm, "DEVICE_MAX_CANDIDATES", cap)
    monkeypatch.setattr(kpgm, "DEVICE_MAX_CANDIDATES", cap)
    rkey, pkey = _keys(30 + S)
    before = _fallbacks(ref)
    want = ref.quilt.quilt_run(rkey, rs.plan, num_samples=S, backend="device")
    got = quilt.quilt_run(pkey, ps.plan, num_samples=S, backend="device")
    _same_runs(want, got)
    assert _fallbacks(ref) == (before[0] + 1, before[1] + 1)
    assert np.array_equal(got.counts, got.targets)


def test_fused_batch_host_topup_matches_reference(ref):
    """One ranked round without oversampling leaves graphs with targets
    of 4 x E|E| short: the host top-up finishes them, decoding graph
    s * B^2 + g' to block pair g' (its tail pieces go back to their own
    sample)."""
    rs, ps = _magm(ref)
    targets = np.full(2 * ps.plan.num_graphs, 4 * int(ps.plan.mean_edges))
    rkey, pkey = _keys(35)
    kw = dict(num_samples=2, targets=targets, backend="device", max_rounds=1, oversample=1.0)
    with pytest.warns(RuntimeWarning, match="host rejection loop"):
        want = ref.quilt.quilt_run(rkey, rs.plan, **kw)
    with pytest.warns(RuntimeWarning, match="host rejection loop"):
        got = quilt.quilt_run(pkey, ps.plan, **kw)
    assert got.tail and max(g for g, _ in got.tail) >= ps.plan.num_graphs
    _same_runs(want, got)


def test_fused_batch_on_the_host_backend_raises(ref):
    rs, ps = _magm(ref)
    rkey, pkey = _keys(40)
    with pytest.raises(ref.quilt.DeviceBatchUnavailable):
        ref.quilt.quilt_run(rkey, rs.plan, num_samples=2, backend="host")
    with pytest.raises(quilt.DeviceBatchUnavailable):
        quilt.quilt_run(pkey, ps.plan, num_samples=2, backend="host")


# --- the sessions ---


@pytest.mark.parametrize("kw", [{}, {"backend": "host"}, {"split": True}], ids=["fused", "host_loop", "split"])
def test_magm_sample_batch_matches_reference(ref, kw):
    rs, ps = _magm(ref, **kw)
    rkey, pkey = _keys(50)
    _same_samples(rs.sample_batch(3, rkey), ps.sample_batch(3, pkey))
    assert ps.sample_batch(0, pkey) == []


@pytest.mark.parametrize("chunk", [100, 1000])
@pytest.mark.parametrize("kw", [{}, {"backend": "host"}, {"split": True}], ids=["exact", "host", "split"])
def test_magm_sample_stream_matches_reference(ref, chunk, kw):
    rs, ps = _magm(ref, **kw)
    rkey, pkey = _keys(60)
    want, got = list(rs.sample_stream(rkey, chunk_edges=chunk)), list(ps.sample_stream(pkey, chunk_edges=chunk))
    _same_chunks(want, got)
    assert np.array_equal(np.concatenate(got), ps.sample(pkey).edges)
    assert all(c.shape[0] == chunk for c in got[:-1])


def test_kpgm_sample_batch_matches_reference(ref):
    for kw in ({}, {"backend": "host"}):
        rs, ps = _kpgm(ref, **kw)
        rkey, pkey = _keys(70)
        want, got = rs.sample_batch(3, rkey), ps.sample_batch(3, pkey)
        _same_samples(want, got)
        if not kw:  # fused: every member meets its own drawn target
            assert all(g.stats.sampled_edges == g.stats.target_edges for g in got)


@pytest.mark.parametrize("session", ["kpgm", "magm"])
def test_sample_batch_of_one_on_the_engine_host_path_matches_reference(ref, monkeypatch, session):
    """A one-sample batch whose first ask passes the candidate cap takes
    the engine's host path (S = 1 does not raise): its run reports the
    engine's own target draw and zero device counts, as the reference's
    does, so the members' stats agree."""
    monkeypatch.setattr(ref.kpgm, "DEVICE_MAX_CANDIDATES", 16)
    monkeypatch.setattr(kpgm, "DEVICE_MAX_CANDIDATES", 16)
    rs, ps = _kpgm(ref) if session == "kpgm" else _magm(ref)
    rkey, pkey = _keys(75)
    want = ref.quilt.quilt_run(rkey, rs.plan, exact_cells=False)
    got = quilt.quilt_run(pkey, ps.plan, exact_cells=False)
    assert got.host_edges is not None and want.host_edges is not None
    _same_runs(want, got)
    assert not got.counts.any()
    _same_samples(rs.sample_batch(1, rkey), ps.sample_batch(1, pkey))


@pytest.mark.parametrize("num_edges", [None, 777])
def test_kpgm_sample_stream_matches_reference(ref, num_edges):
    for kw in ({}, {"backend": "host"}):
        rs, ps = _kpgm(ref, **kw)
        rkey, pkey = _keys(80)
        want = list(rs.sample_stream(rkey, chunk_edges=300, num_edges=num_edges))
        got = list(ps.sample_stream(pkey, chunk_edges=300, num_edges=num_edges))
        _same_chunks(want, got)
        edges = np.concatenate(got)
        assert np.array_equal(edges, ps.sample(pkey, num_edges=num_edges).edges)
        if num_edges is not None:
            assert edges.shape[0] == num_edges


def test_empty_attributes_yield_nothing(ref):
    p = ref.magm.make_params(magm_paper.THETA_1, 0.5, 4)
    rs = ref.api.MAGMSampler(ref.api.SamplerConfig(params=p, F=np.zeros((0, 4), np.int8)))
    params, F, _ = interop.from_reference(np.asarray(p.thetas), np.zeros((0, 4), np.int8), np.zeros(2), np.asarray(p.mu))
    for split in (False, True):
        ps = MAGMSampler(SamplerConfig(params=params, F=F, split=split, device="cpu"))
        rkey, pkey = _keys(90)
        assert list(ps.sample_stream(pkey)) == [] == list(rs.sample_stream(rkey))
        _same_samples(rs.sample_batch(2, rkey), ps.sample_batch(2, pkey))


@pytest.mark.cuda
def test_batches_and_streams_card_match_cpu(cuda_device):
    th = np.broadcast_to(np.asarray(magm_paper.THETA_1, np.float32), (LG, 2, 2)).copy()
    params, key = interop.kpgm_from_reference(th, np.array([0, 5]))
    for cls, p in ((KPGMSampler, params), (MAGMSampler, None)):
        if p is None:
            from repro_torch.core import magm

            p = magm.make_params(magm_paper.THETA_1, 0.5, LG)
            cfg = SamplerConfig(params=p, num_nodes=1 << LG)
        else:
            cfg = SamplerConfig(params=p)
        cpu, card = cls(cfg.replace(device="cpu")), cls(cfg.replace(device=cuda_device))
        want, got = cpu.sample_batch(4, key), card.sample_batch(4, key)
        assert all(np.array_equal(w.edges, g.edges) for w, g in zip(want, got))
        assert all(np.array_equal(a, b) for a, b in zip(cpu.sample_stream(key, chunk_edges=999), card.sample_stream(key, chunk_edges=999)))
