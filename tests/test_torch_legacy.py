"""The legacy ranked rounds and the host fallback of the quilting engine,
port against reference on the same attributes and key: the ranked device
rounds (``exact_cells=False``, explicit targets) with their top-ups, the
host backend, and the whole fallback chain.

Every comparison is bit equality of the edge arrays and the stats.  To
force the fallbacks at test sizes, ``DEVICE_MAX_CANDIDATES`` is lowered in
both packages' ``kpgm`` modules for the duration of a test (monkeypatch;
nothing in the reference is edited).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch import interop
from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.configs import magm_paper
from repro_torch.core import dedup, kpgm, magm, partition, prng, quilt


@pytest.fixture(autouse=True)
def _restore_dispatch_counters():
    """The engine's dispatch counters are process-wide: put them back after
    each test, so files that run later in the same worker see none of this
    file's fallbacks."""
    saved = dict(quilt.DISPATCH_COUNTERS)
    yield
    quilt.DISPATCH_COUNTERS.update(saved)


def _pair(ref, theta, mu, lg, **kw):
    """Reference and port sessions over the reference's attributes."""
    p = ref.magm.make_params(theta, mu, lg)
    rs = ref.api.MAGMSampler(ref.api.SamplerConfig(params=p, num_nodes=1 << lg, **kw))
    params, F, _ = interop.from_reference(np.asarray(p.thetas), rs.F, np.zeros(2), np.asarray(p.mu))
    ps = MAGMSampler(SamplerConfig(params=params, F=F, device="cpu", **kw))
    return rs, ps


def _counters(counters: dict) -> dict:
    return {k: counters[k] for k in quilt.ROUND_COUNTERS}


def _same_sample(ref, rs, ps, seed):
    import jax

    before_ref, before = _counters(ref.quilt.DISPATCH_COUNTERS), _counters(quilt.DISPATCH_COUNTERS)
    want = rs.sample(jax.random.PRNGKey(seed))
    got = ps.sample(prng.PRNGKey(seed))
    assert got.edges.dtype == want.edges.dtype
    assert np.array_equal(want.edges, got.edges)
    assert tuple(want.stats) == tuple(got.stats)
    assert got.stats.kept_edges == got.num_edges
    delta_ref = {k: v - before_ref[k] for k, v in _counters(ref.quilt.DISPATCH_COUNTERS).items()}
    delta = {k: v - before[k] for k, v in _counters(quilt.DISPATCH_COUNTERS).items()}
    assert delta == delta_ref
    return got, delta


# --- host helpers ---


def test_bucket_size_plan_asks_uniform_ask_match_reference(ref):
    rng = np.random.default_rng(0)
    xs = list(range(0, 300)) + [int(x) for x in np.geomspace(300, 2**40, 300)]
    for tile in (1, 8, 512):
        assert [dedup.bucket_size(x, tile) for x in xs] == [ref.dedup.bucket_size(x, tile) for x in xs]
    for _ in range(50):
        needs = rng.integers(-5, 100_000, rng.integers(1, 90))
        needs[rng.random(needs.size) < 0.2] = 0
        for over in (1.0, 1.05, 1.1):
            a, n = dedup.plan_asks(needs, over)
            ra, rn = ref.dedup.plan_asks(needs, over)
            assert n == rn and np.array_equal(a, ra) and a.sum() == n
            assert dedup.uniform_ask(needs, over) == ref.dedup.uniform_ask(needs, over)
    assert dedup.plan_asks(np.zeros(3, np.int64), 1.05)[1] == 0


def test_dedup_edges_lookup_nodes_attributes_match_reference(ref):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    e = rng.integers(0, 40, (500, 2))
    assert np.array_equal(dedup.dedup_edges(e), ref.dedup.dedup_edges(e))
    assert dedup.dedup_edges(np.empty((0, 2))).shape == (0, 2)
    lam = rng.integers(0, 1 << 9, 800)
    part = ref.partition.build_partition(lam)
    cfgs = rng.integers(0, 1 << 9, 3000)
    for b in range(part.B):
        want = ref.partition.lookup_nodes(part.sorted_configs[b], part.sorted_nodes[b], cfgs)
        got = partition.lookup_nodes(part.sorted_configs[b], part.sorted_nodes[b], cfgs)
        assert got.dtype == want.dtype and np.array_equal(want, got)
    empty = np.zeros(0, np.int64)
    assert (partition.lookup_nodes(empty, empty, cfgs[:5]) == -1).all()
    want = np.asarray(ref.magm.attributes_from_configs(jnp.asarray(lam), 9))
    got = magm.attributes_from_configs(torch.from_numpy(lam), 9)
    assert got.dtype == torch.int8 and np.array_equal(want, got.numpy())
    assert torch.equal(magm.configs_from_attributes(got), torch.from_numpy(lam).int())


# --- ranked device rounds ---


CASES = [("THETA_1", 0.5, 8), ("THETA_1", 0.5, 11), ("THETA_2", 0.5, 10), ("THETA_1", 0.6, 10)]


@pytest.mark.parametrize("theta, mu, lg", CASES, ids=[f"{t}-mu{m}-n2^{g}" for t, m, g in CASES])
def test_ranked_rounds_match_reference(ref, theta, mu, lg):
    rs, ps = _pair(ref, getattr(magm_paper, theta), mu, lg, exact_cells=False)
    got, delta = _same_sample(ref, rs, ps, seed=lg)
    assert delta["device_rounds"] == 1 and delta["exact_fallbacks"] == 0
    assert got.stats.kpgm_edges_total > got.num_edges > 0


def _same_run(ref, rs, ps, seed, targets, **kw):
    """quilt_run of both engines with explicit targets: edges, targets,
    counts, stats and the dispatch counters' changes equal."""
    import jax

    before_ref, before = _counters(ref.quilt.DISPATCH_COUNTERS), _counters(quilt.DISPATCH_COUNTERS)
    want = ref.quilt.quilt_run(jax.random.PRNGKey(seed), rs.plan, targets=targets, **kw)
    got = quilt.quilt_run(prng.PRNGKey(seed), ps.plan, targets=targets, **kw)
    assert np.array_equal(want.edges(), got.edges())
    assert np.array_equal(want.targets, got.targets) and np.array_equal(want.counts, got.counts)
    assert tuple(want.stats()) == tuple(got.stats()) and got.slots_per_graph == want.slots_per_graph
    delta_ref = {k: v - before_ref[k] for k, v in _counters(ref.quilt.DISPATCH_COUNTERS).items()}
    delta = {k: v - before[k] for k, v in _counters(quilt.DISPATCH_COUNTERS).items()}
    assert delta == delta_ref
    return got, delta


# 10,000 of the 65,536 cells of each of the 25 graphs at n = 2^8 (THETA_2):
# dense enough that duplicates leave the first ranked round short
_DENSE = 10_000


def test_ranked_topup_rounds_match_reference(ref):
    """The cumulative-slot top-up rounds re-derive the first round as a
    prefix and extend it until every target is met."""
    rs, ps = _pair(ref, magm_paper.THETA_2, 0.5, 8)
    got, delta = _same_run(ref, rs, ps, 1, np.full(ps.plan.num_graphs, _DENSE))
    assert delta["device_topup_rounds"] >= 1 and delta["degraded_fallbacks"] == 0
    assert (got.counts == _DENSE).all()


def test_ranked_rounds_exhausted_finish_on_host(ref):
    """max_rounds = 1: the residual goes to the host top-up loop (lookups
    through quilt_descent_lookup, the pieces in the run's tail), with a
    warning.  Its dedup time counts in kpgm.HOST_DEDUP_SECONDS."""
    rs, ps = _pair(ref, magm_paper.THETA_2, 0.5, 8)
    dedup_s = kpgm.HOST_DEDUP_SECONDS
    with pytest.warns(RuntimeWarning, match="device rounds exhausted"):
        got, delta = _same_run(ref, rs, ps, 1, np.full(ps.plan.num_graphs, _DENSE), max_rounds=1)
    assert delta["degraded_fallbacks"] == 1 and delta["host_topup_rounds"] >= 1
    assert kpgm.HOST_DEDUP_SECONDS > dedup_s
    assert len(got.tail) > 0 and got.kept_edges() == got.edges().shape[0]


def test_ranked_rounds_stop_at_the_cap_and_finish_on_host(ref, monkeypatch):
    """The cumulative slot stream would pass DEVICE_MAX_CANDIDATES in the
    second round (25 graphs x 22,528 slots fit 600,000, the next ask does
    not): the host loop finishes the residual."""
    monkeypatch.setattr(ref.kpgm, "DEVICE_MAX_CANDIDATES", 600_000)
    monkeypatch.setattr(kpgm, "DEVICE_MAX_CANDIDATES", 600_000)
    rs, ps = _pair(ref, magm_paper.THETA_2, 0.5, 8)
    with pytest.warns(RuntimeWarning, match="device rounds exhausted"):
        got, delta = _same_run(ref, rs, ps, 1, np.full(ps.plan.num_graphs, 2 * _DENSE))
    assert delta["device_rounds"] == 1 and delta["device_topup_rounds"] == 0
    assert delta["host_topup_rounds"] >= 1 and got.slots_per_graph == 22_528


@pytest.mark.parametrize("kind", ["drawn-scale", "sparse", "zeros"])
def test_explicit_targets_match_reference(ref, kind):
    import jax

    rs, ps = _pair(ref, magm_paper.THETA_2, 0.5, 9)
    rng = np.random.default_rng(2)
    G = ps.plan.num_graphs
    targets = {
        "drawn-scale": rng.integers(0, 2 * int(ps.plan.mean_edges), G),
        "sparse": np.where(rng.random(G) < 0.3, rng.integers(1, 50, G), 0),
        "zeros": np.zeros(G, np.int64),
    }[kind]
    want = ref.quilt.quilt_run(jax.random.PRNGKey(9), rs.plan, targets=targets)
    got = quilt.quilt_run(prng.PRNGKey(9), ps.plan, targets=targets)
    assert np.array_equal(want.edges(), got.edges())
    assert np.array_equal(want.targets, got.targets) and np.array_equal(want.counts, got.counts)
    assert tuple(want.stats()) == tuple(got.stats())
    assert (got.counts <= got.targets).all()


def test_explicit_targets_over_cap_raise_like_reference(ref, monkeypatch):
    import jax

    monkeypatch.setattr(ref.kpgm, "DEVICE_MAX_CANDIDATES", 1 << 12)
    monkeypatch.setattr(kpgm, "DEVICE_MAX_CANDIDATES", 1 << 12)
    rs, ps = _pair(ref, magm_paper.THETA_1, 0.5, 9)
    targets = np.full(ps.plan.num_graphs, 2000)
    with pytest.raises(ref.quilt.DeviceBatchUnavailable):
        ref.quilt.quilt_run(jax.random.PRNGKey(1), rs.plan, targets=targets)
    with pytest.raises(quilt.DeviceBatchUnavailable, match="targets override"):
        quilt.quilt_run(prng.PRNGKey(1), ps.plan, targets=targets)


# --- the host backend and the fallback chain ---


@pytest.mark.parametrize(
    "theta, lg, kw",
    [
        ("THETA_1", 8, {}),
        ("THETA_2", 10, {}),
        ("THETA_1", 10, {"oversample": 1.0, "max_rounds": 2}),
    ],
    ids=["n2^8", "n2^10", "n2^10-short"],
)
def test_host_backend_matches_reference(ref, theta, lg, kw):
    """backend="host": kpgm_sample_many's shared device round (its lookups
    through quilt_descent_lookup) and host top-up for all B^2 graphs."""
    rs, ps = _pair(ref, getattr(magm_paper, theta), 0.5, lg, backend="host", **kw)
    got, delta = _same_sample(ref, rs, ps, seed=lg + 1)
    assert delta["device_rounds"] == 0 and got.num_edges > 0
    assert got.stats.num_kpgm_draws == ps.plan.B**2


@pytest.mark.parametrize("lg, cap_log2", [(9, 12), (10, 14)], ids=["n2^9", "n2^10"])
def test_fallback_chain_matches_reference(ref, monkeypatch, lg, cap_log2):
    """The default session over a lowered cap, as it runs at n >= 2^16 under
    the real one: the exact round is refused (exact_fallbacks), the ranked
    round is over the cap too (its first ask exceeds the exact budget), and
    the host path samples the graph."""
    monkeypatch.setattr(ref.kpgm, "DEVICE_MAX_CANDIDATES", 1 << cap_log2)
    monkeypatch.setattr(kpgm, "DEVICE_MAX_CANDIDATES", 1 << cap_log2)
    rs, ps = _pair(ref, magm_paper.THETA_1, 0.5, lg)
    got, delta = _same_sample(ref, rs, ps, seed=1)
    assert delta["exact_fallbacks"] == 1
    assert delta["device_rounds"] == 0 and delta["host_topup_rounds"] == 0
    n = 1 << lg
    assert np.unique(got.edges[:, 0] * n + got.edges[:, 1]).size == got.num_edges > 0


def test_device_backend_forces_device_rounds(ref, monkeypatch):
    monkeypatch.setattr(ref.kpgm, "DEVICE_MAX_CANDIDATES", 1 << 12)
    monkeypatch.setattr(kpgm, "DEVICE_MAX_CANDIDATES", 1 << 12)
    rs, ps = _pair(ref, magm_paper.THETA_1, 0.5, 9, backend="device", exact_cells=False)
    _, delta = _same_sample(ref, rs, ps, seed=2)
    assert delta["device_rounds"] == 1


def test_plain_lookup_ranked_and_host_runs():
    """use_kernel=False (the plain lookup of the device rounds) gives the
    same edges; a host run reports its own stats."""
    p = magm.make_params(magm_paper.THETA_1, 0.5, 9)
    base = SamplerConfig(params=p, num_nodes=512, device="cpu", exact_cells=False)
    a = MAGMSampler(base).sample(prng.PRNGKey(4))
    b = MAGMSampler(base.replace(use_kernel=False)).sample(prng.PRNGKey(4))
    assert np.array_equal(a.edges, b.edges)
    s = MAGMSampler(base.replace(backend="host"))
    run = quilt.quilt_run(prng.PRNGKey(4), s.plan, backend="host")
    assert run.host_edges is not None and run.kept_edges() == run.edges().shape[0]
    assert run.stats() == run.host_stats and run.snode is None
    # a host run reports the engine's target draw and no device counts, as
    # the reference's does; the host path's own per-graph targets (it gets
    # the key's first split) are all met here and add up to its stats
    assert not run.counts.any() and run.targets.size == s.plan.num_graphs
    edges, st, targets, counts = quilt._quilt_sample_host(
        prng.split(prng.PRNGKey(4))[0], s.plan, max_rounds=8, oversample=1.05
    )
    assert np.array_equal(edges, run.edges()) and st == run.stats()
    assert np.array_equal(counts, targets) and counts.sum() == run.stats().kpgm_edges_total
