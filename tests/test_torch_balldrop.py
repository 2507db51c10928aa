"""The ball-dropping backend, port against reference on the same attributes
and key: the Kronecker moments, the plan's ball-dropping fields,
``prng.randint``, ``balldrop_run`` in every mode and lookup arm, the host
loop and top-up, the per-sample splits, and the sessions.

Every engine comparison is bit equality of the edge arrays.  The reference
runs its default lookup on the CPU (the dense inverse); the port's three
arms must each give the same edges.  To force the fallbacks at test sizes,
``DEVICE_MAX_CANDIDATES`` is lowered in both packages' ``kpgm`` modules
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
from repro_torch.core import balldrop, kpgm, kron, magm, prng, quilt
from repro_torch.kernels import ops
from repro_torch.kernels import quadrant_descent as qd

LG = 10


@pytest.fixture(autouse=True)
def _restore_dispatch_counters():
    """The dispatch counters are process-wide: put them back after each
    test."""
    saved = dict(balldrop.DISPATCH_COUNTERS)
    yield
    balldrop.DISPATCH_COUNTERS.update(saved)


@pytest.fixture(scope="module")
def bd_ref(ref):
    import importlib

    return importlib.import_module("repro.core.balldrop"), importlib.import_module("repro.core.kron")


def _plans(ref, theta=magm_paper.THETA_2, mu=0.5, lg=LG, seed=1):
    """Reference and port plans over the reference's attributes."""
    import jax

    p = ref.magm.make_params(theta, mu, lg)
    F = np.asarray(ref.magm.sample_attributes(jax.random.PRNGKey(seed), 1 << lg, p.mu))
    params = interop.from_reference(np.asarray(p.thetas), F, np.zeros(2), np.asarray(p.mu))[0]
    return ref.quilt.build_quilt_plan(F, p.thetas), quilt.build_quilt_plan(F, params.thetas, device="cpu")


@pytest.fixture(scope="module")
def plans(ref):
    return _plans(ref)


def _same_run(want, got):
    assert np.array_equal(want.edges(), got.edges())
    assert np.array_equal(want.counts, got.counts) and np.array_equal(want.targets, got.targets)
    assert want.slots_per_graph == got.slots_per_graph and got.sampler == "balldrop"
    assert tuple(want.stats()) == tuple(got.stats())


# --- the Kronecker moments ---


def test_kron_matches_reference(bd_ref):
    _, rkron = bd_ref
    rng = np.random.default_rng(0)
    assert kron.MOMENT_CAP == rkron.MOMENT_CAP
    for d in (1, 5, 9):
        th = rng.uniform(0.05, 1.0, (d, 2, 2)).astype(np.float32)
        v = rng.normal(size=1 << d)
        for name in ("kron_matvec", "kron_rmatvec"):
            assert np.array_equal(getattr(kron, name)(th, v), getattr(rkron, name)(th, v))
        assert np.array_equal(kron.kron_diag(th), rkron.kron_diag(th))
        c = rng.integers(0, 5, 1 << d)
        assert kron.edge_count_moments(c, th) == rkron.edge_count_moments(c, th)
    for args in ((100.0, 3, 50.0), (1.0, 1, 4.0), (5.0, 2, 0.0)):
        assert kron.balldrop_cost_factor(*args) == rkron.balldrop_cost_factor(*args)


def test_kron_matvec_matches_dense():
    rng = np.random.default_rng(1)
    th = rng.uniform(0.1, 0.9, (5, 2, 2))
    P = np.ones((1, 1))
    for t in th:
        P = np.kron(P, t)
    v = rng.normal(size=32)
    np.testing.assert_allclose(kron.kron_matvec(th, v), P @ v, rtol=1e-12)
    np.testing.assert_allclose(kron.kron_rmatvec(th, v), P.T @ v, rtol=1e-12)
    np.testing.assert_allclose(kron.kron_diag(th), np.diag(P), rtol=1e-12)


# --- the plan's ball-dropping fields ---


def _same_bd_fields(rp, pp):
    assert (pp.bd_mean, pp.bd_std, pp.bd_cost) == (rp.bd_mean, rp.bd_std, rp.bd_cost)
    for name in ("inv", "cfg_offset", "cfg_count", "cfg_nodes"):
        r, p = getattr(rp, name), getattr(pp, name)
        assert (r is None) == (p is None), name
        if p is not None:
            assert p.dtype == torch.int32 and np.array_equal(np.asarray(r), p.numpy()), name
    assert np.array_equal(
        kron.config_multiplicities(pp.part, pp.d), kron.config_multiplicities(rp.part, rp.d)
    )


@pytest.mark.parametrize(
    "theta, mu, lg", [("THETA_1", 0.5, 9), ("THETA_2", 0.5, 10), ("THETA_2", 0.8, 8)],
    ids=["theta1-n512", "theta2-n1024", "theta2-mu0.8"],
)
def test_plan_balldrop_fields_match_reference(ref, theta, mu, lg):
    rp, pp = _plans(ref, getattr(magm_paper, theta), mu, lg)
    assert quilt.DENSE_INV_CAP == ref.quilt.DENSE_INV_CAP
    _same_bd_fields(rp, pp)


def test_plan_size_gates_match_reference(ref, monkeypatch):
    """Past DENSE_INV_CAP the dense inverse is not built, and past half of
    it not the by-config tables either."""
    for cap in (1 << 11, 1 << 9):
        monkeypatch.setattr(ref.quilt, "DENSE_INV_CAP", cap)
        monkeypatch.setattr(quilt, "DENSE_INV_CAP", cap)
        ref.quilt.clear_plan_cache()
        quilt.clear_plan_cache()
        rp, pp = _plans(ref, lg=9, seed=cap)
        assert pp.inv is None and (pp.cfg_offset is None) == (cap < 1 << 10)
        _same_bd_fields(rp, pp)


@pytest.mark.parametrize("d", [4, 9])
def test_kpgm_plan_balldrop_fields_match_reference(ref, d):
    import jax.numpy as jnp

    th = np.random.default_rng(d).uniform(0.05, 1.0, (d, 2, 2)).astype(np.float32)
    _same_bd_fields(ref.quilt.build_kpgm_plan(jnp.asarray(th)), quilt.build_kpgm_plan(torch.from_numpy(th), device="cpu"))


# --- prng.randint ---


@pytest.mark.parametrize("lo, hi", [(0, 1), (0, 8), (0, 7), (0, 1000), (-3, 65_537), (0, 2**31 - 1), (5, 5)])
def test_randint_matches_reference(lo, hi):
    import jax
    import jax.numpy as jnp

    for seed in (0, 17):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (999, 2), lo, hi, dtype=jnp.int32))
        got = prng.randint(prng.PRNGKey(seed), (999, 2), lo, hi)
        assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())


def test_randint_rejects_bounds_past_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.PRNGKey(0), (4,), 0, 2**31)


# --- balldrop_run ---


def _arm_plan(pp, arm):
    """The port's plan and use_kernel for a lookup arm."""
    if arm == "kernel":
        return pp, None
    if arm == "inverse":
        return pp, False
    return pp._replace(inv=None), False


def _mode_kwargs(mode, S):
    if mode == "targets":
        return {"targets": np.random.default_rng(S).integers(0, 6000, S)}
    return {"exact_cells": False} if mode == "ranked" else {}


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("arm", ["kernel", "inverse", "bycfg"])
@pytest.mark.parametrize("mode", ["exact", "targets", "ranked"])
def test_balldrop_run_matches_reference(ref, bd_ref, plans, mode, arm, S):
    import jax

    rbd, _ = bd_ref
    rp, pp = plans
    kw = _mode_kwargs(mode, S)
    plan, use_kernel = _arm_plan(pp, arm)
    before, before_ref = dict(balldrop.DISPATCH_COUNTERS), dict(rbd.DISPATCH_COUNTERS)
    want = rbd.balldrop_run(jax.random.PRNGKey(3 + S), rp, num_samples=S, **kw)
    got = balldrop.balldrop_run(prng.PRNGKey(3 + S), plan, num_samples=S, use_kernel=use_kernel, **kw)
    _same_run(want, got)
    assert got.num_samples == S and got.kept_edges() == got.counts.sum() > 0
    for k, v in balldrop.DISPATCH_COUNTERS.items():
        assert v - before[k] == rbd.DISPATCH_COUNTERS[k] - before_ref[k], k
    for w, g in zip(want.edges_per_sample(), got.edges_per_sample()):
        assert np.array_equal(w, g)
    sizes = [e.shape[0] for e in got.edges_per_sample()]
    assert [tuple(s) for s in got.stats_per_sample(sizes)] == [tuple(s) for s in want.stats_per_sample(sizes)]


def test_balldrop_exact_round_is_the_plan_constant_budget(plans):
    _, pp = plans
    budget = quilt._exact_budget(pp.p_max, pp.mean_edges * float(pp.B) ** 2)
    run = balldrop.balldrop_run(prng.PRNGKey(0), pp)
    assert run.slots_per_graph == budget and np.array_equal(run.targets, run.counts)
    e = run.edges()
    assert np.unique(e[:, 0] * pp.n + e[:, 1]).size == e.shape[0] == run.counts[0]


def test_balldrop_host_topup_matches_reference(ref, bd_ref, plans):
    """One ranked round at oversample 1 falls short: the host top-up
    finishes, with the same warning and counters as the reference."""
    import jax

    rbd, _ = bd_ref
    rp, pp = plans
    kw = dict(num_samples=2, exact_cells=False, max_rounds=1, oversample=1.0)
    with pytest.warns(RuntimeWarning, match="device rounds exhausted"):
        want = rbd.balldrop_run(jax.random.PRNGKey(8), rp, **kw)
    before = dict(balldrop.DISPATCH_COUNTERS)
    with pytest.warns(RuntimeWarning, match="device rounds exhausted"):
        got = balldrop.balldrop_run(prng.PRNGKey(8), pp, **kw)
    assert balldrop.DISPATCH_COUNTERS["degraded_fallbacks"] == before["degraded_fallbacks"] + 1
    assert balldrop.DISPATCH_COUNTERS["host_topup_rounds"] > before["host_topup_rounds"]
    assert got.tail
    _same_run(want, got)


def test_balldrop_fallbacks_past_device_cap_match_reference(ref, bd_ref, plans, monkeypatch):
    """With the device budget below the exact budget and the first ask,
    one sample takes the host loop and several raise."""
    import jax

    rbd, _ = bd_ref
    rp, pp = plans
    monkeypatch.setattr(ref.kpgm, "DEVICE_MAX_CANDIDATES", 1 << 14)
    monkeypatch.setattr(kpgm, "DEVICE_MAX_CANDIDATES", 1 << 14)
    want = rbd.balldrop_run(jax.random.PRNGKey(9), rp)
    before = dict(balldrop.DISPATCH_COUNTERS)
    got = balldrop.balldrop_run(prng.PRNGKey(9), pp)
    assert balldrop.DISPATCH_COUNTERS["exact_fallbacks"] == before["exact_fallbacks"] + 1
    assert got.host_edges is not None and got.edges().shape[0] == got.targets[0]
    _same_run(want, got)
    with pytest.raises(quilt.DeviceBatchUnavailable):
        balldrop.balldrop_run(prng.PRNGKey(9), pp, num_samples=3)


@pytest.mark.parametrize("target", [1, 3000, 20_000])
def test_balldrop_sample_host_matches_reference(ref, bd_ref, plans, target):
    import jax

    rbd, _ = bd_ref
    rp, pp = plans
    kw = dict(target=target, max_rounds=2, oversample=1.05)
    want = rbd._balldrop_sample_host(jax.random.PRNGKey(5), rp, **kw)
    got = balldrop._balldrop_sample_host(prng.PRNGKey(5), pp, **kw)
    assert got.dtype == np.int64 and np.array_equal(want, got)


def _paper_plan(lg, device="cpu"):
    """The plan of the default session at the paper's setting (THETA_1,
    mu = 0.5, d = lg), attributes from key 0."""
    params = magm.make_params(magm_paper.THETA_1, magm_paper.DEFAULT_MU, lg)
    cfg = SamplerConfig(params=params, num_nodes=1 << lg, attribute_key=prng.PRNGKey(0), device=device)
    return MAGMSampler(cfg).plan


@pytest.mark.parametrize("lg", [12, 16])
def test_dense_inverse_equals_table_lookup(lg):
    """The precondition of quilt_descent_lookup's inverse arm: for every
    block b in [-1, B] and every config x in [0, 2^d), inv[b, x] (-1 for b
    outside [0, B)) equals the plain version's sorted-table lookup."""
    plan = _paper_plan(lg)
    x = torch.arange(1 << plan.d, dtype=torch.int64)
    for b in range(-1, plan.B + 1):
        want = qd._lookup(plan.table_cfg, plan.table_node, torch.full_like(x, b), x)
        got = plan.inv[b] if 0 <= b < plan.B else torch.full_like(want, -1)
        assert torch.equal(got, want), b
    assert torch.equal(plan.inv[plan.inv >= 0].sort().values, torch.arange(plan.n, dtype=torch.int32))


@pytest.mark.parametrize("lg", [12, 16])
def test_plan_cum_is_the_edge_batch_table(lg):
    """The host loop descends with plan.cum where the reference's proposal
    step calls sample_edge_batch: the two level tables are equal bit for
    bit, and so are the descents of one draw."""
    plan = _paper_plan(lg)
    table = kpgm._level_cumprobs(torch.as_tensor(plan.thetas, dtype=torch.float32).cpu())
    assert torch.equal(plan.cum.view(torch.int32), table.view(torch.int32))
    key = prng.PRNGKey(lg)
    got = kpgm.descend_draw(key, plan.cum, 5000)
    want = kpgm.sample_edge_batch(key, plan.thetas, 5000, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("chunk_elems", [7 * 11, 1 << 26], ids=["ragged", "whole"])
def test_propose_host_matches_reference(ref, bd_ref, plans, monkeypatch, chunk_elems):
    """One host-loop proposal batch (the threefry descent and the ranks
    through quilt_descent_lookup) against the reference's, which looks the
    blocks up on the host: the accepted node pairs in proposal order, and
    the accepted count before each cut.  Draw chunks of 7 rows end
    mid-batch; quadrant_descent is no longer on this path."""
    import jax

    rbd, _ = bd_ref
    rp, pp = plans

    def _no_descent(*args):
        raise AssertionError("the host loop ran quadrant_descent")

    monkeypatch.setattr(kpgm, "DRAW_CHUNK_ELEMS", chunk_elems)
    monkeypatch.setattr(qd, "quadrant_descent", _no_descent)
    ask = 3001
    sn, dn = rbd._propose_host(jax.random.PRNGKey(12), rp, ask)
    ok = (sn >= 0) & (dn >= 0)
    cuts = np.array([0, 1, 1000, 2999, ask])
    flat, before = balldrop._propose_host(prng.PRNGKey(12), pp, ask, cuts=cuts)
    assert flat.dtype == np.int64 and 0 < flat.size < ask
    assert np.array_equal(flat, sn[ok] * pp.n + dn[ok])
    assert np.array_equal(before, np.concatenate([[0], np.cumsum(ok)])[cuts])


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["inverse", "search"])
def test_cuda_balldrop_sample_host_equals_cpu(cuda_device, arm):
    """The host loop at n = 2^12 on the card (quilt_descent_lookup through
    the dense inverse, or searching the tables) equals the CPU's."""
    plans = [_paper_plan(12, dev) for dev in (cuda_device, "cpu")]
    if arm == "search":
        plans[0] = plans[0]._replace(inv=None)
    kw = dict(target=20_000, max_rounds=4, oversample=1.05)
    launches = ops.kernel_launches()
    got = balldrop._balldrop_sample_host(prng.PRNGKey(5), plans[0], **kw)
    after = ops.kernel_launches()
    want = balldrop._balldrop_sample_host(prng.PRNGKey(5), plans[1], **kw)
    assert np.array_equal(got, want) and got.shape[0] == 20_000
    assert after["quilt_descent_lookup"] > launches["quilt_descent_lookup"]
    assert after["quadrant_descent"] == launches["quadrant_descent"]


def test_balldrop_run_rejects(plans):
    _, pp = plans
    with pytest.raises(ValueError, match="moments"):
        balldrop.balldrop_run(prng.PRNGKey(0), pp._replace(bd_cost=None))
    with pytest.raises(ValueError, match="num_samples"):
        balldrop.balldrop_run(prng.PRNGKey(0), pp, num_samples=0)
    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.release()
    try:  # the dry-run's fake world has no real collectives to shard over
        with pytest.raises(ValueError, match="real process group"):
            balldrop.balldrop_run(prng.PRNGKey(0), pp, mesh=mesh_lib.make_host_mesh())
    finally:
        mesh_lib.release()


def test_quilt_run_dispatches_balldrop(ref, plans):
    _, pp = plans
    key = prng.PRNGKey(12)
    got = quilt.quilt_run(key, pp, backend="balldrop", num_samples=2, exact_cells=False)
    want = balldrop.balldrop_run(key, pp, num_samples=2, exact_cells=False)
    assert np.array_equal(got.edges(), want.edges())


# --- the sessions ---


def test_magm_session_balldrop_matches_reference(ref):
    import jax

    p = ref.magm.make_params(magm_paper.THETA_1, 0.5, LG)
    rs = ref.api.MAGMSampler(ref.api.SamplerConfig(params=p, num_nodes=1 << LG, backend="balldrop"))
    params, F, _ = interop.from_reference(np.asarray(p.thetas), rs.F, np.zeros(2), np.asarray(p.mu))
    ps = MAGMSampler(SamplerConfig(params=params, F=F, backend="balldrop", device="cpu"))
    for seed in (0, 1):
        want, got = rs.sample(jax.random.PRNGKey(seed)), ps.sample(prng.PRNGKey(seed))
        assert np.array_equal(want.edges, got.edges) and tuple(want.stats) == tuple(got.stats)
        assert got.stats.num_kpgm_draws == 0


@pytest.mark.parametrize("num_edges", [None, 500])
def test_kpgm_session_balldrop_matches_reference(ref, num_edges):
    import jax
    import jax.numpy as jnp

    th = np.broadcast_to(magm_paper.THETA_2, (9, 2, 2)).copy()
    rs = ref.api.KPGMSampler(ref.api.SamplerConfig(params=ref.kpgm.KPGMParams(jnp.asarray(th)), backend="balldrop"))
    ps = KPGMSampler(SamplerConfig(params=kpgm.KPGMParams(torch.from_numpy(th)), backend="balldrop", device="cpu"))
    want, got = rs.sample(jax.random.PRNGKey(6), num_edges=num_edges), ps.sample(prng.PRNGKey(6), num_edges=num_edges)
    assert np.array_equal(want.edges, got.edges) and tuple(want.stats) == tuple(got.stats)
    if num_edges is not None:
        assert got.num_edges == got.stats.target_edges == num_edges


def test_sessions_refuse_balldrop_without_moments():
    """Past kron.MOMENT_CAP the plan has no moments: the MAGM session
    refuses backend='balldrop' at build time; a KPGM session past
    KPGM_PLAN_MAX_NODES has no plan to drop balls on."""
    d = kron.MOMENT_CAP.bit_length()
    params = magm.make_params(magm_paper.THETA_2, 0.5, d)
    F = magm.sample_attributes(prng.PRNGKey(2), 48, params.mu).numpy()
    with pytest.raises(ValueError, match="balldrop"):
        MAGMSampler(SamplerConfig(params=params, F=F, backend="balldrop", device="cpu"))
    with pytest.raises(ValueError, match="balldrop"):
        KPGMSampler(SamplerConfig(params=kpgm.make_params(magm_paper.THETA_2, 21), backend="balldrop", device="cpu"))
