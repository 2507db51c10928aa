"""The quilt plan: attributes, partition, lookup tables, cumulative table and
plan scalars equal to the reference's; the exact budget equal."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch.configs import magm_paper
from repro_torch.core import f32math, kpgm, magm, partition, prng, quilt


def _ref_plan(ref, theta, mu, lg):
    import jax

    p = ref.magm.make_params(theta, mu, lg)
    F = np.asarray(ref.magm.resolve_attributes(p, num_nodes=1 << lg, attribute_key=jax.random.PRNGKey(lg)))
    return p, F, ref.quilt.build_quilt_plan(F, p.thetas)


@pytest.mark.parametrize("theta", ["THETA_1", "THETA_2"])
@pytest.mark.parametrize("lg, mu", [(8, 0.5), (10, 0.5), (12, 0.5), (10, 0.6)])
def test_plan_matches_reference(ref, theta, lg, mu):
    th = getattr(magm_paper, theta)
    assert np.array_equal(th, getattr(ref.paper, theta))
    p, F, rp = _ref_plan(ref, th, mu, lg)
    pp = magm.make_params(th, mu, lg)
    assert np.array_equal(pp.thetas.numpy(), np.asarray(p.thetas))
    assert np.array_equal(pp.mu.numpy(), np.asarray(p.mu))
    pF = magm.resolve_attributes(pp, num_nodes=1 << lg, attribute_key=prng.PRNGKey(lg), device="cpu")
    assert pF.dtype == F.dtype and np.array_equal(pF, F)

    plan = quilt.build_quilt_plan(pF, pp.thetas, device="cpu")
    assert (plan.n, plan.d, plan.B) == (rp.n, rp.d, rp.B)
    assert np.array_equal(plan.table_cfg.numpy(), np.asarray(rp.table_cfg))
    assert np.array_equal(plan.table_node.numpy(), np.asarray(rp.table_node))
    assert np.array_equal(plan.cum.numpy(), np.asarray(rp.cum))
    assert plan.mean_edges == rp.mean_edges
    assert plan.std_edges == rp.std_edges
    assert plan.p_max == rp.p_max
    budget = quilt._exact_budget(plan.p_max, plan.mean_edges)
    assert budget == ref.quilt._exact_budget(rp.p_max, rp.mean_edges)
    assert plan.num_graphs * budget <= kpgm.DEVICE_MAX_CANDIDATES


def test_partition_matches_reference(ref):
    rng = np.random.default_rng(0)
    for n, d in ((1, 3), (50, 4), (3000, 8)):
        lam = rng.integers(0, 1 << d, n)
        want = ref.partition.build_partition(lam)
        got = partition.build_partition(lam)
        assert got.B == want.B
        assert np.array_equal(got.ranks, want.ranks)
        for a, b in zip(got.sets + got.sorted_configs + got.sorted_nodes,
                        want.sets + want.sorted_configs + want.sorted_nodes):
            assert np.array_equal(a, b)
        tw, tg = ref.partition.padded_lookup_tables(want), partition.padded_lookup_tables(got)
        for a, b in zip(tg, tw):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert partition.CFG_SENTINEL == ref.partition.CFG_SENTINEL == 2**31 - 1


def test_configs_and_moments_match_reference(ref):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    F = (rng.random((500, 13)) < 0.4).astype(np.int8)
    assert np.array_equal(
        magm.configs_from_attributes(torch.from_numpy(F)).numpy(),
        np.asarray(ref.magm.configs_from_attributes(jnp.asarray(F))),
    )
    for d in (1, 7, 15, 31):
        th = rng.uniform(0.01, 1.0, (d, 2, 2)).astype(np.float32)
        cum, m, std, pmax = (np.asarray(x) for x in ref.quilt._plan_constants(jnp.asarray(th)))
        pc, pm, pstd, ppmax = quilt._plan_constants(torch.from_numpy(th))
        assert np.array_equal(pc.numpy(), cum)
        assert (float(pm), float(pstd), float(ppmax)) == (float(m), float(std), float(pmax))


def test_log_prob_pairs_match_reference(ref):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    d = 15
    th = np.broadcast_to(magm_paper.THETA_1, (d, 2, 2)).astype(np.float32)
    src = rng.integers(0, 1 << d, 20_000).astype(np.int32)
    dst = rng.integers(0, 1 << d, 20_000).astype(np.int32)
    want = np.asarray(
        jax.jit(ref.kpgm.log_prob_pairs)(jnp.asarray(th), jnp.asarray(src), jnp.asarray(dst))
    )
    got = kpgm.log_prob_pairs(torch.from_numpy(th), torch.from_numpy(src), torch.from_numpy(dst))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["exp", "log", "log1p", "expm1"])
def test_f32_transcendentals_match_reference(name):
    """Bit-equal to the reference's compiled float32 functions on ~1e6
    inputs per function, denormals and specials included."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    x = np.concatenate([
        rng.uniform(-1, 1, 200_000), rng.uniform(-100, 100, 200_000),
        np.exp(rng.uniform(-80, 80, 200_000)), -np.exp(rng.uniform(-30, 3, 200_000)),
        rng.uniform(-1e-3, 1e-3, 100_000),
        [0.0, -0.0, 0.5, -0.5, 88.0, -88.0, 89.0, -90.0, 1e-38, 1e-40, np.inf, -np.inf, np.nan],
    ]).astype(np.float32)
    if name == "log":
        x = np.abs(x)
    elif name == "log1p":
        x = np.concatenate([x[np.abs(x) < 5], -rng.uniform(0, 1, 200_000).astype(np.float32)])
    want = np.asarray(jax.jit(getattr(jnp, name))(jnp.asarray(x)))
    got = getattr(f32math, name)(torch.from_numpy(x.copy())).numpy()
    both_nan = np.isnan(got) & np.isnan(want)  # NaN payloads carry nothing
    assert np.all((got.view(np.int32) == want.view(np.int32)) | both_nan)
    assert np.array_equal(np.isnan(got), np.isnan(want))


def test_fma_rounds_once():
    """a * b lands exactly on a float32 midpoint; a tiny c decides the
    rounding, which rounding the float64 sum first would lose."""
    a = torch.tensor([1 + 2**-12], dtype=torch.float32)
    up = f32math.fma(a, a, torch.tensor([2.0**-60]))
    down = f32math.fma(a, a, torch.tensor([-(2.0**-60)]))
    assert up.item() == 1 + 2**-11 + 2**-23
    assert down.item() == 1 + 2**-11
    assert f32math.fma(a, a, 0.0).item() == 1 + 2**-11  # the tie goes to even


def test_partition_cache_is_content_keyed():
    rng = np.random.default_rng(3)
    F = (rng.random((200, 6)) < 0.5).astype(np.int8)
    th = magm.make_params(magm_paper.THETA_1, 0.5, 6).thetas
    quilt.clear_plan_cache()
    before = quilt.PLAN_STATS["partition_builds"]
    a = quilt.build_quilt_plan(F, th, device="cpu")
    b = quilt.build_quilt_plan(F.copy(), th * 0.5, device="cpu")
    assert quilt.PLAN_STATS["partition_builds"] == before + 1
    assert a.part is b.part and a.mean_edges != b.mean_edges
    quilt.build_quilt_plan(F, th, device="cpu", reuse_partition=False)
    assert quilt.PLAN_STATS["partition_builds"] == before + 2


def test_plan_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    F = np.zeros((4, 3), dtype=np.int8)
    with pytest.raises(RuntimeError, match="cuda"):
        quilt.build_quilt_plan(F, magm.make_params(magm_paper.THETA_1, 0.5, 3).thetas)
