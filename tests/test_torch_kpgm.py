"""KPGM (Algorithm 1) in the port against the reference: the normal draw
and its float32 inverse error function, the edge-count draw, the host and
shared-batch samplers, and KPGMSampler.

Everything is held to bit equality (a band of 0 ulps): a target is
round(z * std + mean) with std ~ 10^3, so one ulp of z rarely moves it, but
when it does every later slot moves.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch import interop
from repro_torch.api import KPGMSampler, KPGMStats, SamplerConfig
from repro_torch.configs import magm_paper
from repro_torch.core import f32math, kpgm, prng, quilt


@pytest.fixture(autouse=True)
def _restore_dispatch_counters():
    """The engine's dispatch counters are process-wide: put them back after
    each test, so files that run later in the same worker see none of this
    file's fallbacks."""
    saved = dict(quilt.DISPATCH_COUNTERS)
    yield
    quilt.DISPATCH_COUNTERS.update(saved)


def _thetas(d, seed):
    if seed is None:
        return np.broadcast_to(magm_paper.THETA_1, (d, 2, 2)).astype(np.float32)
    return np.random.default_rng(seed).uniform(0.05, 1.0, (d, 2, 2)).astype(np.float32)


@pytest.mark.parametrize("shape", [(), (49,), (81,), (4096,), (1 << 18,)])
def test_normal_matches_reference(ref, shape):
    import jax

    keys = 200 if len(shape) == 0 or shape[0] < 100 else 4
    for s in range(keys):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(s), shape))
        got = prng.normal(prng.PRNGKey(s), shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert np.array_equal(want.view(np.uint32), got.numpy().view(np.uint32))


def test_erf_inv_over_its_tails(ref):
    """Both polynomial branches (w < 5 and w >= 5), the values whose sqrt
    PyTorch's vectorised CPU kernel rounds one ulp off, +-1, 0 and
    subnormals."""
    import jax

    rng = np.random.default_rng(0)
    one = np.float32(1.0)
    edge = np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 1e-30, 0.5, -0.5,
                     np.nextafter(one, np.float32(0)), -np.nextafter(one, np.float32(0)),
                     0.99690944, -0.9977872, -0.99794334, 0.99721724], dtype=np.float32)
    tails = (1.0 - rng.random(1 << 16, dtype=np.float32) * 0.01) * rng.choice([-1, 1], 1 << 16)
    body = rng.uniform(-1, 1, 1 << 16).astype(np.float32)
    x = np.concatenate([edge, tails.astype(np.float32), body])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    got = f32math.erf_inv(torch.from_numpy(x)).numpy()
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))
    w = -np.log1p(-tails.astype(np.float64) ** 2)
    assert (w >= 5).sum() > 1000 and (w < 5).sum() > 1000


def test_f32_sqrt_is_correctly_rounded():
    x = np.random.default_rng(1).uniform(0, 50, 1 << 16).astype(np.float32)
    got = f32math.sqrt(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.sqrt(x))


@pytest.mark.parametrize("d, seed", [(3, 1), (12, None), (20, 2), (31, 3)])
def test_eager_moments_and_num_edges_match_reference(ref, d, seed):
    import jax
    import jax.numpy as jnp

    th = _thetas(d, seed)
    m, v = ref.kpgm.edge_moments(jnp.asarray(th))
    pm, pv = kpgm.edge_moments_eager(torch.from_numpy(th))
    assert np.float32(m) == float(pm) and np.float32(v) == float(pv)
    for s in range(20):
        want = np.asarray(ref.kpgm.sample_num_edges(jax.random.PRNGKey(s), jnp.asarray(th)))
        got = kpgm.sample_num_edges(prng.PRNGKey(s), torch.from_numpy(th))
        assert got.dtype == torch.float32 and float(want) == float(got)


def test_bucket_matches_reference(ref):
    xs = list(range(0, 2000)) + [int(x) for x in np.geomspace(2000, 2**34, 500)]
    assert [kpgm._bucket(x) for x in xs] == [ref.kpgm._bucket(x) for x in xs]


def test_make_params_validates_and_replicates():
    p = kpgm.make_params(magm_paper.THETA_2, 7)
    assert p.d == 7 and p.num_nodes == 128 and p.thetas.dtype == torch.float32
    assert torch.equal(p.thetas[6], torch.from_numpy(magm_paper.THETA_2))
    with pytest.raises(ValueError):
        kpgm.make_params(np.ones((2, 3)), 4)
    with pytest.raises(ValueError):
        kpgm.make_params(np.full((2, 2), 1.5), 4)


@pytest.mark.parametrize(
    "d, seed, count, backend",
    [(8, None, 9, "auto"), (8, None, 9, "host"), (10, 4, 16, "auto"), (10, 4, 3, "device"), (12, None, 4, "host")],
)
def test_kpgm_sample_many_matches_reference(ref, d, seed, count, backend):
    import jax
    import jax.numpy as jnp

    th = _thetas(d, seed)
    want = ref.kpgm.kpgm_sample_many(
        jax.random.PRNGKey(d), ref.kpgm.KPGMParams(jnp.asarray(th)), count, backend=backend
    )
    got = kpgm.kpgm_sample_many(
        prng.PRNGKey(d), kpgm.KPGMParams(torch.from_numpy(th)), count, backend=backend, device="cpu"
    )
    assert len(got) == count
    for w, g in zip(want, got):
        assert g.dtype == np.int64 and np.array_equal(w, g)


def test_kpgm_sample_many_host_topup_rounds(ref):
    """oversample = 1 leaves duplicates short after the first round, so the
    host loop runs several rounds of shrinking asks."""
    import jax
    import jax.numpy as jnp

    th = _thetas(9, None)
    want = ref.kpgm.kpgm_sample_many(
        jax.random.PRNGKey(3), ref.kpgm.KPGMParams(jnp.asarray(th)), 5, oversample=1.0, max_rounds=3
    )
    got = kpgm.kpgm_sample_many(
        prng.PRNGKey(3), kpgm.KPGMParams(torch.from_numpy(th)), 5, oversample=1.0, max_rounds=3,
        device="cpu",
    )
    assert all(np.array_equal(w, g) for w, g in zip(want, got))
    assert kpgm.kpgm_sample_many(prng.PRNGKey(3), kpgm.KPGMParams(torch.from_numpy(th)), 0, device="cpu") == []


@pytest.mark.parametrize("num_edges", [None, 0, 700, 70_000])
def test_kpgm_sample_host_matches_reference(ref, num_edges):
    import jax
    import jax.numpy as jnp

    th = _thetas(8, 6)
    want = ref.kpgm._kpgm_sample_host(
        jax.random.PRNGKey(11), ref.kpgm.KPGMParams(jnp.asarray(th)), num_edges=num_edges
    )
    got = kpgm._kpgm_sample_host(
        prng.PRNGKey(11), kpgm.KPGMParams(torch.from_numpy(th)), num_edges=num_edges, device="cpu"
    )
    assert got.dtype == np.int64 and np.array_equal(want, got)
    if num_edges is not None and num_edges <= 700:
        assert got.shape[0] == num_edges
    assert np.unique(got[:, 0] * 256 + got[:, 1]).size == got.shape[0]


def _samplers(ref, d, backend, **kw):
    import jax.numpy as jnp

    th = _thetas(d, None)
    rs = ref.api.KPGMSampler(ref.api.SamplerConfig(params=ref.kpgm.KPGMParams(jnp.asarray(th)), backend=backend, **kw))
    ps = KPGMSampler(SamplerConfig(params=kpgm.KPGMParams(torch.from_numpy(th.copy())), backend=backend, device="cpu", **kw))
    return rs, ps


@pytest.mark.parametrize("backend", ["auto", "host", "device"])
@pytest.mark.parametrize("num_edges", [None, 500])
def test_kpgm_sampler_matches_reference(ref, backend, num_edges):
    import jax

    rs, ps = _samplers(ref, 11, backend)
    want = rs.sample(jax.random.PRNGKey(4), num_edges=num_edges)
    got = ps.sample(prng.PRNGKey(4), num_edges=num_edges)
    assert np.array_equal(want.edges, got.edges)
    assert (want.stats is None) == (got.stats is None)
    if want.stats is not None:
        assert isinstance(got.stats, KPGMStats) and tuple(want.stats) == tuple(got.stats)
        assert got.stats.sampled_edges == got.num_edges
    if num_edges is not None:
        assert got.num_edges == num_edges
    assert (ps.plan is None) == (backend == "host")


def test_kpgm_sampler_key_stream_and_dtype(ref):
    rs, ps = _samplers(ref, 9, "auto", dtype=np.int32)
    for _ in range(2):
        want, got = rs.sample(), ps.sample()
        assert np.array_equal(np.asarray(want.key).astype(np.int64), got.key.numpy())
        assert got.edges.dtype == np.int32 and np.array_equal(want.edges, got.edges)


def test_kpgm_sampler_num_edges_over_cap_takes_host_loop(ref, monkeypatch):
    """An explicit num_edges whose ranked round would pass the device cap:
    the engine raises DeviceBatchUnavailable and the session runs the
    target-honoring host loop (cap lowered in both packages)."""
    import jax

    monkeypatch.setattr(ref.kpgm, "DEVICE_MAX_CANDIDATES", 1 << 10)
    monkeypatch.setattr(kpgm, "DEVICE_MAX_CANDIDATES", 1 << 10)
    rs, ps = _samplers(ref, 10, "auto")
    with pytest.raises(quilt.DeviceBatchUnavailable):
        quilt.quilt_run(prng.PRNGKey(0), ps.plan, targets=np.array([5000]), exact_cells=False)
    want = rs.sample(jax.random.PRNGKey(6), num_edges=5000)
    got = ps.sample(prng.PRNGKey(6), num_edges=5000)
    assert got.stats is None and want.stats is None
    assert got.num_edges == 5000 and np.array_equal(want.edges, got.edges)


def test_kpgm_sampler_without_target_over_cap_takes_engine_host_path(ref, monkeypatch):
    import jax

    monkeypatch.setattr(ref.kpgm, "DEVICE_MAX_CANDIDATES", 1 << 10)
    monkeypatch.setattr(kpgm, "DEVICE_MAX_CANDIDATES", 1 << 10)
    rs, ps = _samplers(ref, 10, "auto")
    want, got = rs.sample(jax.random.PRNGKey(7)), ps.sample(prng.PRNGKey(7))
    assert got.stats is None and want.stats is None
    assert np.array_equal(want.edges, got.edges) and got.num_edges > 0


def test_kpgm_sampler_rejects_and_shim(ref, tmp_path):
    import jax
    import jax.numpy as jnp

    p = kpgm.KPGMParams(torch.from_numpy(_thetas(6, None)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        KPGMSampler(SamplerConfig(params=p, backend="balldrop", mesh="auto", device="cpu"))
    with pytest.raises(TypeError):
        KPGMSampler(SamplerConfig(params=interop.from_reference(
            _thetas(6, None), np.zeros((4, 6), np.int8), np.zeros(2))[0], device="cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7b"):
        KPGMSampler(SamplerConfig(params=p, mesh="auto", device="cpu"))
    with pytest.raises(ValueError, match="no stream checkpoint"):  # resumable streams run (item 7)
        KPGMSampler(SamplerConfig(params=p, device="cpu")).resume_stream(str(tmp_path / "ckpt"))
    with pytest.warns(DeprecationWarning):
        shim = kpgm.kpgm_sample(prng.PRNGKey(2), p, num_edges=40, device="cpu")
    session = KPGMSampler(SamplerConfig(params=p, device="cpu")).sample(prng.PRNGKey(2), num_edges=40)
    assert np.array_equal(shim, session.edges)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref.kpgm.kpgm_sample(jax.random.PRNGKey(2), ref.kpgm.KPGMParams(jnp.asarray(_thetas(6, None))), num_edges=40)
    assert np.array_equal(want, shim)


def test_kpgm_plan_is_identity_and_cached():
    th = torch.from_numpy(_thetas(7, 3))
    plan = quilt.build_kpgm_plan(th, device="cpu")
    assert plan.B == 1 and plan.n == 128 and plan.num_graphs == 1
    assert torch.equal(plan.table_cfg[0], torch.arange(128, dtype=torch.int32))
    assert torch.equal(plan.table_node[0], torch.arange(128, dtype=torch.int32))
    assert quilt.build_kpgm_plan(th.clone(), device="cpu") is plan
    quilt.clear_plan_cache()
    assert quilt.build_kpgm_plan(th, device="cpu") is not plan


def test_interop_kpgm_params(ref):
    import jax
    import jax.numpy as jnp

    th = _thetas(5, 9)
    rp = ref.kpgm.KPGMParams(jnp.asarray(th))
    params, key = interop.kpgm_from_reference(np.asarray(rp.thetas), np.asarray(jax.random.key_data(jax.random.PRNGKey(3))))
    assert isinstance(params, kpgm.KPGMParams) and params.d == 5
    assert np.array_equal(params.thetas.numpy(), th) and torch.equal(key, prng.PRNGKey(3))
    with pytest.raises(ValueError):
        interop.kpgm_from_reference(np.zeros((3, 2)), np.zeros(2))
