"""The whole default MAGM session: port vs reference on the same attributes
and key, plus the port's device rule and its unported paths.

Edges and stats must be equal.  The exact-cell acceptance alpha is built
from float32 exp / log / log1p / expm1, and exp(log p - log q) magnifies a
one-ulp difference in a log some 16-fold; the port evaluates the
reference's own polynomials (core/f32math.py), so the test holds alpha, the
accept masks and the edges to bit equality, a band of 0 ulps.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import cuda_device, ref  # noqa: F401  (fixtures)

from repro_torch import interop
from repro_torch.api import GraphSample, MAGMSampler, SamplerConfig
from repro_torch.configs import magm_paper
from repro_torch.core import prng, quilt
from repro_torch.kernels import ops

def _pair(ref, theta, mu, lg, key_seed=5):
    """Reference and port sessions over the reference's attributes."""
    import jax

    p = ref.magm.make_params(theta, mu, lg)
    rs = ref.api.MAGMSampler(ref.api.SamplerConfig(params=p, num_nodes=1 << lg))
    key = jax.random.PRNGKey(key_seed)
    params, F, pkey = interop.from_reference(
        np.asarray(p.thetas), rs.F, np.asarray(jax.random.key_data(key)), np.asarray(p.mu)
    )
    ps = MAGMSampler(SamplerConfig(params=params, F=F, device="cpu"))
    return rs, ps, key, pkey


def _round_candidates(ps, pkey):
    """The port's round for ``pkey``: cells, hits, alphas and hash uniforms."""
    plan = ps.plan
    key, _ = prng.split(pkey)
    _, rkey = prng.split(key)
    budget = quilt._exact_budget(plan.p_max, plan.mean_edges)
    gids = torch.arange(plan.num_graphs, dtype=torch.int32)
    scfg, dcfg, snode, dnode = ops.quilt_prng_descent_lookup(
        ops.counter_seed(rkey), gids, plan.cum, plan.table_cfg, plan.table_node,
        a_tot=budget, num_blocks=plan.B,
    )
    gid = torch.arange(scfg.numel()) // budget
    cell = scfg.long() * (1 << plan.d) + dcfg.long()
    u = quilt._accept_u01(quilt.accept_salt(rkey, "cpu"), gid, cell)
    alpha = quilt._exact_alpha(scfg, dcfg, plan.thetas, budget)
    hit = (snode >= 0) & (dnode >= 0)
    return rkey, budget, gid, scfg, dcfg, snode, dnode, hit, u, alpha


def _reference_alpha_and_mask(ref, rkey, budget, gid, scfg, dcfg, thetas):
    import jax
    import jax.numpy as jnp

    def alpha_fn(s, d, th):
        # the alpha of repro.core.quilt._exact_cell_valid, line for line
        logp = ref.kpgm.log_prob_pairs(th, s, d)
        log_s = jnp.sum(jnp.log(jnp.sum(th, axis=(1, 2))))
        pi = jnp.exp((logp - log_s - 0.0).astype(jnp.float32))
        q = -jnp.expm1(jnp.float32(budget) * jnp.log1p(-pi))
        return jnp.minimum(jnp.exp(logp.astype(jnp.float32) - jnp.log(q)), 1.0)

    def mask_fn(k, g, s, d, th):
        return ref.quilt._exact_cell_valid(k, g, s, d, th, budget)

    args = (jnp.asarray(scfg.numpy()), jnp.asarray(dcfg.numpy()), jnp.asarray(thetas.numpy()))
    alpha = np.asarray(jax.jit(alpha_fn)(*args))
    k = jnp.asarray(rkey.numpy().astype(np.uint32))
    with jax.enable_x64(True):
        mask = np.asarray(jax.jit(mask_fn)(k, jnp.asarray(gid.int().numpy()), *args))
    return alpha, mask


CASES = [
    ("THETA_1", 0.5, 10),
    ("THETA_2", 0.5, 10),
    ("THETA_1", 0.5, 12),
    ("THETA_2", 0.5, 12),
    ("THETA_1", 0.6, 10),  # skewed attributes: B = 9
]


@pytest.mark.parametrize("theta, mu, lg", CASES, ids=[f"{t}-mu{m}-n2^{g}" for t, m, g in CASES])
def test_session_matches_reference(ref, theta, mu, lg):
    th = getattr(magm_paper, theta)
    rs, ps, key, pkey = _pair(ref, th, mu, lg)
    want = rs.sample(key)
    got = ps.sample(pkey)

    rkey, budget, gid, scfg, dcfg, snode, dnode, hit, u, alpha = _round_candidates(ps, pkey)
    alpha_ref, mask_ref = _reference_alpha_and_mask(
        ref, rkey, budget, gid, scfg, dcfg, ps.plan.thetas
    )
    u, alpha = u.numpy(), alpha.numpy()
    assert np.array_equal(alpha, alpha_ref)
    assert np.array_equal(u < alpha, mask_ref)
    assert 0 < mask_ref.sum() < mask_ref.size

    assert got.n == want.n == 1 << lg
    assert got.edges.dtype == want.edges.dtype
    assert np.array_equal(got.edges, want.edges)
    assert tuple(got.stats) == tuple(want.stats)
    assert got.stats.kept_edges == got.num_edges
    assert quilt.DISPATCH_COUNTERS["exact_fallbacks"] == 0


def test_session_key_stream_matches_reference(ref):
    rs, ps, _, _ = _pair(ref, magm_paper.THETA_1, 0.5, 8)
    for _ in range(2):
        want, got = rs.sample(), ps.sample()
        assert np.array_equal(np.asarray(want.key).astype(np.int64), got.key.numpy())
        assert np.array_equal(want.edges, got.edges)


def test_plain_lookup_on_request_and_dtype():
    p = interop.from_reference(
        np.broadcast_to(magm_paper.THETA_1, (8, 2, 2)),
        (np.random.default_rng(0).random((256, 8)) < 0.5).astype(np.int8),
        np.array([0, 9], np.uint32),
    )
    base = SamplerConfig(params=p[0], F=p[1], device="cpu")
    a = MAGMSampler(base).sample(p[2])
    b = MAGMSampler(base.replace(use_kernel=False, dtype=np.int32)).sample(p[2])
    assert isinstance(a, GraphSample) and b.edges.dtype == np.int32
    assert np.array_equal(a.edges, b.edges) and a.num_edges > 0
    assert a.density == a.num_edges / 256**2
    assert np.unique(a.edges, axis=0).shape == a.edges.shape
    assert a.edges.min() >= 0 and a.edges.max() < 256


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = interop.from_reference(
        np.broadcast_to(magm_paper.THETA_1, (4, 2, 2)), np.zeros((8, 4), np.int8), np.zeros(2)
    )[0]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        MAGMSampler(SamplerConfig(params=params, num_nodes=16))


@pytest.mark.parametrize(
    "change",
    [
        {"backend": "balldrop", "mesh": "auto"},
        {"split": True, "mesh": "auto"},
        {"mesh": "auto"},
    ],
    ids=["balldrop", "split", "mesh"],
)
def test_unported_session_paths_raise(change):
    p = interop.from_reference(
        np.broadcast_to(magm_paper.THETA_1, (5, 2, 2)), np.zeros((8, 5), np.int8), np.zeros(2)
    )[0]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MAGMSampler(SamplerConfig(params=p, num_nodes=32, device="cpu", **change))


def test_unported_run_paths_raise(tmp_path):
    """Meshes (ROADMAP queue 1 item 7b) still raise; resumable streams
    (item 7) run: tests/test_torch_resilience.py holds them against the
    reference."""
    p = interop.from_reference(
        np.broadcast_to(magm_paper.THETA_1, (5, 2, 2)), np.zeros((8, 5), np.int8), np.zeros(2)
    )[0]
    s = MAGMSampler(SamplerConfig(params=p, num_nodes=32, device="cpu"))
    key = prng.PRNGKey(0)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7b"):
        quilt.quilt_run(key, s.plan, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7b"):
        MAGMSampler(SamplerConfig(params=p, num_nodes=32, device="cpu", mesh="auto"))
    from repro_torch.core import magm

    s = MAGMSampler(SamplerConfig(params=magm.make_params(magm_paper.THETA_1, 0.5, 5), num_nodes=32, device="cpu"))
    d = str(tmp_path / "ckpt")
    chunks = list(s.sample_stream(key, chunk_edges=16, checkpoint_dir=d))
    assert len(chunks) > 1 and np.array_equal(np.concatenate(chunks), s.sample(key).edges)
    assert list(s.resume_stream(d)) == []
    with pytest.raises(ValueError, match="no stream checkpoint"):
        s.resume_stream(str(tmp_path / "none"))


def test_budget_over_device_cap_takes_host_path(monkeypatch):
    """n = 2^16 at the paper's setting needs 80.6 M exact candidates, over
    DEVICE_MAX_CANDIDATES: the exact round is refused, the ranked round is
    over the cap too, and the run takes the host path (stubbed here: the
    real one draws 83.9 M candidates, a chip-sized job; chip_smoke.py runs
    it)."""
    from repro_torch.core import magm

    s = MAGMSampler(
        SamplerConfig(params=magm.make_params(magm_paper.THETA_1, 0.5, 16), num_nodes=1 << 16, device="cpu")
    )
    calls = []

    def host(key, plan, *, max_rounds, oversample):
        calls.append((max_rounds, oversample))
        stats = quilt.QuiltStats(plan.B, plan.num_graphs, 0, 0, 0, plan.n, None)
        zeros = np.zeros(plan.num_graphs, np.int64)
        return np.zeros((0, 2), np.int64), stats, zeros, zeros

    monkeypatch.setattr(quilt, "_quilt_sample_host", host)
    monkeypatch.setattr(quilt, "DISPATCH_COUNTERS", dict(quilt.DISPATCH_COUNTERS))  # restored after
    before = quilt.DISPATCH_COUNTERS["exact_fallbacks"]
    gs = s.sample(prng.PRNGKey(1))
    assert quilt.DISPATCH_COUNTERS["exact_fallbacks"] == before + 1
    assert calls == [(8, 1.05)] and gs.num_edges == 0 and gs.stats.B == s.plan.B == 8


def test_interop_validates_shapes():
    with pytest.raises(ValueError):
        interop.from_reference(np.zeros((3, 2)), np.zeros((4, 3)), np.zeros(2))
    with pytest.raises(ValueError):
        interop.from_reference(np.zeros((3, 2, 2)), np.zeros((4, 2)), np.zeros(2))
    with pytest.raises(ValueError):
        interop.from_reference(np.zeros((3, 2, 2)), np.zeros((4, 3)), np.zeros(3))


@pytest.mark.cuda
def test_cuda_session_equals_cpu_session(cuda_device):
    from repro_torch.core import magm

    params = magm.make_params(magm_paper.THETA_1, 0.5, 10)
    cfg = SamplerConfig(params=params, num_nodes=1 << 10)
    before = ops.kernel_launches()["quilt_prng_descent_lookup"]
    got = MAGMSampler(cfg.replace(device=cuda_device)).sample(prng.PRNGKey(2))
    assert ops.kernel_launches()["quilt_prng_descent_lookup"] == before + 1
    want = MAGMSampler(cfg.replace(device="cpu")).sample(prng.PRNGKey(2))
    assert np.array_equal(got.edges, want.edges)
