"""The port's validation suite (``analysis/validate.py``) and graph
statistics (``core/stats.py``) against the reference's, and a small 3-sigma
run of the port's three backends ("auto", "host", "balldrop") against each
other and against the closed-form moments, on the CPU.

The run takes the setting of the reference's own suite
(``tests/test_validation.py``): THETA_2, n = 2^12, d = 12, mu = 0.5, 4
seeds per backend; ``chip_smoke.py`` runs 16 seeds of it on the card.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch.analysis import validate
from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.configs import magm_paper
from repro_torch.core import magm, prng, quilt, stats

THETA = magm_paper.THETA_2
LG = 12
MU = 0.5
SEEDS = range(4)
BACKENDS = ("auto", "host", "balldrop")


@pytest.fixture(scope="module")
def vref(ref):
    import importlib

    return importlib.import_module("repro.analysis.validate"), importlib.import_module("repro.core.stats")


def _attributes(lg, seed, d=None):
    params = magm.make_params(THETA, MU, d or lg)
    return params, magm.sample_attributes(prng.PRNGKey(seed), 1 << lg, params.mu).numpy()


@pytest.mark.parametrize("lg, d", [(6, 6), (9, 9), (10, 12)])
def test_theory_moments_match_reference(vref, lg, d):
    rv, _ = vref
    params, F = _attributes(lg, lg, d)
    th = params.thetas.numpy()
    want, got = rv.theory_moments(F, th), validate.theory_moments(F, th)
    np.testing.assert_allclose(got.mean_edges, want.mean_edges, rtol=1e-12)
    np.testing.assert_allclose(got.std_edges, want.std_edges, rtol=1e-12)
    np.testing.assert_allclose(got.block_mean, want.block_mean, rtol=1e-12)
    np.testing.assert_allclose(got.block_std, want.block_std, rtol=1e-12)
    np.testing.assert_allclose(got.isolated, want.isolated, rtol=1e-12)
    lam = magm.configs_from_attributes(torch.from_numpy(F)).numpy()
    c = np.bincount(lam, minlength=1 << d).astype(np.float64)
    for order in (1, 3, 7):
        np.testing.assert_allclose(
            validate.expected_isolated(c, th, order), rv.expected_isolated(c, th, order), rtol=1e-12
        )


def test_expected_isolated_matches_exact_product():
    """The order-3 log-survival against the exact prod(1 - Q) at n = 64."""
    params, F = _attributes(6, 9)
    th = params.thetas.numpy()
    P = np.ones((1, 1))
    for t in th.astype(np.float64):
        P = np.kron(P, t)
    lam = magm.configs_from_attributes(torch.from_numpy(F)).numpy()
    log1m = np.log1p(-P[np.ix_(lam, lam)])
    exact = np.exp(log1m.sum(axis=1) + log1m.sum(axis=0) - np.diag(log1m)).sum()
    c = np.bincount(lam, minlength=64).astype(np.float64)
    np.testing.assert_allclose(validate.expected_isolated(c, th, order=30), exact, rtol=1e-10)
    assert abs(validate.expected_isolated(c, th) - exact) < 0.05 * max(exact, 1.0)


def test_summaries_and_claims_match_reference(vref):
    rv, _ = vref
    rng = np.random.default_rng(4)
    n = 300
    assert np.array_equal(validate.degree_bin_edges(n), rv.degree_bin_edges(n))
    ranks = rng.integers(1, 5, n)
    bins = validate.degree_bin_edges(n)
    runs = [rng.integers(0, n, (rng.integers(0, 2000), 2)) for _ in range(5)]
    for e in runs:
        w, g = rv.summarize(e, n, ranks, bins), validate.summarize(e, n, ranks, bins)
        assert w.total == g.total and w.isolated == g.isolated
        assert np.array_equal(w.blocks, g.blocks) and np.array_equal(w.hist, g.hist)
    a = validate.collect("a", lambda s: runs[s], range(3), n, ranks, bins)
    b = validate.collect("b", lambda s: runs[s + 2], range(3), n, ranks, bins)
    ra = rv.collect("a", lambda s: runs[s], range(3), n, ranks, bins)
    rb = rv.collect("b", lambda s: runs[s + 2], range(3), n, ranks, bins)
    for x, y in zip(a[1:], ra[1:]):
        assert np.array_equal(x, y)
    assert [tuple(c) for c in validate.compare_backends(a, b)] == [tuple(c) for c in rv.compare_backends(ra, rb)]
    params, F = _attributes(8, 3)
    tm, rtm = validate.theory_moments(F, params.thetas.numpy()), rv.theory_moments(F, params.thetas.numpy())
    ranks8 = quilt.build_quilt_plan(F, params.thetas, device="cpu").part.ranks
    s8 = validate.collect("s", lambda s: runs[s] % 256, range(2), 256, ranks8, bins)
    r8 = rv.collect("s", lambda s: runs[s] % 256, range(2), 256, ranks8, bins)
    got, want = validate.compare_to_theory(s8, tm), rv.compare_to_theory(r8, rtm)
    assert [c.name for c in got] == [c.name for c in want]
    np.testing.assert_allclose([c[1:] for c in got], [c[1:] for c in want], rtol=1e-12)
    assert [c.name for c in validate.failures(got)] == [c.name for c in rv.failures(want)]


def test_stats_match_reference(vref):
    _, rs = vref
    rng = np.random.default_rng(7)
    for n, m in ((1, 0), (50, 120), (400, 3000)):
        e = rng.integers(0, n, (m, 2))
        assert stats.largest_scc_fraction(e, n) == rs.largest_scc_fraction(e, n)
        for x, y in zip(stats.degree_counts(e, n), rs.degree_counts(e, n)):
            assert np.array_equal(x, y)
    ns, es = np.array([2.0**k for k in range(8, 14)]), rng.uniform(1e3, 1e6, 6)
    assert stats.fit_powerlaw_exponent(ns, es) == rs.fit_powerlaw_exponent(ns, es)
    assert stats.largest_scc_fraction(np.zeros((0, 2), np.int64), 0) == 0.0


@pytest.fixture(scope="module")
def suite():
    """The port's three backends on one F at n = 2^12, 4 seeds each."""
    params, F = _attributes(LG, 1)
    ranks = quilt.build_quilt_plan(F, params.thetas, device="cpu").part.ranks
    bins = validate.degree_bin_edges(1 << LG)
    out = {}
    for b in BACKENDS:
        s = MAGMSampler(SamplerConfig(params=params, F=F, backend=b, device="cpu"))
        out[b] = validate.collect(b, lambda k: s.sample(prng.PRNGKey(k)).edges, SEEDS, 1 << LG, ranks, bins)
    return out, validate.theory_moments(F, params.thetas.numpy())


@pytest.mark.parametrize(
    "a, b", list(itertools.combinations(BACKENDS, 2)), ids=["~".join(p) for p in itertools.combinations(BACKENDS, 2)]
)
def test_cross_backend_equivalence(suite, a, b):
    st, _ = suite
    claims = validate.compare_backends(st[a], st[b], nsigma=3.0)
    assert not validate.failures(claims), validate.failures(claims)


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_matches_theory(suite, backend):
    st, tm = suite
    claims = validate.compare_to_theory(st[backend], tm, nsigma=3.0)
    assert not validate.failures(claims), validate.failures(claims)


@pytest.mark.parametrize("backend", ("auto", "balldrop"))
def test_per_cell_block_z(suite, backend):
    """The exact-cell laws: every (rank, rank) block mean within 3 of its
    standard error (Poisson-scale proxy beside the binomial variance)."""
    st, tm = suite
    k = st[backend].blocks.shape[0]
    se = np.sqrt((tm.block_std**2 + np.abs(tm.block_mean) + 1.0) / k)
    z = (st[backend].blocks.mean(axis=0) - tm.block_mean) / se
    assert float(np.abs(z).max()) <= 3.0, z
