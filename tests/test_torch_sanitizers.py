"""Runtime sanitizers of the port's hot path: the counterparts of
``tests/test_sanitizers.py``, backing the static linter
(``repro_torch.lint``).

- **host -> device copies** (``cuda``): warm sessions of the three MAGM
  backends make no host -> device copy in ``sample()`` or
  ``sample_stream()`` (``torch.profiler``'s ``Memcpy HtoD`` events), where
  the reference samples under ``jax.transfer_guard("disallow")``.
- **rebuild budget** (``cuda``): a warm call runs no ``nvcc`` and loads no
  library (``ctypes.CDLL``), where the reference's warm calls compile
  nothing.
- On the CPU: the counters are not vacuous, the split's heavy round never
  reaches the host binomials, and the exact-cell sanity checks (exact mode
  against the drawn-target law, one round with no top-up, explicit targets
  keep the ranked rounds, ``exact_cells`` forwarded by the config).

The card tests skip here through ``cuda_device``; ``chip_smoke.py --lint``
runs the same instruments at full size.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from test_torch_reference import cuda_device  # noqa: F401  (fixture)

from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.core import balldrop, magm, prng, quilt
from repro_torch.kernels import _build

torch.set_num_threads(1)

THETA = np.array([[0.35, 0.52], [0.52, 0.95]], dtype=np.float32)
N, D = 128, 7

BACKEND_CONFIGS = {
    "quilt": dict(backend="auto"),
    "split": dict(backend="auto", split=True),
    "balldrop": dict(backend="balldrop"),
}


def _attributes(params):
    return magm.sample_attributes(prng.PRNGKey(3), N, params.mu, device="cpu").numpy()


def _make_sampler(device="cpu", mu=0.5, **kw):
    params = magm.make_params(THETA, mu, D)
    return MAGMSampler(SamplerConfig(params=params, F=_attributes(params), device=device, **kw))


@contextlib.contextmanager
def count_builds():
    """Counts of ``nvcc`` runs (``_build._nvcc``) and library loads
    (``ctypes.CDLL``) inside the block."""
    counts = {"nvcc": 0, "cdll": 0}
    nvcc, cdll = _build._nvcc, ctypes.CDLL

    def counted_nvcc(*args, **kwargs):
        counts["nvcc"] += 1
        return nvcc(*args, **kwargs)

    class CountedCDLL(cdll):
        def __init__(self, *args, **kwargs):
            counts["cdll"] += 1
            super().__init__(*args, **kwargs)

    _build._nvcc, ctypes.CDLL = counted_nvcc, CountedCDLL
    try:
        yield counts
    finally:
        _build._nvcc, ctypes.CDLL = nvcc, cdll


def htod_copies(fn) -> tuple:
    """(host -> device copies, device events) of one call of ``fn``; the
    program's spans, device-side user annotations, are no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type != DeviceType.CPU and not e.is_user_annotation]
    return sum(e.name.startswith("Memcpy HtoD") for e in device), len(device)


@pytest.fixture(params=sorted(BACKEND_CONFIGS))
def warm_cuda_sampler(request, cuda_device):
    """A sampler of each backend on the card, warmed on two distinct keys."""
    sampler = _make_sampler(cuda_device, **BACKEND_CONFIGS[request.param])
    sampler.sample(prng.PRNGKey(0))
    sampler.sample(prng.PRNGKey(1))
    return sampler


# ---------------------------------------------------------------------------
# host -> device copies and the rebuild budget, on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_no_htod_copy_warm_sample(warm_cuda_sampler):
    # key built outside the count: the count polices the hot path, not the
    # test's own setup
    key = prng.PRNGKey(2)
    copies, events = htod_copies(lambda: warm_cuda_sampler.sample(key))
    assert events > 0, "the profiler saw no device event"
    assert copies == 0


@pytest.mark.cuda
def test_no_htod_copy_warm_stream(warm_cuda_sampler):
    key = prng.PRNGKey(2)
    ref = warm_cuda_sampler.sample(key).edges
    list(warm_cuda_sampler.sample_stream(prng.PRNGKey(1), chunk_edges=256))
    got = []
    copies, events = htod_copies(lambda: got.extend(warm_cuda_sampler.sample_stream(key, chunk_edges=256)))
    assert events > 0 and copies == 0
    np.testing.assert_array_equal(np.concatenate(got, axis=0), ref)


@pytest.mark.cuda
def test_zero_builds_warm_sample(warm_cuda_sampler):
    with count_builds() as c:
        warm_cuda_sampler.sample(prng.PRNGKey(2))
    assert c == {"nvcc": 0, "cdll": 0}


@pytest.mark.cuda
def test_zero_builds_warm_stream(warm_cuda_sampler):
    list(warm_cuda_sampler.sample_stream(prng.PRNGKey(2), chunk_edges=256))
    with count_builds() as c:
        list(warm_cuda_sampler.sample_stream(prng.PRNGKey(4), chunk_edges=256))
    assert c == {"nvcc": 0, "cdll": 0}


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def test_build_counter_detects_builds_and_loads(tmp_path, monkeypatch):
    """The counters are not vacuous: a cold build runs ``_nvcc`` (here a
    compiler that fails at once), and a library load is a ``CDLL``."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    nvcc, cdll = _build._nvcc, ctypes.CDLL
    with count_builds() as c:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _build.build_all(["bernoulli_tile"])
        ctypes.CDLL(None)
    assert c == {"nvcc": 1, "cdll": 1}
    assert (_build._nvcc, ctypes.CDLL) == (nvcc, cdll)


def test_split_hot_path_never_touches_host_binomial(monkeypatch):
    """The section-5 heavy round is device-resident: a split session keyed
    from ``key`` alone never reaches ``quilt.rng_from_key`` (the numpy
    binomial host fallback).  Skewed mu guarantees real heavy mass."""
    sampler = _make_sampler(mu=0.75, split=True)
    sp = sampler.split_plan
    assert sp.R > 0, "fixture must exercise the heavy groups"
    assert sp.heavy_budget is not None and sp.heavy_budget > 0

    def _boom(key):
        raise AssertionError("rng_from_key called on the split hot path")

    monkeypatch.setattr(quilt, "rng_from_key", _boom)
    gs = sampler.sample(prng.PRNGKey(21))
    assert gs.edges.shape[0] > 0


def _plan():
    params = magm.make_params(THETA, 0.5, D)
    F = _attributes(params)
    return quilt.get_quilt_plan(F, params.thetas, device="cpu"), params, F


def _dense_truth(params, F):
    """Sum of per-pair Bernoulli probabilities (the exact-mode target)."""
    lam = magm.configs_from_attributes(torch.from_numpy(F)).numpy()
    P = np.ones((1, 1))
    for th in params.thetas.numpy().astype(np.float64):
        P = np.kron(P, th)
    return P[np.ix_(lam, lam)].sum()


@pytest.mark.parametrize("engine", ["quilt", "balldrop"])
def test_exact_vs_legacy_mean_edges(engine):
    plan, params, F = _plan()
    truth = _dense_truth(params, F)
    run = quilt.quilt_run if engine == "quilt" else balldrop.balldrop_run

    def mean(exact):
        return np.mean([run(prng.PRNGKey(s), plan, exact_cells=exact).edges().shape[0] for s in range(6)])

    se = np.sqrt(truth / 6.0)
    ex = mean(True)
    assert abs(ex - truth) < 4 * se
    if engine == "quilt":
        assert abs(ex - mean(False)) < 8 * se


def test_exact_single_round_no_topup():
    """Exact mode is one plan-constant round: realized targets equal
    realized counts (no shortfall loop ran)."""
    plan, _, _ = _plan()
    run = quilt.quilt_run(prng.PRNGKey(11), plan, max_rounds=1)
    edges = run.edges()
    assert edges.shape[0] == int(np.asarray(run.targets).sum())
    assert np.unique(edges, axis=0).shape[0] == edges.shape[0]


def test_exact_fallback_counter_on_explicit_targets():
    """Explicit targets keep the ranked-round contract (KPGM sessions)."""
    plan, _, _ = _plan()
    targets = np.full(plan.B**2, 3, dtype=np.int64)
    before = quilt.DISPATCH_COUNTERS["exact_fallbacks"]
    run = quilt.quilt_run(prng.PRNGKey(1), plan, targets=targets)
    assert quilt.DISPATCH_COUNTERS["exact_fallbacks"] == before
    assert int(np.asarray(run.targets).sum()) == 3 * plan.B**2


def test_exact_cells_config_forwarding():
    """SamplerConfig.exact_cells=False reaches the engine, and a non-bool
    is refused."""
    s_exact = _make_sampler()
    s_legacy = _make_sampler(exact_cells=False)
    for g in (s_exact.sample(prng.PRNGKey(5)), s_legacy.sample(prng.PRNGKey(5))):
        assert g.edges.min() >= 0 and g.edges.max() < N
    with pytest.raises(ValueError):
        SamplerConfig(params=s_exact.config.params, exact_cells="yes")
