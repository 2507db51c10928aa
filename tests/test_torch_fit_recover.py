"""Edge ingest, the round trip and the fitting surface in the port against
the reference: ``data.pipeline.build_csr``, ``fit.ingest`` (arrays, text,
``.npy`` and ``.npz`` sources, every option), ``fit.recover`` (hard
attributes, flips, canonicalization, the fitted config, the host
ground-truth sampler, the bootstrap, ``recover``), ``api.fit_config``,
the ``fit`` package's exports and ``interop``'s FitResult conversions.

Bit-equal: ``build_csr``, ``load_edge_list``, ``to_csr``, ``fit_data``,
``hard_attributes``, ``flip_params``, ``canonicalize``, ``exact_edges`` and
``recover``'s observed edges.  ``bootstrap_theta_se`` of one fit:
``rtol=1e-3`` (float32 statistics summed in another order, then a
closed-form root).  Fits themselves are held to the reference in
``test_torch_magfit.py``; here a fit made by ``recover`` or
``fit_config`` is held to the tolerances found there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import cuda_device, ref  # noqa: F401  (fixtures)

import repro_torch.fit as fit_pkg
from repro_torch import api, interop
from repro_torch.core import magm, prng
from repro_torch.data import pipeline
from repro_torch.dist import hints
from repro_torch.fit import ingest
from repro_torch.fit import magfit as mf
from repro_torch.fit import recover as rc
from repro_torch.kernels import ops

THETA = np.array([[0.3, 0.6], [0.6, 0.85]], dtype=np.float32)
THETA_FIT = np.array([[0.25, 0.55], [0.55, 0.82]], dtype=np.float32)  # bench_fit.py's
OPTS = dict(order=3, em_iters=1)  # one known-F EM iteration, as test_torch_magfit.py measures it


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the suite runs in several processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _same_edge_list(got: ingest.EdgeList, want) -> None:
    assert got.n == want.n and got.edges.dtype == np.int64
    assert np.array_equal(got.edges, want.edges)
    if want.node_ids is None:
        assert got.node_ids is None
    else:
        assert np.array_equal(got.node_ids, want.node_ids)


def _sparse_edges(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = np.array([3, 10, 11, 40, 41, 97])
    e = ids[rng.integers(0, ids.size, (30, 2))]
    return np.concatenate([e, e[:4], [[10, 10]]])  # duplicates and a self-loop


# -- CSR and ingest --------------------------------------------------------------


def test_build_csr_bit_equal(ref):
    e = _sparse_edges()
    for edges, n in ((e, 98), (np.zeros((0, 2), np.int64), 5)):
        for got, want in zip(pipeline.build_csr(edges, n), ref.pipeline.build_csr(edges, n)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    for bad in (np.array([[5, 0]]), np.array([[-1, 0]])):
        with pytest.raises(ValueError, match="sources"):
            pipeline.build_csr(bad, 5)


OPTIONS = [
    dict(),
    dict(n=120),
    dict(dedup=False),
    dict(drop_self_loops=True),
    dict(symmetrize=True),
    dict(compact=True, symmetrize=True, drop_self_loops=True),
    dict(compact=False),
    dict(n=98, compact=True),
]


@pytest.mark.parametrize("kw", OPTIONS, ids=[",".join(k) or "defaults" for k in OPTIONS])
def test_load_edge_list_bit_equal(ref, kw):
    e = _sparse_edges()
    _same_edge_list(ingest.load_edge_list(e, **kw), ref.ingest.load_edge_list(e, **kw))
    contiguous = e % 7
    _same_edge_list(ingest.load_edge_list(contiguous, **kw), ref.ingest.load_edge_list(contiguous, **kw))


@pytest.mark.parametrize("fmt", ["txt", "csv", "npy", "npz"])
def test_load_edge_list_files_bit_equal(ref, tmp_path, fmt):
    """SNAP / KONECT text (``#`` and ``%`` comments, blank lines, commas,
    extra columns), ``.npy`` and ``.npz``: the same EdgeList as the
    reference from the same file."""
    e = _sparse_edges(1)
    path = tmp_path / f"g.{fmt}"
    if fmt in ("txt", "csv"):
        sep = "\t" if fmt == "txt" else ","
        rows = [f"{a}{sep}{b}" + (f"{sep}1.0" if i % 3 == 0 else "") for i, (a, b) in enumerate(e)]
        path.write_text("# SNAP header\n% KONECT header\n\n" + "\n".join(rows) + "\n")
    elif fmt == "npy":
        np.save(path, e)
    else:
        np.savez(path, edges=e, other=np.zeros(3))
    for kw in ({}, {"symmetrize": True, "compact": True}):
        _same_edge_list(ingest.load_edge_list(str(path), **kw), ref.ingest.load_edge_list(str(path), **kw))
    _same_edge_list(ingest.load_edge_list(path), ref.ingest.load_edge_list(path))


def test_load_edge_list_rejects_what_the_reference_rejects(ref, tmp_path):
    bad_npz = tmp_path / "bad.npz"
    np.savez(bad_npz, pairs=np.zeros((2, 2)))
    bad_txt = tmp_path / "bad.txt"
    bad_txt.write_text("1 2\n3\n")
    cases = [
        (np.zeros((3, 3)), "shape"),
        (np.array([[0.5, 1.0]]), "integers"),
        (np.array([[-1, 2]]), "non-negative"),
        (str(bad_npz), "'edges'"),
        (str(bad_txt), "bad edge line"),
    ]
    for source, match in cases:
        for load in (ingest.load_edge_list, ref.ingest.load_edge_list):
            with pytest.raises(ValueError, match=match):
                load(source)
    for load in (ingest.load_edge_list, ref.ingest.load_edge_list):
        with pytest.raises(ValueError, match="out of range"):
            load(np.array([[0, 9]]), n=5)
    as_float = ingest.load_edge_list(np.array([[1.0, 2.0], [2.0, 0.0]]))
    _same_edge_list(as_float, ref.ingest.load_edge_list(np.array([[1.0, 2.0], [2.0, 0.0]])))


def test_to_csr_and_fit_data_bit_equal(ref):
    el, rel = ingest.load_edge_list(_sparse_edges(2)), ref.ingest.load_edge_list(_sparse_edges(2))
    for got, want in zip(ingest.to_csr(el), ref.ingest.to_csr(rel)):
        assert np.array_equal(got, want)
    for shard_size in (None, 8):
        got = ingest.fit_data(el, shard_size=shard_size, device="cpu")
        want = ref.ingest.fit_data(rel, shard_size=shard_size)
        assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))
    mesh = hints.MeshShape(("graphs",), (4,))  # names and sizes are all the rounding reads
    got = ingest.fit_data(el, shard_size=8, mesh=mesh, device="cpu")
    want = ref.ingest.fit_data(rel, shard_size=8, mesh=mesh)
    assert got.src.shape[0] % 4 == 0 and got.src.shape[0] > ingest.fit_data(el, shard_size=8, device="cpu").src.shape[0]
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))


# -- recover's host parts ----------------------------------------------------------


def _theta_cases():
    rng = np.random.default_rng(3)
    th = rng.uniform(0.05, 0.95, (5, 2, 2))
    th[1] = [[0.7, 0.2], [0.4, 0.7]]  # t00 == t11: the tie goes to (t10, t01)
    th[2] = th[4]  # equal slices: the sort falls back to mu
    mu = np.array([0.3, 0.6, 0.5, 0.2, 0.4])
    phi = rng.uniform(0.0, 1.0, (16, 5)).astype(np.float32)
    return th, mu, phi


def test_hard_attributes_and_flips_bit_equal(ref):
    th, mu, phi = _theta_cases()
    phi[0, 0] = 0.5  # not above 1/2
    got = rc.hard_attributes(phi)
    assert got.dtype == np.int8 and np.array_equal(got, ref.recover.hard_attributes(phi))
    assert np.array_equal(rc.hard_attributes(torch.from_numpy(phi)), got)
    flips = np.array([True, False, True, False, True])
    for g, w in zip(rc.flip_params(th, mu, flips), ref.recover.flip_params(th, mu, flips)):
        assert g.dtype == np.float64 and np.array_equal(g, w)
    assert np.array_equal(rc.flip_params(*rc.flip_params(th, mu, flips), flips)[0], th)


@pytest.mark.parametrize("kw", [dict(), dict(sort=False), dict(equalize_scale=False)])
def test_canonicalize_bit_equal(ref, kw):
    th, mu, phi = _theta_cases()
    got = rc.canonicalize(th, mu, phi, **kw)
    want = ref.recover.canonicalize(th, mu, phi, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    got_t = rc.canonicalize(torch.from_numpy(th.astype(np.float32)), torch.from_numpy(mu.astype(np.float32)))
    want_t = ref.recover.canonicalize(th.astype(np.float32), mu.astype(np.float32))
    assert got_t[2] is None and all(np.array_equal(g, w) for g, w in zip(got_t[:2] + got_t[3:], want_t[:2] + want_t[3:]))


@pytest.mark.parametrize("n,d,block", [(200, 3, 512), (300, 4, 64)])
def test_exact_edges_bit_equal(ref, n, d, block):
    import jax

    params = magm.make_params(THETA, 0.5, d)
    F = magm.sample_attributes(prng.PRNGKey(1), n, params.mu, device="cpu").numpy()
    rparams = ref.magm.make_params(THETA, 0.5, d)
    assert np.array_equal(F, np.asarray(ref.magm.sample_attributes(jax.random.PRNGKey(1), n, rparams.mu)))
    got = rc.exact_edges(params, F, 9, block=block)
    assert np.array_equal(got, ref.recover.exact_edges(rparams, F, 9, block=block))
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < n


def test_fitted_config_samples():
    fit = mf.FitResult(
        params=magm.make_params(THETA, 0.5, 3),
        phi=np.random.default_rng(0).uniform(0, 1, (64, 3)).astype(np.float32),
        elbo_trace=np.zeros(1), iterations=1, converged=False,
    )
    cfg = rc.fitted_config(fit, device="cpu")
    assert np.array_equal(cfg.F, rc.hard_attributes(fit.phi)) and cfg.backend == "auto"
    assert cfg.device == "cpu" and cfg.params is fit.params
    gs = api.MAGMSampler(cfg).sample(prng.PRNGKey(0))
    assert gs.n == 64 and gs.num_edges > 0
    redraw = rc.fitted_config(fit, F=None, num_nodes=32, device="cpu", backend="host")
    assert api.MAGMSampler(redraw).n == 32 and redraw.backend == "host"


# -- interop, bootstrap, recover, fit_config ------------------------------------------


@pytest.fixture(scope="module")
def ref_fit(ref):
    """(a reference known-F fit, its edges), made once for the module."""
    return _ref_known_f_fit(ref)


def _ref_known_f_fit(ref, seed=20, n=1 << 8, d=3):
    import jax

    rparams = ref.magm.make_params(THETA, 0.5, d)
    F = np.asarray(ref.magm.sample_attributes(jax.random.PRNGKey(seed), n, rparams.mu))
    edges = ref.recover.exact_edges(rparams, F, seed + 1)
    fit = ref.magfit.magfit(edges, n, d, key=jax.random.PRNGKey(0), options=ref.magfit.FitOptions(**OPTS),
                            phi_init=F.astype(np.float32), fit_phi=False)
    return fit, edges


def test_interop_fit_result_round_trip(ref, ref_fit):
    import jax.numpy as jnp

    rfit, _ = ref_fit
    got = interop.fit_from_reference(rfit)
    assert isinstance(got, mf.FitResult) and got.params.thetas.dtype == torch.float32
    assert np.array_equal(got.params.thetas.numpy(), np.asarray(rfit.params.thetas))
    assert np.array_equal(got.params.mu.numpy(), np.asarray(rfit.params.mu))
    assert np.array_equal(got.phi, rfit.phi) and np.array_equal(got.elbo_trace, rfit.elbo_trace)
    assert (got.iterations, got.converged, got.n, got.d) == (rfit.iterations, rfit.converged, rfit.n, rfit.d)
    back = interop.fit_to_reference(got)
    th, mu = back.pop("params")
    again = ref.magfit.FitResult(params=ref.magm.MAGMParams(jnp.asarray(th), jnp.asarray(mu)), **back)
    for a, b in ((again.params.thetas, rfit.params.thetas), (again.params.mu, rfit.params.mu),
                 (again.phi, rfit.phi), (again.elbo_trace, rfit.elbo_trace)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert (again.iterations, again.converged) == (rfit.iterations, rfit.converged)


def test_reference_fit_bootstrapped_by_the_port(ref, ref_fit):
    """A reference fit carried over by ``interop`` and bootstrapped by the
    port gives the reference's SEs, ``rtol=1e-3``; the port's canonical
    thetas of it equal the reference's bit for bit."""
    rfit, edges = ref_fit
    want = ref.recover.bootstrap_theta_se(rfit, edges, num_boot=6, seed=3)
    pfit = interop.fit_from_reference(rfit)
    got = rc.bootstrap_theta_se(pfit, edges, num_boot=6, seed=3, device="cpu")
    assert got.shape == (3, 2, 2) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-3)
    for g, w in zip(rc.canonicalize(pfit.params.thetas, pfit.params.mu, pfit.phi),
                    ref.recover.canonicalize(np.asarray(rfit.params.thetas), np.asarray(rfit.params.mu), rfit.phi)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("exact_observed", [False, True], ids=["session", "exact"])
def test_recover_observed_graph_bit_equal(ref, exact_observed):
    """``recover``'s observed edges (the session's sample, or the exact
    host sampler seeded by ``prng.randint``) and its true config's
    attributes equal the reference's; its known-F fit is within
    ``test_torch_magfit.py``'s known-F tolerances (trace ``rtol=3e-5``,
    thetas ``atol=3e-2``)."""
    import jax

    n, d = 1 << 8, 3
    want = ref.recover.recover(ref.magm.make_params(THETA, 0.5, d), n, key=jax.random.PRNGKey(6),
                               options=ref.magfit.FitOptions(**OPTS), known_F=True, exact_observed=exact_observed)
    got = rc.recover(magm.make_params(THETA, 0.5, d), n, key=prng.PRNGKey(6), options=mf.FitOptions(**OPTS),
                     known_F=True, exact_observed=exact_observed, device="cpu")
    assert got.edges.dtype == np.int64 and np.array_equal(got.edges, want.edges)
    assert np.array_equal(api.MAGMSampler(got.true_config).F, np.asarray(ref.api.MAGMSampler(want.true_config).F))
    assert got.true_config.device == torch.device("cpu") and got.config.device == torch.device("cpu")
    assert (got.fit.iterations, got.fit.converged) == (want.fit.iterations, want.fit.converged)
    np.testing.assert_allclose(got.fit.elbo_trace, want.fit.elbo_trace, rtol=3e-5)
    np.testing.assert_allclose(got.fit.params.thetas.numpy(), np.asarray(want.fit.params.thetas), atol=3e-2)
    assert np.array_equal(got.config.F, rc.hard_attributes(got.fit.phi))
    assert got.theta_se is None and got.flips.shape == (d,) and sorted(got.order) == list(range(d))


def test_recover_bootstrap_se_scale_sane():
    """The reference's ``test_bootstrap_se_scale_sane`` through the port's
    ``recover`` at its n = 2^10, d = 3: a known-F fit of an exact graph
    (order 3, 2 EM iterations where the reference's test runs 4) with 8
    bootstrap replicates (the reference's 12) gives SEs in (0, 0.1) and a
    non-decreasing trace.  (The 3-sigma recovery claim is
    the reference's at n = 2^12, d = 5, where the order-4 truncation bias
    is small; ``chip_smoke.py --fit`` holds the port to it on the card.)"""
    rep = rc.recover(magm.make_params(THETA, 0.5, 3), 1 << 10, key=prng.PRNGKey(20),
                     options=mf.FitOptions(order=3, em_iters=2), known_F=True, exact_observed=True,
                     num_boot=8, device="cpu")
    assert rep.theta_se.shape == (3, 2, 2)
    assert np.all(rep.theta_se > 0) and np.all(rep.theta_se < 0.1)
    assert np.all(np.diff(rep.fit.elbo_trace) >= 0)
    np.testing.assert_allclose(rep.theta_hat, rc.canonicalize(THETA[None].repeat(3, 0), np.full(3, 0.5))[0],
                               atol=0.1)


D3 = dict(n=1 << 10, d=3, key=20, boot=8, opts=dict(order=3, em_iters=2))


def _d3_reports(ref, theta=THETA):
    """The reference's and the port's ``recover`` at D3 (the inputs of
    ``test_recover_bootstrap_se_scale_sane``), and the seed their
    bootstraps draw from ``recover``'s fourth key."""
    import jax

    n, d, key, boot = D3["n"], D3["d"], D3["key"], D3["boot"]
    want = ref.recover.recover(ref.magm.make_params(theta, 0.5, d), n, key=jax.random.PRNGKey(key),
                               options=ref.magfit.FitOptions(**D3["opts"]), known_F=True, exact_observed=True,
                               num_boot=boot)
    got = rc.recover(magm.make_params(theta, 0.5, d), n, key=prng.PRNGKey(key), options=mf.FitOptions(**D3["opts"]),
                     known_F=True, exact_observed=True, num_boot=boot, device="cpu")
    seed = int(prng.randint(prng.split(prng.PRNGKey(key), 4)[3], (), 0, 2**31 - 1))
    return want, got, seed


def _max_z(rep, theta) -> float:
    """The recovery claim's statistic (``TestRecovery``): the largest
    |theta_hat - truth| / sqrt(SE^2 + 0.002^2) over the canonical entries."""
    d = rep.theta_hat.shape[0]
    truth = rc.canonicalize(theta[None].repeat(d, 0), np.full(d, 0.5))[0]
    return float((np.abs(rep.theta_hat - truth) / np.sqrt(rep.theta_se**2 + 2e-3**2)).max())


def test_recover_at_d3_against_the_reference(ref):
    """``test_recover_bootstrap_se_scale_sane``'s inputs (n = 2^10, d = 3,
    key 20, order 3, 2 EM iterations, 8 bootstrap replicates) through the
    reference's ``recover`` and the port's: the observed edges bit for
    bit, the trace and ``theta_hat`` to the known-F tolerances (trace
    ``rtol=3e-5``, thetas ``atol=3e-2``), ``theta_se`` to the bootstrap's
    ``rtol=1e-3`` with both packages bootstrapping the same fit, plus
    ``atol=3e-5``: at n = 2^10 a replicate's canonical thetas differ
    between the packages by up to ~2e-5 (float32 statistics summed in
    another order), and a standard deviation moves by at most its
    replicates' largest move times sqrt(8 / 7).  The two fits differ by
    float noise, and that alone can move a canonical SE by tens of percent
    here: the three attributes share one truth, so replicates sort
    near-tied attributes either way.  The reference misses the 3-sigma
    claim at this setting with its own SEs, as the port does: the miss is
    the model's (TestRecovery's note on d <= 3), not the port's.  Run this
    file as a script for the measured distances."""
    import jax.numpy as jnp

    want, got, seed = _d3_reports(ref)
    boot = D3["boot"]
    assert np.array_equal(got.edges, want.edges)
    np.testing.assert_allclose(got.fit.elbo_trace, want.fit.elbo_trace, rtol=3e-5)
    np.testing.assert_allclose(got.theta_hat, want.theta_hat, atol=3e-2)
    port_of_ref = rc.bootstrap_theta_se(interop.fit_from_reference(want.fit), want.edges, num_boot=boot, seed=seed,
                                        device="cpu")
    np.testing.assert_allclose(port_of_ref, want.theta_se, rtol=1e-3, atol=3e-5)
    back = interop.fit_to_reference(got.fit)
    th, mu = back.pop("params")
    rfit = ref.magfit.FitResult(params=ref.magm.MAGMParams(jnp.asarray(th), jnp.asarray(mu)), **back)
    np.testing.assert_allclose(got.theta_se, ref.recover.bootstrap_theta_se(rfit, got.edges, num_boot=boot, seed=seed),
                               rtol=1e-3, atol=3e-5)
    assert _max_z(want, THETA) > 3.0, "the reference meets the 3-sigma claim at d = 3: the port's miss needs a look"


def test_fit_config_packages_a_fit():
    edges = rc.exact_edges(magm.make_params(THETA, 0.5, 3),
                           magm.sample_attributes(prng.PRNGKey(2), 64, magm.make_params(THETA, 0.5, 3).mu,
                                                  device="cpu").numpy(), 3)
    opts = mf.FitOptions(order=2, em_iters=2, estep_steps=6, mstep_steps=3)
    cfg, fit = api.fit_config(edges, 64, 3, key=prng.PRNGKey(1), options=opts, device="cpu", backend="host")
    direct = mf.magfit(edges, 64, 3, key=prng.PRNGKey(1), options=opts, device="cpu")
    assert np.array_equal(fit.phi, direct.phi) and torch.equal(fit.params.thetas, direct.params.thetas)
    assert np.array_equal(cfg.F, rc.hard_attributes(fit.phi)) and cfg.backend == "host"
    assert cfg.device == torch.device("cpu")
    gs = api.MAGMSampler(cfg).sample(prng.PRNGKey(5))
    assert gs.n == 64 and gs.num_edges > 0


def test_fit_package_exports(ref):
    assert fit_pkg.fit is mf.magfit and fit_pkg.roundtrip is rc.recover
    assert set(ref.recover.__all__) <= set(dir(rc))
    import importlib

    ref_fit = importlib.import_module("repro.fit")
    assert set(ref_fit.__all__) <= set(fit_pkg.__all__)
    assert "fit_config" in api.__all__


def test_round_trip_defaults_to_cuda():
    params = magm.make_params(THETA, 0.5, 3)
    edges = np.array([[0, 1], [1, 2]])
    calls = [
        lambda: rc.recover(params, 16, options=mf.FitOptions(em_iters=1)),
        lambda: api.fit_config(edges, 4, 2, options=mf.FitOptions(em_iters=1)),
        lambda: ingest.fit_data(ingest.load_edge_list(edges)),
    ]
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


@pytest.mark.cuda
def test_cuda_round_trip_matches_cpu(cuda_device):
    """On the card: the observed sample launches kernel 1 and equals the
    CPU's; the fitted config resamples through kernel 1 again."""
    params = magm.make_params(THETA, 0.5, 8)
    opts = mf.FitOptions(order=2, em_iters=1, estep_steps=4, mstep_steps=2)
    ops.reset_kernel_launches()
    gpu = rc.recover(params, 1 << 8, key=prng.PRNGKey(3), options=opts, device=cuda_device)
    assert ops.kernel_launches()["quilt_prng_descent_lookup"] >= 1
    cpu = rc.recover(params, 1 << 8, key=prng.PRNGKey(3), options=opts, device="cpu")
    assert np.array_equal(gpu.edges, cpu.edges)
    assert gpu.config.device.type == "cuda"
    ops.reset_kernel_launches()
    gs = api.MAGMSampler(gpu.config).sample(prng.PRNGKey(4))
    assert ops.kernel_launches()["quilt_prng_descent_lookup"] >= 1 and gs.num_edges > 0


def _measure() -> None:
    """The D3 comparison's numbers, for both thetas of this file."""
    from test_torch_reference import reference_package

    torch.set_num_threads(1)
    with reference_package() as ref:
        for name, theta in (("THETA", THETA), ("THETA_FIT", THETA_FIT)):
            want, got, _ = _d3_reports(ref, theta)
            se_rel = np.abs(got.theta_se - want.theta_se) / want.theta_se
            print(f"{name}: max z reference {_max_z(want, theta):.3f} port {_max_z(got, theta):.3f}; "
                  f"|theta_hat diff| {np.abs(got.theta_hat - want.theta_hat).max():.3g}; "
                  f"theta_se relative diff up to {se_rel.max():.3f}")


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fit_recover.py
    _measure()
