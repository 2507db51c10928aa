"""The generate -> fit -> generate round trip.

Sample a graph from known MAG parameters through :class:`MAGMSampler` on
the card, estimate ``(F, thetas, mu)`` back from nothing but the edge list
(:func:`repro_torch.fit.magfit.magfit`), and package the estimate as a
fitted :class:`SamplerConfig` that ``MAGMSampler`` resamples at any scale.

Identifiability.  The MAG likelihood is invariant under per-attribute bit
flips (``theta'[a,b] = theta[1-a, 1-b]``, ``mu' = 1 - mu``), attribute
permutations, and per-attribute scale (one slice times c, another times
1/c, leaves every Q_ij unchanged).  :func:`canonicalize` quotients these
out so that fits from different runs, or the truth, compare entrywise;
:func:`bootstrap_theta_se` measures estimator spread by resampling the
observed edges with the posteriors held fixed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.core import magm, prng
from repro_torch.core.device import resolve_device
from repro_torch.fit.magfit import (
    FitOptions,
    FitResult,
    closed_form_thetas,
    magfit as _run_magfit,
    shard_edges,
    suff_stats,
)


class RecoveryReport(NamedTuple):
    """Everything the round trip produced, fit and both sampler configs."""

    fit: FitResult
    config: SamplerConfig  # fitted (F_hat, thetas_hat): ready for MAGMSampler
    true_config: SamplerConfig  # the config the observed graph came from
    edges: np.ndarray  # the observed (fitted) edge list
    theta_hat: np.ndarray  # canonicalized fitted thetas (d, 2, 2)
    mu_hat: np.ndarray  # canonicalized fitted mu (d,)
    theta_se: Optional[np.ndarray]  # bootstrap SEs in canonical coordinates
    flips: np.ndarray  # (d,) bool: attributes flipped by canonicalization
    order: np.ndarray  # (d,) attribute sort applied by canonicalization


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def hard_attributes(phi: np.ndarray) -> np.ndarray:
    """MAP attribute matrix: posterior means thresholded at 1/2."""
    return (_host(phi) > 0.5).astype(np.int8)


def flip_params(thetas: np.ndarray, mu: np.ndarray, flips: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Apply per-attribute bit flips: ``theta'[a,b] = theta[1-a,1-b]``."""
    thetas = _host(thetas).astype(np.float64)
    mu = _host(mu).astype(np.float64)
    f = np.asarray(flips, dtype=bool)
    thetas[f] = thetas[f][:, ::-1, ::-1]
    mu[f] = 1.0 - mu[f]
    return thetas, mu


def canonicalize(thetas, mu, phi=None, *, sort: bool = True, equalize_scale: bool = True):
    """Quotient out the MAG symmetries: orient each attribute's bit
    labeling, equalize the per-attribute scales, then sort attributes.

    Flip attribute k iff ``(t00, t10) > (t11, t01)`` lexicographically (the
    1-bit is the stronger side); rescale every slice to the common
    geometric mean ``g = (prod_k g_k)^(1/d)``, which keeps every edge
    probability; sort by the flattened canonical theta, then mu.  Returns
    ``(thetas, mu, phi, flips, order)`` in float64, ``phi`` None when not
    supplied.
    """
    thetas = _host(thetas).astype(np.float64)
    mu = _host(mu).astype(np.float64)
    t00, t01 = thetas[:, 0, 0], thetas[:, 0, 1]
    t10, t11 = thetas[:, 1, 0], thetas[:, 1, 1]
    flips = (t00 > t11) | ((t00 == t11) & (t10 > t01))
    thetas_c, mu_c = flip_params(thetas, mu, flips)
    if equalize_scale:
        g_k = np.exp(np.mean(np.log(np.maximum(thetas_c, 1e-12)), axis=(1, 2)))
        g = np.exp(np.mean(np.log(g_k)))
        thetas_c = thetas_c * (g / g_k)[:, None, None]
    phi_c = None
    if phi is not None:
        phi_c = _host(phi).astype(np.float64)
        phi_c[:, flips] = 1.0 - phi_c[:, flips]
    if sort:
        keys = np.concatenate([thetas_c.reshape(len(mu_c), 4), mu_c[:, None]], axis=1)
        order = np.array(sorted(range(len(mu_c)), key=lambda k: tuple(keys[k])))
    else:
        order = np.arange(len(mu_c))
    thetas_c = thetas_c[order]
    mu_c = mu_c[order]
    if phi_c is not None:
        phi_c = phi_c[:, order]
    return thetas_c, mu_c, phi_c, flips, order


def fitted_config(fit: FitResult, *, backend: str = "auto", **overrides) -> SamplerConfig:
    """A :class:`SamplerConfig` sampling from the fitted model, conditioned
    on the MAP attributes ``hard_attributes(phi)``; ``overrides`` go to
    the config (``device=``, or ``F=None, num_nodes=...`` to redraw the
    attributes from the fitted ``mu``)."""
    kwargs = dict(params=fit.params, F=hard_attributes(fit.phi), backend=backend)
    kwargs.update(overrides)
    return SamplerConfig(**kwargs)


def bootstrap_theta_se(
    fit: FitResult,
    edges: np.ndarray,
    *,
    num_boot: int = 24,
    seed: int = 0,
    shard_size: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Bootstrap standard errors of the fitted thetas, (d, 2, 2) float64.

    Each replicate redraws the observed edges with replacement (numpy,
    ``default_rng(seed)``), rebuilds the order-2 sufficient statistics on
    ``device`` (default ``"cuda"``) with the posteriors held fixed, and
    re-solves the closed form at the fitted point; replicates are
    canonicalized like the fit.
    """
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    n, e = fit.n, edges.shape[0]
    phi = torch.as_tensor(fit.phi, dtype=torch.float32).to(dev)
    thetas = torch.as_tensor(fit.params.thetas, dtype=torch.float32).to(dev)
    mu = _host(fit.params.mu)
    rng = np.random.default_rng(seed)
    reps = []
    for _ in range(int(num_boot)):
        data = shard_edges(edges[rng.integers(0, e, size=e)], n, shard_size=shard_size, device=dev)
        N, coeffs = suff_stats(phi, thetas, data, order=2, device=dev)
        th = closed_form_thetas(N, coeffs[0], coeffs[1]).cpu().numpy().astype(np.float64)
        reps.append(canonicalize(th, mu)[0])
    return np.std(np.stack(reps), axis=0, ddof=1)


def exact_edges(params: magm.MAGMParams, F: np.ndarray, seed: int, *, block: int = 512) -> np.ndarray:
    """Reference sampler: exact independent Bernoulli(Q_ij) edges on the
    host, the ground truth the engines are judged against.

    Per-pair float64 Bernoulli draws from ``np.random.default_rng(seed)``
    through the 2^d config table, in row blocks of ``block``; directed
    ordered pairs including self-loops.
    """
    F = _host(F).astype(np.int64)
    n, d = F.shape
    thetas = _host(params.thetas).astype(np.float64)
    bits = (np.arange(1 << d)[:, None] >> np.arange(d)[None, ::-1]) & 1
    tk = thetas[np.arange(d)[None, None, :], bits[:, None, :], bits[None, :, :]]
    Q = np.prod(tk, axis=2)  # (2^d, 2^d) config-pair edge probabilities
    cid = F @ (1 << np.arange(d)[::-1])
    rng = np.random.default_rng(seed)
    rows = []
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        q = Q[cid[lo:hi, None], cid[None, :]]
        hit = np.argwhere(rng.random(q.shape) < q)
        hit[:, 0] += lo
        rows.append(hit)
    return np.concatenate(rows, axis=0)


def recover(
    params: magm.MAGMParams,
    n: int,
    *,
    key: Optional[torch.Tensor] = None,
    options: FitOptions = FitOptions(),
    backend: str = "auto",
    split: bool = False,
    num_boot: int = 0,
    fit_key: Optional[torch.Tensor] = None,
    known_F: bool = False,
    exact_observed: bool = False,
    device=None,
) -> RecoveryReport:
    """Run the full generate -> fit -> generate round trip on ``device``
    (default ``"cuda"``; raises without a card).

    1. Build the true config (attributes drawn from ``params.mu``) and
       sample one observed graph through ``MAGMSampler``, or with
       ``exact_observed=True`` from :func:`exact_edges`.
    2. Fit ``(phi, thetas, mu)`` to that edge list; ``known_F=True`` fixes
       phi at the realized attributes (EM reduces to the M-step, where
       bootstrap CIs around ``theta_hat`` are valid coverage statements).
    3. Package the fit as a ready-to-sample config plus canonicalized
       estimates and, with ``num_boot > 0``, bootstrap SEs.
    """
    dev = resolve_device(device)
    key = prng.PRNGKey(0) if key is None else key
    k_attr, k_sample, k_fit, k_boot = prng.split(key, 4)
    d = int(params.mu.shape[0])

    true_config = SamplerConfig(
        params=params, num_nodes=int(n), attribute_key=k_attr, backend=backend, split=split, device=dev
    )
    sampler = MAGMSampler(true_config)
    if exact_observed:
        edges = exact_edges(params, sampler.F, int(prng.randint(k_sample, (), 0, 2**31 - 1)))
    else:
        edges = np.asarray(sampler.sample(k_sample).edges, dtype=np.int64)

    fit = _run_magfit(
        edges,
        int(n),
        d,
        key=fit_key if fit_key is not None else k_fit,
        options=options,
        phi_init=np.asarray(sampler.F, dtype=np.float32) if known_F else None,
        fit_phi=not known_F,
        device=dev,
    )
    config = fitted_config(fit, backend=backend, split=split, device=dev)
    theta_hat, mu_hat, _, flips, order = canonicalize(fit.params.thetas, fit.params.mu)
    theta_se = None
    if num_boot > 0:
        seed = int(prng.randint(k_boot, (), 0, 2**31 - 1))
        theta_se = bootstrap_theta_se(fit, edges, num_boot=num_boot, seed=seed, device=dev)
    return RecoveryReport(
        fit=fit,
        config=config,
        true_config=true_config,
        edges=edges,
        theta_hat=theta_hat,
        mu_hat=mu_hat,
        theta_se=theta_se,
        flips=flips,
        order=order,
    )
