"""MAGFIT's dense scoring: the expected log edge-probability of every pair
under the mean-field posterior, and the O(n^2) reference ELBO built on it.

Under q(F) = prod_{i,k} Bernoulli(phi_ik), log Q is bilinear in the bits,
so E_q[log Q_ij] is the same bilinear form evaluated on the soft attributes
phi: with ``use_kernel=True`` :func:`dense_expected_logprob` runs the
``magm_logprob`` tile kernel (``csrc/magm_logprob.cu``) on phi, the path on
which the reference launches its Pallas kernel.

Only this part of ``repro/fit/magfit.py`` is ported.  The variational EM
(E-step, M-step, the ``magfit`` loop), edge ingest and recovery are ROADMAP
queue 1, item 8 (MAGFIT).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import f32math, magm
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops

_LOG_EPS = 1e-12


def _soft_attr(phi: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, d, 2) per-bit marginals [q(f=0), q(f=1)]."""
    return torch.stack([1.0 - phi, phi], dim=-1)


def _xlogx(x: torch.Tensor) -> torch.Tensor:
    return x * f32math.log(torch.clamp(x, _LOG_EPS, 1.0))


def dense_expected_logprob(phi, thetas, *, use_kernel: bool = False, device=None) -> torch.Tensor:
    """(n, n) float32 matrix of ``E_q[log Q_ij]`` for i != j (dense, O(n^2 d))
    on ``device`` (default ``"cuda"``; raises without a card).

    ``use_kernel=True`` runs the ``magm_logprob`` tile kernel (its plain
    version on the CPU); otherwise the plain products of
    ``magm.log_edge_prob``.  Diagonal entries follow the independent-bits
    convention: add ``sum_k w_k (phi - phi^2)`` for exact self-pair values.
    """
    phi = torch.as_tensor(phi).to(device=resolve_device(device), dtype=torch.float32)
    if use_kernel:
        return ops.magm_logprob(phi, phi, thetas)
    return magm.log_edge_prob(phi, phi, thetas)


def elbo_dense(
    phi,
    thetas,
    mu,
    edges,
    n: int,
    *,
    order: int = 3,
    use_kernel: bool = False,
    device=None,
) -> torch.Tensor:
    """O(n^2) per-pair reference ELBO (tests and small-n scoring only), a
    float32 scalar on ``device`` (default ``"cuda"``; raises without a card).

    Materializes every pair's ``E[log Q]`` (through the tile kernel with
    ``use_kernel=True``) and ``E[Q^p]`` for the order-``order`` Taylor
    expansion of the non-edge term ``log(1 - Q)``.
    """
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    phi = torch.as_tensor(phi).to(device=dev, dtype=torch.float32)
    thetas = torch.as_tensor(thetas, dtype=torch.float32).to(dev)
    mu = torch.as_tensor(mu, dtype=torch.float32).to(dev)
    a = _soft_attr(phi)
    adj = torch.zeros((n, n), dtype=torch.float32, device=dev)
    if edges.size:
        e = torch.from_numpy(edges).to(dev)
        adj[e[:, 0], e[:, 1]] = 1.0

    bl = magm.bilinear_decompose(thetas)
    logq = dense_expected_logprob(phi, thetas, use_kernel=use_kernel, device=dev)
    self_corr = torch.sum(bl.w[None, :] * (phi - phi * phi), dim=1)
    logq = logq + torch.diag(self_corr)
    ll = torch.sum(adj * logq)

    eye = torch.eye(n, dtype=torch.bool, device=dev)
    neg1m = torch.zeros((n, n), dtype=torch.float32, device=dev)
    for p in range(1, order + 1):
        tp = thetas**p
        pair = torch.prod(torch.einsum("ida,dab,jdb->ijd", a, tp, a), dim=2)
        md = a[:, :, 0] * tp[None, :, 0, 0] + a[:, :, 1] * tp[None, :, 1, 1]
        pair = torch.where(eye, torch.prod(md, dim=1)[:, None], pair)
        neg1m = neg1m + pair / p
    penalty = torch.sum((1.0 - adj) * neg1m)

    prior = torch.sum(
        phi * f32math.log(torch.clamp(mu, _LOG_EPS, 1.0))[None, :]
        + (1.0 - phi) * f32math.log(torch.clamp(1.0 - mu, _LOG_EPS, 1.0))[None, :]
    )
    entropy = -torch.sum(_xlogx(phi) + _xlogx(1.0 - phi))
    return ll - penalty + prior + entropy
