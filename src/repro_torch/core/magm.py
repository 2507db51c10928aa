"""Multiplicative Attribute Graph Model (MAGM), Kim & Leskovec (2010).

Node i carries an attribute bit-vector f(i) with P(f_k(i)=1) = mu_k, and
Q_ij = prod_k theta^(k)[f_k(i), f_k(j)] = P_{lambda_i, lambda_j}, where the
configuration lambda_i is the integer whose binary expansion is f(i)
(f_1 the most significant bit).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng


class MAGMParams(NamedTuple):
    thetas: torch.Tensor  # (d, 2, 2) float32 in [0, 1]
    mu: torch.Tensor  # (d,) float32 attribute Bernoulli means

    @property
    def d(self) -> int:
        return self.thetas.shape[0]


def make_params(theta, mu, d: int) -> MAGMParams:
    """One 2x2 initiator and one mu (scalar or (d,)) replicated over d
    levels, as float32 CPU tensors."""
    theta = torch.as_tensor(np.asarray(theta, dtype=np.float32))
    mu_arr = np.broadcast_to(np.asarray(mu, dtype=np.float32), (d,)).copy()
    return MAGMParams(theta.expand(d, 2, 2).clone(), torch.from_numpy(mu_arr))


def sample_attributes(key: torch.Tensor, n: int, mu: torch.Tensor, *, device=None) -> torch.Tensor:
    """F in {0,1}^{n x d} with F[:, k] ~ Bernoulli(mu_k), int8."""
    d = mu.shape[0]
    u = prng.uniform(key, (n, d), device=device)
    return (u < mu.to(u.device)[None, :]).to(torch.int8)


def resolve_attributes(
    params: MAGMParams,
    F=None,
    *,
    num_nodes: Optional[int] = None,
    attribute_key: Optional[torch.Tensor] = None,
    device=None,
) -> np.ndarray:
    """A sampler config's attribute source as a concrete host (n, d) array.

    An explicit ``F`` wins and is shape-checked against ``params.d``;
    otherwise ``num_nodes`` rows are drawn from Bernoulli(mu) with
    ``attribute_key`` (default ``PRNGKey(0)``) on ``device``.
    """
    if F is not None:
        F = F.cpu().numpy() if isinstance(F, torch.Tensor) else np.asarray(F)
        if F.ndim != 2 or (F.size and F.shape[1] != params.d):
            raise ValueError(f"F must be (n, {params.d}), got shape {F.shape}")
        return F
    if num_nodes is None:
        raise ValueError(
            "attribute source unspecified: pass F= or num_nodes= "
            "(optionally with attribute_key=)"
        )
    key = attribute_key if attribute_key is not None else prng.PRNGKey(0)
    return sample_attributes(key, int(num_nodes), params.mu, device=device).cpu().numpy()


def configs_from_attributes(F: torch.Tensor) -> torch.Tensor:
    """lambda_i = sum_k f_k(i) 2^(d-k), int32 (requires d <= 31)."""
    F = torch.as_tensor(F)
    d = F.shape[1]
    if d > 31:
        raise ValueError("configs are int32; require d <= 31")
    pows = torch.ones((), dtype=torch.int64) << torch.arange(d - 1, -1, -1)
    return (F.to(torch.int64) * pows.to(F.device)).sum(dim=1).to(torch.int32)
