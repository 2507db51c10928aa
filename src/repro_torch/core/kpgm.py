"""Stochastic Kronecker Product Graph Model (KPGM) math of the quilting
path: level cumulative probabilities, quadrant descent, |E| moments and
log-probabilities of id pairs.

P_ij = prod_k theta^(k)[bit_k(i), bit_k(j)] with 0-based ids, bit 0 the
most significant.  The float32 reductions follow the order of the reference's
compiled plan constants: a (2, 2) initiator sums as (t00 + t01) + (t10 +
t11), the squares' sum fused as fma(t01, t01, t00 * t00) + fma(t11, t11,
t10 * t10), and products, sums and the cumulative table run from index 0
up.  The plan's table and scalars are therefore equal to the reference's,
not merely close.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import f32math
from repro_torch.kernels.quadrant_descent import _descend_body

# above this many candidates in one device round the exact-cell mode is not
# taken (the reference's DEVICE_MAX_CANDIDATES)
DEVICE_MAX_CANDIDATES = 1 << 25


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add, evaluated in float64 (the float32 product
    is exact there)."""
    return (x.double() * y.double() + z.double()).float()


def _level_sums(thetas: torch.Tensor) -> torch.Tensor:
    f = thetas.reshape(-1, 4)
    return (f[:, 0] + f[:, 1]) + (f[:, 2] + f[:, 3])


def _prod_levels(v: torch.Tensor) -> torch.Tensor:
    acc = v[0]
    for x in v[1:]:
        acc = acc * x
    return acc


def _sum_levels(v: torch.Tensor) -> torch.Tensor:
    acc = v[..., 0]
    for k in range(1, v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def edge_moments(thetas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean m = prod_k sum(theta^(k)) and v = prod_k sum(theta^(k)^2) of
    |E| (Algorithm 1 lines 3-4), float32 scalars."""
    f = thetas.reshape(-1, 4)
    sq = _fma(f[:, 1], f[:, 1], f[:, 0] * f[:, 0]) + _fma(
        f[:, 3], f[:, 3], f[:, 2] * f[:, 2]
    )
    return _prod_levels(_level_sums(thetas)), _prod_levels(sq)


def max_cell_prob(thetas: torch.Tensor) -> torch.Tensor:
    """prod_k max(theta^(k)): the largest single-cell probability."""
    return _prod_levels(thetas.reshape(-1, 4).amax(dim=1))


def _level_cumprobs(thetas: torch.Tensor) -> torch.Tensor:
    """(d, 4) cumulative quadrant probabilities, row-major (00, 01, 10, 11).

    Normalised by the pairwise level sums, as in the reference's compiled
    plan constants (XLA shares one level-sum reduction between this table
    and the moments there)."""
    f = thetas.reshape(-1, 4)
    q = f / _level_sums(thetas)[:, None]
    c0 = q[:, 0]
    c1 = c0 + q[:, 1]
    c2 = c1 + q[:, 2]
    return torch.stack([c0, c1, c2, c2 + q[:, 3]], dim=1)


def _descend(u: torch.Tensor, cum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, d) uniforms + (d, 4) cumulative quadrant probs -> int32 id pairs."""
    return _descend_body(u, cum)


def log_level_sum(thetas: torch.Tensor) -> torch.Tensor:
    """sum_k log sum(theta^(k)) = log m, summed from level 0 up."""
    return _sum_levels(f32math.log(_level_sums(thetas)))


def log_prob_pairs(thetas: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """float32 log P_{src,dst} for 0-based id pairs (paper eq. 6), summed
    from level 0 up with the reference's float32 log."""
    d = thetas.shape[0]
    shift = torch.arange(d - 1, -1, -1, device=src.device)
    a = (src.to(torch.int64)[:, None] >> shift) & 1
    b = (dst.to(torch.int64)[:, None] >> shift) & 1
    logt = f32math.log(torch.clamp(thetas, 1e-30, 1.0)).reshape(-1)
    ks = torch.arange(d, device=src.device)
    return _sum_levels(logt[ks * 4 + a * 2 + b])
