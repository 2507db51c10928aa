"""Multiplicative Attribute Graph Model (MAGM), Kim & Leskovec (2010).

Node i carries an attribute bit-vector f(i) with P(f_k(i)=1) = mu_k, and
Q_ij = prod_k theta^(k)[f_k(i), f_k(j)] = P_{lambda_i, lambda_j}, where the
configuration lambda_i is the integer whose binary expansion is f(i)
(f_1 the most significant bit).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import f32math, prng
from repro_torch.core.kpgm import _prod_levels, _sum_levels

# log Q is a float32 product of attributes and log-thetas; TF32 would keep
# ~3 decimal digits of it, so matrix products on the card run in full float32
torch.backends.cuda.matmul.allow_tf32 = False


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


def attributes_from_configs(lam: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`configs_from_attributes`: (n, d) int8 bits."""
    shift = torch.arange(d - 1, -1, -1, device=torch.as_tensor(lam).device)
    return ((torch.as_tensor(lam).to(torch.int64)[:, None] >> shift) & 1).to(torch.int8)


def config_counts(lam) -> Tuple[np.ndarray, np.ndarray]:
    """Unique configurations and their multiplicities (host-side)."""
    lam = lam.cpu().numpy() if isinstance(lam, torch.Tensor) else np.asarray(lam)
    return np.unique(lam, return_counts=True)


class BilinearLogTheta(NamedTuple):
    """log Q decomposition:  logQ = c0 + F u 1^T + 1 (F v)^T + F diag(w) F^T."""

    c0: torch.Tensor  # scalar: sum_k log t00
    u: torch.Tensor  # (d,)  source-bit linear term
    v: torch.Tensor  # (d,)  target-bit linear term
    w: torch.Tensor  # (d,)  interaction term


def bilinear_decompose(thetas: torch.Tensor, eps: float = 1e-30) -> BilinearLogTheta:
    """The reference's float32 terms bit for bit: its log (``f32math.log``)
    of the clipped thetas, and c0 summed from level 0 up, as its compiled
    reduction runs."""
    return bilinear_from_log(f32math.log(torch.clamp(torch.as_tensor(thetas, dtype=torch.float32), eps, 1.0)))


def bilinear_from_log(logt: torch.Tensor) -> BilinearLogTheta:
    """The bilinear terms of (d, 2, 2) log-thetas (MAGFIT passes logs it
    can differentiate)."""
    t00, t01 = logt[:, 0, 0], logt[:, 0, 1]
    t10, t11 = logt[:, 1, 0], logt[:, 1, 1]
    return BilinearLogTheta(
        c0=_sum_levels(t00),
        u=t10 - t00,
        v=t01 - t00,
        w=t11 + t00 - t01 - t10,
    )


def log_edge_prob(F_src: torch.Tensor, F_dst: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """(ns, nt) float32 log Q between rows of F_src and rows of F_dst, on
    F_src's device (plain products; the tile kernel is ``ops.magm_logprob``)."""
    fs = torch.as_tensor(F_src).to(torch.float32)
    ft = torch.as_tensor(F_dst).to(device=fs.device, dtype=torch.float32)
    bl = BilinearLogTheta(*(t.to(fs.device) for t in bilinear_decompose(thetas)))
    inter = (fs * bl.w[None, :]) @ ft.T
    return bl.c0 + (fs @ bl.u)[:, None] + (ft @ bl.v)[None, :] + inter


def _f32_sum(parts):
    """float32 sum of ``parts`` from the left."""
    acc = parts[0]
    for x in parts[1:]:
        acc = np.add(acc, x, dtype=np.float32)
    return acc


def _lanes_h8(a):
    return _f32_sum([_f32_sum([_f32_sum(a[0:2]), _f32_sum(a[2:4])]), _f32_sum([_f32_sum(a[4:6]), _f32_sum(a[6:8])])])


def _lanes_p8(a):
    a = [a[i] for i in (0, 4, 2, 6, 1, 5, 3, 7)]
    return _lanes_h8(a)


def _gemv_sum(X: np.ndarray) -> np.ndarray:
    """Row sums of the (n, d) float32 terms ``X`` in the order of the
    reference's CPU matrix-vector product (Eigen's row-major GEMV on
    8-float packets, as jaxlib 0.9.0 runs it on x86-64).

    Lane j of a row adds terms j, j + 8, ... of its full packets from the
    left; rows in blocks of 8 reduce the 8 lanes pairwise from lane 0, the
    4-, 2- and 1-row blocks after them fold the upper 4 lanes onto the
    lower ones first (((0+4)+(2+6)) + ((1+5)+(3+7))); the last d mod 8
    terms are summed from the left on their own and added after.  A
    single-row product is one sum from the left.
    """
    n, d = X.shape
    if n == 1:
        return _f32_sum([X[:, k] for k in range(d)]) if d else np.zeros(1, np.float32)
    out = np.zeros(n, dtype=np.float32)
    full = 8 * (d // 8)
    n8 = 8 * (n // 8)
    for lo, hi, reduce in ((0, n8, _lanes_h8), (n8, n, _lanes_p8)):
        if hi <= lo:
            continue
        parts = []
        if full:
            parts.append(reduce([_f32_sum([X[lo:hi, j + l] for j in range(0, full, 8)]) for l in range(8)]))
        if d > full:
            parts.append(_f32_sum([X[lo:hi, k] for k in range(full, d)]))
        if parts:
            out[lo:hi] = _f32_sum(parts)
    return out


def host_log_edge_prob(F_src, F_dst, thetas) -> np.ndarray:
    """(ns, nt) float32 log Q between 0/1 rows of F_src and F_dst on the
    host, in the order the reference's eager CPU ``log_edge_prob`` sums:
    ``((c0 + row) + col) + inter``, the row and column terms as its
    matrix-vector products (:func:`_gemv_sum`), the interaction term from
    attribute 0 up.

    The reference's interaction product goes through XLA's thread-pool
    contraction into oneDNN's sgemm, which for some shapes (and thread
    counts) adds the d terms in 4-float lanes instead; there its log Q can
    differ from this one in the last bit.  The products are exact (the
    attributes are 0 or 1), so nothing else can differ.
    """
    bl = [t.cpu().numpy() for t in bilinear_decompose(thetas)]
    c0, u, v, w = bl
    fs = np.asarray(F_src, dtype=np.float32)
    ft = np.asarray(F_dst, dtype=np.float32)
    row = _gemv_sum(fs * u[None, :])
    col = _gemv_sum(ft * v[None, :])
    inter = np.zeros((fs.shape[0], ft.shape[0]), dtype=np.float32)
    fsw = fs * w[None, :]
    for k in range(fs.shape[1]):
        inter += np.multiply.outer(fsw[:, k], ft[:, k])
    return (c0 + row[:, None] + col[None, :]) + inter


def edge_prob_matrix(F: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """Exact dense Q (paper eq. 7), O(n^2 d): tests and small n only."""
    return f32math.exp(log_edge_prob(F, F, thetas))


def log_prob_pairs(
    F: torch.Tensor, thetas: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
) -> torch.Tensor:
    """log Q_{src, dst} for index pairs, O(E d)."""
    F = torch.as_tensor(F)
    bl = BilinearLogTheta(*(t.to(F.device) for t in bilinear_decompose(thetas)))
    fs = F[src].to(torch.float32)
    ft = F[dst].to(torch.float32)
    return bl.c0 + fs @ bl.u + ft @ bl.v + torch.sum(fs * bl.w[None, :] * ft, dim=1)


def expected_edges(params: MAGMParams, n: int) -> float:
    """E|E| = sum_ij Q_ij = n^2 prod_k E_ab theta^(k)[a, b], a, b ~ mu_k."""
    mu = params.mu.to(torch.float32)
    th = params.thetas.to(torch.float32)
    per_level = (
        (1 - mu) * (1 - mu) * th[:, 0, 0]
        + (1 - mu) * mu * th[:, 0, 1]
        + mu * (1 - mu) * th[:, 1, 0]
        + mu * mu * th[:, 1, 1]
    )
    return float(n * n * _prod_levels(per_level))
