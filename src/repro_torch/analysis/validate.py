"""Cross-backend statistical validation suite (host numpy; the reference's
``analysis/validate.py``).

Given one attribute matrix F, every backend ("auto" quilting, the "host"
loop, "balldrop") draws from the same graph distribution, whose first two
moments have closed forms through the Kronecker quadratic forms of
``core/kron.py``.  The 3-sigma claims here are the contract of the laws that
are only distributional: the host fallbacks, ball dropping, and the
device-native PRNG batch.

- :func:`summarize` / :func:`collect`: edge lists to the compared
  statistics (total edges, per-(D_k, D_l) block counts, isolated nodes, a
  coarse degree histogram);
- :func:`theory_moments`: the |E| mean and std ``c^T P c`` forms, the
  per-block means ``a_k^T P a_l`` (a_k the indicator of configurations of
  multiplicity >= k + 1), the expected isolated-node count;
- :func:`compare_backends` / :func:`compare_to_theory`: n-sigma claims,
  standard errors inflated by the Poisson-scale proxy (var <= mean for
  these sums of independent Bernoullis), so few-seed runs do not flake on a
  noisy variance while a real bias, tens of sigma, is caught.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import kron, magm

__all__ = [
    "SampleSummary",
    "BackendStats",
    "TheoryMoments",
    "Claim",
    "degree_bin_edges",
    "summarize",
    "collect",
    "expected_isolated",
    "theory_moments",
    "compare_backends",
    "compare_to_theory",
    "failures",
]


class SampleSummary(NamedTuple):
    """The compared statistics of one sampled graph."""

    total: int
    blocks: np.ndarray  # (B, B) edge counts by (src rank, dst rank) block
    isolated: int
    hist: np.ndarray  # (nbins,) node counts per degree bin


class BackendStats(NamedTuple):
    """Per-seed statistics of one backend, stacked over k draws."""

    name: str
    totals: np.ndarray  # (k,)
    blocks: np.ndarray  # (k, B, B)
    isolated: np.ndarray  # (k,)
    hist: np.ndarray  # (k, nbins)


class TheoryMoments(NamedTuple):
    """Closed-form expectations given F (Kronecker quadratic forms)."""

    mean_edges: float
    std_edges: float
    block_mean: np.ndarray  # (B, B)
    block_std: np.ndarray  # (B, B)
    isolated: float


class Claim(NamedTuple):
    """One equivalence claim: an observed gap against its allowed bound."""

    name: str
    delta: float
    bound: float

    @property
    def ok(self) -> bool:
        return self.delta <= self.bound


def degree_bin_edges(n: int) -> np.ndarray:
    """Degree bin left edges: exact small degrees, then ~1.5x growth, so
    every bin holds enough nodes to compare."""
    edges = [0, 1, 2, 3, 4]
    v = 6
    while v < 2 * n:
        edges.append(v)
        v = max(v + 1, (v * 3) // 2)
    return np.asarray(edges, dtype=np.float64)


def summarize(edges: np.ndarray, n: int, ranks: np.ndarray, bin_edges: np.ndarray) -> SampleSummary:
    """One (E, 2) edge list reduced to the compared statistics.  ``ranks``
    is the Theorem-2 occurrence rank |Z_i| per node (1-based,
    ``Partition.ranks``); block (k, l) counts the edges from D_{k+1} to
    D_{l+1}."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    B = int(ranks.max(initial=0))
    blocks = np.zeros((B, B), dtype=np.int64)
    deg = np.zeros(n, dtype=np.int64)
    if edges.size:
        np.add.at(blocks, (ranks[edges[:, 0]] - 1, ranks[edges[:, 1]] - 1), 1)
        deg = np.bincount(edges[:, 0], minlength=n) + np.bincount(edges[:, 1], minlength=n)
    hist, _ = np.histogram(deg, bins=np.concatenate([bin_edges, [np.inf]]))
    return SampleSummary(total=int(edges.shape[0]), blocks=blocks, isolated=int((deg == 0).sum()), hist=hist)


def collect(
    name: str,
    sample_fn: Callable[[int], np.ndarray],
    seeds: Sequence[int],
    n: int,
    ranks: np.ndarray,
    bin_edges: np.ndarray,
) -> BackendStats:
    """Run ``sample_fn(seed) -> (E, 2)`` over ``seeds``; stack the summaries."""
    sums = [summarize(sample_fn(s), n, ranks, bin_edges) for s in seeds]
    return BackendStats(
        name=name,
        totals=np.array([s.total for s in sums], dtype=np.float64),
        blocks=np.stack([s.blocks for s in sums]).astype(np.float64),
        isolated=np.array([s.isolated for s in sums], dtype=np.float64),
        hist=np.stack([s.hist for s in sums]).astype(np.float64),
    )


def expected_isolated(c: np.ndarray, thetas: np.ndarray, order: int = 3) -> float:
    """E[#isolated nodes] given the attributes.

    Node i (configuration x) is isolated iff none of its incident edges
    fire: log P = sum_j log(1 - Q_ij) + sum_{j != i} log(1 - Q_ji).  With
    log(1 - p) = -sum_k p^k / k and sum_j Q_ij^k one Kronecker matvec of the
    k-th power initiators, this is the Poisson asymptotics of
    arXiv:1901.09698 with corrections up to ``order`` (3: exact to O(max
    Q^4)), in O(order * d * 2^d).
    """
    cf = np.asarray(c, dtype=np.float64)
    th = np.asarray(thetas, dtype=np.float64)
    log_surv = np.zeros_like(cf)
    for p in range(1, order + 1):
        thp = th**p
        w = kron.kron_matvec(thp, cf)
        wt = kron.kron_rmatvec(thp, cf)
        log_surv -= (w + wt - kron.kron_diag(thp)) / p
    return float(cf @ np.exp(log_surv))


def theory_moments(F: np.ndarray, thetas, order: int = 3) -> TheoryMoments:
    """Every closed-form expectation for one attribute matrix."""
    F = np.asarray(F)
    d = int(F.shape[1])
    lam = magm.configs_from_attributes(torch.from_numpy(np.ascontiguousarray(F))).numpy()
    c = np.bincount(lam, minlength=1 << d).astype(np.float64)
    th = np.asarray(thetas, dtype=np.float64)

    mean, std = kron.edge_count_moments(c, th)

    B = int(c.max(initial=0))
    A = np.stack([(c >= k + 1).astype(np.float64) for k in range(B)]) if B else np.zeros((0, c.size))
    PA = np.stack([kron.kron_matvec(th, a) for a in A]) if B else A
    P2A = np.stack([kron.kron_matvec(th**2, a) for a in A]) if B else A
    block_mean = A @ PA.T  # [k, l] = a_k . P a_l
    block_var = np.maximum(block_mean - A @ P2A.T, 0.0)
    return TheoryMoments(
        mean_edges=mean,
        std_edges=std,
        block_mean=block_mean,
        block_std=np.sqrt(block_var),
        isolated=expected_isolated(c, th, order=order),
    )


def _gap_claim(name: str, a: np.ndarray, b: np.ndarray, nsigma: float, floor: float) -> Claim:
    """The worst elementwise mean gap of two (k, ...) stat stacks against
    its bound; the standard error adds the Poisson-scale proxy (mean + 1)
    to the sample variance, which keeps the bound honest at small k."""
    a2 = a.reshape(a.shape[0], -1)
    b2 = b.reshape(b.shape[0], -1)
    ma, mb = a2.mean(axis=0), b2.mean(axis=0)
    va = a2.var(axis=0, ddof=1) if a2.shape[0] > 1 else np.zeros_like(ma)
    vb = b2.var(axis=0, ddof=1) if b2.shape[0] > 1 else np.zeros_like(mb)
    se = np.sqrt((va + np.abs(ma) + 1.0) / a2.shape[0] + (vb + np.abs(mb) + 1.0) / b2.shape[0])
    delta = np.abs(ma - mb)
    bound = nsigma * se + floor
    i = int(np.argmax(delta - bound))
    return Claim(name, float(delta[i]), float(bound[i]))


def compare_backends(a: BackendStats, b: BackendStats, *, nsigma: float = 3.0) -> List[Claim]:
    """Pairwise n-sigma equivalence claims between two backends."""
    tag = f"{a.name}~{b.name}"
    return [
        _gap_claim(f"total[{tag}]", a.totals, b.totals, nsigma, 2.0),
        _gap_claim(f"blocks[{tag}]", a.blocks, b.blocks, nsigma, 2.0),
        _gap_claim(f"isolated[{tag}]", a.isolated, b.isolated, nsigma, 2.0),
        _gap_claim(f"degree[{tag}]", a.hist, b.hist, nsigma, 2.0),
    ]


def compare_to_theory(s: BackendStats, th: TheoryMoments, *, nsigma: float = 3.0) -> List[Claim]:
    """n-sigma claims of one backend against the closed-form expectations."""
    k = s.totals.shape[0]
    claims = [
        Claim(
            f"total[{s.name}~theory]",
            float(abs(s.totals.mean() - th.mean_edges)),
            nsigma * th.std_edges / np.sqrt(k) + 2.0,
        )
    ]
    gap = np.abs(s.blocks.mean(axis=0) - th.block_mean)
    bound = nsigma * th.block_std / np.sqrt(k) + 2.0
    i = int(np.argmax(gap - bound))
    claims.append(Claim(f"blocks[{s.name}~theory]", float(gap.ravel()[i]), float(bound.ravel()[i])))
    # no closed-form variance of the isolated count: the Poisson proxy
    iso_se = np.sqrt((s.isolated.var(ddof=1) if k > 1 else 0.0) + th.isolated + 1.0) / np.sqrt(k)
    claims.append(
        Claim(
            f"isolated[{s.name}~theory]",
            float(abs(s.isolated.mean() - th.isolated)),
            nsigma * float(iso_se) + 2.0,
        )
    )
    return claims


def failures(claims: Sequence[Claim]) -> List[Claim]:
    """The claims that did not hold (empty: every statistic agrees)."""
    return [c for c in claims if not c.ok]
