"""Kronecker-structured linear algebra for MAGM edge-count moments (host
numpy, float64; equal to the reference's ``core/kron.py`` bit for bit).

The MAGM edge probability between configurations x and y is the Kronecker
entry ``P[x, y] = prod_t theta_t[bit_t(x), bit_t(y)]``, so every moment the
samplers need is a quadratic form in the multiplicity vector ``c`` (``c[x]``
= number of nodes whose configuration is x):

    E|E|    = c^T P c,    sum Q^2 = c^T P.2 c,    Var|E| = E|E| - sum Q^2

with ``P.^p = kron(theta_1^p, ..., theta_d^p)`` entrywise: matvecs with a
Kronecker product, O(d 2^d) time and O(2^d) memory, never the (2^d, 2^d)
matrix.  Used by the ball-dropping backend (``core/balldrop.py``) for its
Normal edge-count target and by ``analysis/validate.py`` for its
closed-form expectations.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = [
    "MOMENT_CAP",
    "kron_matvec",
    "kron_rmatvec",
    "kron_diag",
    "config_multiplicities",
    "edge_count_moments",
    "balldrop_cost_factor",
]

# past this many configurations (2^d) the dense multiplicity vector and the
# O(d 2^d) matvecs stop being cheap plan-build work; callers gate on it
MOMENT_CAP = 1 << 22


def kron_matvec(thetas: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``kron(thetas[0], ..., thetas[d-1]) @ v`` without forming the matrix.

    ``thetas`` is (d, 2, 2) and ``v`` has 2^d entries; bit t (most
    significant first) of a configuration selects level t's row/column.
    Each level is one tensor contraction on the (2,)*d reshape of ``v``.

    >>> th = np.array([[[0.3, 0.6], [0.6, 0.9]]] * 3)
    >>> P = np.kron(np.kron(th[0], th[1]), th[2])
    >>> bool(np.allclose(kron_matvec(th, np.arange(8.0)), P @ np.arange(8.0)))
    True
    """
    th = np.asarray(thetas, dtype=np.float64)
    d = int(th.shape[0])
    out = np.asarray(v, dtype=np.float64).reshape((2,) * d)
    for t in range(d):
        out = np.moveaxis(np.tensordot(th[t], out, axes=([1], [t])), 0, t)
    return out.reshape(-1)


def kron_rmatvec(thetas: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``kron(...).T @ v`` (P is not symmetric in general)."""
    return kron_matvec(np.swapaxes(np.asarray(thetas, dtype=np.float64), 1, 2), v)


def kron_diag(thetas: np.ndarray) -> np.ndarray:
    """(2^d,) diagonal ``P[x, x]`` of the Kronecker product."""
    th = np.asarray(thetas, dtype=np.float64)
    out = np.ones(1, dtype=np.float64)
    for t in range(th.shape[0]):
        out = np.kron(out, np.array([th[t, 0, 0], th[t, 1, 1]]))
    return out


def config_multiplicities(part, d: int) -> np.ndarray:
    """Dense (2^d,) multiplicity vector of a Theorem-2 partition: block k's
    table lists each configuration of multiplicity >= k + 1 once, so all
    blocks together repeat every configuration its multiplicity many times."""
    c = np.zeros(1 << d, dtype=np.int64)
    for cfg in part.sorted_configs:
        c[cfg] += 1
    return c


def edge_count_moments(c: np.ndarray, thetas: np.ndarray) -> Tuple[float, float]:
    """(mean, std) of |E| given the attributes: a sum of independent
    Bernoulli(Q_ij) over all n^2 ordered pairs, so mean = c^T P c and
    var = c^T P c - c^T P.2 c."""
    cf = np.asarray(c, dtype=np.float64)
    th = np.asarray(thetas, dtype=np.float64)
    mean = float(cf @ kron_matvec(th, cf))
    second = float(cf @ kron_matvec(th**2, cf))
    return mean, math.sqrt(max(mean - second, 0.0))


def balldrop_cost_factor(mean_edges: float, B: int, e_total: float) -> float:
    """Expected proposals per accepted ball of the ball-dropping backend.

    A proposal (x, y) ~ P_xy / m with uniform ranks (k, l) in [0, B)^2 is
    accepted with probability c_x c_y / B^2, so the acceptance rate is
    E|E| / (m B^2); its inverse (at least 1) is the oversampling factor.
    """
    if e_total <= 0.0:
        return 1.0
    return max(float(mean_edges) * float(B) ** 2 / float(e_total), 1.0)
