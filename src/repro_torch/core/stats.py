"""Graph statistics of the paper's validity experiments (Figs 8-9), host
numpy/scipy, as the reference's ``core/stats.py`` computes them.

- |E| growth as n^c (Fig 8): :func:`fit_powerlaw_exponent`;
- the fraction of nodes in the largest strongly connected component
  (Fig 9): :func:`largest_scc_fraction`;
- in- and out-degrees: :func:`degree_counts`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as _sp
import scipy.sparse.csgraph as _csgraph


def largest_scc_fraction(edges: np.ndarray, n: int) -> float:
    """Fraction of the n nodes in the largest strongly connected component."""
    if n == 0:
        return 0.0
    if edges.size == 0:
        return 1.0 / n
    adj = _sp.coo_matrix(
        (np.ones(edges.shape[0], dtype=np.int8), (edges[:, 0], edges[:, 1])), shape=(n, n)
    ).tocsr()
    _, labels = _csgraph.connected_components(adj, directed=True, connection="strong")
    return float(np.bincount(labels).max()) / n


def degree_counts(edges: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(out_degree, in_degree) arrays of length n."""
    return np.bincount(edges[:, 0], minlength=n), np.bincount(edges[:, 1], minlength=n)


def fit_powerlaw_exponent(n_values: np.ndarray, e_values: np.ndarray) -> float:
    """Slope c of log|E| against log n (the paper's |E| = n^c)."""
    ln_n = np.log(np.asarray(n_values, dtype=np.float64))
    ln_e = np.log(np.maximum(np.asarray(e_values, dtype=np.float64), 1.0))
    return float(np.polyfit(ln_n, ln_e, 1)[0])
