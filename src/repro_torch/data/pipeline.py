"""Graph data helpers: the CSR form that edge ingest (``fit/ingest.py``)
builds for degree and neighbour queries.

Only ``build_csr`` of the reference's ``data/pipeline.py`` is here; its
random-walk corpus ``MAGMCorpus`` belongs to the LM scaffolding (ROADMAP
queue 1 item 10).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def build_csr(edges: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(E, 2) directed edge list -> CSR ``(indptr, adj)`` over n nodes.

    ``adj[indptr[i]:indptr[i+1]]`` are i's out-neighbours (stable source
    order preserved).
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size == 0:
        return np.zeros(n + 1, dtype=np.int64), np.zeros((0,), dtype=np.int64)
    if edges[:, 0].min() < 0 or edges[:, 0].max() >= n:
        raise ValueError(f"edge sources must lie in [0, {n})")
    order = np.argsort(edges[:, 0], kind="stable")
    adj = edges[order, 1].copy()
    counts = np.bincount(edges[:, 0], minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return indptr, adj
