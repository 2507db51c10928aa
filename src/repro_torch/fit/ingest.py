"""Edge-list ingestion: external graphs into the form MAGFIT consumes.

:func:`load_edge_list` accepts an in-memory ``(E, 2)`` array, a
``.npy``/``.npz`` file, or a whitespace/comma text file with optional
``#``/``%`` comment lines (the SNAP / KONECT conventions), and normalizes it
into an :class:`EdgeList`: int64 ids in ``[0, n)``, optionally
deduplicated, symmetrized and stripped of self-loops.  :func:`to_csr`
gives the CSR form (``data.pipeline.build_csr``), :func:`fit_data` the
fixed-shape shards ``fit.magfit`` passes over on the device, and
``fit.magfit.magfit(el.edges, el.n, d)`` runs the fit.

Node ids need not be contiguous: ``compact=True`` (default when ids are
sparse and ``n`` is not given) relabels the distinct ids to ``0..n-1`` and
records the mapping, so fitted posteriors trace back to the source's ids.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.data import pipeline as _pipeline
from repro_torch.fit.magfit import FitData, shard_edges


class EdgeList(NamedTuple):
    """A normalized directed edge list on ``n`` contiguous node ids."""

    edges: np.ndarray  # (E, 2) int64, endpoints in [0, n)
    n: int
    node_ids: Optional[np.ndarray] = None  # original id of compacted node i

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])


def _read_source(source) -> np.ndarray:
    if isinstance(source, (str, os.PathLike)):
        path = os.fspath(source)
        if path.endswith(".npy"):
            return np.load(path)
        if path.endswith(".npz"):
            with np.load(path) as z:
                if "edges" not in z:
                    raise ValueError(f"{path}: .npz sources must contain an 'edges' array")
                return z["edges"]
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line[0] in "#%":
                    continue
                parts = line.replace(",", " ").split()
                if len(parts) < 2:
                    raise ValueError(f"{path}: bad edge line {line!r}")
                rows.append((int(parts[0]), int(parts[1])))
        return np.asarray(rows, dtype=np.int64).reshape(-1, 2)
    return np.asarray(source)


def load_edge_list(
    source,
    *,
    n: Optional[int] = None,
    dedup: bool = True,
    drop_self_loops: bool = False,
    symmetrize: bool = False,
    compact: Optional[bool] = None,
) -> EdgeList:
    """Normalize ``source`` (array or file path) into an :class:`EdgeList`.

    ``n`` defaults to ``max(id) + 1``.  ``compact`` relabels sparse ids to
    ``0..n-1`` (recording ``node_ids``); by default it engages only when
    ``n`` is not given and the ids are not contiguous.  ``symmetrize`` adds
    every reverse edge; ``dedup`` removes exact duplicate ordered pairs.
    """
    raw = _read_source(source)
    if raw.ndim != 2 or raw.shape[1] != 2:
        raise ValueError(f"edge list must have shape (E, 2); got {raw.shape}")
    if raw.size and not np.issubdtype(raw.dtype, np.integer):
        as_int = raw.astype(np.int64)
        if not np.array_equal(as_int, raw):
            raise ValueError("edge endpoints must be integers")
        raw = as_int
    edges = np.asarray(raw, dtype=np.int64).reshape(-1, 2)
    if edges.size and edges.min() < 0:
        raise ValueError("edge endpoints must be non-negative")

    node_ids = None
    max_id = int(edges.max()) + 1 if edges.size else 0
    if compact is None:
        compact = n is None and edges.size and len(np.unique(edges)) < max_id
    if compact and edges.size:
        node_ids, flat = np.unique(edges, return_inverse=True)
        edges = flat.reshape(edges.shape).astype(np.int64)
        max_id = int(node_ids.shape[0])
    n = max_id if n is None else int(n)
    if edges.size and edges.max() >= n:
        raise ValueError(f"edge endpoint {int(edges.max())} out of range for n={n}")

    if drop_self_loops and edges.size:
        edges = edges[edges[:, 0] != edges[:, 1]]
    if symmetrize and edges.size:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    if dedup and edges.size:
        edges = np.unique(edges, axis=0)
    return EdgeList(edges=edges, n=n, node_ids=node_ids)


def to_csr(el: EdgeList) -> Tuple[np.ndarray, np.ndarray]:
    """CSR ``(indptr, adj)`` via ``data.pipeline.build_csr``."""
    return _pipeline.build_csr(el.edges, el.n)


def fit_data(el: EdgeList, *, shard_size: Optional[int] = None, mesh=None, device=None) -> FitData:
    """Pack an :class:`EdgeList` into MAGFIT's fixed-shape shards on
    ``device`` (default ``"cuda"``; raises without a card); ``mesh=``
    rounds the shard count as :func:`repro_torch.fit.magfit.shard_edges`
    does."""
    return shard_edges(el.edges, el.n, shard_size=shard_size, mesh=mesh, device=device)
