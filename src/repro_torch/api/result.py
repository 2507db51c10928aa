"""GraphSample: the result of a sampling call — edges, node count, stats
and the key it consumed."""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np

from repro_torch.core.quilt import QuiltStats

__all__ = ["GraphSample", "KPGMStats", "QuiltStats"]


class KPGMStats(NamedTuple):
    """Bookkeeping of one KPGM sample."""

    num_nodes: int  # 2^d
    target_edges: int  # the X ~ N(m, m - v) draw, or the num_edges override
    sampled_edges: int  # distinct edges emitted


class GraphSample(NamedTuple):
    """One sampled graph.

    ``edges`` is the (E, 2) host array in the config's dtype; ``n`` the
    node count; ``stats`` a :class:`QuiltStats` (MAGM) or
    :class:`KPGMStats` (KPGM; None on its host paths); ``key`` the key this
    sample consumed (re-sampling with it reproduces the edges).
    """

    edges: np.ndarray
    n: int
    stats: Optional[Any]
    key: Optional[Any]

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def density(self) -> float:
        return self.num_edges / float(max(self.n, 1)) ** 2
