"""Theorem-2 partition of nodes by attribute-configuration occurrence rank.

Z_i := { j <= i : lambda_j = lambda_i };  D_c := { i : |Z_i| = c }.

Within every D_c the configuration map lambda is injective, and B =
max_i |Z_i| sets is the fewest any partition with that property can have
(pigeon-hole; paper Theorem 2).  Host numpy: the partition is built once
per attribute matrix and shipped to the device as two (B, L) tables.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch


def occurrence_ranks_np(lam: np.ndarray) -> np.ndarray:
    """|Z_i| for every node (1-based), from one stable sort: equal
    configurations form runs in node order, so the position in the run is
    |Z_i| - 1."""
    lam = np.asarray(lam)
    n = lam.shape[0]
    order = np.argsort(lam, kind="stable")
    sorted_lam = lam[order]
    new_run = np.empty(n, dtype=bool)
    new_run[0] = True
    new_run[1:] = sorted_lam[1:] != sorted_lam[:-1]
    run_start = np.maximum.accumulate(np.where(new_run, np.arange(n), 0))
    ranks = np.empty(n, dtype=np.int64)
    ranks[order] = np.arange(n) - run_start + 1
    return ranks


def occurrence_ranks(lam: torch.Tensor) -> torch.Tensor:
    """Tensor version of :func:`occurrence_ranks_np` on lam's device (int64
    ranks; the run starts are a running max instead of numpy's
    accumulate)."""
    lam = torch.as_tensor(lam)
    n = lam.shape[0]
    order = torch.sort(lam, stable=True).indices
    sorted_lam = lam[order]
    new_run = torch.ones(n, dtype=torch.bool, device=lam.device)
    new_run[1:] = sorted_lam[1:] != sorted_lam[:-1]
    idx = torch.arange(n, device=lam.device)
    if n == 0:
        return idx
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=0).values
    ranks = torch.empty(n, dtype=torch.int64, device=lam.device)
    ranks[order] = idx - run_start + 1
    return ranks


class Partition(NamedTuple):
    """D_1..D_B as index arrays plus per-set sorted config lookup tables."""

    ranks: np.ndarray  # (n,) |Z_i|
    B: int
    sets: List[np.ndarray]  # D_c: original node indices, c = 1..B
    sorted_configs: List[np.ndarray]  # lambda values of D_c, ascending
    sorted_nodes: List[np.ndarray]  # node ids aligned with sorted_configs


def build_partition(lam: np.ndarray) -> Partition:
    lam = np.asarray(lam)
    ranks = occurrence_ranks_np(lam) if lam.size else np.zeros(0, np.int64)
    B = int(ranks.max()) if lam.size else 0
    sets, scfg, snode = [], [], []
    for c in range(1, B + 1):
        members = np.nonzero(ranks == c)[0]
        cfg = lam[members]
        o = np.argsort(cfg)  # configs within a set are distinct
        sets.append(members)
        scfg.append(cfg[o])
        snode.append(members[o])
    return Partition(ranks=ranks, B=B, sets=sets, sorted_configs=scfg, sorted_nodes=snode)


CFG_SENTINEL = np.int32(2**31 - 1)  # larger than any d <= 31 config id


class PaddedTables(NamedTuple):
    """Row c-1 holds D_c's configs ascending (CFG_SENTINEL padding) and the
    node ids aligned with them (-1 padding), as two (B, L) int32 arrays."""

    configs: np.ndarray  # (B, L) int32
    nodes: np.ndarray  # (B, L) int32
    lengths: np.ndarray  # (B,) true row lengths


def padded_lookup_tables(part: Partition, min_width: int = 8) -> PaddedTables:
    width = max([min_width] + [c.size for c in part.sorted_configs])
    width += (-width) % 8
    cfg = np.full((part.B, width), CFG_SENTINEL, dtype=np.int32)
    node = np.full((part.B, width), -1, dtype=np.int32)
    lengths = np.zeros(part.B, dtype=np.int64)
    for b in range(part.B):
        m = part.sorted_configs[b].size
        cfg[b, :m] = part.sorted_configs[b]
        node[b, :m] = part.sorted_nodes[b]
        lengths[b] = m
    return PaddedTables(configs=cfg, nodes=node, lengths=lengths)


def dense_inverse(part: Partition, d: int) -> np.ndarray:
    """(B, 2^d) int32 map config -> node id per block, -1 where absent: the
    per-candidate block lookup as one gather.  O(B * 2^d) memory; callers
    gate on the size (``quilt.DENSE_INV_CAP``)."""
    inv = np.full((part.B, 1 << d), -1, dtype=np.int32)
    for b in range(part.B):
        inv[b, part.sorted_configs[b]] = part.sorted_nodes[b]
    return inv


def lookup_nodes(sorted_configs: np.ndarray, sorted_nodes: np.ndarray, configs: np.ndarray) -> np.ndarray:
    """Node ids of sampled configurations in one D_c, -1 where absent
    (host numpy; the kernels' lookup is checked against it)."""
    configs = np.asarray(configs)
    if sorted_configs.size == 0:
        return np.full(configs.shape, -1, dtype=np.int64)
    pos = np.minimum(np.searchsorted(sorted_configs, configs), sorted_configs.size - 1)
    return np.where(sorted_configs[pos] == configs, sorted_nodes[pos], -1)


def is_valid_partition(lam: np.ndarray, sets: List[np.ndarray]) -> bool:
    """Checks the injectivity invariant and coverage (used by property tests)."""
    lam = np.asarray(lam)
    seen = np.zeros(lam.shape[0], dtype=bool)
    for members in sets:
        if np.unique(lam[members]).size != members.size:
            return False  # two nodes in one set share a configuration
        if seen[members].any():
            return False  # not a partition
        seen[members] = True
    return bool(seen.all())


def min_partition_size(lam: np.ndarray) -> int:
    """Pigeon-hole lower bound = max multiplicity of any configuration."""
    if np.asarray(lam).size == 0:
        return 0
    _, counts = np.unique(np.asarray(lam), return_counts=True)
    return int(counts.max())
