"""Distributed KPGM sampling over the ranks of a DeviceMesh (the
reference's ``repro.core.distributed``).

Algorithm 1's X candidate edges are independent, so each rank draws its
share with its own folded key, and one ``all_gather`` of the fixed-shape
(src, dst) buffers, in rank order, gives every rank the whole batch; the
host dedupes and tops up.  The B^2 block-pair graphs of the quilting
sampler are sharded by ``core.quilt.quilt_run(mesh=)`` itself.

Every rank of the mesh calls with the same arguments (SPMD); a rank's
share runs on the mesh's device type ("cuda": the current card).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import kpgm, prng, quilt


def sample_edges_sharded(key: torch.Tensor, thetas, per_device: int, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """``size * per_device`` edge candidates: rank r (its row-major index
    over the mesh's dims) draws ``kpgm.sample_edge_batch(fold_in(key, r),
    thetas, per_device)``, and the shares come back concatenated in rank
    order on every rank, as int32 (src, dst) on the mesh's device.
    Duplicates are possible; the caller dedupes."""
    axes = tuple(mesh.mesh_dim_names)
    idx, _ = quilt._shard_index(mesh, axes)
    src, dst = kpgm.sample_edge_batch(prng.fold_in(key, idx), thetas, per_device, device=mesh.device_type)
    return quilt._gather_rows(src, mesh, axes), quilt._gather_rows(dst, mesh, axes)


def kpgm_sample_distributed(
    key: torch.Tensor,
    params: kpgm.KPGMParams,
    mesh,
    *,
    max_rounds: int = 8,
    oversample: float = 1.05,
) -> np.ndarray:
    """One KPGM graph drawn by the mesh's ranks: the target X ~ N(m, m - v)
    (capped at n^2), then up to ``max_rounds`` rounds of
    :func:`sample_edges_sharded` asking for the shortfall, deduped on the
    host with ``np.unique`` (so the edges come back sorted by
    ``src * n + dst``).  Returns (E, 2) int64, the same on every rank."""
    thetas = params.thetas
    n = params.num_nodes
    ndev = int(mesh.size())
    key, sub = prng.split(key)
    target = min(int(kpgm.sample_num_edges(sub, thetas)), n * n)
    if target == 0:
        return np.zeros((0, 2), dtype=np.int64)
    seen = np.empty((0,), dtype=np.int64)
    for _ in range(max_rounds):
        need = target - seen.size
        if need <= 0:
            break
        key, sub = prng.split(key)
        per_device = max((int(need * oversample) + ndev - 1) // ndev, 8)
        src, dst = sample_edges_sharded(sub, thetas, per_device, mesh)
        flat = src.cpu().numpy().astype(np.int64) * n + dst.cpu().numpy().astype(np.int64)
        seen = np.unique(np.concatenate([seen, flat]))
    seen = seen[:target]
    return np.stack([seen // n, seen % n], axis=1)
