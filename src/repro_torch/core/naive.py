"""Tiled O(n^2) naive MAGM sampler: the paper's baseline (section 6.2).

The paper's naive scheme performs n^2 sequential Bernoulli trials.  Here
the trials go in (tile x tile) blocks: draw the block's uniforms, take
their float32 log, and compare against the block's log Q in the fused
``bernoulli_tile`` kernel (``csrc/bernoulli_tile.cu``), which computes log Q
in registers from the bilinear form and writes an int8 mask; on a CPU
tensor the kernel's plain version does the same.  The key stream and the
tile walk are the reference's (``repro/core/naive.py``), so the same key and
F give the same edges, up to cells whose log u lies within float32
rounding of log Q.

Still Theta(n^2) work: it reproduces the paper's baseline comparison and
serves as the exact oracle for the quilting sampler at small n.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import f32math, magm, prng
from repro_torch.core.device import resolve_device
from repro_torch.kernels import bernoulli_tile as _bt
from repro_torch.kernels import ops

# the log-space draw: u in [1e-38, 1) as the reference draws it, and
# u < q  <=>  log u < log q, which avoids exp underflow
_MINVAL = 1e-38


def _sample_tile(key, fs: torch.Tensor, ft: torch.Tensor, packed) -> torch.Tensor:
    """int8 mask of one tile from float32 attribute blocks and the packed
    bilinear terms, all on one device."""
    u = prng.uniform(key, (fs.shape[0], ft.shape[0]), minval=_MINVAL, maxval=1.0, device=fs.device)
    return _bt.bernoulli_tile(fs, ft, *packed, f32math.log(u))


def sample_tile(key: torch.Tensor, F_rows: torch.Tensor, F_cols: torch.Tensor, thetas) -> torch.Tensor:
    """Boolean adjacency tile on F_rows's device: A[i, j] ~ Bernoulli(Q[i, j]).

    The uniforms are drawn over the tile's exact shape, as the reference's
    ``sample_tile`` draws them."""
    fs = F_rows.to(torch.float32).contiguous()
    ft = F_cols.to(device=fs.device, dtype=torch.float32).contiguous()  # lint: disable=host-sync-in-step -- a no-op for F on the card; a host F is copied once a tile
    return _sample_tile(key, fs, ft, ops._packed_bilinear(thetas, fs.device)).view(torch.bool)


def naive_sample(
    key: torch.Tensor,
    params: magm.MAGMParams,
    F,
    *,
    tile: int = 2048,
    device=None,
) -> np.ndarray:
    """Full naive sample in (tile x tile) blocks on ``device`` (default
    ``"cuda"``; raises without a card); returns (E, 2) int64 on the host,
    in the reference's order: tiles row-major, cells row-major in a tile."""
    dev = resolve_device(device)
    F = F.cpu().numpy() if isinstance(F, torch.Tensor) else np.asarray(F)
    n = F.shape[0]
    Fd = torch.from_numpy(np.ascontiguousarray(F)).to(device=dev, dtype=torch.float32)
    packed = ops._packed_bilinear(params.thetas, dev)
    out = []
    for i0 in range(0, n, tile):
        i1 = min(i0 + tile, n)
        for j0 in range(0, n, tile):
            j1 = min(j0 + tile, n)
            key, sub = prng.split(key)
            mask = _sample_tile(sub, Fd[i0:i1], Fd[j0:j1], packed)
            idx = torch.nonzero(mask)
            if idx.numel():
                idx[:, 0] += i0
                idx[:, 1] += j0
                out.append(idx)
    if not out:
        return np.zeros((0, 2), dtype=np.int64)
    return torch.cat(out).cpu().numpy()


def count_edges_tile(key: torch.Tensor, F_rows: torch.Tensor, F_cols: torch.Tensor, thetas) -> torch.Tensor:
    """Edge count of one sampled tile (the throughput benchmark's unit)."""
    return torch.sum(sample_tile(key, F_rows, F_cols, thetas))
