"""Compressed cross-pod collectives (the reference's
``repro.dist.collectives`` in PyTorch).

The inter-pod gradient all-reduce is pure data-parallel traffic, so it
tolerates lossy compression: gradients are quantised to int8 with
STOCHASTIC rounding (unbiased: E[q * scale] = x).  The reduction is an
all-gather of the int8 payload plus one float32 scale per rank, then a
local dequantise-and-mean: the wire carries 1 byte per element per peer.

Every rank calls these functions (SPMD): :func:`compressed_psum_mean` on
its own leaf, :func:`compressed_grad_allreduce` on its own tree.  The
rounding draws the reference's threefry uniforms (``core.prng``), with the
key folded by the rank's coordinate on the axis, so the payloads and
scales equal the reference's bit for bit; the mean sums the peers in rank
order, so it is the same on every device.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import prng


def _stochastic_round_int8(x: torch.Tensor, key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantise to int8 with an unbiased stochastic round.

    Returns (q int8, scale float32 0-d) with E[q * scale] = x; the scale is
    the leaf's absmax / 127, so the range is never clipped."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    y = xf / scale
    lo = torch.floor(y)
    frac = y - lo
    u = prng.uniform(key, tuple(x.shape), device=x.device)
    q = lo + (u < frac).to(torch.float32)
    return torch.clamp(q, -127.0, 127.0).to(torch.int8), scale


def compressed_psum_mean(leaf: torch.Tensor, key: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Int8-compressed mean of ``leaf`` over the mesh axis ``axis``, called
    by every rank with its own ``leaf``.  The key is folded with the rank's
    coordinate on ``axis``; only the int8 payload and one float32 scale
    per rank cross the link (two ``all_gather_into_tensor`` calls)."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    k = prng.fold_in(key, mesh.get_local_rank(axis))
    q, scale = _stochastic_round_int8(leaf, k)
    q_all = torch.empty((n * q.numel(),), dtype=torch.int8, device=q.device)  # flat: gloo's layout
    scale_all = torch.empty((n,), dtype=torch.float32, device=q.device)
    dist.all_gather_into_tensor(q_all, q.reshape(-1), group=group)
    dist.all_gather_into_tensor(scale_all, scale.reshape(1), group=group)
    deq = q_all.view(n, *q.shape).to(torch.float32) * scale_all.reshape((n,) + (1,) * leaf.ndim)
    total = deq[0]
    for i in range(1, n):  # rank order: the same bits on every device
        total = total + deq[i]
    return total / n


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)


def compressed_grad_allreduce(grads: Any, key: torch.Tensor, mesh, axis: str = "pod") -> Any:
    """Mean of a gradient tree (nested dicts, leaves in sorted key order,
    as ``jax.tree`` flattens a dict) over ``axis`` via int8 payloads; leaf
    i rounds with ``split(key, n_leaves)[i]``.  Results keep the leaves'
    dtypes."""
    leaves = _leaves(grads)
    keys = prng.split(key, max(len(leaves), 1))
    out = [compressed_psum_mean(g, keys[i], mesh, axis).to(g.dtype) for i, g in enumerate(leaves)]
    return _unflatten(grads, iter(out))
