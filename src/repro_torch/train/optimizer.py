"""AdamW with float32 master weights, global-norm clipping and a cosine
schedule, over dicts of tensors.

The reference's update written out by hand: ``torch.optim.AdamW`` neither
clips by the global norm nor floors the cosine at 0.1, and MAGFIT's M-step
and the LM's train step need exactly this function.  The update is out of
place, as the reference's: it holds the old and the new state at once
(at olmo-1b, two copies of ~14.2 GB of float32 moments and masters).  Each
leaf is updated ``UPDATE_CHUNK`` elements at a time into its new tensors:
the update is elementwise, so the bits are those of one pass, and its
float32 temporaries stay small beside a stacked leaf (zamba2's (54, 2560,
5120) ``w_z`` is 2.8 GB in float32).  A tree here is a dict of tensors, nested
dicts allowed; leaves are visited in sorted key order, as ``jax.tree``
visits a dict's, so the global norm sums them in the reference's order.

On DTensor leaves (the dry-run's sharded params) the state is made
``*_like`` the params, so it takes their placements; each gradient is
first redistributed to its parameter's placements (FSDP's reduce-scatter),
and the update runs on the ranks' local shards (``to_local()``): slicing a
sharded leaf into ``UPDATE_CHUNK`` pieces would force a redistribution,
and AdamW is elementwise, so the shards' update is exact.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any  # float32 tree
    nu: Any  # float32 tree
    master: Any  # float32 master weights


def _map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def init(params: Any) -> OptState:
    """Zero moments and float32 masters on the parameters' devices."""
    zeros = _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=_leaves(params)[0].device),
        mu=zeros,
        nu=_map(torch.clone, zeros),
        master=_map(lambda p: p.detach().to(torch.float32).clone(), params),
    )


def abstract_state(params: Any) -> OptState:
    """The state's shapes and dtypes as meta tensors (no memory)."""
    return init(_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params))


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay floored at 0.1 x lr."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    frac = (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    cos = 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(frac, 0.0, 1.0)))
    return cfg.lr * torch.clamp_max(warm, 1.0) * torch.clamp_min(cos, 0.1)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared entries, in float32."""
    total = None
    for g in _leaves(tree):
        sq = torch.sum(g.to(torch.float32) ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


UPDATE_CHUNK = 1 << 24  # elements of one leaf updated at a time


def update(
    cfg: OptConfig, grads: Any, state: OptState, params: Any
) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new params in their own dtypes, new state,
    metrics)."""
    from torch.distributed.tensor import DTensor

    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    if isinstance(scale, DTensor):  # replicated: every rank's local value is the scalar
        scale = scale.full_tensor()
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))

    def upd_chunk(g, mu, nu, m):
        g = g.to(torch.float32) * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        mhat = mu / b1c
        nhat = nu / b2c
        m = m - lr * (mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * m)
        return mu, nu, m

    def upd(g, mu, nu, m):
        if isinstance(g, DTensor):
            if tuple(g.placements) != tuple(m.placements):
                g = g.redistribute(m.device_mesh, m.placements)
            out = upd(*(t.to_local() for t in (g, mu, nu, m)))
            return tuple(DTensor.from_local(o, m.device_mesh, m.placements, run_check=False,
                                            shape=m.shape, stride=m.stride()) for o in out)
        if g.numel() <= UPDATE_CHUNK:
            return upd_chunk(g, mu, nu, m)
        out = tuple(torch.empty_like(t) for t in (mu, nu, m))
        src = [t.reshape(-1) for t in (g, mu, nu, m)]
        dst = [t.view(-1) for t in out]
        for a in range(0, g.numel(), UPDATE_CHUNK):
            part = upd_chunk(*(t[a : a + UPDATE_CHUNK] for t in src))
            for d, v in zip(dst, part):
                d[a : a + UPDATE_CHUNK] = v
        return out

    out = _map(upd, grads, state.mu, state.nu, state.master)
    mu, nu, master = (_map(lambda o, i=i: o[i], out) for i in range(3))
    new_params = _map(lambda m, p: m.to(p.dtype), master, params)
    return new_params, OptState(step=step, mu=mu, nu=nu, master=master), {"grad_norm": gnorm, "lr": lr}
