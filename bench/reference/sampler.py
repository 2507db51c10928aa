"""The plain reference of the benchmark's samplers: the quilted MAGM graph
(Algorithm 2 with the exact-cell round or the ranked rounds) and the KPGM
graph (Algorithm 1 as the B = 1 quilt), from the same seed-made inputs
the program receives, in plain PyTorch and NumPy.

What the program derives at set-up and in its round is worked out again
here, each step in the straightforward way:

- the attribute matrix F ~ Bernoulli(mu) from the attribute key;
- the Theorem-2 partition (node i goes to block |Z_i| - 1, its occurrence
  rank among the nodes of its configuration) as a dense config -> node map
  per block, where the program searches sorted tables;
- each candidate's descent, one level at a time, from the counter hash of
  (round key, graph, slot * 64 + level);
- in the exact-cell round, acceptance with alpha = min(p / q, 1) against a
  splitmix64 hash of (salt, graph, cell);
- the first occurrences per graph in arrival order, by a stable sort of
  (graph, pair) keys, capped at each graph's target.

``precision="bfloat16"`` computes every floating-point step (the descent's
thresholds, alpha, the edge-count targets) in bfloat16 instead of float32:
the benchmark's control, which has to fail the comparison.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from bench.reference import f32, prng

M32 = 0xFFFFFFFF
CHANNELS = 64  # counter words reserved per candidate slot
MAX_CANDIDATES = 1 << 25  # the largest single device round
MAX_ROUNDS = 8
ROW_BLOCK = 1 << 24  # candidate rows descended at a time


class Plan(NamedTuple):
    n: int
    d: int
    B: int
    thetas: torch.Tensor  # (d, 2, 2) float32
    inv: torch.Tensor  # (B, 2^d) int32 node of each config per block, -1 absent
    cum: torch.Tensor  # (d, 4) float32 cumulative quadrant probabilities
    mean: float
    std: float
    p_max: float

    @property
    def graphs(self) -> int:
        return self.B * self.B


def _u64(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


_ACC = [_u64(c) for c in (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)]
_MIX = (0x7FEB352D, 0x846CA68B)
_WORD_C, _GID_C = 0x9E3779B9, 0x85EBCA6B


# -- inputs -----------------------------------------------------------------


def thetas_of(theta, d: int) -> torch.Tensor:
    return torch.from_numpy(np.broadcast_to(np.asarray(theta, dtype=np.float32), (d, 2, 2)).copy())


def attributes(attr_key: torch.Tensor, n: int, mu: float, d: int, device) -> np.ndarray:
    """(n, d) int8 bits: F[i, k] = uniform(attr_key)[i, k] < mu."""
    u = prng.uniform(attr_key, (n, d), device=device)
    return (u < float(np.float32(mu))).to(torch.int8).cpu().numpy()


def _fma64(x, y, z):
    return (x.double() * y.double() + z.double()).float()


def plan(F: np.ndarray, thetas: torch.Tensor, device) -> Plan:
    """The quilting plan of the attribute rows F (n, d)."""
    n, d = F.shape
    lam = (F.astype(np.int64) << np.arange(d - 1, -1, -1)).sum(axis=1)
    # occurrence rank: position of node i among the nodes of its config
    order = np.argsort(lam, kind="stable")
    run_start = np.zeros(n, dtype=np.int64)
    new = np.ones(n, dtype=bool)
    new[1:] = lam[order][1:] != lam[order][:-1]
    run_start[new] = np.nonzero(new)[0]
    run_start = np.maximum.accumulate(run_start)
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n) - run_start
    B = int(rank.max()) + 1
    inv = np.full((B, 1 << d), -1, dtype=np.int32)
    inv[rank, lam] = np.arange(n, dtype=np.int32)

    f = thetas.reshape(-1, 4)
    sums = (f[:, 0] + f[:, 1]) + (f[:, 2] + f[:, 3])
    q = f / sums[:, None]
    c1 = q[:, 0] + q[:, 1]
    c2 = c1 + q[:, 2]
    cum = torch.stack([q[:, 0], c1, c2, c2 + q[:, 3]], dim=1)
    sq = _fma64(f[:, 1], f[:, 1], f[:, 0] * f[:, 0]) + _fma64(f[:, 3], f[:, 3], f[:, 2] * f[:, 2])
    m, v, pm = sums[0], sq[0], f[0].max()
    for k in range(1, d):
        m, v, pm = m * sums[k], v * sq[k], pm * f[k].max()
    std = f32.sqrt(torch.clamp_min(m - v, 0.0))
    return Plan(n, d, B, thetas, torch.from_numpy(inv).to(device), cum.to(device), float(m), float(std), float(pm))


def kpgm_plan(thetas: torch.Tensor, device) -> Plan:
    """The B = 1 plan of a KPGM graph: config c is node c."""
    d = thetas.shape[0]
    F = ((np.arange(1 << d)[:, None] >> np.arange(d - 1, -1, -1)) & 1).astype(np.int8)
    return plan(F, thetas, device)


# -- the round ----------------------------------------------------------------


def _mix32(x):
    x = x ^ (x >> 16)
    x = (x * _MIX[0]) & M32
    x = x ^ (x >> 15)
    x = (x * _MIX[1]) & M32
    return x ^ (x >> 16)


def _u01(s0: int, s1: int, gid: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    x = _mix32((word * _WORD_C + s0) & M32)
    x = _mix32(x ^ ((gid * _GID_C + s1) & M32))
    return (x >> 8).to(torch.float32) * 2.0**-24


def descend(seed, p: Plan, graphs: int, slots: int, precision: str):
    """(scfg, dcfg, snode, dnode) int64 of ``graphs * slots`` candidates:
    row r is slot r % slots of graph r // slots."""
    s0, s1 = seed
    dev = p.inv.device
    rows = graphs * slots
    outs = [torch.empty(rows, dtype=torch.int64, device=dev) for _ in range(4)]
    cum = p.cum if precision == "float32" else p.cum.to(torch.bfloat16)
    for lo in range(0, rows, ROW_BLOCK):
        r = torch.arange(lo, min(lo + ROW_BLOCK, rows), dtype=torch.int64, device=dev)
        gid, slot = r // slots, r % slots
        del r
        scfg = torch.zeros_like(gid)
        dcfg = torch.zeros_like(gid)
        for k in range(p.d):
            u = _u01(s0, s1, gid, slot * CHANNELS + k)
            if precision != "float32":
                u = u.to(torch.bfloat16)
            quad = (u >= cum[k, 0]).to(torch.int64) + (u >= cum[k, 1]) + (u >= cum[k, 2])
            scfg = scfg * 2 + quad // 2
            dcfg = dcfg * 2 + quad % 2
        blk = gid % p.graphs
        kb, lb = blk // p.B, blk % p.B
        for o, x in zip(outs, (scfg, dcfg, p.inv[kb, scfg], p.inv[lb, dcfg])):
            o[lo : lo + x.numel()] = x
    return outs


def _accept_u01(salt: int, gid: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer over (salt, graph, cell), in int64 arithmetic
    that wraps mod 2^64; the top 24 bits as a uniform in [0, 1)."""
    g, c, m1, m2 = _ACC
    x = salt ^ (gid * g) ^ (cell * c)

    def lsr(y, k):
        return (y >> k) & ((1 << (64 - k)) - 1)

    x = (x ^ lsr(x, 30)) * m1
    x = (x ^ lsr(x, 27)) * m2
    x = x ^ lsr(x, 31)
    return lsr(x, 40).to(torch.float32) * 2.0**-24


def alpha(scfg, dcfg, p: Plan, budget: int, precision: str) -> torch.Tensor:
    """min(p / q, 1) per candidate: p the cell's probability, q = 1 - (1 -
    p / m)^G its chance to be proposed at least once in G draws."""
    d = p.d
    shift = torch.arange(d - 1, -1, -1, device=scfg.device)
    idx = torch.arange(d, device=scfg.device) * 4 + ((scfg[:, None] >> shift) & 1) * 2 + ((dcfg[:, None] >> shift) & 1)
    th = p.thetas.to(scfg.device)
    f = th.reshape(-1, 4)
    sums = (f[:, 0] + f[:, 1]) + (f[:, 2] + f[:, 3])
    if precision == "float32":
        logt = f32.log(torch.clamp(th, 1e-30, 1.0)).reshape(-1)[idx]
        logs = f32.log(sums)
        exp, log, log1p, expm1, dt = f32.exp, f32.log, f32.log1p, f32.expm1, torch.float32
    else:
        dt = torch.bfloat16
        logt = torch.log(torch.clamp(th, 1e-30, 1.0).to(dt)).reshape(-1)[idx]
        logs = torch.log(sums.to(dt))
        exp, log, log1p, expm1 = torch.exp, torch.log, torch.log1p, torch.expm1
    logp, log_m = logt[:, 0], logs[0]
    for k in range(1, d):
        logp = logp + logt[:, k]
        log_m = log_m + logs[k]
    del logt
    pi = exp(logp - log_m)
    g = torch.full((), float(budget), dtype=dt, device=scfg.device)
    q = -expm1(g * log1p(-pi))
    return torch.clamp_max(exp(logp - log(q)), 1.0)


def first_taken(graph: torch.Tensor, a: torch.Tensor, b: torch.Tensor, valid, targets: torch.Tensor, bits: int):
    """Mask of the rows that are among the first ``targets[g]`` distinct
    valid (a, b) pairs of their graph g, in row order."""
    pair = a * (1 << bits) + b
    if valid is not None:
        pair = torch.where(valid, pair, torch.full_like(pair, 1 << (2 * bits)))
    order = torch.sort(graph * (1 << (2 * bits + 1)) + pair, stable=True).indices
    sg, sp = graph[order], pair[order]
    first = torch.ones_like(sg, dtype=torch.bool)
    first[1:] = (sg[1:] != sg[:-1]) | (sp[1:] != sp[:-1])
    fresh = torch.empty_like(first)
    fresh[order] = first
    del order, sg, sp, first
    if valid is not None:
        fresh &= valid
    G = targets.numel()
    per = torch.bincount(graph, weights=None, minlength=G)  # rows per graph
    start = torch.cumsum(per, 0) - per
    c = torch.cumsum(fresh.to(torch.int64), 0)
    before = torch.where(start > 0, c[torch.clamp_min(start - 1, 0)], torch.zeros_like(start))
    rank = c - before[graph]
    return fresh & (rank <= targets[graph])


def _bucket(x: int) -> int:
    x = max(int(x), 1)
    if x <= 16:
        return 16
    base = 1 << (x.bit_length() - 4)
    for mult in range(8, 16):
        if mult * base >= x:
            return mult * base
    return 16 * base


def _ask(needs: np.ndarray, oversample: float) -> int:
    top = int(np.maximum(needs, 0).max(initial=0))
    return 0 if top == 0 else _bucket(int(top * oversample) + 16)


def exact_budget(p: Plan) -> Optional[int]:
    pm = min(p.p_max, 1.0 - 1e-6)
    S = max(p.mean, pm)
    if pm <= 0.0 or pm / S >= 1.0:
        return 1
    g = math.log1p(-pm) / math.log1p(-pm / S)
    if not math.isfinite(g) or g > MAX_CANDIDATES:
        return None
    return max(int(math.ceil(g)), 1)


class Unsupported(RuntimeError):
    """The run would leave the device rounds (host path or host top-up),
    which this reference does not follow."""


def _exact_fits(p: Plan, samples: int, exact: bool) -> Optional[int]:
    """The exact budget G where ``exact`` and one round holds it, else None."""
    budget = exact_budget(p) if exact else None
    return None if budget is None or samples * p.graphs * budget > MAX_CANDIDATES else budget


def work(p: Plan, samples: int, exact: bool, oversample: float) -> dict:
    """One call's shapes: its candidate rows (the exact round's, or one
    ranked round's at the mean edge count) and its lookup tables'."""
    gtot = samples * p.graphs
    budget = _exact_fits(p, samples, exact)
    rows = gtot * (budget if budget is not None else _ask(np.array([round(p.mean)]), oversample))
    width = max(int((p.inv >= 0).sum(dim=1).max()), 8)
    return dict(rows=rows, d=p.d, table_rows=p.B, table_width=width + (-width) % 8, num_graphs=p.graphs)


def sample(k: torch.Tensor, p: Plan, *, samples: int = 1, exact: bool = True, backend: str = "auto",
           oversample: float = 1.05, precision: str = "float32") -> List[np.ndarray]:
    """The (E, 2) int64 edges of each of ``samples`` graphs drawn with key
    ``k`` over plan ``p``: the exact-cell round where ``exact`` and its
    budget fit one round, else the ranked rounds."""
    gtot = samples * p.graphs
    dev = p.inv.device
    budget = _exact_fits(p, samples, exact)
    k, sub = prng.split(k)
    if budget is not None:
        targets = np.full(gtot, budget, dtype=np.int64)
    else:
        z = prng.normal(sub, (gtot,))
        if precision == "float32":
            x = z.numpy() * np.float32(p.std) + np.float32(p.mean)
        else:
            x = (z.to(torch.bfloat16) * p.std + p.mean).float().numpy()
        targets = np.clip(np.round(x), 0, min(4 ** p.d, 2**62)).astype(np.int64)
    ask = budget if budget is not None else _ask(targets, oversample)
    if budget is None and backend == "auto" and gtot * ask > MAX_CANDIDATES:
        raise Unsupported(f"{gtot * ask} candidates take the host path")
    _, rkey = prng.split(k)
    seed = (int(rkey[0]) & M32, int(rkey[1]) & M32)
    tdev = torch.from_numpy(targets).to(dev)
    slots, short = 0, targets
    for _ in range(1 if budget is not None else MAX_ROUNDS):
        ask = budget if budget is not None else _ask(short, oversample)
        if ask == 0:
            break
        if slots and gtot * (slots + ask) > MAX_CANDIDATES:
            raise Unsupported("the residual goes to the host top-up")
        slots += ask
        scfg, dcfg, snode, dnode = descend(seed, p, gtot, slots, precision)
        graph = torch.arange(gtot * slots, device=dev) // slots
        valid = None
        if budget is not None:
            salt = prng.bits64_scalar(prng.fold_in(rkey, 0x5EED))
            u = _accept_u01(salt, graph, scfg * (1 << p.d) + dcfg)
            valid = (snode >= 0) & (dnode >= 0) & (u < alpha(scfg, dcfg, p, budget, precision))
            del u
        take = first_taken(graph, scfg, dcfg, valid, tdev, p.d)
        counts = torch.bincount(graph[take], minlength=gtot).cpu().numpy()
        short = np.zeros_like(targets) if budget is not None else targets - counts
        if short.max(initial=0) <= 0:
            break
    if short.max(initial=0) > 0:
        raise Unsupported("the device rounds ended short of the targets")
    keep = take & (snode >= 0) & (dnode >= 0)
    per_sample = slots * p.graphs
    out = []
    for s in range(samples):
        sl = slice(s * per_sample, (s + 1) * per_sample)
        m = keep[sl]
        out.append(torch.stack([snode[sl][m], dnode[sl][m]], dim=1).cpu().numpy())
    return out
