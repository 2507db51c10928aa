"""Stochastic Kronecker Product Graph Model (KPGM): the level cumulative
probabilities, quadrant descent, |E| moments and log-probabilities of the
quilting path, and Algorithm 1 itself — the edge-count draw, the threefry
candidate batches and the ranked rejection rounds that keep the first X
distinct edges (:func:`kpgm_sample_many`, :func:`_kpgm_sample_host`).

P_ij = prod_k theta^(k)[bit_k(i), bit_k(j)] with 0-based ids, bit 0 the
most significant.  The float32 reductions follow the order of the reference's
compiled plan constants: a (2, 2) initiator sums as (t00 + t01) + (t10 +
t11), the squares' sum fused as fma(t01, t01, t00 * t00) + fma(t11, t11,
t10 * t10), and products, sums and the cumulative table run from index 0
up.  The plan's table and scalars are therefore equal to the reference's,
not merely close.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dedup, f32math, prng
from repro_torch.core.device import resolve_device
from repro_torch.kernels import quadrant_descent as qd
from repro_torch.kernels.quadrant_descent import _descend_body

# above this many candidates one device round is not taken: the exact-cell
# mode and the ranked rounds fall back (the reference's DEVICE_MAX_CANDIDATES)
DEVICE_MAX_CANDIDATES = 1 << 25

# float32 uniforms drawn at once by descend_draw: the threefry runs in int64
# PyTorch ops with ~10 live 8-byte temporaries per element, so a chunk of
# 2^26 elements peaks near 5 GB on the card whatever the batch size
DRAW_CHUNK_ELEMS = 1 << 26


class KPGMParams(NamedTuple):
    """Per-level 2x2 initiator matrices, (d, 2, 2) float32 in [0, 1]."""

    thetas: torch.Tensor

    @property
    def d(self) -> int:
        return self.thetas.shape[0]

    @property
    def num_nodes(self) -> int:
        return 1 << self.d


def make_params(theta, d: int) -> KPGMParams:
    """One 2x2 initiator replicated at every level, as a float32 CPU tensor."""
    theta = np.asarray(theta, dtype=np.float32)
    if theta.shape != (2, 2):
        raise ValueError(f"initiator must be 2x2, got {theta.shape}")
    if not ((theta >= 0).all() and (theta <= 1).all()):
        raise ValueError("initiator entries must lie in [0, 1]")
    return KPGMParams(torch.from_numpy(np.broadcast_to(theta, (d, 2, 2)).copy()))


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add, evaluated in float64 (the float32 product
    is exact there)."""
    return (x.double() * y.double() + z.double()).float()


def _level_sums(thetas: torch.Tensor) -> torch.Tensor:
    f = thetas.reshape(-1, 4)
    return (f[:, 0] + f[:, 1]) + (f[:, 2] + f[:, 3])


def _prod_levels(v: torch.Tensor) -> torch.Tensor:
    acc = v[0]
    for x in v[1:]:
        acc = acc * x
    return acc


def _sum_levels(v: torch.Tensor) -> torch.Tensor:
    acc = v[..., 0]
    for k in range(1, v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def edge_moments(thetas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean m = prod_k sum(theta^(k)) and v = prod_k sum(theta^(k)^2) of
    |E| (Algorithm 1 lines 3-4), float32 scalars."""
    f = thetas.reshape(-1, 4)
    sq = _fma(f[:, 1], f[:, 1], f[:, 0] * f[:, 0]) + _fma(
        f[:, 3], f[:, 3], f[:, 2] * f[:, 2]
    )
    return _prod_levels(_level_sums(thetas)), _prod_levels(sq)


def edge_moments_eager(thetas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, v) as the reference's ``edge_moments`` evaluates outside a
    compiled program: the same pairwise level sums and level products, but
    each square rounded before its sum (no fused multiply-add)."""
    f = torch.as_tensor(thetas, dtype=torch.float32).reshape(-1, 4)
    sq = f * f
    return _prod_levels(_level_sums(f)), _prod_levels((sq[:, 0] + sq[:, 1]) + (sq[:, 2] + sq[:, 3]))


def expected_edges(thetas) -> float:
    """E|E| = prod_k sum(theta^(k)), as the reference's eager
    ``expected_edges`` evaluates it."""
    return float(edge_moments_eager(thetas)[0])


def _edge_std(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return f32math.sqrt(torch.clamp_min(m - v, 0.0))


def sample_num_edges(key: torch.Tensor, thetas) -> torch.Tensor:
    """X ~ N(m, m - v) (Algorithm 1 line 5), rounded half to even and
    clipped at 0: a float32 scalar, as the reference draws it."""
    m, v = edge_moments_eager(thetas)
    x = m + _edge_std(m, v) * prng.normal(key, ())
    return torch.clamp_min(torch.round(x), 0.0)


def _bucket(x: int) -> int:
    """Smallest 2^k * {4,5,6,7,8}/4 >= x (at least 64): the batch sizes of
    the single-graph host loop."""
    if x <= 64:
        return 64
    k = (x - 1).bit_length() - 3
    base = 1 << k
    for mult in (4, 5, 6, 7, 8):
        if mult * base >= x:
            return mult * base
    return 8 * base


def max_cell_prob(thetas: torch.Tensor) -> torch.Tensor:
    """prod_k max(theta^(k)): the largest single-cell probability."""
    return _prod_levels(thetas.reshape(-1, 4).amax(dim=1))


def _level_cumprobs(thetas: torch.Tensor) -> torch.Tensor:
    """(d, 4) cumulative quadrant probabilities, row-major (00, 01, 10, 11).

    Normalised by the pairwise level sums, as in the reference's compiled
    plan constants (XLA shares one level-sum reduction between this table
    and the moments there)."""
    f = thetas.reshape(-1, 4)
    q = f / _level_sums(thetas)[:, None]
    c0 = q[:, 0]
    c1 = c0 + q[:, 1]
    c2 = c1 + q[:, 2]
    return torch.stack([c0, c1, c2, c2 + q[:, 3]], dim=1)


def _descend(u: torch.Tensor, cum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, d) uniforms + (d, 4) cumulative quadrant probs -> int32 id pairs."""
    return _descend_body(u, cum)


def edge_prob_matrix(thetas) -> torch.Tensor:
    """Exact dense P = kron(theta_1, ..., theta_d), float32.  Only for small
    d (tests)."""
    thetas = torch.as_tensor(thetas, dtype=torch.float32)
    p = thetas[0]
    for k in range(1, thetas.shape[0]):
        p = torch.kron(p, thetas[k])
    return p


def log_level_sum(thetas: torch.Tensor) -> torch.Tensor:
    """sum_k log sum(theta^(k)) = log m, summed from level 0 up."""
    return _sum_levels(f32math.log(_level_sums(thetas)))


def level_log_table(thetas: torch.Tensor) -> torch.Tensor:
    """(4 d,) float32 log theta^(k)_{ab} at index 4 k + 2 a + b, each theta
    clamped to [1e-30, 1], with the reference's float32 log."""
    return f32math.log(torch.clamp(thetas, 1e-30, 1.0)).reshape(-1)


def log_prob_pairs(thetas: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """float32 log P_{src,dst} for 0-based id pairs (paper eq. 6), summed
    from level 0 up with the reference's float32 log."""
    d = thetas.shape[0]
    shift = torch.arange(d - 1, -1, -1, device=src.device)
    a = (src.to(torch.int64)[:, None] >> shift) & 1
    b = (dst.to(torch.int64)[:, None] >> shift) & 1
    ks = torch.arange(d, device=src.device)
    return _sum_levels(level_log_table(thetas)[ks * 4 + a * 2 + b])


def descend_draw(
    key: torch.Tensor,
    cum: torch.Tensor,
    num_rows: int,
    *,
    lookup: Optional[tuple] = None,
):
    """Quadrant descent of the threefry draw ``uniform(key, (num_rows, d))``
    on cum's device, bit for bit the descent of the whole draw.

    The draw goes ``DRAW_CHUNK_ELEMS // d`` rows at a time (``prng.uniform``'s
    ``offset``), each chunk through the ``quadrant_descent`` kernel, or with
    ``lookup=(kb, lb, table_cfg, table_node, inv)`` (kb, lb per row; inv the
    tables' dense inverse or None) through ``quilt_descent_lookup``; only
    the int32 outputs are kept.  Returns
    ``(src, dst)``, or ``(src_cfg, dst_cfg, src_node, dst_node)`` with a
    lookup.
    """
    d = cum.shape[0]
    if d > 31:
        raise ValueError("node ids are int32; require d <= 31")
    dev = cum.device
    num_rows = int(num_rows)
    outs = [torch.empty(num_rows, dtype=torch.int32, device=dev) for _ in range(2 if lookup is None else 4)]
    step = max(DRAW_CHUNK_ELEMS // d, 1)
    for a in range(0, num_rows, step):
        b = min(a + step, num_rows)
        u = prng.uniform(key, (b - a, d), offset=a * d, device=dev)
        if lookup is None:
            parts = qd.quadrant_descent(u, cum)
        else:
            kb, lb, tcfg, tnode, inv = lookup
            parts = qd.quilt_descent_lookup(u, cum, kb[a:b], lb[a:b], tcfg, tnode, inv)
        del u
        for o, p in zip(outs, parts):
            o[a:b] = p
    return tuple(outs)


def sample_edge_batch(key: torch.Tensor, thetas, num_edges: int, *, device=None):
    """``num_edges`` iid (src, dst) int32 candidates of Algorithm 1 on
    ``device`` (default ``"cuda"``): the threefry draw of ``key`` descended
    through the ``quadrant_descent`` kernel, with the level table in the
    order the reference's compiled ``sample_edge_batch`` sums it.
    Duplicates are possible; callers dedupe."""
    dev = resolve_device(device)
    cum = _level_cumprobs(torch.as_tensor(thetas, dtype=torch.float32).cpu()).to(dev)  # lint: disable=host-sync-in-step -- the (d, 4) level table, summed on the host in the reference's order
    return descend_draw(key, cum, int(num_edges))


def _draw_targets(key: torch.Tensor, thetas, count: int, n: int) -> np.ndarray:
    """``count`` per-graph edge targets ~ N(m, m - v), as the reference's
    ``kpgm_sample_many`` draws them: the eager moments, then the normals
    scaled and shifted in float32."""
    m, v = edge_moments_eager(thetas)
    std = np.float32(_edge_std(m, v))
    draws = prng.normal(key, (count,)).numpy() * std + np.float32(m)
    return np.clip(np.round(draws), 0, min(n * n, 2**62)).astype(np.int64)


def _arrival_fresh(chunk: np.ndarray, seen: np.ndarray) -> np.ndarray:
    """Positions in ``chunk`` of its first occurrences that are not in
    ``seen``, in arrival order."""
    _, first_idx = np.unique(chunk, return_index=True)
    first_idx = np.sort(first_idx)
    return first_idx[~np.isin(chunk[first_idx], seen)]


# host seconds spent in the arrival-order dedup (np.unique / np.isin) since
# import or since a caller reset it
HOST_DEDUP_SECONDS = 0.0


class _Graphs:
    """Per-graph arrival-ordered state of the ranked host rounds: the flat
    config keys ``src * n + dst`` kept so far and, when a lookup rides
    along, the node ids of each key."""

    def __init__(self, count: int, nodes: bool):
        empty = np.empty((0,), dtype=np.int64)
        self.keys: List[np.ndarray] = [empty] * count
        self.snode: Optional[List[np.ndarray]] = [empty] * count if nodes else None
        self.dnode: Optional[List[np.ndarray]] = [empty] * count if nodes else None

    def sizes(self) -> np.ndarray:
        return np.array([k.size for k in self.keys], dtype=np.int64)


def _graph_lookup(asks: np.ndarray, num_blocks: int, tables, device):
    """(kb, lb, table_cfg, table_node, inv) of a batch split by ``asks``
    (``tables = (table_cfg, table_node, inv)``): row r of graph g looks up
    block rows k and l of g mod B^2 = k * B + l (graph s * B^2 + g' of a
    fused batch is block pair g' of sample s)."""
    g = torch.repeat_interleave(
        torch.arange(len(asks), dtype=torch.int32, device=device),
        torch.from_numpy(np.asarray(asks, dtype=np.int64)).to(device),  # lint: disable=host-sync-in-step -- the round's host-planned asks, one copy a round
        output_size=int(np.sum(asks)),
    ) % (num_blocks * num_blocks)
    return (g // num_blocks, g % num_blocks, *tables)


def _draw_round(key, cum, n, asks, batch, lookup_spec):
    """One host round's candidates as host arrays: flat keys, and node ids
    when ``lookup_spec=(B, (table_cfg, table_node, inv))`` is given."""
    lookup = None if lookup_spec is None else _graph_lookup(asks, lookup_spec[0], lookup_spec[1], cum.device)
    out = descend_draw(key, cum, batch, lookup=lookup)
    flat = (out[0].to(torch.int64) * n + out[1].to(torch.int64)).cpu().numpy()
    if lookup is None:
        return flat, None, None
    return flat, out[2].cpu().numpy().astype(np.int64), out[3].cpu().numpy().astype(np.int64)


def _host_rounds(key, cum, n, targets, keys, max_rounds, oversample, lookup_spec=None):
    """Round-by-round host rejection loop (the reference's ``_host_topup``):
    one batch per round split across the graphs short of their targets,
    each graph's chunk deduped in arrival order against ``keys[g]``, its
    fresh keys appended there up to its target.  Yields, after each round,
    the list of ``(graph, src_node, dst_node)`` of the fresh keys (node ids
    with ``lookup_spec``, else None)."""
    global HOST_DEDUP_SECONDS
    for _ in range(max_rounds):
        needs = targets - np.array([k.size for k in keys], dtype=np.int64)
        if needs.max(initial=0) <= 0:
            break
        asks, batch = dedup.plan_asks(needs, oversample)
        key, sub = prng.split(key)
        flat, sn, dn = _draw_round(sub, cum, n, asks, batch, lookup_spec)
        t0 = time.perf_counter()
        fresh, off = [], 0
        for g, ask in enumerate(asks):
            if ask == 0:
                continue
            pos = (off + _arrival_fresh(flat[off : off + int(ask)], keys[g]))[: int(needs[g])]
            off += int(ask)
            if pos.size:
                keys[g] = np.concatenate([keys[g], flat[pos]])
                fresh.append((g, None if sn is None else sn[pos], None if dn is None else dn[pos]))
        HOST_DEDUP_SECONDS += time.perf_counter() - t0
        yield fresh


def _host_topup(key, cum, n, targets, graphs: _Graphs, max_rounds, oversample, lookup_spec=None) -> _Graphs:
    """The host rounds on ``graphs``, node ids kept beside their keys."""
    for fresh in _host_rounds(key, cum, n, targets, graphs.keys, max_rounds, oversample, lookup_spec):
        if graphs.snode is not None:
            for g, sn, dn in fresh:
                graphs.snode[g] = np.concatenate([graphs.snode[g], sn])
                graphs.dnode[g] = np.concatenate([graphs.dnode[g], dn])
    return graphs


def _many_round(key, cum, asks: np.ndarray, targets: np.ndarray, *, num_candidates: int, lookup_spec=None):
    """One device round for all graphs (the reference's ``_many_round``):
    the batch's descent, then one segmented first-occurrence dedup with
    per-graph target caps.  Returns the kernel's outputs plus ``take`` and
    the per-graph ``counts``, on cum's device."""
    dev = cum.device
    lookup = None if lookup_spec is None else _graph_lookup(asks, lookup_spec[0], lookup_spec[1], dev)
    out = descend_draw(key, cum, num_candidates, lookup=lookup)
    cum_asks = torch.from_numpy(np.cumsum(asks)).to(dev)  # lint: disable=host-sync-in-step -- the round's host-planned asks, one copy a round
    graph_id = torch.searchsorted(cum_asks, torch.arange(num_candidates, device=dev), right=True)
    take, counts = dedup.segmented_unique_mask(
        graph_id, out[0], out[1], cum_asks, torch.from_numpy(np.asarray(targets)).to(dev),  # lint: disable=host-sync-in-step -- the round's host-planned targets, one copy a round
        node_bits=cum.shape[0],
    )
    return out, take, counts


def _sample_many(
    key: torch.Tensor,
    thetas,
    count: int,
    *,
    max_rounds: int,
    oversample: float,
    backend: str,
    device,
    lookup_tables=None,
):
    """Algorithm 1 for ``count`` independent graphs sharing their batches
    (the reference's ``kpgm_sample_many``), with the same key splits and
    asks.  With ``lookup_tables=(B, (table_cfg, table_node, inv))`` graph
    g = k * B + l also looks its configs up in blocks k and l, and the
    node ids ride with their keys through the dedup.  Returns the
    per-graph state (:class:`_Graphs`) and the drawn targets."""
    thetas = torch.as_tensor(thetas, dtype=torch.float32).cpu()
    d = thetas.shape[0]
    n = 1 << d
    key, sub = prng.split(key)
    targets = _draw_targets(sub, thetas, count, n)
    graphs = _Graphs(count, lookup_tables is not None)
    if count == 0:
        return graphs, targets
    dev = resolve_device(device)
    cum = _level_cumprobs(thetas).to(dev)
    total = int(targets.sum())
    use_device = backend == "device" or (
        backend == "auto" and 0 < total and total * oversample + 16 * count <= DEVICE_MAX_CANDIDATES
    )
    rounds_left = max_rounds
    if use_device and total > 0:
        asks, batch = dedup.plan_asks(targets, oversample)
        key, sub = prng.split(key)
        out, take, counts = _many_round(sub, cum, asks, targets, num_candidates=batch, lookup_spec=lookup_tables)
        # taken candidates stay grouped by graph: split at the count bounds
        flat = (out[0].to(torch.int64) * n + out[1].to(torch.int64))[take].cpu().numpy()
        bounds = np.cumsum(counts.cpu().numpy().astype(np.int64))[:-1]
        graphs.keys = list(np.split(flat, bounds))
        if lookup_tables is not None:
            graphs.snode = list(np.split(out[2][take].cpu().numpy().astype(np.int64), bounds))
            graphs.dnode = list(np.split(out[3][take].cpu().numpy().astype(np.int64), bounds))
        rounds_left -= 1
    graphs = _host_topup(key, cum, n, targets, graphs, rounds_left, oversample, lookup_tables)
    return graphs, targets


def kpgm_sample_many(
    key: torch.Tensor,
    params: KPGMParams,
    count: int,
    *,
    max_rounds: int = 8,
    oversample: float = 1.1,
    backend: str = "auto",
    device=None,
) -> list:
    """``count`` independent KPGM graphs drawn from shared batches on
    ``device`` (default ``"cuda"``): a list of (E_g, 2) int64 host arrays,
    equal to the reference's for the same key.  The first round runs as
    one device round with a segmented dedup when the whole budget fits
    ``DEVICE_MAX_CANDIDATES`` (``backend="auto"``/``"device"``); the host
    loop finishes the rest, or all of it with ``backend="host"``."""
    graphs, _ = _sample_many(
        key, params.thetas, count, max_rounds=max_rounds, oversample=oversample,
        backend=backend, device=device,
    )
    n = params.num_nodes
    return [np.stack([s // n, s % n], axis=1) for s in graphs.keys]


def _kpgm_sample_host(
    key: torch.Tensor,
    params: KPGMParams,
    *,
    max_rounds: int = 8,
    oversample: float = 1.05,
    num_edges: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Algorithm 1 for one graph, round by round (the reference's host
    path): draw X ~ N(m, m - v) unless ``num_edges`` is given, then
    candidate batches on ``device`` deduped on the host in arrival order
    until X distinct edges are held.  Returns (E, 2) int64."""
    global HOST_DEDUP_SECONDS
    thetas = torch.as_tensor(params.thetas, dtype=torch.float32).cpu()
    n = params.num_nodes
    dev = resolve_device(device)
    key, sub = prng.split(key)
    target = int(sample_num_edges(sub, thetas)) if num_edges is None else int(num_edges)
    target = min(target, n * n)
    if target == 0:
        return np.zeros((0, 2), dtype=np.int64)
    cum = _level_cumprobs(thetas).to(dev)
    seen = np.empty((0,), dtype=np.int64)
    for _ in range(max_rounds):
        need = target - seen.size
        if need <= 0:
            break
        key, sub = prng.split(key)
        batch = _bucket(max(int(need * oversample) + 16, 64))
        src, dst = descend_draw(sub, cum, batch)
        flat = (src.to(torch.int64) * n + dst.to(torch.int64)).cpu().numpy()
        t0 = time.perf_counter()
        seen = np.concatenate([seen, flat[_arrival_fresh(flat, seen)]])
        HOST_DEDUP_SECONDS += time.perf_counter() - t0
    seen = seen[:target]
    return np.stack([seen // n, seen % n], axis=1)


def kpgm_sample(
    key: torch.Tensor,
    params: KPGMParams,
    *,
    max_rounds: int = 8,
    oversample: float = 1.05,
    num_edges: Optional[int] = None,
    backend: str = "auto",
    mesh=None,
    device=None,
) -> np.ndarray:
    """DEPRECATED shim over ``repro_torch.api.KPGMSampler``: one KPGM graph
    as a unique (E, 2) int64 array, equal to the session's for the key."""
    import warnings

    warnings.warn(
        "kpgm_sample is deprecated; use repro_torch.api.KPGMSampler",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch import api

    sampler = api.KPGMSampler(
        api.SamplerConfig(
            params=params, backend=backend, mesh=mesh, max_rounds=max_rounds,
            oversample=oversample, device=resolve_device(device),
        )
    )
    return sampler.sample(key, num_edges=num_edges).edges
