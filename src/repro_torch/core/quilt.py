"""Algorithm 2 — quilting KPGM samples into a MAGM sample — and the
section-5 split sampler for unbalanced attributes, on PyTorch.

Quilting partitions the nodes into D_1..D_B (partition.py) and, for every
block pair (k, l), draws candidate edges of a full KPGM graph, keeps those
(x, y) for which some i in D_k has lambda_i = x and some j in D_l has
lambda_j = y, and maps them to node space (Theorem 3).

:func:`quilt_run` takes one of three paths, as the reference does:

- **exact cells** (the default): one fixed-shape round in which every one
  of the B^2 graphs draws the plan-constant budget G of candidates
  (:func:`_exact_budget`), each candidate's cell survives with probability
  alpha = p / q, decided by a per-cell hash shared by its duplicates, and
  the first occurrence of each surviving cell is kept — so every cell is in
  the graph with exactly its Bernoulli(p) probability;
- **ranked device rounds** (``exact_cells=False``, explicit ``targets``,
  KPGM sessions, or an exact budget over ``DEVICE_MAX_CANDIDATES``): every
  graph draws X ~ N(m, m - v) and keeps its first X distinct cells, the
  slot stream growing round by round until the targets are met; a residual
  left after ``max_rounds`` is finished by the host loop
  (:func:`_host_quilt_topup`);
- **the host path** (``backend="host"``, or a ranked round that would pass
  ``DEVICE_MAX_CANDIDATES``): :func:`_quilt_sample_host`, Algorithm 1 for
  the B^2 graphs with shared threefry batches (``kpgm._sample_many``).

A device round is the fused counter-PRNG descent + block lookup (the CUDA
kernel ``quilt_prng_descent_lookup`` on a card), the acceptance thinning in
the exact mode (:func:`_exact_cell_valid`), and the sort-based segmented
dedup (``core/dedup.py``).  A host round descends threefry uniforms and
looks them up in the kernel ``quilt_descent_lookup``, then dedupes on the
host in arrival order.  ``backend="balldrop"`` goes to the ball-dropping
engine (``core/balldrop.py``) over the same plan.  ``num_samples = S > 1``
fuses S samples into the same rounds: block pair g' of sample s is graph
s * B^2 + g'.

With ``mesh=`` (a DeviceMesh over a real process group,
``launch.mesh.make_sampler_mesh``) every rank runs the engine on the same
key and plan, and the graphs are laid out along the mesh's ``graphs`` role
(``dist.sharding.graph_layout``): padded to a multiple of the shard count,
rank r's round runs the contiguous chunk r of the gids, with no collective
inside; one ``all_gather`` of the per-graph counts a round gives every rank
the shortfall, and the run's buffers are gathered in graph order at its
end.  A graph's candidates depend only on (key, global graph id, slot), so
a mesh run equals the unsharded one bit for bit, on every rank.  A
``DeviceLoss`` at ``quilt.dispatch`` rebuilds the mesh over the surviving
ranks and re-runs the round (:func:`_degrade_layout`).

The section-5 split (:func:`build_split_plan`, :func:`split_run`) pulls the
configurations that occur more than B' times out into R heavy groups.  The
light nodes W are quilted with B <= B'; every block pair that touches a
heavy group is an Erdos-Renyi block of one scalar p, and all of them are
realized in one fixed-shape device round (:func:`_split_heavy_body`) or,
past the candidate cap or with an explicit numpy Generator, by host
binomials (:func:`_sample_cells`).

The free functions :func:`quilt_sample` and :func:`quilt_sample_fast` are
the reference's deprecated shims over the sessions, kept bit-identical to
them.

:func:`naive_reference_sample` is the O(n^2) exact oracle the quilting
sampler is tested against.
"""

from __future__ import annotations

import hashlib
import math
import warnings
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import dedup, f32math, kpgm, kron, magm, partition, prng
from repro_torch.core.device import resolve_device
from repro_torch.dist import chaos
from repro_torch.kernels import ops


class QuiltStats(NamedTuple):
    B: int
    num_kpgm_draws: int
    kpgm_edges_total: int
    kept_edges: int
    heavy_groups: int
    light_nodes: int
    bprime: Optional[int]


# a dense config -> node inverse above this many entries would dominate
# memory; larger plans look up through the sorted tables
DENSE_INV_CAP = 1 << 24


class QuiltPlan(NamedTuple):
    """Device state for quilting one attribute matrix: the Theorem-2
    partition, the padded per-block lookup tables (and, within
    ``DENSE_INV_CAP``, the dense and by-config inverses), the level
    cumulative probabilities and the |E| moments.  Built by
    :func:`build_quilt_plan`."""

    n: int
    d: int
    B: int
    part: partition.Partition  # host-side partition
    thetas: torch.Tensor  # (d, 2, 2) float32, on device
    cum: torch.Tensor  # (d, 4) cumulative quadrant probabilities, on device
    table_cfg: torch.Tensor  # (B, L) int32 sorted configs, CFG_SENTINEL padded
    table_node: torch.Tensor  # (B, L) int32 node ids, -1 padded
    mean_edges: float  # E|E| of one KPGM draw
    std_edges: float  # sqrt(m - v)
    p_max: float  # largest single-cell probability prod_k max(theta^(k))
    device: torch.device
    inv: Optional[torch.Tensor] = None  # (B, 2^d) int32 dense inverse, on device
    # |E| moments given the attributes (c^T P c forms, core/kron.py) and the
    # ball-dropping proposals per edge; None past kron.MOMENT_CAP, where
    # backend="balldrop" is unavailable
    bd_mean: Optional[float] = None
    bd_std: Optional[float] = None
    bd_cost: Optional[float] = None
    # nodes grouped by configuration in node order: cfg_nodes[cfg_offset[x]
    # + b] is the node of dense_inverse[b, x], in O(2^d + n) memory
    cfg_offset: Optional[torch.Tensor] = None  # (2^d,) int32 exclusive prefix
    cfg_count: Optional[torch.Tensor] = None  # (2^d,) int32 multiplicities
    cfg_nodes: Optional[torch.Tensor] = None  # (n,) int32 grouped node ids

    @property
    def num_graphs(self) -> int:
        return self.B * self.B


PLAN_STATS = {"partition_builds": 0, "plan_builds": 0, "plan_hits": 0}
_PART_CACHE: "OrderedDict" = OrderedDict()
_PLAN_CACHE: "OrderedDict" = OrderedDict()
_KPGM_PLAN_CACHE: "OrderedDict" = OrderedDict()
_CACHE_MAX = 8

# device_rounds: first device rounds; device_topup_rounds: ranked rounds
# after the first; host_topup_rounds: rounds of the host top-up loop after
# the device rounds; degraded_fallbacks: runs whose device rounds ran out
# (max_rounds or the candidate cap) short of their targets; exact_fallbacks:
# runs that asked for the exact-cell mode and could not take it;
# mesh_degrades: dispatch-time rank losses recovered by rebuilding the mesh
# over the survivors
DISPATCH_COUNTERS = {
    "device_rounds": 0,
    "device_topup_rounds": 0,
    "host_topup_rounds": 0,
    "mesh_degrades": 0,
    "degraded_fallbacks": 0,
    "exact_fallbacks": 0,
}

# the uniform of the acceptance test comes from the top 24 of 64 hash bits
_TWO_M24 = 2.0**-24


def clear_plan_cache() -> None:
    """Drop the content-keyed partition, shim-plan and identity-plan caches
    (plans held by sessions are unaffected)."""
    _PART_CACHE.clear()
    _PLAN_CACHE.clear()
    _KPGM_PLAN_CACHE.clear()


def _warn_shim(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new}", DeprecationWarning, stacklevel=3)


def _cache_put(cache: "OrderedDict", key, value) -> None:
    cache[key] = value
    cache.move_to_end(key)
    while len(cache) > _CACHE_MAX:
        cache.popitem(last=False)


def _digest(a: np.ndarray):
    a = np.ascontiguousarray(a)
    return (a.shape, a.dtype.str, hashlib.sha1(a.tobytes()).hexdigest())


def _partition_state(F: np.ndarray):
    """Partition, padded lookup tables and the dense and by-config inverses
    (host numpy, each None where its size gate fails) of one attribute
    matrix."""
    d = int(F.shape[1])
    lam = magm.configs_from_attributes(torch.from_numpy(np.array(F))).numpy()
    part = partition.build_partition(lam)
    PLAN_STATS["partition_builds"] += 1
    tables = partition.padded_lookup_tables(part) if part.B else None
    inv = partition.dense_inverse(part, d) if part.B and part.B * (1 << d) <= DENSE_INV_CAP else None
    bycfg = None
    if part.B and 2 * (1 << d) <= DENSE_INV_CAP:
        # a stable sort groups nodes by config in node order, the Theorem-2
        # occurrence-rank order: entry b of config x's group is block b's node
        count = np.bincount(lam, minlength=1 << d).astype(np.int32)
        offset = np.zeros(1 << d, dtype=np.int32)
        offset[1:] = np.cumsum(count[:-1])
        bycfg = (offset, count, np.argsort(lam, kind="stable").astype(np.int32))
    return part, tables, inv, bycfg


def _plan_constants(thetas: torch.Tensor):
    """(cum, m, std, p_max) of the thetas, in the reference's float32 order."""
    cum = kpgm._level_cumprobs(thetas)
    m, v = kpgm.edge_moments(thetas)
    return cum, m, kpgm._edge_std(m, v), kpgm.max_cell_prob(thetas)


def _assemble_plan(F_shape, th: torch.Tensor, state, dev: torch.device) -> QuiltPlan:
    """A QuiltPlan from a partition state and the thetas, on ``dev``."""
    part, tables, inv, bycfg = state
    n, d = int(F_shape[0]), int(F_shape[1])
    cum, m, std, p_max = _plan_constants(th)
    bd_mean = bd_std = bd_cost = None
    if part.B and (1 << d) <= kron.MOMENT_CAP:
        bd_mean, bd_std = kron.edge_count_moments(kron.config_multiplicities(part, d), th.numpy())
        bd_cost = kron.balldrop_cost_factor(float(m), part.B, bd_mean)
    empty = torch.zeros((0, 8), dtype=torch.int32)
    offset, count, nodes = (torch.from_numpy(a).to(dev) for a in bycfg) if bycfg else (None,) * 3
    plan = QuiltPlan(
        n=n,
        d=d,
        B=part.B,
        part=part,
        thetas=th.to(dev),
        cum=cum.to(dev),
        table_cfg=(torch.from_numpy(tables.configs) if tables else empty).to(dev),
        table_node=(torch.from_numpy(tables.nodes) if tables else empty).to(dev),
        mean_edges=float(m),
        std_edges=float(std),
        p_max=float(p_max),
        device=dev,
        inv=None if inv is None else torch.from_numpy(inv).to(dev),
        bd_mean=bd_mean,
        bd_std=bd_std,
        bd_cost=bd_cost,
        cfg_offset=offset,
        cfg_count=count,
        cfg_nodes=nodes,
    )
    PLAN_STATS["plan_builds"] += 1
    return plan


def build_quilt_plan(
    F: np.ndarray, thetas, *, reuse_partition: bool = True, device=None
) -> QuiltPlan:
    """Build the QuiltPlan of an (n, d) attribute matrix on ``device``
    (default ``"cuda"``; raises without a card).

    The partition state depends on F alone and is shared through a
    content-keyed cache (``reuse_partition=False`` builds it afresh); the
    theta constants are computed for every plan.
    """
    dev = resolve_device(device)
    F = F.cpu().numpy() if isinstance(F, torch.Tensor) else np.asarray(F)
    th = torch.as_tensor(thetas, dtype=torch.float32).cpu()
    if reuse_partition:
        fkey = _digest(F)
        state = _PART_CACHE.get(fkey)
        if state is None:
            state = _partition_state(F)
        _cache_put(_PART_CACHE, fkey, state)
    else:
        state = _partition_state(F)
    return _assemble_plan(F.shape, th, state, dev)


def get_quilt_plan(F: np.ndarray, thetas, *, device=None) -> QuiltPlan:
    """The shims' plan of (F, thetas) on ``device``, from a content-keyed
    cache: a repeated call returns the same plan, and new thetas over the
    same F reuse its partition.  Sessions build and hold their own plan
    (:func:`build_quilt_plan`)."""
    dev = resolve_device(device)
    F = F.cpu().numpy() if isinstance(F, torch.Tensor) else np.asarray(F)
    th = torch.as_tensor(thetas, dtype=torch.float32).cpu()
    pkey = (_digest(F), _digest(th.numpy()), str(dev))
    plan = _PLAN_CACHE.get(pkey)
    if plan is not None:
        PLAN_STATS["plan_hits"] += 1
        _PLAN_CACHE.move_to_end(pkey)
        return plan
    plan = build_quilt_plan(F, th, device=dev)
    _cache_put(_PLAN_CACHE, pkey, plan)
    return plan


def build_kpgm_plan(thetas, *, device=None) -> QuiltPlan:
    """Identity-partition plan on ``device``: one block mapping config c to
    node c, so a plain KPGM graph runs through the quilting engine as the
    trivial B = 1 quilt.  O(2^d) memory (callers gate on d); content-cached
    by the thetas and the device, since it depends on nothing else."""
    dev = resolve_device(device)
    th = torch.as_tensor(thetas, dtype=torch.float32).cpu()
    tkey = (_digest(th.numpy()), str(dev))
    plan = _KPGM_PLAN_CACHE.get(tkey)
    if plan is None:
        d = int(th.shape[0])
        F_id = magm.attributes_from_configs(torch.arange(1 << d), d).numpy()
        plan = _assemble_plan(F_id.shape, th, _partition_state(F_id), dev)
    _cache_put(_KPGM_PLAN_CACHE, tkey, plan)
    return plan


def _exact_budget(p_max: Optional[float], mean_edges: float) -> Optional[int]:
    """Fixed per-graph proposal count G of the exact-cell mode.

    Descent proposes cell c with probability pi_c = p_c / S (S =
    ``mean_edges``), so after G proposals it is occupied with q_c = 1 -
    (1 - pi_c)^G.  The smallest G with q_c >= p_c for every cell is
    log(1 - p) / log(1 - p / S) at p = p_max.  None when no usable finite
    budget exists.
    """
    if p_max is None or mean_edges <= 0.0:
        return None
    # cells with p within float-eps of 1 would need an unbounded budget;
    # clipping concedes a <=1e-6 relative bias for those cells only
    p = min(float(p_max), 1.0 - 1e-6)
    S = max(float(mean_edges), p)
    if p <= 0.0:
        return 1
    ratio = p / S
    if ratio >= 1.0:
        return 1
    g = math.log1p(-p) / math.log1p(-ratio)
    if not math.isfinite(g) or g > float(kpgm.DEVICE_MAX_CANDIDATES):
        return None
    return max(int(math.ceil(g)), 1)


def _u64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_ACC_G = _u64(0x9E3779B97F4A7C15)
_ACC_C = _u64(0xC2B2AE3D27D4EB4F)
_ACC_M1 = _u64(0xBF58476D1CE4E5B9)
_ACC_M2 = _u64(0x94D049BB133111EB)


def _lsr64(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64-held uint64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _accept_u01(salt: torch.Tensor, gid: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """float32 uniform in [0, 1) per (salt, graph, cell): a splitmix64
    finalizer over the packed ids, in int64 arithmetic that wraps mod 2^64.
    Every duplicate of a cell hashes alike, so acceptance keeps or kills the
    cell as a unit."""
    x = salt ^ (gid.to(torch.int64) * _ACC_G) ^ (cell.to(torch.int64) * _ACC_C)
    x = (x ^ _lsr64(x, 30)) * _ACC_M1
    x = (x ^ _lsr64(x, 27)) * _ACC_M2
    x = x ^ _lsr64(x, 31)
    return _lsr64(x, 40).to(torch.float32) * _TWO_M24


def accept_salt(rkey: torch.Tensor, device) -> torch.Tensor:
    """The round's acceptance salt: 64 bits of ``fold_in(rkey, 0x5EED)``,
    drawn where the key lives and filled in on ``device`` (no host -> device
    copy)."""
    salt = int(prng.bits(prng.fold_in(rkey, 0x5EED), (), "uint64"))  # lint: disable=host-sync-in-step -- the sessions' keys live on the host; a key on the card costs one 8-byte read
    return torch.full((), salt, dtype=torch.int64, device=device)


def _exact_alpha(
    scfg: torch.Tensor, dcfg: torch.Tensor, thetas: torch.Tensor, budget: int, log_extra: float = 0.0
) -> torch.Tensor:
    """float32 acceptance alpha = min(p / q, 1) of each candidate's cell,
    with q = 1 - (1 - pi)^G its occupancy after ``budget`` proposals and
    pi = p / S / exp(``log_extra``).  The transcendentals are the
    reference's (core/f32math.py), so alpha is bit-identical to it on every
    device.  ``log_extra`` (ball dropping's 2 log B) is rounded to float32
    and subtracted as a second float32 op, as the reference's weakly typed
    constant is."""
    logp = kpgm.log_prob_pairs(thetas, scfg, dcfg)
    logpi = logp - kpgm.log_level_sum(thetas)
    if log_extra:
        logpi = logpi - torch.full((), log_extra, dtype=torch.float32, device=logp.device)
    pi = f32math.exp(logpi)
    g = torch.full((), float(budget), dtype=torch.float32, device=logp.device)
    q = -f32math.expm1(g * f32math.log1p(-pi))
    return torch.clamp_max(f32math.exp(logp - f32math.log(q)), 1.0)


def _exact_cell_valid(
    salt: torch.Tensor,
    gid: torch.Tensor,
    scfg: torch.Tensor,
    dcfg: torch.Tensor,
    thetas: torch.Tensor,
    budget: int,
    log_extra: float = 0.0,
    cell: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-candidate accept mask making cell inclusion exactly Bernoulli(p):
    the cell survives when its shared hash uniform is below alpha.  The
    hash unit is the config cell, or ``cell`` where given (ball dropping
    passes the packed node pair: node pairs that share a config pair draw
    independent accept bits)."""
    if cell is None:
        cell = scfg.to(torch.int64) * (1 << thetas.shape[0]) + dcfg.to(torch.int64)
    return _accept_u01(salt, gid, cell) < _exact_alpha(scfg, dcfg, thetas, budget, log_extra)


def _round_body(
    rkey: torch.Tensor,
    gids: torch.Tensor,
    targets: torch.Tensor,
    plan: QuiltPlan,
    *,
    a_tot: int,
    budget: Optional[int],
    use_kernel: bool,
):
    """One device round over the graphs ``gids`` with ``a_tot`` slots each:
    descent + lookup, then the dedup capped at ``targets``.  With an exact
    ``budget`` (then a_tot == budget) each candidate also passes the
    acceptance thinning; without one the round ranks the first distinct
    cells of the cumulative slot stream (slot s draws the same uniforms in
    every round, so a longer round re-derives the shorter ones as its
    prefix).  Returns ``(scfg, dcfg, snode, dnode, take, counts)`` on the
    plan's device."""
    gc = gids.numel()
    seed = ops.counter_seed(rkey)
    lookup = (
        ops.quilt_prng_descent_lookup
        if use_kernel
        else ops.quilt_prng_descent_lookup_plain
    )
    scfg, dcfg, snode, dnode = lookup(
        seed, gids, plan.cum, plan.table_cfg, plan.table_node,
        a_tot=a_tot, num_blocks=plan.B,
    )
    dev = gids.device
    local = torch.arange(gc * a_tot, dtype=torch.int64, device=dev) // a_tot
    cum_asks = torch.arange(1, gc + 1, dtype=torch.int64, device=dev) * a_tot
    valid = None
    if budget is not None:
        # fold the lookup misses in too: counts are then the realized edge totals
        valid = (
            (snode >= 0)
            & (dnode >= 0)
            & _exact_cell_valid(
                accept_salt(rkey, dev), gids.to(torch.int64)[local], scfg, dcfg,
                plan.thetas, budget,
            )
        )
    take, counts = dedup.segmented_unique_mask(
        local, scfg, dcfg, cum_asks, targets, node_bits=plan.d, valid=valid
    )
    return scfg, dcfg, snode, dnode, take, counts


class DeviceBatchUnavailable(RuntimeError):
    """Raised by :func:`quilt_run` when explicit targets would need the host
    path, which draws its own targets; callers (``KPGMSampler``) run their
    own target-honoring host loop instead."""


class QuiltRun(NamedTuple):
    """One executed run of the engine.

    A device run holds the last round's fixed-shape buffers on the device
    (``snode``, ``dnode``, ``keep``) plus ``tail``, the ``(graph, (E, 2))``
    pieces of the host top-up appended after them in arrival order; a host
    run holds ``host_edges`` and ``host_stats`` instead.  ``sampler`` says
    which engine made the run: ``"quilt"`` (B^2 block-pair graphs per
    sample) or ``"balldrop"`` (one node-pair stream per sample,
    ``core/balldrop.py``); the per-sample splits and stats key off it."""

    plan: QuiltPlan
    # per-graph targets (the realized counts when exact; on a quilting host
    # run the engine's unused draw, with zero counts, as the reference has
    # them; on a ball-dropping host run the target its loop met) and
    # distinct cells taken
    targets: np.ndarray
    counts: np.ndarray
    snode: Optional[torch.Tensor]  # (graphs * slots,) candidate node ids, on device
    dnode: Optional[torch.Tensor]
    keep: Optional[torch.Tensor]  # bool: taken AND both lookups hit, on device
    slots_per_graph: int
    tail: Tuple[Tuple[int, np.ndarray], ...]
    host_edges: Optional[np.ndarray]
    host_stats: Optional[QuiltStats]
    num_samples: int = 1
    sampler: str = "quilt"

    @property
    def graphs_per_sample(self) -> int:
        """Dedup graphs one sample spans: B^2 block pairs, or one node-pair
        stream for ball dropping."""
        return 1 if self.sampler == "balldrop" else self.plan.num_graphs

    def kept_edges(self) -> int:
        if self.host_edges is not None:
            return int(self.host_edges.shape[0])
        kept = int(self.keep.sum()) if self.keep is not None else 0
        return kept + sum(int(p.shape[0]) for _, p in self.tail)

    def _device_pairs(self) -> np.ndarray:
        pairs = torch.stack([self.snode[self.keep], self.dnode[self.keep]], dim=1)
        return pairs.to(torch.int64).cpu().numpy()

    def edges(self) -> np.ndarray:
        """(E, 2) int64 host array: the device edges in candidate order,
        then the tail pieces (sample-major for several samples)."""
        if self.host_edges is not None:
            return self.host_edges
        if self.num_samples != 1 and self.tail:
            # tail pieces land after every device edge; the split puts each
            # sample's back with its own
            return np.concatenate(self.edges_per_sample(), axis=0)
        pieces: List[np.ndarray] = []
        if self.keep is not None:
            pieces.append(self._device_pairs())
        pieces.extend(p for _, p in self.tail)
        pieces = [p for p in pieces if p.size]
        if not pieces:
            return np.zeros((0, 2), dtype=np.int64)
        return np.concatenate(pieces, axis=0)

    def iter_chunks(self, chunk_edges: int):
        """The edges of a one-sample run as ``(chunk_edges, 2)`` host chunks
        (the last may be shorter), in :meth:`edges` order; a device run
        copies each chunk's kept rows only (``dedup.iter_edge_chunks``)."""
        if self.num_samples != 1:
            raise ValueError("iter_chunks streams single-sample runs only")
        if self.host_edges is not None:
            return dedup.rechunk_edges([self.host_edges], chunk_edges)
        tail = [p for _, p in self.tail]
        if self.keep is None:
            return dedup.rechunk_edges(tail, chunk_edges)
        return dedup.iter_edge_chunks(self.snode, self.dnode, self.keep, chunk_edges, tail=tail)

    def edges_per_sample(self) -> List[np.ndarray]:
        """The kept edges split into per-sample (E_s, 2) arrays (candidates
        are sample-major, so each sample's device edges are contiguous)."""
        if self.host_edges is not None:
            return [self.host_edges]
        G, S = self.graphs_per_sample, self.num_samples
        per: List[List[np.ndarray]] = [[] for _ in range(S)]
        if self.keep is not None:
            idx = torch.nonzero(self.keep).reshape(-1).cpu().numpy()
            samp = (idx // max(self.slots_per_graph, 1)) // G
            bounds = np.searchsorted(samp, np.arange(1, S))
            for s, piece in enumerate(np.split(self._device_pairs(), bounds)):
                per[s].append(piece)
        for g, piece in self.tail:
            per[g // G].append(piece)
        return [
            np.concatenate(p, axis=0) if sum(x.size for x in p) else np.zeros((0, 2), dtype=np.int64)
            for p in per
        ]

    def stats(self, kept: Optional[int] = None) -> QuiltStats:
        if self.host_stats is not None:
            return self.host_stats
        return QuiltStats(
            B=self.plan.B,
            # ball dropping never draws whole KPGM graphs
            num_kpgm_draws=0 if self.sampler == "balldrop" else self.plan.num_graphs,
            kpgm_edges_total=int(self.counts.sum()),
            kept_edges=self.kept_edges() if kept is None else int(kept),
            heavy_groups=0,
            light_nodes=self.plan.n,
            bprime=None,
        )

    def stats_per_sample(self, kept_sizes: List[int]) -> List[QuiltStats]:
        G = self.graphs_per_sample
        csum = self.counts.reshape(self.num_samples, G).sum(axis=1)
        return [
            QuiltStats(
                B=self.plan.B,
                num_kpgm_draws=0 if self.sampler == "balldrop" else G,
                kpgm_edges_total=int(csum[s]),
                kept_edges=int(kept_sizes[s]),
                heavy_groups=0,
                light_nodes=self.plan.n,
                bprime=None,
            )
            for s in range(self.num_samples)
        ]


def _mesh_layout(mesh, num_graphs: int):
    """``(mesh, graph axes, padded row count)`` of ``num_graphs`` graphs on
    ``mesh``; ``(None, (), num_graphs)`` for no mesh or one without a graph
    axis, which run the unsharded program."""
    from repro_torch.dist import sharding as _dist_sharding

    layout = _dist_sharding.graph_layout(mesh, num_graphs)
    if not layout.axes:
        return None, (), int(num_graphs)
    if dist.get_backend(mesh.get_group(layout.axes[0])) == "fake":
        raise ValueError("a sampler mesh needs a real process group, not the dry-run's fake one")
    return mesh, layout.axes, layout.padded


def _pad_inputs(gtot: int, g_pad: int, targets: np.ndarray, budget: Optional[int], device):
    """``(gids, targets)`` of ``g_pad`` rows on ``device``: the graphs
    0..gtot-1, then padding rows of gid 0 and target 0, which emit nothing.
    Exact targets are one constant, filled in on the device (not copied
    there)."""
    gids = torch.arange(g_pad, dtype=torch.int32, device=device)
    if budget is not None:
        tdev = torch.full((g_pad,), budget, dtype=torch.int64, device=device)
    else:
        tdev = torch.from_numpy(np.pad(targets, (0, g_pad - gtot))).to(device)
    if g_pad > gtot:
        gids[gtot:] = 0
        tdev[gtot:] = 0
    return gids, tdev


def _graph_groups(mesh, axes):
    """The process groups of the graph axes, major first."""
    return [mesh.get_group(a) for a in axes]


def _shard_index(mesh, axes) -> Tuple[int, int]:
    """``(index, count)`` of this rank's shard over the mesh ``axes``: its
    row-major index, each axis in its group's rank order (the order
    ``all_gather`` returns), and the product of the axes' sizes."""
    idx, shards = 0, 1
    for group in _graph_groups(mesh, axes):
        size = dist.get_world_size(group)
        idx = idx * size + dist.get_group_rank(group, dist.get_rank())
        shards *= size
    return idx, shards


def _shard_rows(mesh, axes, g_pad: int) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of the ``g_pad`` padded graphs that this rank
    runs: chunk r of equal chunks, r = :func:`_shard_index`."""
    if mesh is None:
        return 0, g_pad
    idx, shards = _shard_index(mesh, axes)
    chunk = g_pad // shards
    return idx * chunk, (idx + 1) * chunk


def _gather_rows(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every shard's ``x`` concatenated in shard order, on every rank: an
    ``all_gather`` over each graph axis, minor first (bool rides as
    uint8)."""
    if mesh is None:
        return x
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    for group in reversed(_graph_groups(mesh, axes)):
        parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, wire, group=group)
        wire = torch.cat(parts)
    return wire.to(torch.bool) if x.dtype == torch.bool else wire


def _degrade_layout(mesh, exc: chaos.DeviceLoss, num_graphs: int, counters=None):
    """Recover from a dispatch-time ``DeviceLoss``: ``(mesh, axes, g_pad)``
    over the surviving ranks (``launch.mesh.degrade_sampler_mesh``).

    Re-raises ``exc`` where no recovery exists (no mesh, a 1-rank mesh)
    and on the lost rank itself, which leaves the run.  The re-run is
    bit-identical on the smaller mesh: no graph's stream depends on the
    layout, and a changed pad only adds zero-target rows."""
    if mesh is None:
        raise exc
    from repro_torch.launch import mesh as _launch_mesh

    try:
        survivors = _launch_mesh.degrade_sampler_mesh(mesh, exc.device)
    except ValueError:
        raise exc from None
    if survivors is None:
        raise exc
    out = _mesh_layout(survivors, num_graphs)
    (DISPATCH_COUNTERS if counters is None else counters)["mesh_degrades"] += 1
    warnings.warn(
        f"device {exc.device} lost mid-dispatch: rebuilt the sampler mesh over "
        f"{survivors.size()} surviving device(s) and re-running the round "
        "(layout invariance keeps the edges bit-identical)",
        RuntimeWarning,
        stacklevel=3,
    )
    return out


def _clip_targets(x: np.ndarray, ncfg: int) -> np.ndarray:
    return np.clip(x, 0, min(ncfg * ncfg, 2**62))


def quilt_run(
    key: torch.Tensor,
    plan: QuiltPlan,
    *,
    num_samples: int = 1,
    targets: Optional[np.ndarray] = None,
    max_rounds: int = 8,
    oversample: float = 1.05,
    backend: str = "auto",
    use_kernel: Optional[bool] = None,
    mesh=None,
    exact_cells: Optional[bool] = None,
) -> QuiltRun:
    """Run the quilting engine of ``plan`` for ``key`` on the plan's device;
    the same key gives the reference's edges, on every path.

    ``exact_cells`` (default: on when no ``targets`` are given) selects the
    exact-cell round; runs that cannot take it (explicit targets, the host
    backend, a budget over ``DEVICE_MAX_CANDIDATES``, the last counted in
    ``DISPATCH_COUNTERS["exact_fallbacks"]``) take the ranked rounds.  ``targets`` overrides the per-graph N(m, m - v) draws
    (the key is split alike either way).  The ranked rounds run on the
    device while ``B^2 * slots`` stays within ``DEVICE_MAX_CANDIDATES``
    (``backend="device"`` forces them), else the run takes the host path —
    which draws its own targets, so explicit ``targets`` raise
    :class:`DeviceBatchUnavailable` there.  ``use_kernel`` None or True runs
    the device rounds' lookup through its kernel wrapper, False through its
    plain version.

    ``num_samples = S > 1`` fuses S independent samples into the same
    rounds (graph s * B^2 + g' is block pair g' of sample s); a batch whose
    backend decision resolves to the host raises
    :class:`DeviceBatchUnavailable`, and callers loop over samples.

    ``backend="balldrop"`` runs the ball-dropping engine over the same plan
    (:func:`repro_torch.core.balldrop.balldrop_run`): one node-pair stream
    per sample, ``targets`` per sample, ``num_samples >= 1``.

    ``mesh=`` (a DeviceMesh over a real process group; every rank calls
    with the same arguments) gives each rank its chunk of the graphs and
    returns, on every rank, the unsharded run's result (module docstring).
    """
    if backend == "balldrop":
        from repro_torch.core import balldrop  # balldrop imports this module

        return balldrop.balldrop_run(
            key, plan, num_samples=num_samples, targets=targets, max_rounds=max_rounds,
            oversample=oversample, use_kernel=use_kernel, mesh=mesh, exact_cells=exact_cells,
        )
    S = int(num_samples)
    gtot = S * plan.num_graphs
    ncfg = 1 << plan.d
    targets_given = targets is not None
    use_kernel = True if use_kernel is None else bool(use_kernel)

    exact = (not targets_given) if exact_cells is None else bool(exact_cells)
    exact = exact and not targets_given and backend in ("auto", "device") and gtot > 0
    budget = _exact_budget(plan.p_max, plan.mean_edges) if exact else None
    if exact and (budget is None or gtot * budget > kpgm.DEVICE_MAX_CANDIDATES):
        DISPATCH_COUNTERS["exact_fallbacks"] += 1
        exact, budget = False, None

    key, sub = prng.split(key)
    if exact:
        targets = np.full(gtot, budget, dtype=np.int64)
        ask0 = budget
    else:
        if targets is None:
            # float32 arithmetic on the host, as the reference's numpy does it
            z = prng.normal(sub, (gtot,)).numpy()
            targets = _clip_targets(
                np.round(z * np.float32(plan.std_edges) + np.float32(plan.mean_edges)), ncfg
            ).astype(np.int64)
        else:
            targets = _clip_targets(np.asarray(targets, dtype=np.int64).reshape(gtot), ncfg)
        ask0 = dedup.uniform_ask(targets, oversample)
    total = int(targets.sum())

    mesh, axes, g_pad = _mesh_layout(mesh, gtot)
    # the decision depends on gtot and the first ask only, as the
    # reference's does (layout-invariant: no shard count enters it)
    use_device = exact or backend == "device" or (
        backend == "auto" and gtot * ask0 <= kpgm.DEVICE_MAX_CANDIDATES
    )
    if not use_device:
        if S > 1:
            raise DeviceBatchUnavailable(
                f"a fused batch needs the device backend (backend={backend!r}, "
                f"candidates={gtot * ask0})"
            )
        if targets_given:
            raise DeviceBatchUnavailable(
                f"targets override needs the device backend (backend={backend!r}, "
                f"candidates={gtot * ask0})"
            )
        edges, st, _, _ = _quilt_sample_host(key, plan, max_rounds=max_rounds, oversample=oversample)
        # the engine's own target draw and no device counts, as the
        # reference reports them; the host path's totals are in ``st``
        return QuiltRun(plan, targets, np.zeros(gtot, dtype=np.int64), None, None, None, 0, (), edges, st)

    tail: List[Tuple[int, np.ndarray]] = []
    counts = np.zeros(gtot, dtype=np.int64)
    shortfall = targets.copy()
    outs = None
    key, rkey = prng.split(key)
    a_tot = 0
    if total > 0:
        gids, tdev = _pad_inputs(gtot, g_pad, targets, budget, plan.device)
        for r in range(1 if exact else max_rounds):
            chaos.maybe_fail("quilt.round")
            ask = budget if exact else dedup.uniform_ask(shortfall, oversample)
            if ask == 0:
                break
            if a_tot and gtot * (a_tot + ask) > kpgm.DEVICE_MAX_CANDIDATES:
                # the cumulative stream would outgrow the device budget: the
                # host loop finishes the residual
                break
            a_tot += ask
            while True:
                try:
                    # before the round's first launch, so a fault leaves no
                    # launch pending
                    chaos.maybe_fail("quilt.dispatch")
                    lo, hi = _shard_rows(mesh, axes, g_pad)
                    outs = _round_body(
                        rkey, gids[lo:hi], tdev[lo:hi], plan, a_tot=a_tot, budget=budget,
                        use_kernel=use_kernel,
                    )
                    break
                except chaos.DeviceLoss as exc:
                    # the same program would fail alike: rebuild over the
                    # survivors and re-run the round, to the same bits
                    mesh, axes, g_pad = _degrade_layout(mesh, exc, gtot)
                    gids, tdev = _pad_inputs(gtot, g_pad, targets, budget, plan.device)
            DISPATCH_COUNTERS["device_rounds" if r == 0 else "device_topup_rounds"] += 1
            counts = _gather_rows(outs[5], mesh, axes)[:gtot].cpu().numpy().astype(np.int64)
            # the exact thinning already realized each cell's draw
            shortfall = np.zeros_like(targets) if exact else targets - counts
            if shortfall.max(initial=0) <= 0:
                break

    snode = dnode = keep = None
    if outs is not None:
        scfg, dcfg, snode, dnode, take, _ = outs
        keep = _gather_rows(take & (snode >= 0) & (dnode >= 0), mesh, axes)
        snode, dnode = _gather_rows(snode, mesh, axes), _gather_rows(dnode, mesh, axes)
        if shortfall.max(initial=0) > 0:
            scfg, dcfg, take = (_gather_rows(x, mesh, axes) for x in (scfg, dcfg, take))
            DISPATCH_COUNTERS["degraded_fallbacks"] += 1
            warnings.warn(
                f"device rounds exhausted (max_rounds={max_rounds}, {a_tot} slots/graph) "
                f"with {int(shortfall.sum())} edges still short: finishing the residual "
                "with the host rejection loop (raise max_rounds or oversample to stay "
                "device-resident)",
                RuntimeWarning,
                stacklevel=2,
            )
            flat = (scfg[take].to(torch.int64) * ncfg + dcfg[take].to(torch.int64)).cpu().numpy()
            seen_cfg = np.split(flat, np.cumsum(counts)[:-1])
            counts = _host_quilt_topup(key, plan, targets, seen_cfg, tail, max_rounds, oversample)
    if exact:
        targets = counts.copy()
    return QuiltRun(plan, targets, counts, snode, dnode, keep, a_tot, tuple(tail), None, None, S)


def quilt_sample(
    key: torch.Tensor,
    params: magm.MAGMParams,
    F,
    *,
    max_rounds: int = 8,
    oversample: float = 1.05,
    backend: str = "auto",
    use_kernel: Optional[bool] = None,
    mesh=None,
    return_stats: bool = False,
    exact_cells: Optional[bool] = None,
    device=None,
):
    """Deprecated shim: one MAGM graph of the (n, d) attributes ``F`` on
    ``device`` (default ``"cuda"``), equal to ``MAGMSampler(SamplerConfig(
    params=params, F=F, ...)).sample(key)``, through the cached plan of
    :func:`get_quilt_plan`.  Returns the (E, 2) edges, and the stats with
    ``return_stats``."""
    _warn_shim("quilt_sample", "repro_torch.api.MAGMSampler.sample")
    F = F.cpu().numpy() if isinstance(F, torch.Tensor) else np.asarray(F)
    if F.size == 0:
        out = np.zeros((0, 2), dtype=np.int64)
        return (out, QuiltStats(0, 0, 0, 0, 0, 0, None)) if return_stats else out
    run = quilt_run(
        key, get_quilt_plan(F, params.thetas, device=device), max_rounds=max_rounds,
        oversample=oversample, backend=backend, use_kernel=use_kernel, mesh=mesh, exact_cells=exact_cells,
    )
    out = run.edges()
    return (out, run.stats(out.shape[0])) if return_stats else out


def _host_quilt_topup(
    key: torch.Tensor,
    plan: QuiltPlan,
    targets: np.ndarray,
    seen_cfg: List[np.ndarray],
    tail: List[Tuple[int, np.ndarray]],
    max_rounds: int,
    oversample: float,
) -> np.ndarray:
    """Finish the shortfall the device rounds left with the host rounds
    (``kpgm._host_rounds``): each round's threefry batch descended and
    looked up in the ``quilt_descent_lookup`` kernel (graph g = k * B + l
    in blocks k and l), each graph's fresh cells appended to ``seen_cfg``.
    Appends ``(graph, (E, 2))`` pieces of the cells whose two lookups hit
    to ``tail``; returns the per-graph counts."""
    lookup_spec = (plan.B, (plan.table_cfg, plan.table_node, plan.inv))
    rounds = kpgm._host_rounds(key, plan.cum, 1 << plan.d, targets, seen_cfg, max_rounds, oversample, lookup_spec)
    for fresh in rounds:
        DISPATCH_COUNTERS["host_topup_rounds"] += 1
        for g, sn, dn in fresh:
            hit = (sn >= 0) & (dn >= 0)
            if hit.any():
                tail.append((g, np.stack([sn[hit], dn[hit]], axis=1)))
    return np.array([k.size for k in seen_cfg], dtype=np.int64)


def _quilt_sample_host(key: torch.Tensor, plan: QuiltPlan, *, max_rounds: int, oversample: float):
    """The host path: Algorithm 1 for the B^2 graphs with shared batches
    (``kpgm._sample_many``), each candidate looked up in the kernel
    ``quilt_descent_lookup`` so its node ids ride with its config through
    the arrival-order dedup; the edges are the kept cells whose two lookups
    hit, graph by graph.  Returns ``(edges, stats, targets, counts)``, the
    last two per graph."""
    B = plan.B
    key, sub = prng.split(key)
    graphs, targets = kpgm._sample_many(
        sub, plan.thetas, B * B, max_rounds=max_rounds, oversample=oversample,
        backend="auto", device=plan.device, lookup_tables=(B, (plan.table_cfg, plan.table_node, plan.inv)),
    )
    edges = []
    for s, d in zip(graphs.snode, graphs.dnode):
        hit = (s >= 0) & (d >= 0)
        if hit.any():
            edges.append(np.stack([s[hit], d[hit]], axis=1))
    out = np.concatenate(edges, axis=0) if edges else np.zeros((0, 2), dtype=np.int64)
    counts = graphs.sizes()
    stats = QuiltStats(
        B=B,
        num_kpgm_draws=B * B,
        kpgm_edges_total=int(counts.sum()),
        kept_edges=out.shape[0],
        heavy_groups=0,
        light_nodes=plan.n,
        bprime=None,
    )
    return out, stats, targets, counts


# ---------------------------------------------------------------------------
# Section 5: the split sampler for unbalanced attributes
# ---------------------------------------------------------------------------

# rounds of the sparse rows' collision redraws before the exact fallback,
# and the cap on one dense chunk's (rows, G) key matrix (~32 MB)
_RESAMPLE_ROUNDS = 32
_DENSE_CHUNK_CELLS = 1 << 22


def _node_bits(n: int) -> int:
    """Bits that pack a node id of [0, n)."""
    return max(int(n - 1).bit_length(), 1) if n > 1 else 1


def choose_bprime(counts: np.ndarray, n: int, d: int, expected_e: float) -> Tuple[int, float]:
    """The B' minimising the paper's cost T(B') = B'^2 log(n) |E| + (|W| +
    d) R + d R^2, and that cost, over B' = 0 and the distinct
    multiplicities ``counts`` of the configurations (T only changes
    there); (0, 0.0) for no configurations."""
    counts = np.sort(np.asarray(counts, dtype=np.int64).reshape(-1))
    if counts.size == 0:
        return 0, 0.0
    log_n = max(np.log2(max(n, 2)), 1.0)
    cands = np.concatenate([[0], np.unique(counts)])
    best_bp, best_t = int(counts.max()), float("inf")
    for bp in cands:
        heavy = counts > bp
        r = int(heavy.sum())
        w = int(counts[~heavy].sum())
        t = float(bp) ** 2 * log_n * max(expected_e, 1.0) + (w + d) * r + d * r * r
        if t < best_t:
            best_t, best_bp = t, int(bp)
    return best_bp, best_t


class SplitPlan(NamedTuple):
    """The section-5 split of (F, thetas, B'), built by
    :func:`build_split_plan`: the light nodes W and their quilt plan, the R
    heavy groups, the scalar edge probabilities of every heavy block, and
    the device state of the heavy round.

    The heavy round sees every heavy unit (R^2 heavy-heavy blocks and, per
    direction, |W| R one-node strips) as one of M uniform blocks of ``rows
    x cols`` cells sharing one p, over the node pool ``[cat, W]``.  A block
    is proposed with weight rows * cols * p (``blk_cumw``), so each cell is
    proposed with p / ``heavy_mean``, and the per-block acceptance
    ``blk_alpha`` makes each cell an edge with probability exactly p.
    ``heavy_budget`` is the round's proposal count: None past
    ``kpgm.DEVICE_MAX_CANDIDATES`` (the host binomials run instead), 0
    with no heavy mass.
    """

    n: int
    d: int
    bprime: int
    W: np.ndarray  # light node ids
    heavy_cfgs: np.ndarray  # (R,) heavy configurations
    sizes: np.ndarray  # (R,) heavy group sizes
    offs: np.ndarray  # (R,) offsets of the groups in cat
    cat: np.ndarray  # the heavy groups' node ids, concatenated
    p_hh: np.ndarray  # (R, R) heavy-heavy edge probabilities, float32
    p_wh: np.ndarray  # (|W|, R) light-source strip probabilities
    p_hw: np.ndarray  # (R, |W|) heavy-source strip probabilities
    light_plan: Optional[QuiltPlan]  # quilt plan of F[W] (None if W is empty)
    pool: Optional[torch.Tensor] = None  # (|cat| + |W|,) int32 node ids, on device
    blk_rows: Optional[torch.Tensor] = None  # (M,) int32
    blk_cols: Optional[torch.Tensor] = None  # (M,) int32
    blk_src_base: Optional[torch.Tensor] = None  # (M,) int32 pool offset of the rows
    blk_dst_base: Optional[torch.Tensor] = None  # (M,) int32 pool offset of the cols
    blk_alpha: Optional[torch.Tensor] = None  # (M,) float32 per-cell acceptance
    blk_cumw: Optional[torch.Tensor] = None  # (M,) float64 normalized cumulative weights
    heavy_budget: Optional[int] = None
    heavy_mean: float = 0.0  # expected heavy-part edges S_h

    @property
    def R(self) -> int:
        return int(self.heavy_cfgs.size)


def _edge_probs(Fa: np.ndarray, Fb: np.ndarray, thetas) -> np.ndarray:
    """float32 min(exp(log Q), 1) between rows of Fa and Fb: the reference's
    host log Q (``magm.host_log_edge_prob``), then numpy's float32 exp, as
    the reference takes it."""
    return np.minimum(np.exp(magm.host_log_edge_prob(Fa, Fb, thetas)), 1.0)


def build_split_plan(
    F, params: magm.MAGMParams, bprime: Optional[int] = None, *, use_cache: bool = False, device=None
) -> SplitPlan:
    """The section-5 split of the (n, d) attributes ``F`` on ``device``
    (default ``"cuda"``); ``bprime=None`` minimises the paper's cost model
    (:func:`choose_bprime`).

    Everything is computed on the host, as the reference computes it; only
    the finished light plan and heavy-round arrays go to the device.
    ``use_cache=True`` takes the light plan from the shims' cache
    (:func:`get_quilt_plan`)."""
    dev = resolve_device(device)
    F = F.cpu().numpy() if isinstance(F, torch.Tensor) else np.asarray(F)
    n, d = F.shape
    lam = magm.configs_from_attributes(torch.from_numpy(np.array(F))).numpy()
    uniq, counts = np.unique(lam, return_counts=True)
    if bprime is None:
        bprime, _ = choose_bprime(counts, n, d, magm.expected_edges(params, n))

    heavy = counts > bprime
    heavy_cfgs = uniq[heavy]
    R = int(heavy_cfgs.size)
    node_is_heavy = np.isin(lam, heavy_cfgs)
    W = np.nonzero(~node_is_heavy)[0]
    sizes = counts[heavy].astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]) if R else np.zeros(0, dtype=np.int64)
    # a stable sort by config lists each heavy group's nodes in node order
    order = np.argsort(lam, kind="stable")
    cat = order[node_is_heavy[order]].astype(np.int64)
    p_hh, p_wh, p_hw = np.zeros((0, 0)), np.zeros((W.size, 0)), np.zeros((0, W.size))
    if R:
        heavy_attr = magm.attributes_from_configs(torch.from_numpy(heavy_cfgs), d).numpy()
        p_hh = _edge_probs(heavy_attr, heavy_attr, params.thetas)
        if W.size:
            p_wh = _edge_probs(F[W], heavy_attr, params.thetas)
            p_hw = _edge_probs(heavy_attr, F[W], params.thetas)

    light_plan = None
    if W.size:
        light_plan = (
            get_quilt_plan(F[W], params.thetas, device=dev)
            if use_cache
            else build_quilt_plan(F[W], params.thetas, device=dev)
        )
    return SplitPlan(
        n=n, d=d, bprime=int(bprime), W=W, heavy_cfgs=heavy_cfgs, sizes=sizes, offs=offs, cat=cat,
        p_hh=p_hh, p_wh=p_wh, p_hw=p_hw, light_plan=light_plan,
        **_heavy_device_state(n, W, sizes, offs, cat, p_hh, p_wh, p_hw, dev),
    )


def _heavy_device_state(n, W, sizes, offs, cat, p_hh, p_wh, p_hw, device) -> dict:
    """The heavy round's arrays on ``device``: the M uniform blocks in the
    reference's order (the R^2 heavy-heavy blocks row-major, then the
    light -> heavy strips (i, b) row-major, then heavy -> light), their
    weights w = rows * cols * p, the exact budget G at p_max / S_h, the
    acceptance alpha = p / (1 - (1 - p / S_h)^G) and the normalized
    cumulative weights in float64 (block choice by searchsorted over up to
    ~10^7 blocks needs more than float32's grid).  The arithmetic is the
    reference's numpy float64, so every array is equal to its."""
    R = int(sizes.size)
    if R == 0:
        return {}
    C = int(cat.size)
    s32 = sizes.astype(np.int32)
    o32 = offs.astype(np.int32)
    rows, cols, src_base, dst_base = [np.repeat(s32, R)], [np.tile(s32, R)], [np.repeat(o32, R)], [np.tile(o32, R)]
    probs = [p_hh.reshape(-1).astype(np.float64)]
    if W.size:
        strip = C + np.repeat(np.arange(W.size, dtype=np.int32), R)
        ones = np.ones(W.size * R, dtype=np.int32)
        rows += [ones, np.tile(s32, W.size)]
        cols += [np.tile(s32, W.size), ones]
        src_base += [strip, np.tile(o32, W.size)]
        dst_base += [np.tile(o32, W.size), strip]
        probs += [p_wh.reshape(-1).astype(np.float64), p_hw.T.reshape(-1).astype(np.float64)]
    rows, cols, probs = np.concatenate(rows), np.concatenate(cols), np.concatenate(probs)
    w = rows.astype(np.float64) * cols.astype(np.float64) * probs
    s_h = float(w.sum())
    if s_h <= 0.0:
        return {"heavy_budget": 0, "heavy_mean": 0.0}
    budget = _exact_budget(float(probs.max()), s_h)
    if budget is None or budget > kpgm.DEVICE_MAX_CANDIDATES:
        return {"heavy_mean": s_h}  # no budget: the host binomials run
    pi = np.minimum(probs / s_h, 1.0 - 1e-12)
    q = -np.expm1(float(budget) * np.log1p(-pi))
    del pi
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = np.where(q > 0.0, np.minimum(probs / q, 1.0), 0.0).astype(np.float32)
    del q, probs
    cumw = np.cumsum(w) / s_h
    cumw[-1] = 1.0
    del w
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {
        "pool": put(np.concatenate([cat, W]).astype(np.int32)),
        "blk_rows": put(rows),
        "blk_cols": put(cols),
        "blk_src_base": put(np.concatenate(src_base)),
        "blk_dst_base": put(np.concatenate(dst_base)),
        "blk_alpha": put(alpha),
        "blk_cumw": put(cumw),
        "heavy_budget": int(budget),
        "heavy_mean": s_h,
    }


def rng_from_key(key: torch.Tensor) -> np.random.Generator:
    """The numpy Generator of a key: ``default_rng`` seeded with the two
    uint32 words of ``fold_in(key, 0x5EED)``, the reference's exact stream.
    It draws the heavy part where the host binomials run."""
    words = prng.fold_in(key, 0x5EED).reshape(-1).tolist()
    return np.random.default_rng([int(x) & 0xFFFFFFFF for x in words])


def _split_heavy_body(hkey: torch.Tensor, sp: SplitPlan, *, budget: int, node_bits: int):
    """One fixed-shape round realizing every heavy block at once, on the
    plan's device: ``(src, dst, take)`` of ``budget`` proposals.

    Proposal s picks block m by a 48-bit uniform from hash channels 0 and
    1 of slot s (exact in float64), then a uniform cell of the block from
    channels 2 and 3.  The cell (the packed node pair) is accepted with
    ``blk_alpha[m]`` by a hash that its duplicates share, and the
    segmented dedup keeps each accepted pair's first proposal."""
    dev = sp.pool.device
    s0, s1 = ops.counter_seed(hkey)
    gid0 = torch.zeros((), dtype=torch.int64, device=dev)
    base = torch.arange(budget, dtype=torch.int64, device=dev) * ops.PRNG_CHANNELS
    hi = ops.counter_hash(s0, s1, gid0, base)
    lo = ops.counter_hash(s0, s1, gid0, base + 1)
    u_blk = (hi >> 8).to(torch.float64) * 2.0**-24 + (lo >> 8).to(torch.float64) * 2.0**-48
    del hi, lo
    m = torch.clamp(torch.searchsorted(sp.blk_cumw, u_blk, right=True), 0, sp.blk_cumw.numel() - 1)
    del u_blk
    rows, cols = sp.blk_rows[m], sp.blk_cols[m]
    u_r = ops.counter_u01(s0, s1, gid0, base + 2)
    u_c = ops.counter_u01(s0, s1, gid0, base + 3)
    r = torch.minimum((u_r * rows.to(torch.float32)).to(torch.int32), rows - 1)
    c = torch.minimum((u_c * cols.to(torch.float32)).to(torch.int32), cols - 1)
    src = sp.pool[sp.blk_src_base[m] + r]
    dst = sp.pool[sp.blk_dst_base[m] + c]
    # heavy and light nodes are disjoint and the blocks tile disjoint
    # rectangles of pairs, so the packed pair names the cell
    pair = src.to(torch.int64) * (1 << node_bits) + dst.to(torch.int64)
    accept = _accept_u01(accept_salt(hkey, dev), gid0, pair) < sp.blk_alpha[m]
    take, _ = dedup.segmented_unique_mask(
        torch.zeros(budget, dtype=torch.int32, device=dev), src, dst,
        torch.full((1,), budget, dtype=torch.int64, device=dev),
        torch.full((1,), budget, dtype=torch.int64, device=dev),
        node_bits=node_bits, valid=accept,
    )
    return src, dst, take


def _heavy_host(rng: np.random.Generator, sp: SplitPlan) -> List[np.ndarray]:
    """The heavy blocks by host binomials: one batched binomial for the R^2
    heavy-heavy counts and one for each direction's |W| x R strips, then
    the distinct cells of each (:func:`_sample_cells`).  Returns the
    ``(E, 2)`` pieces in the reference's order."""
    W, R, sizes, offs, cat = sp.W, sp.R, sp.sizes, sp.offs, sp.cat
    pieces = []
    cells = sizes[:, None] * sizes[None, :]
    counts_hh = rng.binomial(cells, sp.p_hh).reshape(-1)
    cell_ids = _sample_cells(rng, counts_hh, cells.reshape(-1))
    if cell_ids.size:
        rep = np.repeat(np.arange(R * R), counts_hh)
        a, b = rep // R, rep % R
        rr, cc = cell_ids // sizes[b], cell_ids % sizes[b]
        pieces.append(np.stack([cat[offs[a] + rr], cat[offs[b] + cc]], axis=1))
    if W.size:
        sizes_rep = np.tile(sizes, W.size)
        for p, flip in ((sp.p_wh, False), (sp.p_hw.T, True)):
            counts_s = rng.binomial(sizes[None, :], p).reshape(-1)  # row-major over (i, b)
            cols = _sample_cells(rng, counts_s, sizes_rep)
            if not cols.size:
                continue
            rep = np.repeat(np.arange(W.size * R), counts_s)
            i, b = rep // R, rep % R
            light, heavy = W[i], cat[offs[b] + cols]
            pieces.append(np.stack([heavy, light] if flip else [light, heavy], axis=1))
    return pieces


def split_run(
    key: torch.Tensor,
    sp: SplitPlan,
    rng: Optional[np.random.Generator] = None,
    *,
    max_rounds: int = 8,
    oversample: float = 1.05,
    backend: str = "auto",
    use_kernel: Optional[bool] = None,
    mesh=None,
) -> Tuple[np.ndarray, QuiltStats]:
    """One section-5 sample of ``sp`` for ``key``: ``((E, 2) edges, stats)``.

    The light subgraph is quilted (:func:`quilt_run` on ``sp.light_plan``,
    sharded over ``mesh`` where given, mapped to node ids through W) and the heavy blocks are realized by the
    device round (:func:`_split_heavy_body`) keyed by a sibling split of
    ``key``; only its kept pairs are copied to the host.  With ``rng`` (a
    numpy Generator), or where the plan has no heavy budget, the heavy
    blocks are host binomials, drawn from ``rng`` or from
    :func:`rng_from_key`.  The pieces are deduped on the host in order
    (``dedup.dedup_edges``)."""
    W, R = sp.W, sp.R
    pieces: List[np.ndarray] = []
    stats_b = draws = kp_total = 0
    key, hkey = prng.split(key)
    if W.size:
        key, sub = prng.split(key)
        run = quilt_run(
            sub, sp.light_plan, max_rounds=max_rounds, oversample=oversample, backend=backend,
            use_kernel=use_kernel, mesh=mesh,
        )
        ew = run.edges()
        st = run.stats(ew.shape[0])
        stats_b, draws, kp_total = st.B, st.num_kpgm_draws, st.kpgm_edges_total
        if ew.size:
            pieces.append(np.stack([W[ew[:, 0]], W[ew[:, 1]]], axis=1))
    if R and rng is None and sp.heavy_budget is not None:
        if sp.heavy_budget > 0:
            src, dst, take = _split_heavy_body(hkey, sp, budget=sp.heavy_budget, node_bits=_node_bits(sp.n))
            pairs = torch.stack([src[take], dst[take]], dim=1).to(torch.int64).cpu().numpy()
            if pairs.size:
                pieces.append(pairs)
    elif R:
        pieces.extend(_heavy_host(rng_from_key(key) if rng is None else rng, sp))
    out = dedup.dedup_edges(np.concatenate(pieces, axis=0)) if pieces else np.zeros((0, 2), dtype=np.int64)
    return out, QuiltStats(
        B=stats_b, num_kpgm_draws=draws, kpgm_edges_total=kp_total, kept_edges=out.shape[0],
        heavy_groups=R, light_nodes=int(W.size), bprime=int(sp.bprime),
    )


_SEED_UNSET = object()


def quilt_sample_fast(
    key: torch.Tensor,
    params: magm.MAGMParams,
    F,
    *,
    bprime: Optional[int] = None,
    seed=_SEED_UNSET,
    mesh=None,
    backend: str = "auto",
    use_kernel: Optional[bool] = None,
    return_stats: bool = False,
    device=None,
):
    """Deprecated shim: one section-5 sample of the attributes ``F`` on
    ``device`` (default ``"cuda"``), equal to ``MAGMSampler(SamplerConfig(
    ..., split=True)).sample(key)``.  ``seed=`` (deprecated as well) draws
    the heavy blocks by host binomials from ``np.random.default_rng(seed)``
    instead of the device round."""
    _warn_shim("quilt_sample_fast", "repro_torch.api.MAGMSampler (SamplerConfig split=True)")
    if seed is _SEED_UNSET:
        rng = None
    else:
        warnings.warn(
            "quilt_sample_fast(seed=...) is deprecated: omit it and the numpy stream derives "
            "from `key` (rng_from_key)",
            DeprecationWarning,
            stacklevel=2,
        )
        rng = np.random.default_rng(seed)
    sp = build_split_plan(F, params, bprime, use_cache=True, device=device)
    out, st = split_run(key, sp, rng, mesh=mesh, backend=backend, use_kernel=use_kernel)
    return (out, st) if return_stats else out


def _er_block(rng: np.random.Generator, ns: int, nt: int, p: float) -> np.ndarray:
    """An Erdos-Renyi ns x nt block: each cell an edge with probability p,
    as a Binomial(ns * nt, p) count of distinct uniform cells."""
    cells = ns * nt
    if cells == 0 or p <= 0.0:
        return np.zeros((0, 2), dtype=np.int64)
    count = rng.binomial(cells, min(p, 1.0))
    if count == 0:
        return np.zeros((0, 2), dtype=np.int64)
    flat = _sample_cells(rng, np.array([count], np.int64), np.array([cells], np.int64))
    return np.stack([flat // nt, flat % nt], axis=1).astype(np.int64)


def _sample_cells(rng: np.random.Generator, counts: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """For each row i, ``counts[i]`` distinct integers of [0, sizes[i])
    (counts clipped to sizes; rows in order, empty rows skipped).

    Dense rows (more than half their range) take the first counts[i] of a
    random-key argsort with the out-of-range columns pushed last; sparse
    rows draw with replacement and redraw only the colliding slots, all
    rows at once per round, with ``rng.choice(replace=False)`` for rows
    still colliding after ``_RESAMPLE_ROUNDS``."""
    counts = np.asarray(counts, dtype=np.int64)
    sizes = np.asarray(sizes, dtype=np.int64)
    pos_mask = counts > 0
    pos = np.minimum(counts[pos_mask], sizes[pos_mask])
    sz = sizes[pos_mask]
    tot = int(pos.sum())
    if tot == 0:
        return np.empty(0, dtype=np.int64)
    seg_id = np.repeat(np.arange(pos.size, dtype=np.int64), pos)
    cols = np.empty(tot, dtype=np.int64)

    dense_seg = pos > sz // 2
    dense_slot = dense_seg[seg_id]
    if dense_seg.any():
        lens, szs = pos[dense_seg], sz[dense_seg]
        gmax = int(szs.max())
        picks = []
        rows_per_chunk = max(1, _DENSE_CHUNK_CELLS // max(gmax, 1))
        for lo in range(0, lens.size, rows_per_chunk):
            chunk_len = lens[lo : lo + rows_per_chunk]
            chunk_sz = szs[lo : lo + rows_per_chunk]
            keys = rng.random((chunk_len.size, gmax))
            keys[np.arange(gmax)[None, :] >= chunk_sz[:, None]] = 2.0
            order = np.argsort(keys, axis=1)
            picks.append(order[np.arange(gmax)[None, :] < chunk_len[:, None]])
        cols[dense_slot] = np.concatenate(picks)

    sparse_slot = ~dense_slot
    ns = int(sparse_slot.sum())
    if ns:
        sid = seg_id[sparse_slot]
        smax = int(sz.max())
        sub = rng.integers(0, sz[sid])
        dup = np.zeros(ns, dtype=bool)
        for _ in range(_RESAMPLE_ROUNDS):
            key = sid * smax + sub
            order = np.argsort(key, kind="stable")
            sk = key[order]
            dup[:] = False
            dup[order[1:]] = sk[1:] == sk[:-1]
            if not dup.any():
                break
            sub[dup] = rng.integers(0, sz[sid[dup]])
        else:  # rows still colliding: an exact draw for those only
            for s in np.unique(sid[dup]):
                m = sid == s
                sub[m] = rng.choice(int(sz[s]), size=int(m.sum()), replace=False)
        cols[sparse_slot] = sub
    return cols


def _sample_cols(rng: np.random.Generator, counts: np.ndarray, group: np.ndarray) -> np.ndarray:
    """For each row i, ``counts[i]`` distinct members of ``group``."""
    counts = np.asarray(counts)
    return group[_sample_cells(rng, counts, np.full(counts.shape, group.size, dtype=np.int64))]


def naive_reference_sample(key: torch.Tensor, params: magm.MAGMParams, F, *, device=None) -> np.ndarray:
    """O(n^2) exact sampler (the paper's baseline) on ``device`` (default
    ``"cuda"``; raises without a card); small n only.  The dense Q in
    float32 against one (n, n) uniform draw, as the reference computes it;
    returns (E, 2) int64 on the host, row-major."""
    dev = resolve_device(device)
    F = F.cpu().numpy() if isinstance(F, torch.Tensor) else np.asarray(F)
    Q = magm.edge_prob_matrix(torch.from_numpy(np.ascontiguousarray(F)).to(dev), params.thetas)
    u = prng.uniform(key, tuple(Q.shape), device=dev)
    return torch.nonzero(u < Q).cpu().numpy()
