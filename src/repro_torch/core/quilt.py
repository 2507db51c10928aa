"""Algorithm 2 — quilting KPGM samples into a MAGM sample — on PyTorch.

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
engine (``core/balldrop.py``) over the same plan.  The section-5 split,
meshes and fused quilting batches raise ``NotImplementedError`` naming
their ROADMAP item.

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

from repro_torch.core import dedup, f32math, kpgm, kron, magm, partition, prng
from repro_torch.core.device import resolve_device
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


PLAN_STATS = {"partition_builds": 0, "plan_builds": 0}
_PART_CACHE: "OrderedDict" = OrderedDict()
_KPGM_PLAN_CACHE: "OrderedDict" = OrderedDict()
_CACHE_MAX = 8

# device_rounds: first device rounds; device_topup_rounds: ranked rounds
# after the first; host_topup_rounds: rounds of the host top-up loop after
# the device rounds; degraded_fallbacks: runs whose device rounds ran out
# (max_rounds or the candidate cap) short of their targets; exact_fallbacks:
# runs that asked for the exact-cell mode and could not take it
DISPATCH_COUNTERS = {
    "device_rounds": 0,
    "device_topup_rounds": 0,
    "host_topup_rounds": 0,
    "degraded_fallbacks": 0,
    "exact_fallbacks": 0,
}

# the uniform of the acceptance test comes from the top 24 of 64 hash bits
_TWO_M24 = 2.0**-24


def clear_plan_cache() -> None:
    """Drop the content-keyed partition and identity-plan caches (plans
    held by sessions are unaffected)."""
    _PART_CACHE.clear()
    _KPGM_PLAN_CACHE.clear()


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
    """The round's acceptance salt: 64 bits of ``fold_in(rkey, 0x5EED)``."""
    return prng.bits(prng.fold_in(rkey, 0x5EED), (), "uint64").to(device)


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
        logpi = logpi - torch.tensor(log_extra, dtype=torch.float32, device=logp.device)
    pi = f32math.exp(logpi)
    g = torch.tensor(float(budget), dtype=torch.float32, device=logp.device)
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
    # per-graph targets (the realized counts when exact; on a host run the
    # targets the host path drew) and distinct cells taken
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


def unported_reason(*, mesh=None, split: bool = False, num_samples: int = 1) -> Optional[str]:
    """Which requested path the port does not run yet, and the ROADMAP
    queue-1 item that will port it; None for a path it runs."""
    if split:
        return "split=True (ROADMAP queue 1: the section-5 split)"
    if mesh is not None:
        return "mesh= (ROADMAP queue 1: resilience and serving)"
    if num_samples != 1:
        return "num_samples > 1 (ROADMAP queue 1: stream and batch)"
    return None


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

    ``backend="balldrop"`` runs the ball-dropping engine over the same plan
    (:func:`repro_torch.core.balldrop.balldrop_run`): one node-pair stream
    per sample, ``targets`` per sample, ``num_samples >= 1``.
    """
    if backend == "balldrop":
        from repro_torch.core import balldrop  # balldrop imports this module

        return balldrop.balldrop_run(
            key, plan, num_samples=num_samples, targets=targets, max_rounds=max_rounds,
            oversample=oversample, use_kernel=use_kernel, mesh=mesh, exact_cells=exact_cells,
        )
    reason = unported_reason(mesh=mesh, num_samples=num_samples)
    if reason is not None:
        raise NotImplementedError(f"{reason} is not ported yet")
    gtot = plan.num_graphs
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

    # the decision depends on gtot and the first ask only, as the
    # reference's does (layout-invariant)
    use_device = exact or backend == "device" or (
        backend == "auto" and gtot * ask0 <= kpgm.DEVICE_MAX_CANDIDATES
    )
    if not use_device:
        if targets_given:
            raise DeviceBatchUnavailable(
                f"targets override needs the device backend (backend={backend!r}, "
                f"candidates={gtot * ask0})"
            )
        edges, st, host_targets, host_counts = _quilt_sample_host(
            key, plan, max_rounds=max_rounds, oversample=oversample
        )
        return QuiltRun(plan, host_targets, host_counts, None, None, None, 0, (), edges, st)

    tail: List[Tuple[int, np.ndarray]] = []
    counts = np.zeros(gtot, dtype=np.int64)
    shortfall = targets.copy()
    outs = None
    key, rkey = prng.split(key)
    a_tot = 0
    if total > 0:
        gids = torch.arange(gtot, dtype=torch.int32, device=plan.device)
        tdev = torch.from_numpy(targets).to(plan.device)
        for r in range(1 if exact else max_rounds):
            ask = budget if exact else dedup.uniform_ask(shortfall, oversample)
            if ask == 0:
                break
            if a_tot and gtot * (a_tot + ask) > kpgm.DEVICE_MAX_CANDIDATES:
                # the cumulative stream would outgrow the device budget: the
                # host loop finishes the residual
                break
            a_tot += ask
            outs = _round_body(
                rkey, gids, tdev, plan, a_tot=a_tot, budget=budget, use_kernel=use_kernel
            )
            DISPATCH_COUNTERS["device_rounds" if r == 0 else "device_topup_rounds"] += 1
            counts = outs[5].cpu().numpy().astype(np.int64)
            # the exact thinning already realized each cell's draw
            shortfall = np.zeros_like(targets) if exact else targets - counts
            if shortfall.max(initial=0) <= 0:
                break

    snode = dnode = keep = None
    if outs is not None:
        scfg, dcfg, snode, dnode, take, _ = outs
        keep = take & (snode >= 0) & (dnode >= 0)
        if shortfall.max(initial=0) > 0:
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
    return QuiltRun(plan, targets, counts, snode, dnode, keep, a_tot, tuple(tail), None, None)


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
