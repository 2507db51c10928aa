"""Algorithm 2 — quilting KPGM samples into a MAGM sample — on PyTorch,
exact-cell path.

Quilting partitions the nodes into D_1..D_B (partition.py) and, for every
block pair (k, l), draws candidate edges of a full KPGM graph, keeps those
(x, y) for which some i in D_k has lambda_i = x and some j in D_l has
lambda_j = y, and maps them to node space (Theorem 3).

The exact-cell mode is one fixed-shape round: every one of the B^2 graphs
draws the plan-constant budget G of candidates (:func:`_exact_budget`),
each candidate's cell survives with probability alpha = p / q, decided by a
per-cell hash shared by its duplicates, and the first occurrence of each
surviving cell is kept — so every cell is in the graph with exactly its
Bernoulli(p) probability.  The round is

1. the fused counter-PRNG descent + block lookup (the CUDA kernel of
   ``kernels/quadrant_descent.py`` on a card, its plain version on the CPU);
2. the acceptance thinning (:func:`_exact_cell_valid`);
3. the sort-based segmented dedup (``core/dedup.py``).

Runs that the reference takes elsewhere raise ``NotImplementedError`` and
name the ROADMAP item that will port them: the legacy ranked rounds (an
explicit target, or a budget over ``DEVICE_MAX_CANDIDATES``), the host
backend, ball dropping, fused batches and meshes.

:func:`naive_reference_sample` is the O(n^2) exact oracle the quilting
sampler is tested against.
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import dedup, f32math, kpgm, magm, partition, prng
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


class QuiltPlan(NamedTuple):
    """Device state for quilting one attribute matrix: the Theorem-2
    partition, the padded per-block lookup tables, the level cumulative
    probabilities and the |E| moments.  Built by :func:`build_quilt_plan`."""

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

    @property
    def num_graphs(self) -> int:
        return self.B * self.B


PLAN_STATS = {"partition_builds": 0, "plan_builds": 0}
_PART_CACHE: "OrderedDict" = OrderedDict()
_CACHE_MAX = 8

# one fused round per exact sample; exact_fallbacks counts runs whose budget
# would leave the exact path (they raise until the legacy rounds are ported)
DISPATCH_COUNTERS = {"device_rounds": 0, "exact_fallbacks": 0}

# the uniform of the acceptance test comes from the top 24 of 64 hash bits
_TWO_M24 = 2.0**-24


def clear_plan_cache() -> None:
    """Drop the content-keyed partition cache (plans held by sessions are
    unaffected)."""
    _PART_CACHE.clear()


def _digest(a: np.ndarray):
    a = np.ascontiguousarray(a)
    return (a.shape, a.dtype.str, hashlib.sha1(a.tobytes()).hexdigest())


def _partition_state(F: np.ndarray):
    """Partition + padded lookup tables (host numpy) of one attribute matrix."""
    lam = magm.configs_from_attributes(torch.from_numpy(np.array(F))).numpy()
    part = partition.build_partition(lam)
    PLAN_STATS["partition_builds"] += 1
    tables = partition.padded_lookup_tables(part) if part.B else None
    return part, tables


def _plan_constants(thetas: torch.Tensor):
    """(cum, m, std, p_max) of the thetas, in the reference's float32 order."""
    cum = kpgm._level_cumprobs(thetas)
    m, v = kpgm.edge_moments(thetas)
    std = torch.sqrt(torch.clamp_min(m - v, 0.0))
    return cum, m, std, kpgm.max_cell_prob(thetas)


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
            _PART_CACHE[fkey] = state
            while len(_PART_CACHE) > _CACHE_MAX:
                _PART_CACHE.popitem(last=False)
        _PART_CACHE.move_to_end(fkey)
    else:
        state = _partition_state(F)
    part, tables = state
    cum, m, std, p_max = _plan_constants(th)
    empty = torch.zeros((0, 8), dtype=torch.int32)
    plan = QuiltPlan(
        n=int(F.shape[0]),
        d=int(F.shape[1]),
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
    )
    PLAN_STATS["plan_builds"] += 1
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
    scfg: torch.Tensor, dcfg: torch.Tensor, thetas: torch.Tensor, budget: int
) -> torch.Tensor:
    """float32 acceptance alpha = min(p / q, 1) of each candidate's cell,
    with q = 1 - (1 - p / S)^G its occupancy after ``budget`` proposals.
    The transcendentals are the reference's (core/f32math.py), so alpha is
    bit-identical to it on every device."""
    logp = kpgm.log_prob_pairs(thetas, scfg, dcfg)
    pi = f32math.exp(logp - kpgm.log_level_sum(thetas))
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
) -> torch.Tensor:
    """Per-candidate accept mask making cell inclusion exactly Bernoulli(p):
    the cell survives when its shared hash uniform is below alpha."""
    d = thetas.shape[0]
    cell = scfg.to(torch.int64) * (1 << d) + dcfg.to(torch.int64)
    return _accept_u01(salt, gid, cell) < _exact_alpha(scfg, dcfg, thetas, budget)


def _round_body(
    rkey: torch.Tensor,
    gids: torch.Tensor,
    plan: QuiltPlan,
    *,
    budget: int,
    use_kernel: bool,
):
    """One exact-cell round over the graphs ``gids`` (``budget`` slots
    each): descent + lookup, acceptance, dedup.  Returns
    ``(scfg, dcfg, snode, dnode, take, counts)`` on the plan's device."""
    gc = gids.numel()
    seed = ops.counter_seed(rkey)
    lookup = (
        ops.quilt_prng_descent_lookup
        if use_kernel
        else ops.quilt_prng_descent_lookup_plain
    )
    scfg, dcfg, snode, dnode = lookup(
        seed, gids, plan.cum, plan.table_cfg, plan.table_node,
        a_tot=budget, num_blocks=plan.B,
    )
    dev = gids.device
    local = torch.arange(gc * budget, dtype=torch.int64, device=dev) // budget
    cum_asks = torch.arange(1, gc + 1, dtype=torch.int64, device=dev) * budget
    targets = torch.full((gc,), budget, dtype=torch.int64, device=dev)
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


class QuiltRun(NamedTuple):
    """One executed exact-cell quilting run: the round's fixed-shape device
    buffers and the per-graph counts."""

    plan: QuiltPlan
    counts: np.ndarray  # (B^2,) per-graph edge counts realized by the round
    snode: torch.Tensor  # (B^2 * slots,) candidate node ids, on device
    dnode: torch.Tensor
    keep: torch.Tensor  # bool: taken AND both lookups hit, on device
    slots_per_graph: int

    def kept_edges(self) -> int:
        return int(self.keep.sum())

    def edges(self) -> np.ndarray:
        """(E, 2) int64 host array of the kept edges, in candidate order."""
        pairs = torch.stack([self.snode[self.keep], self.dnode[self.keep]], dim=1)
        return pairs.to(torch.int64).cpu().numpy()

    def stats(self, kept: Optional[int] = None) -> QuiltStats:
        return QuiltStats(
            B=self.plan.B,
            num_kpgm_draws=self.plan.num_graphs,
            kpgm_edges_total=int(self.counts.sum()),
            kept_edges=self.kept_edges() if kept is None else int(kept),
            heavy_groups=0,
            light_nodes=self.plan.n,
            bprime=None,
        )


def unported_reason(
    *,
    backend: str = "auto",
    mesh=None,
    exact_cells: Optional[bool] = None,
    split: bool = False,
    num_samples: int = 1,
    targets=None,
) -> Optional[str]:
    """Which requested path the port does not run yet, and the ROADMAP
    queue-1 item that will port it; None for the exact-cell main path."""
    legacy = "(ROADMAP queue 1: the legacy ranked rounds and the host fallback)"
    if backend == "balldrop":
        return "backend='balldrop' (ROADMAP queue 1: ball dropping)"
    if backend == "host":
        return f"backend='host' {legacy}"
    if split:
        return "split=True (ROADMAP queue 1: the section-5 split)"
    if mesh is not None:
        return "mesh= (ROADMAP queue 1: resilience and serving)"
    if exact_cells is False or targets is not None:
        return f"exact_cells=False / explicit targets {legacy}"
    if num_samples != 1:
        return "num_samples > 1 (ROADMAP queue 1: stream and batch)"
    return None


def quilt_run(
    key: torch.Tensor,
    plan: QuiltPlan,
    *,
    num_samples: int = 1,
    targets: Optional[np.ndarray] = None,
    backend: str = "auto",
    use_kernel: Optional[bool] = None,
    mesh=None,
    exact_cells: Optional[bool] = None,
) -> QuiltRun:
    """Run the exact-cell quilting round of ``plan`` for ``key``, on the
    plan's device.

    ``use_kernel`` None or True runs the fused lookup through its kernel
    wrapper (the CUDA kernel for a plan on a card); False asks for the plain
    PyTorch version explicitly.  The key is split as the reference splits
    it (once for the edge-count draw the exact mode does not use, once for
    the round key), so the same key gives the reference's edges.
    """
    reason = unported_reason(
        backend=backend, mesh=mesh, exact_cells=exact_cells,
        num_samples=num_samples, targets=targets,
    )
    if reason is not None:
        raise NotImplementedError(f"{reason} is not ported yet")
    gtot = plan.num_graphs
    budget = _exact_budget(plan.p_max, plan.mean_edges)
    if budget is None or gtot * budget > kpgm.DEVICE_MAX_CANDIDATES:
        DISPATCH_COUNTERS["exact_fallbacks"] += 1
        raise NotImplementedError(
            f"the exact-cell round needs {gtot} graphs x {budget} candidates, "
            f"over DEVICE_MAX_CANDIDATES={kpgm.DEVICE_MAX_CANDIDATES}; the "
            "legacy ranked rounds it falls back to are not ported yet "
            "(ROADMAP queue 1: the legacy ranked rounds and the host fallback)"
        )
    key, _ = prng.split(key)  # the edge-count draw's key: unused when exact
    _, rkey = prng.split(key)
    gids = torch.arange(gtot, dtype=torch.int32, device=plan.device)
    scfg, dcfg, snode, dnode, take, counts = _round_body(
        rkey, gids, plan, budget=budget,
        use_kernel=True if use_kernel is None else bool(use_kernel),
    )
    DISPATCH_COUNTERS["device_rounds"] += 1
    counts_h = counts.cpu().numpy().astype(np.int64)
    keep = take & (snode >= 0) & (dnode >= 0)
    return QuiltRun(plan, counts_h, snode, dnode, keep, budget)


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
