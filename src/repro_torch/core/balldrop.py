"""Ball-dropping MAGM sampler (Moreno et al., arXiv:1202.6001) over the
quilting plan, on PyTorch; the same key gives the reference's edges.

Quilting draws B^2 whole KPGM graphs and filters them down to the
attributes.  Ball dropping draws the graph's edge count first and places
that many balls directly:

1. **Target**: |E| given F is a sum of independent Bernoulli(Q_ij), so one
   draw N ~ round(Normal(c^T P c, sqrt(Var))) with the plan's ``bd_mean``
   and ``bd_std`` (``core/kron.py``).
2. **Proposal**: each ball is a quadrant descent (config pair (x, y) with
   probability P_xy / m) plus two uniform block ranks (k, l) in [0, B)^2.
3. **Rejection**: the ranks go through the quilt's per-block tables; block
   k holds config x iff c_x >= k + 1, so the lookup hits with probability
   c_x c_y / B^2 and an accepted ball lands on node pair (i, j) with
   probability proportional to Q_ij.  A miss is the rejection.
4. **Dedup**: accepted balls go through the segmented dedup over NODE
   pairs (``valid=`` masks the misses), with the ranked top-up rounds: a
   later round re-derives the earlier ones as the prefix of its stream.

Without explicit targets the exact-cell round runs instead: one
plan-constant round of ``quilt._exact_budget(p_max, mean_edges * B^2)``
proposals per sample, each node pair accepted through the per-pair hash of
``quilt._exact_cell_valid`` (``log_extra = 2 log B``), so edge inclusion is
exactly Bernoulli(Q_ij).

A device round's lookup takes one of three arms, bit-identical to each
other: the kernel ``quilt_prng_descent_lookup`` with ``ranks=True`` (its
plain version on a CPU tensor), the dense-inverse gather, or the by-config
short-circuit.  A first ask over ``DEVICE_MAX_CANDIDATES`` takes the host
loop (:func:`_balldrop_sample_host`): threefry proposals descended and
looked up on the plan's device by the kernel ``quilt_descent_lookup``
(through the dense inverse where the plan has it), the accepted node pairs
copied to the host and deduped there.  The result is a :class:`repro_torch.core.quilt.QuiltRun`
with ``sampler="balldrop"``, one dedup graph per sample.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dedup, kpgm, kron, prng, quilt
from repro_torch.dist import chaos
from repro_torch.kernels import ops

__all__ = ["balldrop_run", "DISPATCH_COUNTERS"]

# rounds of the ball-dropping engine, kept apart from quilt.DISPATCH_COUNTERS
# (same meanings)
DISPATCH_COUNTERS = {
    "device_rounds": 0,
    "device_topup_rounds": 0,
    "host_topup_rounds": 0,
    "mesh_degrades": 0,
    "degraded_fallbacks": 0,
    "exact_fallbacks": 0,
}

_UNAVAILABLE = (
    "backend='balldrop' needs the plan's ball-dropping moments; this plan was built "
    f"without them (2^d > {kron.MOMENT_CAP} configurations, or an empty partition)"
)


def _lookup_arm(plan: quilt.QuiltPlan, use_kernel: Optional[bool]) -> str:
    """The rank lookup of the device rounds: ``"kernel"`` (use_kernel None
    or True), else the dense inverse where the plan has it, else the
    by-config tables; the kernel where neither was built."""
    if use_kernel is None or use_kernel:
        return "kernel"
    if plan.inv is not None:
        return "inverse"
    return "bycfg" if plan.cfg_offset is not None else "kernel"


def _bd_round_body(
    rkey: torch.Tensor,
    gids: torch.Tensor,
    targets: torch.Tensor,
    plan: quilt.QuiltPlan,
    *,
    a_tot: int,
    node_bits: int,
    arm: str,
    budget: Optional[int],
):
    """One device round over the samples ``gids`` with ``a_tot`` slots each:
    descent, uniform block ranks and the ``arm`` lookup, then the dedup of
    node pairs capped at ``targets``, the lookup misses masked out.  With an
    exact ``budget`` (then a_tot == budget) each node pair also passes the
    acceptance thinning.  Returns ``(snode, dnode, take, counts)`` on the
    plan's device."""
    gc = gids.numel()
    dev = gids.device
    s0, s1 = seed = ops.counter_seed(rkey)
    local = torch.arange(gc * a_tot, dtype=torch.int64, device=dev) // a_tot
    gid = gids.to(torch.int64)[local]
    if arm == "kernel":
        scfg, dcfg, snode, dnode = ops.quilt_prng_descent_lookup(
            seed, gids, plan.cum, plan.table_cfg, plan.table_node,
            a_tot=a_tot, num_blocks=plan.B, ranks=True,
        )
    else:
        slot = torch.arange(gc * a_tot, dtype=torch.int64, device=dev) - local * a_tot
        u = ops.descent_uniforms(s0, s1, gid, slot, plan.d)
        kb, lb = (r.to(torch.int64) for r in ops.rank_pair(s0, s1, gid, slot, plan.B))
        del slot
        scfg, dcfg = kpgm._descend(u, plan.cum)
        del u
        sc, dc = scfg.to(torch.int64), dcfg.to(torch.int64)
        if arm == "bycfg":
            # rank kb names config x's kb-th node directly (a hit iff kb < c_x)
            cs, cd = plan.cfg_count[sc].to(torch.int64), plan.cfg_count[dc].to(torch.int64)
            idx_s = plan.cfg_offset[sc] + torch.minimum(kb, torch.clamp_min(cs - 1, 0))
            idx_d = plan.cfg_offset[dc] + torch.minimum(lb, torch.clamp_min(cd - 1, 0))
            miss = torch.full((), -1, dtype=torch.int32, device=dev)
            snode = torch.where(kb < cs, plan.cfg_nodes[idx_s], miss)
            dnode = torch.where(lb < cd, plan.cfg_nodes[idx_d], miss)
        else:
            flat = plan.inv.reshape(-1)
            snode = flat[(kb << plan.d) | sc]
            dnode = flat[(lb << plan.d) | dc]
    valid = (snode >= 0) & (dnode >= 0)
    if budget is not None:
        pair = snode.to(torch.int64) * (1 << node_bits) + dnode.to(torch.int64)
        valid = valid & quilt._exact_cell_valid(
            quilt.accept_salt(rkey, dev), gid, scfg, dcfg, plan.thetas, budget,
            log_extra=2.0 * math.log(plan.B), cell=pair,
        )
    cum_asks = torch.arange(1, gc + 1, dtype=torch.int64, device=dev) * a_tot
    take, counts = dedup.segmented_unique_mask(
        local, snode, dnode, cum_asks, targets, node_bits=node_bits, valid=valid
    )
    return snode, dnode, take, counts


def _propose_host(key: torch.Tensor, plan: quilt.QuiltPlan, ask: int, cuts=()) -> Tuple[np.ndarray, np.ndarray]:
    """One host-loop batch of ``ask`` proposals: the flat node pairs
    ``snode * n + dnode`` of the accepted ones in proposal order, and for
    each proposal index in ``cuts`` the number accepted before it, as host
    int64 arrays.  The uniforms are ``kpgm.sample_edge_batch``'s threefry
    draw (``plan.cum`` is its level table), the block ranks
    ``prng.randint``; on the plan's device the kernel
    ``quilt_descent_lookup`` descends and looks up each proposal (a miss on
    either side is the rejection), and only the accepted pairs are copied."""
    uk, kk = prng.split(key)
    kl = prng.randint(kk, (ask, 2), 0, plan.B, device=plan.device)
    lookup = (kl[:, 0].contiguous(), kl[:, 1].contiguous(), plan.table_cfg, plan.table_node, plan.inv)
    del kl
    _, _, sn, dn = kpgm.descend_draw(uk, plan.cum, ask, lookup=lookup)
    ok = (sn >= 0) & (dn >= 0)
    flat = sn[ok].to(torch.int64) * plan.n + dn[ok].to(torch.int64)
    accepted = torch.cumsum(ok, 0)
    before = torch.cat([accepted.new_zeros(1), accepted])[torch.as_tensor(cuts, dtype=torch.int64, device=ok.device)]
    return flat.cpu().numpy(), before.cpu().numpy()


def _fresh(flat: np.ndarray, seen: np.ndarray) -> np.ndarray:
    """The first occurrences in ``flat`` not in ``seen``, in arrival order;
    the time counts in ``kpgm.HOST_DEDUP_SECONDS``."""
    t0 = time.perf_counter()
    out = flat[kpgm._arrival_fresh(flat, seen)]
    kpgm.HOST_DEDUP_SECONDS += time.perf_counter() - t0
    return out


def _balldrop_sample_host(
    key: torch.Tensor, plan: quilt.QuiltPlan, *, target: int, max_rounds: int, oversample: float
) -> np.ndarray:
    """The host loop: the same rejection process as the device rounds in
    rounds of at most ``DEVICE_MAX_CANDIDATES`` proposals, deduped on the
    host in arrival order until ``target`` node pairs are held.  Returns
    (E, 2) int64."""
    n = plan.n
    target = min(int(target), n * n)
    if target <= 0 or plan.B == 0:
        return np.zeros((0, 2), dtype=np.int64)
    seen = np.empty((0,), dtype=np.int64)
    for _ in range(max_rounds):
        need = target - seen.size
        if need <= 0:
            break
        ask = min(dedup.bucket_size(int(need * oversample * plan.bd_cost) + 16), kpgm.DEVICE_MAX_CANDIDATES)
        key, sub = prng.split(key)
        flat, _ = _propose_host(sub, plan, ask)
        seen = np.concatenate([seen, _fresh(flat, seen)])
    seen = seen[:target]
    return np.stack([seen // n, seen % n], axis=1)


def _host_balldrop_topup(
    key: torch.Tensor,
    plan: quilt.QuiltPlan,
    targets: np.ndarray,
    counts: np.ndarray,
    seen_pairs: List[np.ndarray],
    tail: List[Tuple[int, np.ndarray]],
    max_rounds: int,
    oversample: float,
) -> np.ndarray:
    """Finish the shortfall the device rounds left: shared proposal batches
    split across the samples that need edges, each sample's chunk deduped
    on the host against the node pairs it holds; ``(sample, (E, 2))``
    pieces go to ``tail``.  Returns the per-sample counts."""
    n = plan.n
    for _ in range(max_rounds):
        needs = targets - counts
        if needs.max(initial=0) <= 0:
            break
        asks, batch = dedup.plan_asks(needs, oversample * plan.bd_cost)
        key, sub = prng.split(key)
        flat, ends = _propose_host(sub, plan, batch, cuts=np.cumsum(asks))
        DISPATCH_COUNTERS["host_topup_rounds"] += 1
        for g, ask in enumerate(asks):
            if ask == 0:
                continue
            chunk = flat[(ends[g - 1] if g else 0) : ends[g]]
            fresh = _fresh(chunk, seen_pairs[g])[: int(needs[g])]
            if fresh.size == 0:
                continue
            seen_pairs[g] = np.concatenate([seen_pairs[g], fresh])
            counts[g] += fresh.size
            tail.append((g, np.stack([fresh // n, fresh % n], axis=1)))
    return counts


def balldrop_run(
    key: torch.Tensor,
    plan: quilt.QuiltPlan,
    *,
    num_samples: int = 1,
    targets: Optional[np.ndarray] = None,
    max_rounds: int = 8,
    oversample: float = 1.05,
    use_kernel: Optional[bool] = None,
    mesh=None,
    exact_cells: Optional[bool] = None,
) -> quilt.QuiltRun:
    """Run the ball-dropping engine of ``plan`` for ``key`` on the plan's
    device (the ``backend="balldrop"`` arm of ``quilt.quilt_run``).

    ``targets`` are per sample and default to independent N(bd_mean,
    bd_std) draws; ``exact_cells`` (default: on without explicit targets)
    takes the exact-cell round while ``num_samples * budget`` fits
    ``DEVICE_MAX_CANDIDATES``, else counts an ``exact_fallbacks`` and takes
    the drawn-target rounds.  A first ask over that cap runs the host loop
    for one sample and raises ``quilt.DeviceBatchUnavailable`` for several.
    ``use_kernel`` None or True looks the ranks up through the kernel
    wrapper, False through the dense inverse or the by-config tables.
    Raises ``ValueError`` for a plan without ball-dropping moments.

    ``mesh=`` shards the S sample streams as ``quilt.quilt_run`` shards its
    graphs (the same layout, gathers and degrade-and-rerun on a
    ``DeviceLoss``, counted in this module's ``DISPATCH_COUNTERS``).
    """
    S = int(num_samples)
    if S < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    n = plan.n
    if plan.bd_cost is None:
        raise ValueError(_UNAVAILABLE)
    targets_given = targets is not None
    arm = _lookup_arm(plan, use_kernel)

    exact = (not targets_given) if exact_cells is None else bool(exact_cells)
    exact = exact and not targets_given and plan.B > 0
    budget = None
    if exact:
        # a proposal hits a given node pair with pi = p_xy / (m B^2): the
        # descent picks the config cell, the two ranks the occurrence ranks
        budget = quilt._exact_budget(plan.p_max, plan.mean_edges * float(plan.B) ** 2)
        if budget is None or S * budget > kpgm.DEVICE_MAX_CANDIDATES:
            DISPATCH_COUNTERS["exact_fallbacks"] += 1
            exact, budget = False, None

    key, sub = prng.split(key)
    if exact:
        targets = np.full(S, budget, dtype=np.int64)
    elif targets is None:
        # float32 draws times Python floats stay float32, as the reference's numpy
        draws = prng.normal(sub, (S,)).numpy() * plan.bd_std + plan.bd_mean
        targets = np.clip(np.round(draws), 0, n * n).astype(np.int64)
    else:
        targets = np.clip(np.asarray(targets, dtype=np.int64).reshape(S), 0, n * n)
    total = int(targets.sum())

    mesh, axes, s_pad = quilt._mesh_layout(mesh, S)
    ask0 = budget if exact else dedup.uniform_ask(targets, oversample * plan.bd_cost)
    # layout-invariant device decision, as quilt_run's (S, not s_pad)
    if not (exact or S * ask0 <= kpgm.DEVICE_MAX_CANDIDATES):
        if S > 1:
            raise quilt.DeviceBatchUnavailable(
                f"ball-dropping batch over the device budget (candidates={S * ask0})"
            )
        edges = _balldrop_sample_host(
            key, plan, target=int(targets[0]), max_rounds=max_rounds, oversample=oversample
        )
        st = quilt.QuiltStats(
            B=plan.B, num_kpgm_draws=0, kpgm_edges_total=int(edges.shape[0]),
            kept_edges=int(edges.shape[0]), heavy_groups=0, light_nodes=n, bprime=None,
        )
        return quilt.QuiltRun(
            plan, targets, np.zeros(S, np.int64), None, None, None, 0, (), edges, st,
            num_samples=1, sampler="balldrop",
        )

    tail: List[Tuple[int, np.ndarray]] = []
    counts = np.zeros(S, dtype=np.int64)
    shortfall = targets.copy()
    outs = None
    key, rkey = prng.split(key)
    a_tot = 0
    nb = quilt._node_bits(n)
    if total > 0:
        gids, tdev = quilt._pad_inputs(S, s_pad, targets, budget, plan.device)
        for r in range(1 if exact else max_rounds):
            chaos.maybe_fail("quilt.round")
            ask = budget if exact else dedup.uniform_ask(shortfall, oversample * plan.bd_cost)
            if ask == 0:
                break
            if a_tot and S * (a_tot + ask) > kpgm.DEVICE_MAX_CANDIDATES:
                # the cumulative stream would outgrow the device budget: the
                # host top-up finishes the residual
                break
            a_tot += ask
            while True:
                try:
                    chaos.maybe_fail("quilt.dispatch")
                    lo, hi = quilt._shard_rows(mesh, axes, s_pad)
                    outs = _bd_round_body(
                        rkey, gids[lo:hi], tdev[lo:hi], plan, a_tot=a_tot, node_bits=nb, arm=arm,
                        budget=budget,
                    )
                    break
                except chaos.DeviceLoss as exc:
                    # quilt_run's recovery: the sample streams are layout-invariant too
                    mesh, axes, s_pad = quilt._degrade_layout(mesh, exc, S, DISPATCH_COUNTERS)
                    gids, tdev = quilt._pad_inputs(S, s_pad, targets, budget, plan.device)
            DISPATCH_COUNTERS["device_rounds" if r == 0 else "device_topup_rounds"] += 1
            counts = quilt._gather_rows(outs[3], mesh, axes)[:S].cpu().numpy().astype(np.int64)
            shortfall = np.zeros_like(targets) if exact else targets - counts
            if shortfall.max(initial=0) <= 0:
                break

    snode = dnode = keep = None
    if outs is not None:
        # the dedup's valid mask already excludes the misses: taken rows are
        # accepted balls
        snode, dnode, keep = (quilt._gather_rows(x, mesh, axes) for x in outs[:3])
        if shortfall.max(initial=0) > 0:
            DISPATCH_COUNTERS["degraded_fallbacks"] += 1
            warnings.warn(
                f"device rounds exhausted (max_rounds={max_rounds}, {a_tot} slots/sample) with "
                f"{int(shortfall.sum())} edges still short: finishing the residual with the host "
                "ball-dropping loop (raise max_rounds or oversample to stay device-resident)",
                RuntimeWarning,
                stacklevel=2,
            )
            flat = (snode[keep].to(torch.int64) * n + dnode[keep].to(torch.int64)).cpu().numpy()
            seen = list(np.split(flat, np.cumsum(counts)[:-1]))
            counts = _host_balldrop_topup(key, plan, targets, counts, seen, tail, max_rounds, oversample)
    if exact:
        targets = counts.copy()
    return quilt.QuiltRun(
        plan, targets, counts, snode, dnode, keep, a_tot, tuple(tail), None, None,
        num_samples=S, sampler="balldrop",
    )
