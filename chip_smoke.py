#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from src/repro_torch/csrc, holds it against its plain
PyTorch version on the card, checks a session on the card against the same
session on the CPU, then drives the default MAGM session at full size
(n = 2^15, THETA_1, mu = 0.5, d = 15: 49 block-pair graphs x 528,283
candidates in one exact-cell round) and times it.  Exits non-zero, with no
result line, when there is no CUDA device or any phase fails.

Output, last three lines: the card's name and power limit as nvidia-smi
reports them, one JSON object with every kernel of the main path, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import MAGMSampler, SamplerConfig  # noqa: E402
from repro_torch.configs.magm_paper import DEFAULT_MU, THETA_1  # noqa: E402
from repro_torch.core import kpgm, magm, prng, quilt  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import quadrant_descent as qd  # noqa: E402

FULL_LOG2_N = 15  # the largest paper configuration the exact path runs
CHECK_LOG2_N = 12  # tables fit shared memory; small enough for the CPU
SEED = 0

# H100 SXM peaks: HBM 3.35 TB/s (NVIDIA data sheet); 32-bit operations at
# 128 lanes per SM x 132 SMs x 1.98 GHz = 33.5 T ops/s, half the 67 TFLOP/s
# float32 rate (which counts an FMA as two): integer multiplies issue on the
# FMA pipe beside the 64 INT32 lanes, so no mix of 32-bit ops goes faster
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 128 * 132 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def paper_config(log2_n: int, device) -> SamplerConfig:
    params = magm.make_params(THETA_1, DEFAULT_MU, log2_n)
    return SamplerConfig(
        params=params, num_nodes=1 << log2_n,
        attribute_key=prng.PRNGKey(SEED), device=device,
    )


def round_inputs(plan: quilt.QuiltPlan, key):
    """The kernel's arguments exactly as the session's round passes them."""
    key, _ = prng.split(key)
    _, rkey = prng.split(key)
    budget = quilt._exact_budget(plan.p_max, plan.mean_edges)
    gids = torch.arange(plan.num_graphs, dtype=torch.int32, device=plan.device)
    args = (ops.counter_seed(rkey), gids, plan.cum, plan.table_cfg, plan.table_node)
    return args, dict(a_tot=budget, num_blocks=plan.B)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_bound_ms(plan: quilt.QuiltPlan, rows: int) -> tuple:
    """Least time for the kernel's work on this card: its int32 operations
    at the int32 peak, or its bytes (outputs written once, inputs read once)
    at the HBM rate, whichever is larger.  Operations per row, counted from
    the source: a level's counter hash 20, the uniform 3, the quadrant
    compares 5, the bit updates 5, loop control 2 (35 per level); a search
    step 10, twice per row; 80 for the row decode, block decode and stores.
    The searches run a fixed number of steps, so the count does not depend
    on the data."""
    steps = max(plan.table_cfg.shape[1] - 1, 1).bit_length() + 1
    ops_ = rows * (35 * plan.d + 2 * 10 * steps + 80)
    bytes_ = rows * 16 + plan.table_cfg.numel() * 8 + plan.num_graphs * 4 + plan.d * 16
    t_ops, t_bytes = ops_ / INT32_OPS_PER_S * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernel_vs_plain(device) -> dict:
    """The CUDA kernel against its plain version, ranks False and True, with
    the tables in shared memory (n = 2^12) and in global memory (2^15)."""
    errs = []
    for log2_n in (CHECK_LOG2_N, FULL_LOG2_N):
        s = MAGMSampler(paper_config(log2_n, device))
        args, kw = round_inputs(s.plan, prng.PRNGKey(SEED + 1))
        smem = qd.tables_in_shared_memory(s.plan.table_cfg)
        for ranks in (False, True):
            got = qd.quilt_prng_descent_lookup(*args, ranks=ranks, **kw)
            want = qd.quilt_prng_descent_lookup_plain(*args, ranks=ranks, **kw)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"kernel != plain at n=2^{log2_n}, ranks={ranks}: "
                        f"{int((g != w).sum())} rows differ"
                    )
                errs.append(int((g.long() - w.long()).abs().max()))
            log(f"kernel == plain: n=2^{log2_n} ranks={ranks} rows={got[0].numel()} "
                f"tables_in_smem={smem}")
    return {"max_abs_err": max(errs)}


def phase_cross_device(device) -> None:
    """One session at n = 2^12 on the card and on the CPU, same F and key:
    alpha, edges and stats must be equal (the port's float32 math is the
    same on both devices)."""
    cuda_s = MAGMSampler(paper_config(CHECK_LOG2_N, device))
    cpu_s = MAGMSampler(paper_config(CHECK_LOG2_N, "cpu"))
    if not np.array_equal(cuda_s.F, cpu_s.F):
        raise AssertionError("attributes drawn on the card differ from the CPU's")
    key = prng.PRNGKey(SEED + 2)
    got, want = cuda_s.sample(key), cpu_s.sample(key)
    args, kw = round_inputs(cuda_s.plan, key)
    scfg, dcfg = qd.quilt_prng_descent_lookup(*args, **kw)[:2]
    a_dev = quilt._exact_alpha(scfg, dcfg, cuda_s.plan.thetas, kw["a_tot"]).cpu()
    a_cpu = quilt._exact_alpha(scfg.cpu(), dcfg.cpu(), cpu_s.plan.thetas, kw["a_tot"])
    alpha_diff = int((a_dev != a_cpu).sum())
    flips = len({tuple(e) for e in got.edges.tolist()} ^ {tuple(e) for e in want.edges.tolist()})
    log(f"cross-device n=2^{CHECK_LOG2_N}: edges cuda={got.num_edges} cpu={want.num_edges} "
        f"alpha mismatches={alpha_diff} band flips={flips}")
    if alpha_diff or flips or not np.array_equal(got.edges, want.edges):
        raise AssertionError("the card's session differs from the CPU's")
    if tuple(got.stats) != tuple(want.stats):
        raise AssertionError(f"stats differ: {got.stats} vs {want.stats}")


def stage_breakdown(sampler, args, kw) -> None:
    """Device ms of each stage of one warm round, timed one by one with the
    round's own inputs (the sum can differ from sample()'s host-clock time)."""
    plan = sampler.plan
    budget = kw["a_tot"]
    key, _ = prng.split(prng.PRNGKey(SEED + 3))
    _, rkey = prng.split(key)
    scfg, dcfg, snode, dnode = qd.quilt_prng_descent_lookup(*args, **kw)
    dev = scfg.device
    local = torch.arange(scfg.numel(), device=dev) // budget
    cell = scfg.long() * (1 << plan.d) + dcfg.long()
    salt = quilt.accept_salt(rkey, dev)
    alpha = quilt._exact_alpha(scfg, dcfg, plan.thetas, budget)
    valid = (snode >= 0) & (dnode >= 0) & (quilt._accept_u01(salt, local, cell) < alpha)
    cum_asks = torch.arange(1, plan.num_graphs + 1, device=dev) * budget
    targets = torch.full((plan.num_graphs,), budget, device=dev)
    take, _ = quilt.dedup.segmented_unique_mask(
        local, scfg, dcfg, cum_asks, targets, node_bits=plan.d, valid=valid
    )
    keep = take & (snode >= 0) & (dnode >= 0)
    stages = {
        "lookup_kernel": lambda: qd.quilt_prng_descent_lookup(*args, **kw),
        "alpha": lambda: quilt._exact_alpha(scfg, dcfg, plan.thetas, budget),
        "accept_hash": lambda: quilt._accept_u01(salt, local, cell),
        "dedup": lambda: quilt.dedup.segmented_unique_mask(
            local, scfg, dcfg, cum_asks, targets, node_bits=plan.d, valid=valid
        ),
        "edges_to_host": lambda: torch.stack([snode[keep], dnode[keep]], 1).long().cpu(),
    }
    log("stage_ms " + " ".join(f"{k}={cuda_ms(f, reps=3)}" for k, f in stages.items()))


def phase_full_size(device) -> dict:
    """The main path at full size through the public entry points."""
    t0 = time.perf_counter()
    sampler = MAGMSampler(paper_config(FULL_LOG2_N, device))
    plan = sampler.plan
    budget = quilt._exact_budget(plan.p_max, plan.mean_edges)
    rows = plan.num_graphs * budget
    log(f"plan n=2^{FULL_LOG2_N}: B={plan.B} L={plan.table_cfg.shape[1]} budget={budget} "
        f"candidates/round={rows} build_s={time.perf_counter() - t0:.3f}")
    if rows > kpgm.DEVICE_MAX_CANDIDATES:
        raise AssertionError("the full-size round would leave the exact path")

    fallbacks = quilt.DISPATCH_COUNTERS["exact_fallbacks"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    gs = sampler.sample(prng.PRNGKey(SEED + 3))
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    if quilt.DISPATCH_COUNTERS["exact_fallbacks"] != fallbacks:
        raise AssertionError("the full-size sample left the exact path")
    if launches["quilt_prng_descent_lookup"] < 1:
        raise AssertionError("the main path did not launch quilt_prng_descent_lookup")
    e = gs.edges
    n = 1 << FULL_LOG2_N
    if e.ndim != 2 or e.shape[1] != 2 or e.shape[0] != gs.stats.kept_edges or e.shape[0] == 0:
        raise AssertionError(f"bad edge array {e.shape} for stats {gs.stats}")
    if e.min() < 0 or e.max() >= n:
        raise AssertionError("edge ids outside [0, n)")
    if np.unique(e[:, 0] * n + e[:, 1]).size != e.shape[0]:
        raise AssertionError("duplicate edges")
    log(f"sample n=2^{FULL_LOG2_N}: edges={e.shape[0]} stats={tuple(gs.stats)} "
        f"launches={launches} peak_mem_bytes={peak}")

    walls, events = [], []
    for i in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        sampler.sample(prng.PRNGKey(SEED + 10 + i))  # ends in a copy to the host
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        events.append(start.elapsed_time(end))
    sample_ms = statistics.median(events)

    args, kw = round_inputs(plan, prng.PRNGKey(SEED + 3))
    k_ms = cuda_ms(lambda: qd.quilt_prng_descent_lookup(*args, **kw), reps=20)
    p_ms = cuda_ms(lambda: qd.quilt_prng_descent_lookup_plain(*args, **kw), reps=3)
    bound, bound_by = kernel_bound_ms(plan, rows)
    log(f"timing n=2^{FULL_LOG2_N}: kernel_ms={k_ms} plain_ms={p_ms} bound_ms={bound} ({bound_by}) "
        f"sample_ms_median5={sample_ms} sample_ms_events={events} sample_ms_host_clock={walls} candidates={rows} "
        f"edges={e.shape[0]} max_memory_allocated={peak}")
    stage_breakdown(sampler, args, kw)
    return {
        "launches": launches["quilt_prng_descent_lookup"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = nvidia_smi()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    qd._library()
    log(f"build: {time.perf_counter() - t0:.2f}s (nvcc {_build.BUILD_SECONDS['quilt_prng_descent_lookup']:.2f}s)")
    for line in _build.BUILD_LOG.get("quilt_prng_descent_lookup", "").splitlines():
        log(f"  ptxas: {line}")

    check = phase_kernel_vs_plain(device)
    phase_cross_device(device)
    full = phase_full_size(device)

    kernels = [{
        "name": "quilt_prng_descent_lookup",
        "route": "cuda",
        "source": "src/repro_torch/csrc/quilt_prng_descent_lookup.cu",
        "replaces": "src/repro/kernels/quadrant_descent.py:516",
        "launches": full["launches"],
        "max_abs_err": check["max_abs_err"],
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }]
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
