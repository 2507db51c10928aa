#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel from src/repro_torch/csrc (one nvcc per source, all
at once) and holds each against its plain PyTorch version on the card, then
drives the port's paths through their public entry points, each with the
launch counts set to 0 just before and read just after:

- the default MAGM session at full size (n = 2^15, THETA_1, mu = 0.5,
  d = 15: 49 block-pair graphs x 528,283 candidates in one exact-cell
  round), checked against the same session on the CPU at n = 2^12; the
  round's acceptance kernel exact_accept against its plain version on that
  round, timed beside its bound;
- the naive O(n^2) baseline on the session's F (1.07e9 Bernoulli trials in
  256 tiles of 2048^2), with the expected edge count sum Q and its sigma
  computed tile by tile through the magm_logprob kernel: the naive count
  and the quilting count must both lie within 4 sigma of sum Q; the naive
  baseline on the card against the CPU at n = 2^10;
- MAGFIT's dense scoring (dense_expected_logprob, elbo_dense) through the
  magm_logprob kernel, one (2^13)^2 launch;
- both tile kernels against their plain versions at the shapes of
  TILE_CHECKS (ragged edges, d = 0, d > 32, unaligned F bases, odd log-u
  strides, 2048^2, 8192^2), timed at 2048^2 and 8192^2 with a warm and a
  cold L2;
- the counter-PRNG KPGM edge batch (2^25 edges) through
  quadrant_descent_prng;
- the uniforms-operand kernels quadrant_descent (2^24 rows at d = 16, and a
  ragged count) and quilt_descent_lookup in both arms (through the plan's
  dense inverse, and searching the tables: one draw chunk and a ragged
  count with the n = 2^16 tables in L2, and with the n = 2^12 tables in
  shared memory; random block ids, and at n = 2^16 the host path's
  graph-contiguous ones) against their plain versions, both arms timed at
  4,194,304 rows of d = 16 with both rank patterns;
- the default MAGM session at n = 2^16, whose exact round would pass
  DEVICE_MAX_CANDIDATES, so it takes the host path (threefry batches through
  quilt_descent_lookup's inverse arm, arrival-order dedup on the host): every graph's
  distinct-cell count against its drawn target, the edge count's z against
  sum Q;
- KPGMSampler(backend="host") at d = 20 (~40 M edges) through
  quadrant_descent, its edge count against its drawn target;
- MAGMSampler(exact_cells=False) at n = 2^15, the ranked device rounds;
- the card against the CPU at n = 2^12, bit for bit, for backend="host",
  exact_cells=False, explicit targets, and KPGMSampler ("auto" and "host");
- the device-native PRNG edge batch (sample_edge_batch_prng(tpu_native=True))
  through quadrant_descent_native, an in-kernel Philox4x32-10, bit for bit
  against its plain version at 2^25 slots (d = 15), timed beside
  quadrant_descent_prng, and the law of both streams at d = 6 over 2^24
  slots (a chi-square and the max |z| over the 4096 cells, the per-level
  quadrant fractions);
- ball dropping (backend="balldrop") at n = 2^15 (one exact round through
  quilt_prng_descent_lookup with ranks=True; the count within 4 sigma of
  bd_mean) and at n = 2^16 (the host loop: proposals descended and looked
  up by quilt_descent_lookup on the card, the accepted node pairs copied to
  the host and deduped there; no quadrant_descent), and the card against
  the CPU at n = 2^12 in every mode and lookup arm, the host loop in both
  arms of quilt_descent_lookup;
- the section-5 split (split=True) at n = 2^15, THETA_1, mu = 0.5 (B' = 3:
  a 9-graph light quilt through quilt_prng_descent_lookup, 92.5 K heavy
  proposals) and mu = 0.8 (B' = 1: ~24 M heavy proposals): plan, gates (the
  count within 4 sigma of sum Q, the heavy part's within 4 sigma of
  heavy_mean), timings by stage, the idle share, and the kernel against its
  plain version on the light plan's round; the split (three configurations,
  the host-binomial fallback, quilt_sample_fast(seed=)), sample_batch(4) of
  MAGM and KPGM sessions and sample_stream of the default, split and KPGM
  sessions on the card against the CPU at n = 2^12; sample_batch(4) at
  n = 2^15 (as configured, and fused with backend="device"), KPGM d = 16
  sample_batch(4) and the n = 2^15 stream in chunks of 2^16;
- the 3-sigma validation suite on the card: THETA_2, n = 2^12, 16 seeds of
  each of "auto", "host", "balldrop" and "split", every pair of backends and
  auto against split, and each against the closed-form moments, no failed
  claim;
- resilience and serving: checkpointed streams (chunks of 2^16) of the
  n = 2^15 default session, the split at mu = 0.5 and KPGM d = 16 with
  num_edges, each killed at chunk 4 (a FaultSchedule on stream.chunk),
  resumed by a fresh session and killed again at visit 6, then resumed to
  the end: equal to sample(key), with no byte left on the card by the kill;
  card -> CPU and CPU -> card resumes at n = 2^12; a fault inside a save
  (checkpoint.rename); the GraphServer over the n = 2^15 session: a burst of
  12 seeds against max_queue = 4 (typed responses, accepted + shed = 12, ok
  edges equal to sample(), p99 latency within (max_queue + 1) x the longest
  service), 8 requests in turn (p50/p99, edges/s), an InjectedFault retried
  to ok, a DeviceLoss answered 500 then ok, an expired deadline answered
  408 with no launch, garbage answered 400, and the serve CLI;
- MAGFIT (phase_magfit): at n = 2^10, d = 3 elbo (and elbo_dense through
  magm_logprob), the M-step statistics, estep, mstep and a known-F magfit
  on the card against the CPU port, estep and the fit twice bit for bit;
  benchmarks/bench_fit.py's rows on the card (n = 2^12, d = 4, ~1.45 M
  exact edges: one 10-step estep with its idle share, a known-F fit of
  8 EM iterations); the reference's recovery claim (n = 2^12, d = 5,
  order 4, 24 bootstrap replicates: every canonical theta within 3 sigma);
  the round trip at the paper's setting (recover of THETA_1, mu = 0.5,
  n = 2^12 through the session, api.fit_config on its edges, a resample of
  the fitted config: kernel 1 launched at least twice); one estep and one
  mstep at n = 2^13, d = 13 (n 2^d = 2^26) with peak memory;
- LM serving, dense family (phase_lm; no CUDA kernel of its own: PyTorch
  ops in a layer loop): serve_lm at the reference CLI's default, full
  olmo-1b (16 layers, d = 2048, 1.18 B params) in bf16, batch 4, prompt
  32, 16 generated tokens; prefill and decode-step ms by CUDA events (as
  the loop sees them, and behind a spin kernel), the generation's
  tokens/s, a decode step's idle share, peak memory, each beside its
  bound (analysis.roofline: the decode step's weights and cache over the
  HBM rate); gates: finite logits, decode parity at full width (0.05 x
  max|logit|), the four dense smoke configs card == CPU port in float32
  (no TF32) and bf16 to the CPU tests' bounds, one float32 prefill of
  full-width olmo-1b card == CPU port, the chunked weight draw on the card
  bit-equal to the CPU's, and dedup.segmented_unique card == CPU on the
  n = 2^12 plan's candidate stream;
- LM training, dense family (phase_train; PyTorch ops, kernel 1 in the
  corpus): on phase_lm's full olmo-1b weights, a MAGMCorpus at the train
  CLI's default n = 2^12 (kernel 1's launches read around its build),
  three train steps at batch 8 x 128 (finite loss and grad norm, step ms
  by CUDA events); gates: the four dense smoke configs' gradients and one
  train step card == CPU port in float32 (no TF32), and flash attention's
  backward card == CPU at one multi-chunk GQA shape;
- the LM families (phase_families; PyTorch ops, kernel 1 in the corpus):
  the smoke configs of phi3.5-moe, mixtral, falcon-mamba, zamba2,
  llama-3.2-vision and whisper in float32 (no TF32) on the card against
  the CPU port (forward and prefill logits, the cache, four decode steps,
  the MoE routes, the loss and every gradient of one train step; the
  vlm's cross gates at 0.5 with a random context); then full zamba2-2.7b
  uncut (2.34 B params): serve_lm at the CLI's defaults with its timings
  and gates 1-2, and three train steps at 8 x 128 on a MAGMCorpus at
  n = 2^12 (kernel 1's launches read around its build), the loss finite
  and the batch-0 loss falling.

Exits non-zero, with no result line, when there is no CUDA device or any
phase fails.  Output, last three lines: the card's name and power limit as
nvidia-smi reports them, one JSON object with every kernel, and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --tiles

builds the kernels and runs the tile phase alone (both tile kernels against
their plain versions at every shape of TILE_CHECKS, timed at 2048^2 and
8192^2 with a warm and a cold L2), so that the tile kernels of two trees can
be compared in one call.

    python3 chip_smoke.py --accept

builds the kernels and runs exact_accept's check and timing alone (the
kernel against its plain version on the exact cell's round at n = 2^15,
timed beside its bound and the plain version).

    python3 chip_smoke.py --lookup

builds the kernels and runs quilt_descent_lookup's checks and timings alone
(both arms against the plain version at n = 2^16 and 2^12, timed at the
main-path shape with random and graph-contiguous block ids).

    python3 chip_smoke.py --split

builds the kernels and runs the split, batch and stream phases and the
3-sigma suite alone.

    python3 chip_smoke.py --serve

builds the kernels and runs the resilience and serving phase alone.

    python3 chip_smoke.py --fit

builds the kernels and runs the MAGFIT phase alone.

    python3 chip_smoke.py --lm

builds the kernels and runs the LM phase, then serve_lm at full width for
qwen3-14b (40 layers, ~28 GB of bf16 weights) and yi-9b (48 layers), and
the serve loop for deepseek-67b at full width with its depth cut to
LM_DEEPSEEK_LAYERS of 95 (one card holds 80 GB).

    python3 chip_smoke.py --train

builds the kernels and trains full olmo-1b (16 layers, d = 2048, 1.18 B
params, bf16 weights, AdamW with float32 state): on a MAGMCorpus at
n = 2^15 (build seconds, kernel 1's launches), 20 steps at the train CLI's
batch 8 x 128 (the loss falls) and 6 at train_4k's sequence of 4096 with
its global batch cut from 256 to 4, each with step ms by CUDA events,
tokens/s, MFU and the share of analysis.roofline.train_step_bound_ms, a
profiled step's idle share and top device ops, its host syncs and peak
memory; then the supervisor gate (olmo-1b at full width cut to 2 layers:
14 steps with an InjectedFault before step 9 and checkpoints every 5 end
bit-equal to an uninterrupted run) and the train CLI on the card (the
smoke config, and full olmo-1b when the disk holds its ~16.5 GB
checkpoints), its checkpoints in a temporary directory removed after.

    python3 chip_smoke.py --families [arch ...]

builds the kernels, runs the families' smoke gate (card == CPU), then
serves each arch (default: the six of FAMILY_SERVE_LAYERS) at full width
at the serve CLI's defaults, its depth cut only where one 80 GB card
forces it (FAMILY_SERVE_LAYERS), with prefill and decode ms, tokens/s and
the decode step's byte bound, and trains it FAMILY_TRAIN_STEPS steps at
8 x 128 where AdamW's state fits (FAMILY_TRAIN_LAYERS): step ms, MFU, the
step's bound, peak memory, the batch-0 loss falling.

    python3 chip_smoke.py --dryrun

builds the kernels and checks the multi-chip dry-run (launch/dryrun.py):
(a) the ten archs' rows at decode_32k on the 16x16 fake mesh (modelled
at the data sheet's peaks, logged); (a') olmo-1b's train_4k on 16x16
and 2x16x16 and its decode_32k on 2x16x16 (DRYRUN_PRODUCTION), each a
gate, so that the card host's torch traces the production cells; (b) the
1-device dry-run of full
olmo-1b at the full run's train 8 x 128 and decode batch 4 against the
same steps on the card: the traced FLOPs equal, the predicted peak above
the step's inputs within DRYRUN_PEAK_REL of the max_memory_allocated
delta, and no CUDA-event step time below its row's t_ideal or modelled
step; (c) compressed_grad_allreduce over a world-size-1 NCCL group bit
for bit against the CPU's over gloo.  It exits non-zero when a gate fails.

    python3 chip_smoke.py --lint

builds the kernels and checks the linter (repro_torch.lint) against what
the card does: (a) the static half, no finding over src/repro_torch, with
the rule catalog; (b) the runtime halves on warm calls at full size (two
warm calls on keys 0 and 1, then one on key 2 under three instruments: the
sync debug mode's sites, torch.profiler's host -> device copies, and counts
of nvcc runs and library loads) of the n = 2^15 default, split (mu = 0.5)
and ball-dropping sessions' sample() and sample_stream(), a KPGM host
sample at d = 20, and full olmo-1b's decode step and train step at
8 x 128.  Gates: no build or load in a warm call; every sync site inside a
step-reachable function is a line that host-sync-in-step or
dynamic-shape-in-step flags or pragmas (the other sites, the sessions' own
read-backs, are printed); no host -> device copy in the three sessions'
warm calls.  It runs first in its process: late in the full run the
profiler loses device events.

    python3 chip_smoke.py --mesh

builds the kernels and runs the sampler on a ``graphs`` mesh over a
world-size-1 NCCL group that the session starts (``mesh="auto"``): (a) the
exact session, ball dropping and the split (mu = 0.5) at n = 2^15, each
equal to the same session without a mesh on five keys, kernel 1 launched
by the mesh run, host-clock ms of both and the NCCL kernels' device ms;
(b) the 4- and 3-rank layouts' gid chunks, padding rows included, through
_round_body on the card one after another, their concatenation equal to
the whole round and kernel 1 equal to its plain version on the last chunk;
(c) kpgm_sample_distributed at d = 16 on the card mesh against the CPU
port on a gloo mesh over the same world; (d) restore(shardings=) onto the
card mesh.  It ends with the contracted line; any mismatch exits non-zero.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import ctypes
import dataclasses
import inspect
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis import validate  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    BF16_FLOPS_PER_S, HBM_BYTES_PER_S, accept_bound_ms, accept_terms_ms, descent_bound_ms, kernel_bound_ms,
    model_flops, model_min_bytes,
    native_bound_ms, tile_bound_ms, train_step_bound_ms, uniform_bound_ms,
)
from repro_torch.api import KPGMSampler, MAGMSampler, SamplerConfig  # noqa: E402
from repro_torch.api import stream as stream_mod  # noqa: E402
from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.magm_paper import DEFAULT_MU, THETA_1, THETA_2  # noqa: E402
from repro_torch.core import balldrop, dedup, f32math, kpgm, magm, naive, prng, quilt  # noqa: E402
from repro_torch.data.pipeline import MAGMCorpus  # noqa: E402
from repro_torch.dist import chaos  # noqa: E402
from repro_torch.dist import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.dist import fault  # noqa: E402
from repro_torch.api import fit_config as api_fit_config  # noqa: E402
from repro_torch.fit import magfit  # noqa: E402
from repro_torch.fit import recover as fit_recover  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import bernoulli_tile as bt  # noqa: E402
from repro_torch.kernels import magm_logprob as ml  # noqa: E402
from repro_torch.kernels import quadrant_descent as qd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import flash as lm_flash  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.models import transformer as lm_transformer  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import steps as lm_steps  # noqa: E402

FULL_LOG2_N = 15  # the largest paper configuration the exact path runs
CHECK_LOG2_N = 12  # tables fit shared memory; small enough for the CPU
NAIVE_TILE = 2048  # naive_sample's default tile
NAIVE_CHECK_LOG2_N = 10  # the naive baseline on the card against the CPU
DENSE_N = 1 << 13  # MAGFIT's dense scoring: one (n, n) magm_logprob tile
BATCH_SLOTS = 1 << 25  # the KPGM edge batch (DEVICE_MAX_CANDIDATES)
LOGQ_ATOL = 2e-4  # the reference's own log-Q tolerance (tests/test_kernels.py)
BAND = 2e-4  # a Bernoulli compare may flip only where |log u - log q| <= BAND
SEED = 0

HOST_LOG2_N = 16  # the smallest paper configuration past the exact path's cap
KPGM_D = 20  # KPGM_PLAN_MAX_NODES = 2^20: the largest identity plan
UNIFORM_ROWS = 1 << 24  # quadrant_descent against its plain version
UNIFORM_D = 16

LAW_D = 6  # the descent laws over all 4^6 cells
LAW_SLOTS = 1 << 24
SUITE_SEEDS = 16  # the 3-sigma suite's seeds per backend on the card
SPLIT_MUS = (0.5, 0.8)  # the split at n = 2^15: B' = 3 with ~92.5 K heavy proposals; B' = 1, ~24 M
KPGM_BATCH_D = 16  # KPGMSampler.sample_batch(4) at size: ~1.2 M edges a member, one fused round
# warm runs of the split at n = 2^15 by mu: the mu = 0.8 sample takes ~8 s
# (its host dedup); one run keeps the whole script within half its 1200 s
# limit (the n = 2^16 host session and the KPGM d = 20 loop time their
# profiled run as their warm run for the same reason)
SPLIT_WARM = {0.5: 3, 0.8: 1}

KERNELS = (
    "quilt_prng_descent_lookup", "quadrant_descent_prng", "magm_logprob", "bernoulli_tile",
    "quadrant_descent", "quilt_descent_lookup", "quadrant_descent_native", "exact_accept",
)

SPIN_CYCLES_PER_S = 1.98e9  # SM clock at boost: a spin of this many cycles lasts >= 1 s


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
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events.

    A spin kernel (``torch.cuda._sleep``) holds the stream while the host
    enqueues the events and the calls, so a call whose host side (Python,
    argument checks, ctypes) takes longer than its device work is timed by
    the device work, not by the host.  A call that synchronises inside is
    timed with its host side all the same."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_s * reps + 1e-3) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_kernel_ms(fn, reps: int, kernel: str):
    """Mean device time per traced launch of the CUDA kernels whose name
    holds ``kernel``, from a ``torch.profiler`` trace of ``reps`` calls (a
    trace that holds fewer launches than calls is reported); None when the
    trace shows no device time for them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the profiler's note on clearing events per cycle
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    us, count = sum(e.device_time_total for e in hits), sum(e.count for e in hits)
    if count != reps:
        log(f"profiler: {count} launches of {kernel} traced in {reps} calls")
    return us / 1e3 / count if us > 0 else None


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


def accept_inputs(plan, rkey, gids, rows, budget: int, **extra):
    """exact_accept's arguments exactly as the engines pass them."""
    args = (quilt.accept_salt(rkey, plan.device), gids, *rows, plan.thetas, plan.logt, plan.log_level_sum)
    return args, dict(a_tot=budget, budget=budget, **extra)


def stage_breakdown(sampler, args, kw) -> None:
    """Device ms of each stage of one warm round, timed one by one with the
    round's own inputs (the sum can differ from sample()'s host-clock time);
    the acceptance by the kernel exact_accept and by its plain version."""
    plan = sampler.plan
    budget = kw["a_tot"]
    key, _ = prng.split(prng.PRNGKey(SEED + 3))
    _, rkey = prng.split(key)
    scfg, dcfg, snode, dnode = rows = qd.quilt_prng_descent_lookup(*args, **kw)
    dev = scfg.device
    local = torch.arange(scfg.numel(), device=dev) // budget
    acc, acc_kw = accept_inputs(plan, rkey, args[1], rows, budget)
    valid = ops.exact_accept(*acc, **acc_kw)
    cum_asks = torch.arange(1, plan.num_graphs + 1, device=dev) * budget
    targets = torch.full((plan.num_graphs,), budget, device=dev)
    take, _ = quilt.dedup.segmented_unique_mask(
        local, scfg, dcfg, cum_asks, targets, node_bits=plan.d, valid=valid
    )
    keep = take & (snode >= 0) & (dnode >= 0)
    stages = {
        "lookup_kernel": lambda: qd.quilt_prng_descent_lookup(*args, **kw),
        "accept_kernel": lambda: ops.exact_accept(*acc, **acc_kw),
        "accept_plain": lambda: ops.exact_accept_plain(*acc, **acc_kw),
        "dedup": lambda: quilt.dedup.segmented_unique_mask(
            local, scfg, dcfg, cum_asks, targets, node_bits=plan.d, valid=valid
        ),
        "edges_to_host": lambda: torch.stack([snode[keep], dnode[keep]], 1).long().cpu(),
    }
    log("stage_ms " + " ".join(f"{k}={cuda_ms(f, reps=3)}" for k, f in stages.items()))


def phase_exact_accept(device) -> dict:
    """The kernel exact_accept against its plain version (torch.equal) on
    the exact cell's round (n = 2^15, 49 x 528,283 candidates), timed there
    beside its bound and the plain version's time (its launches on the main
    path are phase_full_size's)."""
    plan = MAGMSampler(paper_config(FULL_LOG2_N, device)).plan
    args, kw = round_inputs(plan, prng.PRNGKey(SEED + 3))
    key, _ = prng.split(prng.PRNGKey(SEED + 3))
    _, rkey = prng.split(key)
    rows = qd.quilt_prng_descent_lookup(*args, **kw)
    acc, acc_kw = accept_inputs(plan, rkey, args[1], rows, kw["a_tot"])
    got = ops.exact_accept(*acc, **acc_kw)
    want = ops.exact_accept_plain(*acc, **acc_kw)
    torch.cuda.synchronize()
    err = equal_or_raise([got], [want], f"exact_accept n=2^{FULL_LOG2_N}")
    n, hits, kept = got.numel(), int(((rows[2] >= 0) & (rows[3] >= 0)).sum()), int(want.sum())
    del want
    k_ms = cuda_ms(lambda: ops.exact_accept(*acc, **acc_kw), reps=20)
    prof_ms = profiled_kernel_ms(lambda: ops.exact_accept(*acc, **acc_kw), 10, "exact_accept_kernel")
    p_ms = cuda_ms(lambda: ops.exact_accept_plain(*acc, **acc_kw), reps=3)
    bound, bound_by = accept_bound_ms(n, hits, plan.d)
    out = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
           "bound_by": bound_by, "library_ms": None}
    log(f"timing exact_accept n=2^{FULL_LOG2_N}: {json.dumps(out)} rows={n} hits={hits} kept={kept} "
        f"profiler_kernel_ms={prof_ms} ops_bound_ms, bytes_bound_ms={accept_terms_ms(n, hits, plan.d)}")
    for line in _build.BUILD_LOG.get("exact_accept", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas exact_accept: {line.strip()}")
    return out


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
    if launches["exact_accept"] != 1:
        raise AssertionError(f"the exact round launched exact_accept {launches['exact_accept']} times, not once")
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
        "launches": launches["quilt_prng_descent_lookup"], "exact_accept_launches": launches["exact_accept"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
    }, sampler, int(e.shape[0])


def phase_build() -> None:
    """Build every kernel, one nvcc per source, all started together."""
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    log(f"build: {time.perf_counter() - t0:.2f}s wall for {len(KERNELS)} sources")
    for name in KERNELS:
        log(f"  {name}: nvcc {_build.BUILD_SECONDS[name]:.2f}s")
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            log(f"    ptxas: {line}")
    qd._library(), qd._prng_library(), ml._library(), bt._library()
    qd._descent_library(), qd._lookup_library(), qd._native_library()


def band_mismatches(got, want, logu, logq) -> tuple:
    """(mismatches, band cells) of two masks; raises on a mismatch outside
    the band |logu - logq| <= BAND."""
    diff = got != want
    band = (logu.double() - logq.double()).abs() <= BAND
    outside = int((diff & ~band).sum())
    if outside:
        raise AssertionError(f"{outside} mask cells differ outside the band")
    return int(diff.sum()), int(band.sum())


def tile_inputs(M: int, N: int, d: int, device, seed: int, off: int = 0, pad: int = 0, flat: bool = False):
    """Hard attribute rows (views ``off`` rows into their tensors), THETA_1's
    packed terms (c0 alone at d = 0; with ``flat`` its thetas raised to
    3 / d, so Q is near the size of three levels' product and masks hold
    many ones) and a log-uniform draw whose rows are N + pad apart."""
    g = torch.Generator().manual_seed(seed)
    fs = (torch.rand(M + off, d, generator=g) < DEFAULT_MU).float().to(device)[off:]
    ft = (torch.rand(N + off, d, generator=g) < DEFAULT_MU).float().to(device)[off:]
    if d:
        thetas = magm.make_params(THETA_1, DEFAULT_MU, d).thetas
        packed = ops._packed_bilinear(thetas ** (3.0 / d) if flat else thetas, device)
    else:
        packed = (*(torch.zeros(0, device=device) for _ in range(3)), torch.full((1,), -1.5, device=device))
    wide = prng.uniform(prng.PRNGKey(seed), (M, N + pad), minval=1e-38, maxval=1.0, device=device)
    return fs, ft, packed, f32math.log(wide)[:, :N]


def cuda_ms_cold(fn, reps: int) -> float:
    """Mean device time of ``fn`` with the L2 cold: before each call a read
    of a 256 MB buffer (5x the 50 MB L2) evicts what the last call left
    (its dirty lines are written back during the read, not during the
    call), then a spin holds the stream while the host enqueues the call;
    one pair of events around each call."""
    flush = torch.ones(1 << 26, device="cuda")
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(int((2 * host_s + 1e-4) * SPIN_CYCLES_PER_S))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def ptxas_usage(name: str, kernel: str) -> dict:
    """Registers, shared memory, stack and spill bytes of ``kernel`` from
    the -Xptxas -v report of this run's build of csrc/<name>.cu (empty when
    the library was loaded from an earlier build)."""
    pats = {
        "registers": r"Used (\d+) registers", "smem_bytes": r"(\d+) bytes smem",
        "stack_bytes": r"(\d+) bytes stack frame", "spill_store_bytes": r"(\d+) bytes spill stores",
        "spill_load_bytes": r"(\d+) bytes spill loads",
    }
    out, inside = {}, False
    for line in _build.BUILD_LOG.get(name, "").splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside:
            for key, pat in pats.items():
                m = re.search(pat, line)
                if m:
                    out[key] = int(m.group(1))
    return out


# (M, N, d, F row offset, extra log-u row stride) held against the plain
# versions: ragged edges with N % 4 != 0; one row and one column past the
# 128 x 128 tile; d > 32 (three 16-deep chunks) with an odd log-u stride; a
# single row; d = 0; F[1:] at d = 15 (bases not 16 B aligned) with an odd
# stride; the naive path's tile and MAGFIT's dense-scoring tile, both timed
# (at THETA_1 itself; the other shapes at its flattened thetas)
TILE_CHECKS = (
    (300, 513, 20, 0, 0), (129, 257, 15, 0, 0), (130, 70, 33, 0, 37), (1, 300, 15, 0, 0),
    (200, 300, 0, 0, 0), (NAIVE_TILE, NAIVE_TILE, 15, 1, 37), (NAIVE_TILE, NAIVE_TILE, 15, 0, 0),
    (DENSE_N, DENSE_N, 15, 0, 0),
)


def tile_timing(fs, ft, packed, logu, logq) -> dict:
    """Both tile kernels, their plain versions, one float32 matmul of the
    augmented operands (the same log-Q tile) and one PyTorch pass that moves
    the same bytes (``same_bytes_ms``: a fill of the output, a compare of
    log u), by CUDA events: ``ms`` back to back with a warm L2
    (``cuda_ms``), ``cold_ms`` with the L2 flushed before each call
    (``cuda_ms_cold``)."""
    M, N, d = fs.shape[0], ft.shape[0], fs.shape[1]
    u, v, w, c0 = packed
    a = torch.cat([fs * w, fs @ u[:, None], torch.ones(M, 1, device=fs.device)], dim=1)
    b = torch.cat([ft, torch.ones(N, 1, device=fs.device), (ft @ v + c0)[:, None]], dim=1)
    lib_err = float((a @ b.T - logq).abs().max())
    reps = 50 if M * N <= NAIVE_TILE ** 2 else 10
    fns = {
        "magm_logprob": (lambda: ml.magm_logprob(fs, ft, *packed), lambda: ml.magm_logprob_plain(fs, ft, *packed),
                         lambda: a @ b.T),
        # no single PyTorch call compares a bilinear form with a tile
        "bernoulli_tile": (lambda: bt.bernoulli_tile(fs, ft, *packed, logu),
                           lambda: bt.bernoulli_tile_plain(fs, ft, *packed, logu), None),
    }
    # one PyTorch pass that moves each kernel's bytes and computes nothing:
    # the memory rate a tile could reach (printed, not in the kernels line)
    fill = torch.empty((M, N), device=fs.device)
    below = torch.empty((M, N), dtype=torch.bool, device=fs.device)
    moves = {"magm_logprob": lambda: fill.fill_(1.0), "bernoulli_tile": lambda: torch.lt(logu, 0.0, out=below)}
    out = {}
    for (name, (kernel, plain, lib)), cell_bytes in zip(fns.items(), (4, 5)):
        bound, bound_by = tile_bound_ms(M, N, d, cell_bytes)
        out[name] = {
            "ms": cuda_ms(kernel, reps), "cold_ms": cuda_ms_cold(kernel, reps),
            "plain_ms": cuda_ms(plain, max(reps // 5, 2)),
            "library_ms": cuda_ms(lib, reps) if lib else None,
            "library_cold_ms": cuda_ms_cold(lib, reps) if lib else None,
            "bound_ms": bound, "bound_by": bound_by, "same_bytes_ms": cuda_ms(moves[name], reps),
        }
    log(f"timing tile {M}x{N}x{d}: {json.dumps(out)} library_max_abs_err={lib_err}")
    return out


def phase_tiles_vs_plain(device) -> dict:
    """magm_logprob and bernoulli_tile against their plain versions at every
    shape of TILE_CHECKS; timings at the naive tile and the dense-scoring
    tile; the compiler's report of both kernels."""
    for name in ("magm_logprob", "bernoulli_tile"):
        usage = ptxas_usage(name, f"{name}_kernel")
        log(f"ptxas {name}_kernel: {json.dumps(usage) if usage else 'not built in this run'}")
    errs, flips, timed = [], 0, {}
    for M, N, d, off, pad in TILE_CHECKS:
        timed_shape = (off, pad, d) == (0, 0, FULL_LOG2_N) and M in (NAIVE_TILE, DENSE_N)
        fs, ft, packed, logu = tile_inputs(M, N, d, device, seed=M + d, off=off, pad=pad, flat=not timed_shape)
        got = ml.magm_logprob(fs, ft, *packed)
        want = ml.magm_logprob_plain(fs, ft, *packed)
        mask = bt.bernoulli_tile(fs, ft, *packed, logu)
        plain = bt.bernoulli_tile_plain(fs, ft, *packed, logu)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= LOGQ_ATOL:
            raise AssertionError(f"magm_logprob differs from plain by {err} at {M}x{N}x{d} off={off}")
        mism, band = band_mismatches(mask, plain, logu, want)
        errs.append(err)
        flips = max(flips, int((mask.int() - plain.int()).abs().max()))
        log(f"tiles {M}x{N}x{d} F_offset_rows={off} logu_ld={logu.stride(0)}: magm_logprob max_abs_err={err} "
            f"bernoulli_tile mismatches={mism} (all inside the band of {band} cells) ones={float(mask.float().mean())}")
        if timed_shape:
            timed[M] = tile_timing(fs, ft, packed, logu, want)
        if M == NAIVE_TILE and (off, pad) == (0, 0):
            prof = {
                "magm_logprob": profiled_kernel_ms(lambda: ml.magm_logprob(fs, ft, *packed), 20,
                                                   "magm_logprob_kernel"),
                "bernoulli_tile": profiled_kernel_ms(lambda: bt.bernoulli_tile(fs, ft, *packed, logu), 20,
                                                     "bernoulli_tile_kernel"),
            }
            log(f"profiler_kernel_ms tile {M}x{N}x{d}: {json.dumps(prof)}")
        del fs, ft, logu, got, want, mask, plain
    # the kernels line: the naive tile's timings, as in earlier runs
    out = {name: {k: timed[NAIVE_TILE][name][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
           for name in ("magm_logprob", "bernoulli_tile")}
    out["magm_logprob"]["max_abs_err"], out["bernoulli_tile"]["max_abs_err"] = max(errs), flips
    return out


def batch_thetas() -> torch.Tensor:
    return magm.make_params(THETA_1, DEFAULT_MU, FULL_LOG2_N).thetas


def phase_descent_prng(device) -> dict:
    """quadrant_descent_prng against its plain version at 2^25 slots, d = 15
    (bit-identical), then the KPGM edge batch through its entry point."""
    key = prng.PRNGKey(SEED + 30)
    seed = ops.counter_seed(key)
    cum = ops._batch_cumprobs(batch_thetas()).to(device)
    got = qd.quadrant_descent_prng(seed, cum, num_slots=BATCH_SLOTS)
    want = qd.quadrant_descent_prng_plain(seed, cum, num_slots=BATCH_SLOTS)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"quadrant_descent_prng != plain: {int((g != w).sum())} slots differ")
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    log(f"quadrant_descent_prng == plain: slots={BATCH_SLOTS} d={FULL_LOG2_N}")

    ops.reset_kernel_launches()
    src, dst = ops.sample_edge_batch_prng(key, batch_thetas(), BATCH_SLOTS, device=device)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()["quadrant_descent_prng"]
    if launches < 1:
        raise AssertionError("sample_edge_batch_prng did not launch quadrant_descent_prng")
    if not (torch.equal(src, got[0]) and torch.equal(dst, got[1])):
        raise AssertionError("sample_edge_batch_prng differs from the checked kernel run")
    n = 1 << FULL_LOG2_N
    if int(src.min()) < 0 or int(src.max()) >= n or int(dst.min()) < 0 or int(dst.max()) >= n:
        raise AssertionError("edge batch ids outside [0, 2^d)")
    bound, bound_by = descent_bound_ms(BATCH_SLOTS, FULL_LOG2_N)
    prof = profiled_kernel_ms(lambda: qd.quadrant_descent_prng(seed, cum, num_slots=BATCH_SLOTS), 5,
                              "quadrant_descent_prng_kernel")
    log(f"quadrant_descent_prng profiler_kernel_ms={prof}")
    out = {
        "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(lambda: qd.quadrant_descent_prng(seed, cum, num_slots=BATCH_SLOTS), reps=20),
        "plain_ms": cuda_ms(lambda: qd.quadrant_descent_prng_plain(seed, cum, num_slots=BATCH_SLOTS), reps=2),
        "bound_ms": bound, "bound_by": bound_by,
        # no PyTorch call computes the counter-hash descent
        "library_ms": None,
    }
    log(f"edge batch: launches={launches} distinct_src={int(torch.unique(src).numel())} "
        f"timing {json.dumps(out)}")
    return out


def naive_stage_ms(F: np.ndarray, params, device) -> None:
    """Device ms of each stage of one warm 2048^2 naive tile, timed one by one."""
    Fd = torch.from_numpy(F[:2 * NAIVE_TILE]).to(device=device, dtype=torch.float32)
    fs, ft = Fd[:NAIVE_TILE], Fd[NAIVE_TILE:]
    packed = ops._packed_bilinear(params.thetas, device)
    key = prng.split(prng.PRNGKey(SEED + 40))[1]
    shape = (NAIVE_TILE, NAIVE_TILE)
    u = prng.uniform(key, shape, minval=1e-38, maxval=1.0, device=device)
    logu = f32math.log(u)
    mask = bt.bernoulli_tile(fs, ft, *packed, logu)
    idx = torch.nonzero(mask)
    stages = {
        "uniforms": lambda: prng.uniform(key, shape, minval=1e-38, maxval=1.0, device=device),
        "f32math_log": lambda: f32math.log(u),
        "kernel": lambda: bt.bernoulli_tile(fs, ft, *packed, logu),
        "nonzero": lambda: torch.nonzero(mask),
        "copy_to_host": lambda: idx.cpu(),
    }
    log(f"naive stage_ms per {NAIVE_TILE}^2 tile (x256 tiles at n=2^15): "
        + " ".join(f"{k}={cuda_ms(f, reps=5)}" for k, f in stages.items()))


def sum_q(F: np.ndarray, thetas, device) -> tuple:
    """(sum Q, its sigma) given F: the expected edge count of a MAGM graph
    and the standard deviation of the count, tile by tile through the
    magm_logprob kernel."""
    n = F.shape[0]
    Fd = torch.from_numpy(F).to(device=device, dtype=torch.float32)
    s1 = torch.zeros((), dtype=torch.float64, device=device)
    s2 = torch.zeros((), dtype=torch.float64, device=device)
    for i0 in range(0, n, NAIVE_TILE):
        for j0 in range(0, n, NAIVE_TILE):
            q = torch.exp(ops.magm_logprob(Fd[i0:i0 + NAIVE_TILE], Fd[j0:j0 + NAIVE_TILE], thetas).double())
            s1 += q.sum()
            s2 += (q * (1.0 - q)).sum()
    torch.cuda.synchronize()
    return float(s1), float(s2) ** 0.5


def phase_naive_full_size(sampler, quilt_edges: int) -> dict:
    """The naive baseline on the full-size session's F: sum Q and sigma
    through the magm_logprob kernel tile by tile, then naive_sample; both
    counts within 4 sigma of sum Q."""
    device = sampler.device
    F, params = sampler.F, sampler.config.params
    n = F.shape[0]
    tiles = (-(-n // NAIVE_TILE)) ** 2

    ops.reset_kernel_launches()
    mean, sigma = sum_q(F, params.thetas, device)
    logprob_launches = ops.kernel_launches()["magm_logprob"]

    ops.reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    e = naive.naive_sample(prng.PRNGKey(SEED + 20), params, F, tile=NAIVE_TILE, device=device)
    cold_s = time.perf_counter() - t0
    tile_launches = ops.kernel_launches()["bernoulli_tile"]
    peak = torch.cuda.max_memory_allocated()
    if logprob_launches != tiles or tile_launches != tiles:
        raise AssertionError(f"launches magm_logprob={logprob_launches} bernoulli_tile={tile_launches}, "
                             f"expected {tiles} each")
    if e.ndim != 2 or e.shape[1] != 2 or e.shape[0] == 0 or e.min() < 0 or e.max() >= n:
        raise AssertionError(f"bad naive edge array {e.shape}")
    if np.unique(e[:, 0] * n + e[:, 1]).size != e.shape[0]:
        raise AssertionError("duplicate naive edges")
    z_naive, z_quilt = (e.shape[0] - mean) / sigma, (quilt_edges - mean) / sigma
    log(f"naive n=2^{FULL_LOG2_N}: sum_Q={mean} sigma={sigma} naive_edges={e.shape[0]} z={z_naive} "
        f"quilt_edges={quilt_edges} z={z_quilt} tiles={tiles} launches magm_logprob={logprob_launches} "
        f"bernoulli_tile={tile_launches} cold_s={cold_s} peak_mem_bytes={peak}")
    if abs(z_naive) > 4 or abs(z_quilt) > 4:
        raise AssertionError("an edge count lies outside 4 sigma of sum Q")

    walls, events = [], []
    for i in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        naive.naive_sample(prng.PRNGKey(SEED + 21 + i), params, F, tile=NAIVE_TILE, device=device)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        events.append(start.elapsed_time(end))
    log(f"timing naive_sample n=2^{FULL_LOG2_N}: ms_median3={statistics.median(events)} "
        f"ms_events={events} ms_host_clock={walls}")
    naive_stage_ms(F, params, device)
    return {"bernoulli_tile": tile_launches, "magm_logprob": logprob_launches}


def phase_naive_cross_device(device) -> None:
    """naive_sample at n = 2^10 on the card and on the CPU: the same key walk
    and draws, so equal edges outside the band."""
    n = 1 << NAIVE_CHECK_LOG2_N
    params = magm.make_params(THETA_1, DEFAULT_MU, NAIVE_CHECK_LOG2_N)
    F = magm.sample_attributes(prng.PRNGKey(SEED + 50), n, params.mu).numpy()
    key = prng.PRNGKey(SEED + 51)
    got = naive.naive_sample(key, params, F, device=device)
    want = naive.naive_sample(key, params, F, device="cpu")
    adj = [torch.zeros((n, n), dtype=torch.bool) for _ in range(2)]
    for a, e in zip(adj, (got, want)):
        a[torch.from_numpy(e[:, 0]), torch.from_numpy(e[:, 1])] = True
    _, sub = prng.split(key)  # one tile: the walk's first subkey
    logu = f32math.log(prng.uniform(sub, (n, n), minval=1e-38, maxval=1.0))
    logq = magm.log_edge_prob(torch.from_numpy(F), torch.from_numpy(F), params.thetas)
    mism, band = band_mismatches(adj[0], adj[1], logu, logq)
    log(f"naive cross-device n=2^{NAIVE_CHECK_LOG2_N}: edges cuda={got.shape[0]} cpu={want.shape[0]} "
        f"mismatches={mism} (inside the band of {band} cells)")


def phase_dense_scoring(device) -> int:
    """MAGFIT's dense scoring through the magm_logprob kernel: the (n, n)
    E_q[log Q] at n = 2^13, and elbo_dense at n = 512, against the plain
    products on the card; returns the kernel's launches in the scoring."""
    rng = np.random.default_rng(SEED + 60)
    thetas = magm.make_params(THETA_1, DEFAULT_MU, FULL_LOG2_N).thetas
    phi = rng.uniform(0.0, 1.0, (DENSE_N, FULL_LOG2_N)).astype(np.float32)
    ops.reset_kernel_launches()
    got = magfit.dense_expected_logprob(phi, thetas, use_kernel=True, device=device)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()["magm_logprob"]
    want = magfit.dense_expected_logprob(phi, thetas, use_kernel=False, device=device)
    err = float((got - want).abs().max())
    if launches < 1 or not torch.isfinite(got).all() or not err <= LOGQ_ATOL:
        raise AssertionError(f"dense scoring: launches={launches} max_abs_err={err}")
    n = 512
    mu = np.full(FULL_LOG2_N, DEFAULT_MU, dtype=np.float32)
    edges = rng.integers(0, n, (4 * n, 2))
    e_kernel = float(magfit.elbo_dense(phi[:n], thetas, mu, edges, n, use_kernel=True, device=device))
    e_plain = float(magfit.elbo_dense(phi[:n], thetas, mu, edges, n, device=device))
    if not abs(e_kernel - e_plain) <= 1e-5 * abs(e_plain):
        raise AssertionError(f"elbo_dense kernel {e_kernel} vs plain {e_plain}")
    log(f"dense scoring n=2^13: launches magm_logprob={launches} max_abs_err={err}; "
        f"elbo_dense n={n}: kernel={e_kernel} plain={e_plain}")
    return launches


# --- the uniforms-operand kernels and the paths that run them ---


def test_uniforms(rows: int, cum: torch.Tensor, seed: int) -> torch.Tensor:
    """(rows, d) float32 uniforms on cum's device, every 97th row set to a
    level threshold (the compares are >=)."""
    g = torch.Generator(device=cum.device).manual_seed(seed)
    u = torch.rand((rows, cum.shape[0]), generator=g, device=cum.device)
    u[::97] = cum[:, 1][None, :]
    return u


def equal_or_raise(got, want, what: str) -> int:
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel != plain in {int((g != w).sum())} rows")
    return max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want) if g.numel())


def uniform_kernel_timing(fn, kernel: str, plain, bound: tuple) -> dict:
    """A uniforms kernel's timings: ``ms`` by CUDA events over 20
    back-to-back calls (``cuda_ms``, as the other kernels are timed), beside
    the median events time of a call alone (10 calls, each queued behind a
    spin), the profiler's device time per launch and the host time per
    call."""
    events = cuda_ms(fn, reps=20)
    prof = profiled_kernel_ms(fn, 10, kernel)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        fn()
    host = (time.perf_counter() - t) * 1e3 / 20
    torch.cuda.synchronize()
    alone = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(1e-3 * SPIN_CYCLES_PER_S))  # the call is queued before start runs
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        alone.append(start.elapsed_time(end))
    return {
        "ms": events, "events_alone_ms": statistics.median(alone), "profiler_ms": prof,
        "host_ms_per_call": host,
        "plain_ms": cuda_ms(plain, reps=3),
        "bound_ms": bound[0], "bound_by": bound[1],
        # no single PyTorch call computes the descent, with or without the lookup
        "library_ms": None,
    }


def host_round_blocks(plan: quilt.QuiltPlan, rows: int):
    """The (kb, lb) of the first ``rows`` rows of the quilt host path's first
    round at this plan (``kpgm._graph_lookup`` over the asks of the B^2
    graphs' drawn targets): graph-contiguous block ids."""
    _, sub = prng.split(prng.PRNGKey(SEED + 96))
    targets = kpgm._draw_targets(sub, plan.thetas.cpu(), plan.num_graphs, 1 << plan.d)
    asks, _ = quilt.dedup.plan_asks(targets, 1.05)
    kb, lb = kpgm._graph_lookup(asks, plan.B, (None, None), plan.device)[:2]
    return kb[:rows].contiguous(), lb[:rows].contiguous()


def lookup_arms(plan: quilt.QuiltPlan) -> dict:
    """quilt_descent_lookup's two arms at this plan: through the dense
    inverse, and searching the tables (no inverse).  A tree whose wrapper
    takes no inverse (the kernel before its redesign) has the search arm
    alone, so that ``--lookup`` times both kernels in one call."""
    arms = {"inverse": plan.inv, "search": None}
    if "inv" not in inspect.signature(qd.quilt_descent_lookup).parameters:
        del arms["inverse"]
    return arms


def lookup(args, inv):
    """quilt_descent_lookup on ``args`` through ``inv`` (None: search)."""
    return qd.quilt_descent_lookup(*args) if inv is None else qd.quilt_descent_lookup(*args, inv)


def phase_uniform_kernels_vs_plain(device, plans) -> dict:
    """quadrant_descent at its main-path shape (a draw chunk of the KPGM
    host loop at d = 20, and a ragged count) and at 2^24 rows of d = 16
    (and a ragged count), each equal to its plain version, the d = 20 shape
    timed (the d = 16 one too, for the record); then
    phase_lookup_vs_plain."""
    chunk = kpgm.DRAW_CHUNK_ELEMS // KPGM_D
    cases = (
        (KPGM_D, kpgm._level_cumprobs(kpgm.make_params(THETA_1, KPGM_D).thetas), (chunk, chunk - 333)),
        (UNIFORM_D, kpgm._level_cumprobs(magm.make_params(THETA_1, DEFAULT_MU, UNIFORM_D).thetas),
         (UNIFORM_ROWS, UNIFORM_ROWS - 333)),
    )
    errs, timings = [], {}
    for d, cum, sizes in cases:
        cum = cum.to(device)
        for rows in sizes:
            u = test_uniforms(rows, cum, SEED + rows % 1000)
            errs.append(equal_or_raise(qd.quadrant_descent(u, cum), qd.quadrant_descent_plain(u, cum),
                                       f"quadrant_descent rows={rows} d={d}"))
            log(f"quadrant_descent == plain: rows={rows} d={d}")
        u = test_uniforms(sizes[0], cum, SEED)
        timings[d] = uniform_kernel_timing(
            lambda: qd.quadrant_descent(u, cum), "quadrant_descent_kernel",
            lambda: qd.quadrant_descent_plain(u, cum), uniform_bound_ms(sizes[0], d),
        )
        log(f"timing quadrant_descent rows={sizes[0]} d={d}: {json.dumps(timings[d])}")
        del u
    descent = {"max_abs_err": max(errs), **timings[KPGM_D]}
    return {"quadrant_descent": descent, "quilt_descent_lookup": phase_lookup_vs_plain(device, plans)}


def phase_lookup_vs_plain(device, plans) -> dict:
    """quilt_descent_lookup in both arms (dense inverse, table search) on
    one draw chunk of the main path and a ragged count with the tables of
    each plan (n = 2^16: L2; n = 2^12: shared memory), with random block
    ids, and at n = 2^16 also with the host path's graph-contiguous ones,
    each equal to the plain version (which searches the tables).  Both arms
    are timed at n = 2^16 with both rank patterns; the kernels line takes
    the inverse arm with contiguous ranks, the quilt host path's launch."""
    errs, timed = [], {}
    for plan in plans:
        rows = kpgm.DRAW_CHUNK_ELEMS // plan.d
        g = torch.Generator(device=device).manual_seed(SEED + 71)
        blocks = {"random": [torch.randint(0, plan.B, (rows,), generator=g, device=device, dtype=torch.int32)
                             for _ in range(2)]}
        if plan.n == 1 << HOST_LOG2_N:
            blocks["contiguous"] = host_round_blocks(plan, rows)
        for ranks, (kb, lb) in blocks.items():
            for r in (rows, rows - 333):
                u = test_uniforms(r, plan.cum, SEED + plan.d + r % 1000)
                args = (u, plan.cum, kb[:r], lb[:r], plan.table_cfg, plan.table_node)
                want = qd.quilt_descent_lookup_plain(*args)
                for arm, inv in lookup_arms(plan).items():
                    got = lookup(args, inv)
                    errs.append(equal_or_raise(got, want, f"quilt_descent_lookup {arm} {ranks} n={plan.n} rows={r}"))
                hits = float((want[2] >= 0).float().mean())
                log(f"quilt_descent_lookup == plain (arms {list(lookup_arms(plan))}): n={plan.n} rows={r} "
                    f"d={plan.d} ranks={ranks} tables={tuple(plan.table_cfg.shape)} "
                    f"tables_in_smem={qd.descent_tables_in_shared_memory(plan.d, plan.table_cfg)} src_hit_rate={hits}")
                del u, args, want, got
            if plan.n != 1 << HOST_LOG2_N:
                continue
            u = test_uniforms(rows, plan.cum, SEED + plan.d)
            for arm, inv in lookup_arms(plan).items():
                args = (u, plan.cum, kb, lb, plan.table_cfg, plan.table_node)
                timed[arm, ranks] = uniform_kernel_timing(
                    lambda: lookup(args, inv), "quilt_descent_lookup_kernel",
                    lambda: qd.quilt_descent_lookup_plain(*args), uniform_bound_ms(rows, plan.d, plan.table_cfg),
                )
                log(f"timing quilt_descent_lookup {arm} ranks={ranks} n={plan.n} rows={rows}: "
                    f"{json.dumps(timed[arm, ranks])}")
            del u
    log("quilt_descent_lookup ms at the main-path shape: "
        + " ".join(f"{arm}/{ranks}={t['ms']}" for (arm, ranks), t in timed.items()))
    main_path = ("inverse" if ("inverse", "contiguous") in timed else "search", "contiguous")
    return {"max_abs_err": max(errs), **timed[main_path]}


def profiled_call(fn) -> tuple:
    """(result, wall ms, device-busy ms, top device ops) of one call under
    torch.profiler: busy is the sum of the device events' times (kernels,
    copies, fills).  A CPU op's device time repeats that of the kernels it
    launched, so the sum over every event, the measure of earlier runs,
    counts most of the busy time twice; it is logged beside, as
    ``all_events_ms``.  The program's spans (``obs.span``) also appear as
    device-side user annotations as long as their range: those are no
    device work, and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
    ev = [e for e in prof.key_averages() if not e.is_user_annotation]
    device = [e for e in ev if e.device_type != DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in device) / 1e3
    log(f"profiler: device events {busy} ms, all_events_ms={sum(e.self_device_time_total for e in ev) / 1e3}")
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return out, wall, busy, [(e.key, round(e.self_device_time_total / 1e3, 3)) for e in top]


def timed_runs(fn, keys) -> list:
    """Host-clock ms of fn(key) for each key; each call ends on the host."""
    out = []
    for k in keys:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(k)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def check_edges(e: np.ndarray, n: int, what: str) -> None:
    if e.ndim != 2 or e.shape[1] != 2 or e.shape[0] == 0:
        raise AssertionError(f"{what}: bad edge array {e.shape}")
    if e.min() < 0 or e.max() >= n:
        raise AssertionError(f"{what}: edge ids outside [0, {n})")
    if np.unique(e[:, 0] * n + e[:, 1]).size != e.shape[0]:
        raise AssertionError(f"{what}: duplicate edges")


def counters_delta(before: dict) -> dict:
    """The round counters' and the drawn and kept rows' growth since
    ``before`` (the span totals of the same registry are left out)."""
    return {k: quilt.DISPATCH_COUNTERS[k] - before[k] for k in (*quilt.ROUND_COUNTERS, "candidates", "edges_out")}


def phase_host_session(device) -> dict:
    """The default MAGMSampler at n = 2^16: the exact round is refused, the
    ranked round is over the cap too, and the host path runs with
    quilt_descent_lookup.  Gates: unique in-range edges, every graph's
    distinct-cell count equal to its drawn target unless max_rounds ran out
    (printed), the card's run equal to the engine's for the same key."""
    t0 = time.perf_counter()
    sampler = MAGMSampler(paper_config(HOST_LOG2_N, device))
    plan = sampler.plan
    budget = quilt._exact_budget(plan.p_max, plan.mean_edges)
    log(f"plan n=2^{HOST_LOG2_N}: B={plan.B} L={plan.table_cfg.shape[1]} exact budget {plan.num_graphs} x "
        f"{budget} = {plan.num_graphs * budget} > DEVICE_MAX_CANDIDATES={kpgm.DEVICE_MAX_CANDIDATES} "
        f"build_s={time.perf_counter() - t0:.3f}")
    n = plan.n
    key = prng.PRNGKey(SEED + 90)
    before = dict(quilt.DISPATCH_COUNTERS)
    ops.reset_kernel_launches()
    kpgm.HOST_DEDUP_SECONDS = 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    gs = sampler.sample(key)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t) * 1e3
    launches = ops.kernel_launches()
    delta = counters_delta(before)
    peak = torch.cuda.max_memory_allocated()
    dedup_s = kpgm.HOST_DEDUP_SECONDS
    if delta["exact_fallbacks"] != 1 or delta["device_rounds"] != 0:
        raise AssertionError(f"n=2^{HOST_LOG2_N} did not take the host path: {delta}")
    if launches["quilt_descent_lookup"] < 1:
        raise AssertionError("the host path did not launch quilt_descent_lookup")
    check_edges(gs.edges, n, f"host session n=2^{HOST_LOG2_N}")
    if gs.edges.shape[0] != gs.stats.kept_edges:
        raise AssertionError(f"edges {gs.edges.shape} vs stats {gs.stats}")
    log(f"sample n=2^{HOST_LOG2_N}: edges={gs.num_edges} stats={tuple(gs.stats)} launches={launches} "
        f"counters={delta} peak_mem_bytes={peak} host_dedup_s={dedup_s} cold_ms={cold_ms}")

    # the engine's host path under the session (quilt_run hands it the
    # key's first split), for its own per-graph targets and counts
    edges, _, targets, counts = quilt._quilt_sample_host(
        prng.split(key)[0], plan, max_rounds=sampler.config.max_rounds, oversample=sampler.config.oversample
    )
    if not np.array_equal(edges, gs.edges):
        raise AssertionError("the engine's host path differs from the session's for the same key")
    short = targets - counts
    rounds_ran_out = bool((short > 0).any())
    if (short < 0).any():
        raise AssertionError("a graph holds more cells than its target")
    mean, sigma = sum_q(sampler.F, sampler.config.params.thetas, device)
    z = (gs.num_edges - mean) / sigma
    log(f"host session gates: graphs={targets.size} targets_met={int((short == 0).sum())} "
        f"max_rounds_ran_out={rounds_ran_out} shortfall={int(short.sum())} targets_sum={int(targets.sum())} "
        f"sum_Q={mean} sigma={sigma} z={z} (first-N-distinct law: printed, not gated)")
    if rounds_ran_out:
        log("host session: max_rounds ran out before every target was met (allowed, printed)")

    dedup0 = kpgm.HOST_DEDUP_SECONDS
    _, wall, busy, top = profiled_call(lambda: sampler.sample(prng.PRNGKey(SEED + 91)))
    log(f"timing host session n=2^{HOST_LOG2_N}: ms_warm=[{wall}] (the profiled run) "
        f"host_dedup_s_per_run={kpgm.HOST_DEDUP_SECONDS - dedup0} profiled_run wall_ms={wall} device_busy_ms={busy} "
        f"device_idle_share={1 - busy / wall} top_device_ops={top}")
    stage_host_path(plan, device)
    return {"quilt_descent_lookup": launches["quilt_descent_lookup"]}


def stage_host_path(plan, device) -> None:
    """Device ms of one draw chunk's stages on the host path (threefry,
    the lookup kernel through the plan's dense inverse with the round's
    graph-contiguous block ids, the copy of the four id arrays to the
    host), timed one by one at the main path's chunk."""
    rows = kpgm.DRAW_CHUNK_ELEMS // plan.d
    key = prng.PRNGKey(SEED + 95)
    u = prng.uniform(key, (rows, plan.d), offset=rows * plan.d, device=device)
    kb, lb = host_round_blocks(plan, rows)
    args = (u, plan.cum, kb, lb, plan.table_cfg, plan.table_node, plan.inv)
    out = qd.quilt_descent_lookup(*args)
    stages = {
        "threefry_uniforms": lambda: prng.uniform(key, (rows, plan.d), offset=rows * plan.d, device=device),
        "quilt_descent_lookup": lambda: qd.quilt_descent_lookup(*args),
        "ids_to_host": lambda: [o.cpu() for o in out],
    }
    log(f"host path stage_ms per draw chunk of {rows} rows: "
        + " ".join(f"{k}={cuda_ms(f, reps=3)}" for k, f in stages.items()))


def phase_kpgm_host(device) -> dict:
    """KPGMSampler(backend="host") at d = 20 through quadrant_descent: the
    edges unique and in range, their count equal to the drawn target
    (unless max_rounds ran out, printed)."""
    params = kpgm.make_params(THETA_1, KPGM_D)
    sampler = KPGMSampler(SamplerConfig(params=params, backend="host", device=device))
    n = params.num_nodes
    key = prng.PRNGKey(SEED + 100)
    target = int(kpgm.sample_num_edges(prng.split(key)[1], params.thetas))  # the host loop's first split
    ops.reset_kernel_launches()
    kpgm.HOST_DEDUP_SECONDS = 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    gs = sampler.sample(key)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t) * 1e3
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    if launches["quadrant_descent"] < 1:
        raise AssertionError("the KPGM host loop did not launch quadrant_descent")
    check_edges(gs.edges, n, f"KPGM d={KPGM_D}")
    if gs.num_edges > target:
        raise AssertionError(f"{gs.num_edges} edges over the target {target}")
    m, v = kpgm.edge_moments_eager(params.thetas)
    z = (gs.num_edges - float(m)) / float(kpgm._edge_std(m, v))
    log(f"KPGM d={KPGM_D}: edges={gs.num_edges} target={target} target_met={gs.num_edges == target} "
        f"z_vs_m={z} launches={launches} peak_mem_bytes={peak} host_dedup_s={kpgm.HOST_DEDUP_SECONDS} "
        f"cold_ms={cold_ms}")
    dedup0 = kpgm.HOST_DEDUP_SECONDS
    _, wall, busy, top = profiled_call(lambda: sampler.sample(prng.PRNGKey(SEED + 101)))
    log(f"timing KPGM host d={KPGM_D}: ms_warm=[{wall}] (the profiled run) "
        f"host_dedup_s_per_run={kpgm.HOST_DEDUP_SECONDS - dedup0} profiled_run wall_ms={wall} "
        f"device_busy_ms={busy} device_idle_share={1 - busy / wall} top_device_ops={top}")
    return {"quadrant_descent": launches["quadrant_descent"]}


def phase_ranked(device) -> None:
    """MAGMSampler(exact_cells=False) at n = 2^15: the ranked device rounds
    with quilt_prng_descent_lookup."""
    sampler = MAGMSampler(paper_config(FULL_LOG2_N, device).replace(exact_cells=False))
    before = dict(quilt.DISPATCH_COUNTERS)
    ops.reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    gs = sampler.sample(prng.PRNGKey(SEED + 110))
    torch.cuda.synchronize()
    launches, delta = ops.kernel_launches(), counters_delta(before)
    if launches["quilt_prng_descent_lookup"] < 1 or delta["device_rounds"] != 1:
        raise AssertionError(f"ranked rounds: launches={launches} counters={delta}")
    check_edges(gs.edges, sampler.n, "ranked rounds")
    walls = timed_runs(sampler.sample, [prng.PRNGKey(SEED + 111 + i) for i in range(3)])
    log(f"ranked rounds n=2^{FULL_LOG2_N}: edges={gs.num_edges} stats={tuple(gs.stats)} counters={delta} "
        f"launches={launches} peak_mem_bytes={torch.cuda.max_memory_allocated()} ms={walls} "
        f"ms_median={statistics.median(walls)}")


def same_sample(what: str, got, want) -> None:
    if not np.array_equal(got.edges, want.edges):
        raise AssertionError(f"{what}: the card's edges differ from the CPU's")
    if (got.stats is None) != (want.stats is None) or (got.stats is not None and tuple(got.stats) != tuple(want.stats)):
        raise AssertionError(f"{what}: stats differ: {got.stats} vs {want.stats}")


def phase_legacy_cross_device(device) -> None:
    """Each new path at n = 2^12 (d = 12) on the card and on the CPU, same
    inputs and key: equal edges and stats."""
    key = prng.PRNGKey(SEED + 120)
    for name, change, kernel in (
        ("backend=host", {"backend": "host"}, "quilt_descent_lookup"),
        ("exact_cells=False", {"exact_cells": False}, "quilt_prng_descent_lookup"),
    ):
        cuda_s = MAGMSampler(paper_config(CHECK_LOG2_N, device).replace(**change))
        cpu_s = MAGMSampler(paper_config(CHECK_LOG2_N, "cpu").replace(**change))
        ops.reset_kernel_launches()
        got = cuda_s.sample(key)
        launches = ops.kernel_launches()[kernel]
        same_sample(name, got, cpu_s.sample(key))
        log(f"cross-device {name} n=2^{CHECK_LOG2_N}: edges={got.num_edges} {kernel} launches={launches}")
        if launches < 1:
            raise AssertionError(f"{name} did not launch {kernel}")
    targets = np.random.default_rng(SEED).integers(0, 2 * int(cuda_s.plan.mean_edges), cuda_s.plan.num_graphs)
    got = quilt.quilt_run(key, cuda_s.plan, targets=targets)
    want = quilt.quilt_run(key, cpu_s.plan, targets=targets)
    if not np.array_equal(got.edges(), want.edges()) or not np.array_equal(got.counts, want.counts):
        raise AssertionError("explicit targets: the card's run differs from the CPU's")
    log(f"cross-device explicit targets n=2^{CHECK_LOG2_N}: edges={got.kept_edges()} counts_sum={int(got.counts.sum())}")
    params = kpgm.make_params(THETA_1, CHECK_LOG2_N)
    for backend in ("auto", "host"):
        for num_edges in (None, 5000):
            cfg = SamplerConfig(params=params, backend=backend)
            got = KPGMSampler(cfg.replace(device=device)).sample(key, num_edges=num_edges)
            same_sample(f"KPGM {backend}", got, KPGMSampler(cfg.replace(device="cpu")).sample(key, num_edges=num_edges))
            log(f"cross-device KPGMSampler backend={backend} num_edges={num_edges} d={CHECK_LOG2_N}: "
                f"edges={got.num_edges} stats={got.stats}")


# --- the device-native PRNG batch, ball dropping and the 3-sigma suite ---


def sass_opcodes(name: str, kernel: str) -> dict:
    """Static opcode histogram of ``kernel`` in the built library of
    ``csrc/<name>.cu`` (``cuobjdump -sass``, beside nvcc), by opcode with
    its modifiers, predicates dropped: what the op count of its bound is
    held against."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(_build.build(name))],
                         capture_output=True, text=True, check=True, timeout=120).stdout
    hist, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                hist[m.group(1)] = hist.get(m.group(1), 0) + 1
    if not hist:
        raise AssertionError(f"no SASS found for {kernel} in {name}")
    return dict(sorted(hist.items(), key=lambda kv: -kv[1]))


def descent_law(src: torch.Tensor, dst: torch.Tensor, thetas: np.ndarray) -> dict:
    """A batch's cells against P_xy / m: the chi-square over all 4^d cells
    (its p-value), the max |z| of a cell (over all cells, and over the cells
    expecting >= 25 draws, where z is near normal), and the worst per-level
    quadrant fraction's distance from theta / sum(theta) in standard
    errors."""
    from scipy import stats as sps

    d = thetas.shape[0]
    n = src.numel()
    cell = src.long() * (1 << d) + dst.long()
    got = torch.bincount(cell, minlength=1 << (2 * d)).double().cpu().numpy()
    P = np.ones((1, 1))
    for th in thetas.astype(np.float64):
        P = np.kron(P, th)
    p = P.reshape(-1) / P.sum()
    expect = n * p
    chi2 = float(((got - expect) ** 2 / expect).sum())
    z = np.abs((got - expect) / np.sqrt(expect * (1 - p)))
    shift = torch.arange(d - 1, -1, -1, device=src.device)
    quad = (((src.long()[:, None] >> shift) & 1) * 2 + ((dst.long()[:, None] >> shift) & 1))
    frac = torch.stack([(quad == q).double().mean(dim=0) for q in range(4)], dim=1).cpu().numpy()
    t = thetas.astype(np.float64).reshape(d, 4)
    want = t / t.sum(axis=1, keepdims=True)
    level_z = float((np.abs(frac - want) / np.sqrt(want * (1 - want) / n)).max())
    return {"chi2": chi2, "dof": expect.size - 1, "p_value": float(sps.chi2.sf(chi2, expect.size - 1)),
            "max_abs_z": float(z.max()), "max_abs_z_expect_ge_25": float(z[expect >= 25].max()),
            "level_max_abs_z": level_z}


def phase_native(device, prng_ms: float) -> dict:
    """quadrant_descent_native (sample_edge_batch_prng(tpu_native=True))
    bit for bit against its plain version at 2^25 and 2^25 - 333 slots,
    d = 15; the edge batch through its entry point; its time beside
    quadrant_descent_prng's at the same shape; the law of both streams."""
    key = prng.PRNGKey(SEED + 130)
    seed = ops.counter_seed(key)
    cum = ops._batch_cumprobs(batch_thetas()).to(device)
    errs = []
    for slots in (BATCH_SLOTS, BATCH_SLOTS - 333):
        got = qd.quadrant_descent_native(seed, cum, num_slots=slots)
        want = qd.quadrant_descent_native_plain(seed, cum, num_slots=slots)
        torch.cuda.synchronize()
        errs.append(equal_or_raise(got, want, f"quadrant_descent_native slots={slots}"))
        log(f"quadrant_descent_native == plain: slots={slots} d={FULL_LOG2_N}")

    ops.reset_kernel_launches()
    src, dst = ops.sample_edge_batch_prng(key, batch_thetas(), BATCH_SLOTS, tpu_native=True, device=device)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    if launches["quadrant_descent_native"] < 1 or launches["quadrant_descent_prng"] != 0:
        raise AssertionError(f"tpu_native=True launches: {launches}")
    n = 1 << FULL_LOG2_N
    if not (0 <= int(src.min()) and int(src.max()) < n and 0 <= int(dst.min()) and int(dst.max()) < n):
        raise AssertionError("native edge batch ids outside [0, 2^d)")
    head = ops.sample_edge_batch_prng(key, batch_thetas(), 1000, tpu_native=True, device=device)
    if not (torch.equal(head[0], src[:1000]) and torch.equal(head[1], dst[:1000])):
        raise AssertionError("a shorter native batch is not a prefix of a longer one")

    fn = lambda: qd.quadrant_descent_native(seed, cum, num_slots=BATCH_SLOTS)  # noqa: E731
    bound, bound_by = native_bound_ms(BATCH_SLOTS, FULL_LOG2_N)
    out = {
        "launches": launches["quadrant_descent_native"], "max_abs_err": max(errs),
        "ms": cuda_ms(fn, reps=20),
        "plain_ms": cuda_ms(lambda: qd.quadrant_descent_native_plain(seed, cum, num_slots=BATCH_SLOTS), reps=2),
        "bound_ms": bound, "bound_by": bound_by,
        # no PyTorch call computes the descent on a Philox stream
        "library_ms": None,
    }
    log(f"timing quadrant_descent_native slots={BATCH_SLOTS} d={FULL_LOG2_N}: {json.dumps(out)} "
        f"profiler_kernel_ms={profiled_kernel_ms(fn, 5, 'quadrant_descent_native_kernel')} "
        f"beside quadrant_descent_prng_ms={prng_ms} (ratio {out['ms'] / prng_ms})")
    log("sass quadrant_descent_native_kernel static opcodes: "
        + json.dumps(sass_opcodes("quadrant_descent_native", "quadrant_descent_native_kernel")))

    th = np.broadcast_to(THETA_1, (LAW_D, 2, 2)).copy()
    for name, native in (("quadrant_descent_native", True), ("quadrant_descent_prng", False)):
        law = descent_law(*ops.sample_edge_batch_prng(prng.PRNGKey(SEED + 131), th, LAW_SLOTS,
                                                     tpu_native=native, device=device), th)
        log(f"law {name} d={LAW_D} slots={LAW_SLOTS}: {json.dumps(law)}")
        if not (law["p_value"] > 1e-6 and law["max_abs_z_expect_ge_25"] < 5.5 and law["level_max_abs_z"] < 5.0):
            raise AssertionError(f"{name} does not draw cells with probability P_xy / m: {law}")
    return out


def balldrop_config(log2_n: int, device) -> SamplerConfig:
    return paper_config(log2_n, device).replace(backend="balldrop")


def balldrop_stages(plan, budget: int) -> int:
    """Device ms of each stage of one warm exact ball-dropping round, timed
    one by one with the round's own inputs; the round's
    quilt_prng_descent_lookup (ranks=True) held equal to its plain version
    on those inputs.  Returns the largest difference (0)."""
    key, _ = prng.split(prng.PRNGKey(SEED + 140))
    _, rkey = prng.split(key)
    gids = torch.zeros(1, dtype=torch.int32, device=plan.device)
    args = (ops.counter_seed(rkey), gids, plan.cum, plan.table_cfg, plan.table_node)
    kw = dict(a_tot=budget, num_blocks=plan.B, ranks=True)
    scfg, dcfg, snode, dnode = got = qd.quilt_prng_descent_lookup(*args, **kw)
    want = qd.quilt_prng_descent_lookup_plain(*args, **kw)
    torch.cuda.synchronize()
    err = equal_or_raise(got, want, f"quilt_prng_descent_lookup ranks=True n=2^{FULL_LOG2_N} a_tot={budget}")
    log(f"kernel == plain: balldrop round n=2^{FULL_LOG2_N} ranks=True rows={scfg.numel()} B={plan.B}")
    del want
    dev = scfg.device
    nb = quilt._node_bits(plan.n)
    local = torch.zeros(scfg.numel(), dtype=torch.int64, device=dev)
    acc, acc_kw = accept_inputs(plan, rkey, gids, got, budget, log_extra=2.0 * math.log(plan.B), node_bits=nb)
    valid = ops.exact_accept(*acc, **acc_kw)
    err = max(err, equal_or_raise([valid], [ops.exact_accept_plain(*acc, **acc_kw)],
                                  f"exact_accept node pairs n=2^{FULL_LOG2_N} a_tot={budget}"))
    log(f"kernel == plain: exact_accept, balldrop round n=2^{FULL_LOG2_N} rows={valid.numel()} "
        f"kept={int(valid.sum())}")
    cum_asks = torch.full((1,), budget, device=dev)
    stages = {
        "lookup_kernel_ranks": lambda: qd.quilt_prng_descent_lookup(*args, **kw),
        "accept_kernel": lambda: ops.exact_accept(*acc, **acc_kw),
        "accept_plain": lambda: ops.exact_accept_plain(*acc, **acc_kw),
        "dedup": lambda: quilt.dedup.segmented_unique_mask(
            local, snode, dnode, cum_asks, cum_asks, node_bits=nb, valid=valid
        ),
    }
    log("balldrop stage_ms " + " ".join(f"{k}={cuda_ms(f, reps=3)}" for k, f in stages.items()))
    return err


def phase_balldrop_full_size(device) -> dict:
    """MAGMSampler(backend="balldrop") at n = 2^15: one exact round of the
    plan-constant budget through quilt_prng_descent_lookup (ranks=True);
    unique in-range edges, the count within 4 sigma of bd_mean +- bd_std."""
    sampler = MAGMSampler(balldrop_config(FULL_LOG2_N, device))
    plan = sampler.plan
    budget = quilt._exact_budget(plan.p_max, plan.mean_edges * float(plan.B) ** 2)
    log(f"balldrop plan n=2^{FULL_LOG2_N}: B={plan.B} bd_mean={plan.bd_mean} bd_std={plan.bd_std} "
        f"bd_cost={plan.bd_cost} exact budget={budget}")
    before = dict(balldrop.DISPATCH_COUNTERS)
    ops.reset_kernel_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gs = sampler.sample(prng.PRNGKey(SEED + 141))
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    delta = {k: v - before[k] for k, v in balldrop.DISPATCH_COUNTERS.items()}
    if launches["quilt_prng_descent_lookup"] != 1 or delta["device_rounds"] != 1 or delta["exact_fallbacks"]:
        raise AssertionError(f"n=2^{FULL_LOG2_N} ball dropping left the exact round: {launches} {delta}")
    if launches["exact_accept"] != 1:
        raise AssertionError(f"n=2^{FULL_LOG2_N} ball dropping launched exact_accept {launches['exact_accept']} times")
    check_edges(gs.edges, plan.n, f"balldrop n=2^{FULL_LOG2_N}")
    z = (gs.num_edges - plan.bd_mean) / plan.bd_std
    walls = timed_runs(sampler.sample, [prng.PRNGKey(SEED + 142 + i) for i in range(5)])
    log(f"balldrop sample n=2^{FULL_LOG2_N}: edges={gs.num_edges} z_vs_bd_mean={z} stats={tuple(gs.stats)} "
        f"launches={launches} counters={delta} peak_mem_bytes={peak} ms_warm={walls} "
        f"ms_median5={statistics.median(walls)}")
    if abs(z) > 4:
        raise AssertionError(f"ball-dropping edge count {gs.num_edges} outside 4 sigma of bd_mean")
    err = balldrop_stages(plan, budget)
    return {"quilt_prng_descent_lookup": launches["quilt_prng_descent_lookup"]}, err


def phase_balldrop_host(device) -> dict:
    """MAGMSampler(backend="balldrop") at n = 2^16: the exact budget and
    the drawn first ask pass DEVICE_MAX_CANDIDATES, so the host loop runs
    (threefry proposals descended and looked up by quilt_descent_lookup on
    the card, no quadrant_descent; the accepted node pairs deduped on the
    host); unique in-range edges, their count within 4 sigma of bd_mean."""
    sampler = MAGMSampler(balldrop_config(HOST_LOG2_N, device))
    plan = sampler.plan
    before = dict(balldrop.DISPATCH_COUNTERS)
    ops.reset_kernel_launches()
    kpgm.HOST_DEDUP_SECONDS = 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    gs = sampler.sample(prng.PRNGKey(SEED + 150))
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t) * 1e3
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    delta = {k: v - before[k] for k, v in balldrop.DISPATCH_COUNTERS.items()}
    if delta["exact_fallbacks"] != 1 or delta["device_rounds"] or launches["quilt_descent_lookup"] < 1:
        raise AssertionError(f"n=2^{HOST_LOG2_N} ball dropping did not take the host loop: {launches} {delta}")
    if launches["quadrant_descent"]:
        raise AssertionError(f"n=2^{HOST_LOG2_N} ball dropping still launched quadrant_descent: {launches}")
    check_edges(gs.edges, plan.n, f"balldrop host n=2^{HOST_LOG2_N}")
    z = (gs.num_edges - plan.bd_mean) / plan.bd_std
    log(f"balldrop host n=2^{HOST_LOG2_N}: edges={gs.num_edges} z_vs_bd_mean={z} bd_cost={plan.bd_cost} "
        f"launches={launches} counters={delta} peak_mem_bytes={peak} host_dedup_s={kpgm.HOST_DEDUP_SECONDS} "
        f"cold_ms={cold_ms}")
    if abs(z) > 4:
        raise AssertionError(f"ball-dropping edge count {gs.num_edges} outside 4 sigma of bd_mean")
    _, wall, busy, top = profiled_call(lambda: sampler.sample(prng.PRNGKey(SEED + 151)))
    dedup0 = kpgm.HOST_DEDUP_SECONDS
    walls = timed_runs(sampler.sample, [prng.PRNGKey(SEED + 152 + i) for i in range(2)])
    log(f"timing balldrop host n=2^{HOST_LOG2_N}: ms_warm={walls} ms_median={statistics.median(walls)} "
        f"host_dedup_s_per_run={(kpgm.HOST_DEDUP_SECONDS - dedup0) / 2} profiled_run wall_ms={wall} "
        f"device_busy_ms={busy} device_idle_share={1 - busy / wall} top_device_ops={top}")
    stage_balldrop_host(plan)
    return {"quilt_descent_lookup": launches["quilt_descent_lookup"]}


def stage_balldrop_host(plan) -> None:
    """Host-clock ms of one host-loop round of DEVICE_MAX_CANDIDATES
    proposals, stage by stage as balldrop._propose_host and the loop run
    them (the samples before it ran every stage at this shape, so each is
    warm): the ranks (prng.randint), the threefry draw with the kernel
    quilt_descent_lookup (kpgm.descend_draw through the plan's dense
    inverse), the compaction of the accepted node pairs on the card, their
    copy to the host, and the arrival-order dedup on the host."""
    ask = kpgm.DEVICE_MAX_CANDIDATES
    uk, kk = prng.split(prng.PRNGKey(SEED + 155))

    def clock(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    kl, ranks = clock(lambda: prng.randint(kk, (ask, 2), 0, plan.B, device=plan.device))
    lookup = (kl[:, 0].contiguous(), kl[:, 1].contiguous(), plan.table_cfg, plan.table_node, plan.inv)
    (_, _, sn, dn), draw = clock(lambda: kpgm.descend_draw(uk, plan.cum, ask, lookup=lookup))

    def compact():
        ok = (sn >= 0) & (dn >= 0)
        return sn[ok].to(torch.int64) * plan.n + dn[ok].to(torch.int64)

    flat, compaction = clock(compact)
    host, copy = clock(lambda: flat.cpu().numpy())
    _, dedup_ms = clock(lambda: balldrop._fresh(host, np.empty(0, np.int64)))
    log(f"balldrop host round stage_ms ({ask} proposals, {host.size} accepted): ranks={ranks} "
        f"threefry_and_quilt_descent_lookup={draw} device_compaction={compaction} to_host={copy} "
        f"host_dedup={dedup_ms}")


def phase_balldrop_cross_device(device) -> None:
    """Ball dropping at n = 2^12 on the card and on the CPU, same F and key:
    equal edges in every mode and lookup arm, the host loop, and KPGM."""
    cuda_s = MAGMSampler(balldrop_config(CHECK_LOG2_N, device))
    cpu_s = MAGMSampler(balldrop_config(CHECK_LOG2_N, "cpu"))
    key = prng.PRNGKey(SEED + 160)
    targets = np.array([20_000, 5, 31_000])
    cases = (
        ("exact", {}),
        ("explicit targets", {"num_samples": 3, "targets": targets}),
        ("exact_cells=False", {"num_samples": 2, "exact_cells": False}),
        ("use_kernel=False dense inverse", {"use_kernel": False}),
        ("use_kernel=False by-config", {"use_kernel": False, "exact_cells": False, "bycfg": True}),
    )
    for name, kw in cases:
        kw = dict(kw)
        bycfg = kw.pop("bycfg", False)
        plans = [s.plan._replace(inv=None) if bycfg else s.plan for s in (cuda_s, cpu_s)]
        ops.reset_kernel_launches()
        got = balldrop.balldrop_run(key, plans[0], **kw)
        launches = ops.kernel_launches()["quilt_prng_descent_lookup"]
        want = balldrop.balldrop_run(key, plans[1], **kw)
        if not (np.array_equal(got.edges(), want.edges()) and np.array_equal(got.counts, want.counts)):
            raise AssertionError(f"balldrop {name}: the card's run differs from the CPU's")
        if (launches == 0) != (kw.get("use_kernel") is False):
            raise AssertionError(f"balldrop {name}: {launches} launches of quilt_prng_descent_lookup")
        log(f"cross-device balldrop {name} n=2^{CHECK_LOG2_N}: edges={got.kept_edges()} counts={got.counts.tolist()}")
    want = balldrop._balldrop_sample_host(key, cpu_s.plan, target=20_000, max_rounds=4, oversample=1.05)
    for arm, inv in lookup_arms(cuda_s.plan).items():
        got = balldrop._balldrop_sample_host(
            key, cuda_s.plan._replace(inv=inv), target=20_000, max_rounds=4, oversample=1.05
        )
        if not np.array_equal(got, want):
            raise AssertionError(f"balldrop host loop ({arm} arm): the card's edges differ from the CPU's")
        log(f"cross-device balldrop host loop n=2^{CHECK_LOG2_N} ({arm} arm): edges={got.shape[0]}")
    cfg = SamplerConfig(params=kpgm.make_params(THETA_1, CHECK_LOG2_N), backend="balldrop")
    for num_edges in (None, 5000):
        got = KPGMSampler(cfg.replace(device=device)).sample(key, num_edges=num_edges)
        same_sample(f"KPGM balldrop num_edges={num_edges}", got,
                    KPGMSampler(cfg.replace(device="cpu")).sample(key, num_edges=num_edges))
        log(f"cross-device KPGMSampler backend=balldrop num_edges={num_edges}: edges={got.num_edges} stats={got.stats}")


# --- the section-5 split, fused batches and streams ---


def split_config(log2_n: int, mu: float, device, theta=THETA_1) -> SamplerConfig:
    params = magm.make_params(theta, mu, log2_n)
    return SamplerConfig(
        params=params, num_nodes=1 << log2_n, attribute_key=prng.PRNGKey(SEED), split=True, device=device,
    )


def heavy_moments(sp: quilt.SplitPlan) -> tuple:
    """(mean, sigma) of the heavy part's edge count: every heavy cell is an
    independent Bernoulli(p) of its block, so the variance is the sum of
    rows * cols * p (1 - p) over the blocks."""
    s = sp.sizes.astype(np.float64)
    var = float((s[:, None] * s[None, :] * sp.p_hh * (1.0 - sp.p_hh)).sum())
    if sp.W.size:
        var += float((s[None, :] * sp.p_wh * (1.0 - sp.p_wh)).sum() + (s[:, None] * sp.p_hw * (1.0 - sp.p_hw)).sum())
    return sp.heavy_mean, var ** 0.5


def split_stage_ms(sampler, key) -> dict:
    """Host-clock ms of each stage of one warm split sample, run one by one
    with the sample's own keys: the light quilt (round, copy, map through
    W), the heavy round on the card, the copy of its kept pairs, the host
    dedup of the pieces.  The heavy round's device ms by CUDA events."""
    sp = sampler.split_plan
    lkey, hkey = prng.split(key)
    _, sub = prng.split(lkey)
    out, pieces = {}, []

    def clock(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) * 1e3
        return r

    if sp.light_plan is not None:
        ew = clock("light_quilt", lambda: quilt.quilt_run(sub, sp.light_plan).edges())
        pieces.append(np.stack([sp.W[ew[:, 0]], sp.W[ew[:, 1]]], axis=1))
    heavy = lambda: quilt._split_heavy_body(hkey, sp, budget=sp.heavy_budget, node_bits=quilt._node_bits(sp.n))  # noqa: E731
    src, dst, take = clock("heavy_round", heavy)
    pieces.append(clock("heavy_copy", lambda: torch.stack([src[take], dst[take]], 1).to(torch.int64).cpu().numpy()))
    edges = clock("host_dedup", lambda: quilt.dedup.dedup_edges(np.concatenate(pieces, axis=0)))
    out["heavy_round_device_ms"] = cuda_ms(heavy, reps=3)
    # the stages are split_run's own sequence: same key, same edges
    if not np.array_equal(edges, sampler.sample(key).edges):
        raise AssertionError("split_stage_ms's stages give other edges than sample(key)")
    return out


def phase_split_full_size(device, mu: float) -> dict:
    """The split session at n = 2^15 (THETA_1, the default session's
    attribute key): plan, one sample with the launch counts read, its
    gates (unique in-range edges; the count within 4 sigma of sum Q, and
    the heavy part's within 4 sigma of heavy_mean, both exact-cell laws),
    warm timings, a stage breakdown, the idle share, and kernel 1 against
    its plain version on the light plan's round."""
    t0 = time.perf_counter()
    sampler = MAGMSampler(split_config(FULL_LOG2_N, mu, device))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sp, lp = sampler.split_plan, sampler.split_plan.light_plan
    n = sampler.n
    M = 0 if sp.blk_rows is None else sp.blk_rows.numel()
    light = "none" if lp is None else f"B={lp.B} graphs={lp.num_graphs} budget={quilt._exact_budget(lp.p_max, lp.mean_edges)}"
    log(f"split plan n=2^{FULL_LOG2_N} mu={mu}: build_s={build_s} bprime={sp.bprime} R={sp.R} |W|={sp.W.size} "
        f"M={M} heavy_budget={sp.heavy_budget} heavy_mean={sp.heavy_mean} light {light}")
    if sp.heavy_budget is None or sp.heavy_budget == 0:
        raise AssertionError("the full-size split has no device heavy round")

    key = prng.PRNGKey(SEED + 200)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t = time.perf_counter()
    gs = sampler.sample(key)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t) * 1e3
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    if lp is not None and launches["quilt_prng_descent_lookup"] < 1:
        raise AssertionError("the split's light quilt did not launch quilt_prng_descent_lookup")
    check_edges(gs.edges, n, f"split n=2^{FULL_LOG2_N} mu={mu}")
    if gs.num_edges != gs.stats.kept_edges or gs.stats.heavy_groups != sp.R:
        raise AssertionError(f"edges {gs.edges.shape} vs stats {gs.stats}")
    mean, sigma = sum_q(sampler.F, sampler.config.params.thetas, device)
    is_heavy = np.ones(n, dtype=bool)
    is_heavy[sp.W] = False
    heavy_edges = int((is_heavy[gs.edges[:, 0]] | is_heavy[gs.edges[:, 1]]).sum())
    hmean, hsigma = heavy_moments(sp)
    z, zh = (gs.num_edges - mean) / sigma, (heavy_edges - hmean) / hsigma
    log(f"split sample n=2^{FULL_LOG2_N} mu={mu}: edges={gs.num_edges} stats={tuple(gs.stats)} launches={launches} "
        f"peak_mem_bytes={peak} cold_ms={cold_ms} sum_Q={mean} sigma={sigma} z={z} heavy_edges={heavy_edges} "
        f"heavy_mean={hmean} heavy_sigma={hsigma} z_heavy={zh}")
    if abs(z) > 4 or abs(zh) > 4:
        raise AssertionError(f"split counts outside 4 sigma: z={z} z_heavy={zh}")

    walls = timed_runs(sampler.sample, [prng.PRNGKey(SEED + 201 + i) for i in range(SPLIT_WARM[mu])])
    stages = split_stage_ms(sampler, prng.PRNGKey(SEED + 201))
    _, wall, busy, top = profiled_call(lambda: sampler.sample(prng.PRNGKey(SEED + 204)))
    log(f"timing split n=2^{FULL_LOG2_N} mu={mu}: ms_warm={walls} ms_median={statistics.median(walls)} "
        f"stage_ms={json.dumps(stages)} profiled_run wall_ms={wall} device_busy_ms={busy} "
        f"device_idle_share={1 - busy / wall} top_device_ops={top}")

    err = 0
    if lp is not None:
        # the light quilt's round: split_run hands quilt_run the second split
        _, sub = prng.split(prng.split(key)[0])
        args, kw = round_inputs(lp, sub)
        got = qd.quilt_prng_descent_lookup(*args, **kw)
        want = qd.quilt_prng_descent_lookup_plain(*args, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"kernel != plain on the split's light plan (mu={mu})")
            err = max(err, int((g.long() - w.long()).abs().max()))
        rows = got[0].numel()
        k_ms = cuda_ms(lambda: qd.quilt_prng_descent_lookup(*args, **kw), reps=20)
        bound, bound_by = kernel_bound_ms(lp, rows)
        log(f"kernel == plain: split light plan n=2^{FULL_LOG2_N} mu={mu} rows={rows} B={lp.B} "
            f"kernel_ms={k_ms} bound_ms={bound} ({bound_by})")
    return {"launches": launches["quilt_prng_descent_lookup"], "max_abs_err": err}


def same_chunks(what: str, got, want) -> int:
    if len(got) != len(want) or not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{what}: the card's chunks differ from the CPU's")
    return len(got)


def phase_split_cross_device(device) -> None:
    """The split, the shims, batches and streams at n = 2^12 (d = 12) on
    the card and on the CPU, same inputs and keys: equal edges and stats,
    member by member and chunk by chunk."""
    key = prng.PRNGKey(SEED + 210)
    for theta, name, mu in ((THETA_1, "THETA_1", 0.5), (THETA_1, "THETA_1", 0.8), (THETA_2, "THETA_2", 0.5)):
        cfg = split_config(CHECK_LOG2_N, mu, device, theta)
        cuda_s, cpu_s = MAGMSampler(cfg), MAGMSampler(cfg.replace(device="cpu"))
        ops.reset_kernel_launches()
        got = cuda_s.sample(key)
        launches = ops.kernel_launches()["quilt_prng_descent_lookup"]
        same_sample(f"split {name} mu={mu}", got, cpu_s.sample(key))
        if cuda_s.split_plan.light_plan is not None and launches < 1:
            raise AssertionError(f"split {name} mu={mu}: no launch of quilt_prng_descent_lookup")
        fb = [quilt.split_run(key, s.split_plan._replace(heavy_budget=None))[0] for s in (cuda_s, cpu_s)]
        if not np.array_equal(*fb):
            raise AssertionError(f"split {name} mu={mu}, heavy_budget=None: the card's edges differ from the CPU's")
        log(f"cross-device split {name} mu={mu} n=2^{CHECK_LOG2_N}: edges={got.num_edges} stats={tuple(got.stats)} "
            f"kernel launches={launches} host_binomials_edges={fb[0].shape[0]}")
    params = magm.make_params(THETA_2, DEFAULT_MU, CHECK_LOG2_N)
    F = cpu_s.F
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got, want = (quilt.quilt_sample_fast(key, params, F, seed=7, return_stats=True, device=d) for d in (device, "cpu"))
    if not np.array_equal(got[0], want[0]) or tuple(got[1]) != tuple(want[1]):
        raise AssertionError("quilt_sample_fast(seed=): the card's edges differ from the CPU's")
    log(f"cross-device quilt_sample_fast(seed=7) n=2^{CHECK_LOG2_N}: edges={got[0].shape[0]}")

    kcfg = SamplerConfig(params=kpgm.make_params(THETA_1, CHECK_LOG2_N))
    for name, cuda_s, cpu_s in (
        ("MAGM", MAGMSampler(paper_config(CHECK_LOG2_N, device)), MAGMSampler(paper_config(CHECK_LOG2_N, "cpu"))),
        ("KPGM", KPGMSampler(kcfg.replace(device=device)), KPGMSampler(kcfg.replace(device="cpu"))),
    ):
        ops.reset_kernel_launches()
        got = cuda_s.sample_batch(4, key)
        launches = ops.kernel_launches()["quilt_prng_descent_lookup"]
        want = cpu_s.sample_batch(4, key)
        for s, (g, w) in enumerate(zip(got, want)):
            same_sample(f"{name} sample_batch(4) member {s}", g, w)
        if launches != 1 or any(g.key is not None for g in got):
            raise AssertionError(f"{name} sample_batch(4) was not one fused round: {launches} launches")
        log(f"cross-device {name} sample_batch(4) n=2^{CHECK_LOG2_N}: fused, launches={launches} "
            f"edges={[g.num_edges for g in got]}")
    streams = (
        ("default", MAGMSampler(paper_config(CHECK_LOG2_N, device)), MAGMSampler(paper_config(CHECK_LOG2_N, "cpu"))),
        ("split", MAGMSampler(split_config(CHECK_LOG2_N, 0.5, device)), MAGMSampler(split_config(CHECK_LOG2_N, 0.5, "cpu"))),
        ("KPGM", KPGMSampler(kcfg.replace(device=device)), KPGMSampler(kcfg.replace(device="cpu"))),
    )
    for name, cuda_s, cpu_s in streams:
        chunks = same_chunks(
            f"{name} sample_stream", list(cuda_s.sample_stream(key, chunk_edges=5000)),
            list(cpu_s.sample_stream(key, chunk_edges=5000)),
        )
        log(f"cross-device {name} sample_stream(chunk_edges=5000) n=2^{CHECK_LOG2_N}: chunks={chunks}")


def fused_round_vs_plain(plan: quilt.QuiltPlan, key, run: quilt.QuiltRun, what: str) -> int:
    """Kernel 1 against its plain version on a fused run's last round, as
    quilt_run passes it: graphs 0 .. S * B^2 - 1 (graph s * B^2 + g' is
    block pair g' of sample s), the run's cumulative slots a graph, the
    round key of quilt_run's second split.  torch.equal on all four
    outputs; returns the max abs difference (0)."""
    key, _ = prng.split(key)
    _, rkey = prng.split(key)
    gids = torch.arange(run.num_samples * plan.num_graphs, dtype=torch.int32, device=plan.device)
    args = (ops.counter_seed(rkey), gids, plan.cum, plan.table_cfg, plan.table_node)
    kw = dict(a_tot=run.slots_per_graph, num_blocks=plan.B)
    got = qd.quilt_prng_descent_lookup(*args, **kw)
    want = qd.quilt_prng_descent_lookup_plain(*args, **kw)
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"kernel != plain on the fused round of {what}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    log(f"kernel == plain: fused round of {what}: graphs={gids.numel()} slots_per_graph={run.slots_per_graph} "
        f"rows={got[0].numel()} B={plan.B}")
    del got, want
    return err


def phase_fused_at_size(device, sampler) -> dict:
    """Batches and the stream at size: MAGMSampler(n = 2^15).sample_batch(4)
    as configured (4 x 49 graphs pass the candidate cap in the exact and
    the ranked round, so it draws sample(fold_in(key, s)) four times; the
    path taken is logged) and with backend="device" (one fused ranked round of 4 x 49 graphs; every
    graph's distinct count against its drawn target), KPGMSampler(d =
    16).sample_batch(4) (fused), and sample_stream(chunk_edges=2^16) of the
    n = 2^15 session against sample(key)."""
    key = prng.PRNGKey(SEED + 220)
    before = dict(quilt.DISPATCH_COUNTERS)
    ops.reset_kernel_launches()
    t = time.perf_counter()
    batch = sampler.sample_batch(4, key)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t) * 1e3
    launches, delta = ops.kernel_launches()["quilt_prng_descent_lookup"], counters_delta(before)
    if launches < 1:
        raise AssertionError(f"n=2^{FULL_LOG2_N} sample_batch(4) launched no quilt_prng_descent_lookup")
    for g in batch:
        check_edges(g.edges, sampler.n, "sample_batch member")
    path = "fused" if batch[0].key is None else "per-sample loop"
    log(f"sample_batch(4) n=2^{FULL_LOG2_N} backend=auto: {path}, launches={launches} counters={delta} "
        f"ms={loop_ms} edges={[g.num_edges for g in batch]}")

    fused = MAGMSampler(sampler.config.replace(F=sampler.F, backend="device"))
    before = dict(quilt.DISPATCH_COUNTERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t = time.perf_counter()
    batch = fused.sample_batch(4, key)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t) * 1e3
    launches, delta = ops.kernel_launches()["quilt_prng_descent_lookup"], counters_delta(before)
    peak = torch.cuda.max_memory_allocated()
    if delta["exact_fallbacks"] != 1 or launches < 1 or any(g.key is not None for g in batch):
        raise AssertionError(f"backend=device sample_batch(4) was not fused ranked: {launches} {delta}")
    for g in batch:
        check_edges(g.edges, sampler.n, "fused batch member")
    run = quilt.quilt_run(key, fused.plan, num_samples=4, backend="device")
    if not all(np.array_equal(e, g.edges) for e, g in zip(run.edges_per_sample(), batch)):
        raise AssertionError("the engine's fused run differs from sample_batch for the same key")
    short = run.targets - run.counts
    if (short < 0).any():
        raise AssertionError("a graph of the fused batch holds more cells than its target")
    err = fused_round_vs_plain(fused.plan, key, run, f"MAGM n=2^{FULL_LOG2_N} sample_batch(4) backend=device")
    log(f"sample_batch(4) n=2^{FULL_LOG2_N} backend=device: fused ranked, graphs={run.targets.size} "
        f"slots_per_graph={run.slots_per_graph} targets_met={int((short == 0).sum())} shortfall={int(short.sum())} "
        f"launches={launches} counters={delta} ms={fused_ms} peak_mem_bytes={peak} edges={[g.num_edges for g in batch]}")
    if (short > 0).any():
        log("fused batch: max_rounds or the cap ran out before every target was met (allowed, printed)")

    ks = KPGMSampler(SamplerConfig(params=kpgm.make_params(THETA_1, KPGM_BATCH_D), device=device))
    ops.reset_kernel_launches()
    t = time.perf_counter()
    kb = ks.sample_batch(4, key)
    torch.cuda.synchronize()
    k_ms = (time.perf_counter() - t) * 1e3
    k_launches = ops.kernel_launches()["quilt_prng_descent_lookup"]
    for g in kb:
        check_edges(g.edges, ks.n, "KPGM batch member")
    if k_launches < 1 or any(g.stats.sampled_edges != g.stats.target_edges for g in kb):
        raise AssertionError(f"KPGM d={KPGM_BATCH_D} sample_batch(4): launches={k_launches} stats={[g.stats for g in kb]}")
    krun = quilt.quilt_run(key, ks.plan, num_samples=4, exact_cells=False)
    if not all(np.array_equal(e, g.edges) for e, g in zip(krun.edges_per_sample(), kb)):
        raise AssertionError("the engine's fused KPGM run differs from sample_batch for the same key")
    err = max(err, fused_round_vs_plain(ks.plan, key, krun, f"KPGM d={KPGM_BATCH_D} sample_batch(4)"))
    del krun
    log(f"KPGM d={KPGM_BATCH_D} sample_batch(4): fused, launches={k_launches} ms={k_ms} "
        f"edges={[g.num_edges for g in kb]} (each equal to its target)")

    t = time.perf_counter()
    chunks = list(sampler.sample_stream(key, chunk_edges=1 << 16))
    stream_ms = (time.perf_counter() - t) * 1e3
    whole = sampler.sample(key).edges
    if not np.array_equal(np.concatenate(chunks), whole) or any(c.shape[0] != 1 << 16 for c in chunks[:-1]):
        raise AssertionError("sample_stream's chunks do not concatenate to sample(key).edges")
    log(f"sample_stream(chunk_edges=2^16) n=2^{FULL_LOG2_N}: chunks={len(chunks)} edges={whole.shape[0]} ms={stream_ms}")
    return {"fused_launches": launches, "max_abs_err": err}


def phase_validation_suite(device) -> None:
    """The 3-sigma suite on the card at the reference's setting (THETA_2,
    n = 2^12, d = 12, mu = 0.5): SUITE_SEEDS samples of each backend and of
    the split sampler ("split", split=True), every pair of backends and auto
    against split compared, each against the closed-form moments, and the
    per-cell block z of the exact laws ("auto", "balldrop", "split"), all
    over the blocks of the full quilt plan; no claim may fail."""
    params = magm.make_params(THETA_2, DEFAULT_MU, CHECK_LOG2_N)
    F = magm.sample_attributes(prng.PRNGKey(SEED + 170), 1 << CHECK_LOG2_N, params.mu, device=device).cpu().numpy()
    theory = validate.theory_moments(F, params.thetas.numpy())
    bins = validate.degree_bin_edges(1 << CHECK_LOG2_N)
    stats, secs = {}, {}
    ranks = quilt.build_quilt_plan(F, params.thetas, device=device).part.ranks
    for b in ("auto", "host", "balldrop", "split"):
        change = {"split": True} if b == "split" else {"backend": b}
        s = MAGMSampler(SamplerConfig(params=params, F=F, device=device, **change))
        t = time.perf_counter()
        stats[b] = validate.collect(b, lambda k: s.sample(prng.PRNGKey(1000 + k)).edges, range(SUITE_SEEDS),
                                    1 << CHECK_LOG2_N, ranks, bins)
        secs[b] = time.perf_counter() - t
    claims = []
    for a, b in (("auto", "host"), ("auto", "balldrop"), ("host", "balldrop"), ("auto", "split")):
        claims += validate.compare_backends(stats[a], stats[b], nsigma=3.0)
    for b in stats:
        claims += validate.compare_to_theory(stats[b], theory, nsigma=3.0)
    for c in claims:
        log(f"  claim {c.name}: delta={c.delta} bound={c.bound} ok={c.ok}")
    zmax = {}
    for b in ("auto", "balldrop", "split"):
        se = np.sqrt((theory.block_std**2 + np.abs(theory.block_mean) + 1.0) / SUITE_SEEDS)
        zmax[b] = float(np.abs((stats[b].blocks.mean(axis=0) - theory.block_mean) / se).max())
    failed = validate.failures(claims)
    log(f"3-sigma suite n=2^{CHECK_LOG2_N} seeds={SUITE_SEEDS}: claims={len(claims)} failed={len(failed)} "
        f"mean_edges theory={theory.mean_edges} " + " ".join(f"{b}={float(st.totals.mean())}" for b, st in stats.items())
        + f" per_cell_max_abs_z={json.dumps(zmax)} seconds={json.dumps(secs)}")
    if failed or max(zmax.values()) > 3.0:
        raise AssertionError(f"3-sigma suite: failed claims {failed}, per-cell z {zmax}")


def phase_split_and_batches(device, sampler) -> dict:
    """The split at n = 2^15 for each of SPLIT_MUS, the card against the
    CPU at n = 2^12, and the batches and stream at size (``sampler``: the
    n = 2^15 default session); logs each phase's seconds."""
    secs, out = {}, {"max_abs_err": 0, "launches": {}}
    for mu in SPLIT_MUS:
        t = time.perf_counter()
        r = phase_split_full_size(device, mu)
        secs[f"split_mu{mu}"] = time.perf_counter() - t
        out["max_abs_err"] = max(out["max_abs_err"], r["max_abs_err"])
        out["launches"][f"split_mu{mu}"] = r["launches"]
    t = time.perf_counter()
    phase_split_cross_device(device)
    secs["split_cross_device"] = time.perf_counter() - t
    t = time.perf_counter()
    r = phase_fused_at_size(device, sampler)
    out["launches"]["fused_batch"] = r["fused_launches"]
    out["max_abs_err"] = max(out["max_abs_err"], r["max_abs_err"])
    secs["batches_and_stream"] = time.perf_counter() - t
    log(f"split and batch phases: seconds={json.dumps(secs)} quilt_prng_descent_lookup launches={json.dumps(out['launches'])}")
    return out


RESUME_CHUNK = 1 << 16  # the stream's chunk at size: ~8 chunks of the n = 2^15 sample
RESUME_KILLS = (4, 6)  # stream.chunk visits of the first run and of the first resume
RESUME_KPGM_EDGES = 500_000  # KPGM d = 16 with num_edges: ~8 chunks
CROSS_CHUNK = 1 << 12  # the n = 2^12 cross-device streams
SERVE_SEEDS = 12
SERVE_QUEUE = 4
SERVE_SEQUENTIAL = 8
SERVE_STATUSES = {"ok": 0, "bad_request": 400, "deadline_exceeded": 408, "overloaded": 429, "error": 500}


def killed_stream(chunks, visit: int, replayed: int = 0) -> list:
    """Consume ``chunks`` under a FaultSchedule that kills stream.chunk at
    ``visit``; the chunks delivered before the fault (exactly ``visit -
    replayed``: a resumed stream's replay passes the site without
    delivering)."""
    got = []
    try:
        with chaos.active(chaos.FaultSchedule([chaos.FaultSpec("stream.chunk", (visit,))])):
            for c in chunks:
                got.append(c)
    except chaos.InjectedFault:
        pass
    else:
        raise AssertionError(f"the stream ended before its kill at chunk {visit}")
    if len(got) != visit - replayed:
        raise AssertionError(f"a kill at chunk {visit} delivered {len(got)} chunks")
    return got


def same_stream(what: str, got: list, whole: np.ndarray, chunk: int) -> None:
    if not np.array_equal(np.concatenate(got), whole) or any(c.shape[0] != chunk for c in got[:-1]):
        raise AssertionError(f"{what}: the killed and resumed stream differs from the uninterrupted one")


def kill_and_resume(what: str, make, key, chunk: int, **kw) -> dict:
    """A checkpointed stream of a fresh ``make()`` session killed at chunk
    RESUME_KILLS[0], resumed by another fresh session and killed again at
    visit RESUME_KILLS[1] of that replay, then resumed to its end: the
    splice must equal ``sample(key).edges``; the killed run's device
    buffers must be freed (memory back to where it was after a warm
    sample()).  Times the last resume against one sample(), and the
    checkpoint saves."""
    sampler = make()
    sampler.sample(key, **kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    whole = sampler.sample(key, **kw).edges
    sample_ms = (time.perf_counter() - t) * 1e3
    with tempfile.TemporaryDirectory() as d:
        saves = []
        real_save = stream_mod._save

        def timed_save(directory, state):
            t = time.perf_counter()
            real_save(directory, state)
            saves.append(time.perf_counter() - t)

        stream_mod._save = timed_save
        try:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_kernel_launches()
            got = killed_stream(sampler.sample_stream(key, chunk_edges=chunk, checkpoint_dir=d, **kw), RESUME_KILLS[0])
            freed = torch.cuda.memory_allocated() - before
            got += killed_stream(make().resume_stream(d), RESUME_KILLS[1], replayed=RESUME_KILLS[0])
            torch.cuda.synchronize()
            t = time.perf_counter()
            got += list(make().resume_stream(d))
            resume_ms = (time.perf_counter() - t) * 1e3
            peak = torch.cuda.max_memory_allocated()
            launches = ops.kernel_launches()["quilt_prng_descent_lookup"]
            if list(make().resume_stream(d)):
                raise AssertionError(f"{what}: a finished stream resumed with chunks")
        finally:
            stream_mod._save = real_save
    same_stream(what, got, whole, chunk)
    if freed > 0:
        raise AssertionError(f"{what}: the killed stream left {freed} bytes on the card")
    if launches < 3:
        raise AssertionError(f"{what}: {launches} launches of quilt_prng_descent_lookup in three engine runs")
    out = {"chunks": len(got), "edges": int(whole.shape[0]), "resume_ms": resume_ms, "sample_ms": sample_ms,
           "saves": len(saves), "saves_ms_total": sum(saves) * 1e3, "peak_mem_bytes": peak,
           "bytes_left_by_kill": freed, "launches": launches}
    log(f"kill and resume {what}: {json.dumps(out)}")
    return out


def phase_resume_cross_device(device) -> None:
    """At n = 2^12: a stream killed on the card resumes in a CPU session,
    and one killed on the CPU resumes on the card; both splices equal the
    CPU port's uninterrupted stream."""
    key = prng.PRNGKey(SEED + 310)
    cfg = paper_config(CHECK_LOG2_N, device)
    want = list(MAGMSampler(cfg.replace(device="cpu")).sample_stream(key, chunk_edges=CROSS_CHUNK))
    for src, dst in ((device, "cpu"), ("cpu", device)):
        with tempfile.TemporaryDirectory() as d:
            s = MAGMSampler(cfg.replace(device=src))
            got = killed_stream(s.sample_stream(key, chunk_edges=CROSS_CHUNK, checkpoint_dir=d), 3)
            got += list(MAGMSampler(cfg.replace(device=dst)).resume_stream(d))
        if same_chunks(f"resume {src} -> {dst} n=2^{CHECK_LOG2_N}", got, want) < 4:
            raise AssertionError("the cross-device stream is too short to be killed mid-stream")
    log(f"resume across devices n=2^{CHECK_LOG2_N}: card -> CPU and CPU -> card equal the CPU stream "
        f"({len(want)} chunks of {CROSS_CHUNK})")


def phase_save_fault(sampler) -> None:
    """A fault inside a save (checkpoint.rename at the save of step 3):
    latest_step still offers the previous cursor (2), and the resume from
    it equals sample(key)."""
    key = prng.PRNGKey(SEED + 320)
    with tempfile.TemporaryDirectory() as d:
        got = []
        try:
            with chaos.active(chaos.FaultSchedule([chaos.FaultSpec("checkpoint.rename", (3,))])):
                for c in sampler.sample_stream(key, chunk_edges=RESUME_CHUNK, checkpoint_dir=d):
                    got.append(c)
        except chaos.InjectedFault:
            pass
        step = ckpt_mod.latest_step(d)
        if step != 2 or len(got) != 3:
            raise AssertionError(f"a fault in the save of step 3: latest_step={step}, {len(got)} chunks out")
        rest = list(MAGMSampler(sampler.config.replace(F=sampler.F)).resume_stream(d))
    same_stream("resume after a fault in a save", got[:step] + rest, sampler.sample(key).edges, RESUME_CHUNK)
    log(f"fault inside a save: latest_step={step} after {len(got)} chunks out; the resume equals sample(key)")


def served(fut) -> "serve.ServeResponse":
    resp = fut.result(timeout=600)
    if not isinstance(resp, serve.ServeResponse) or SERVE_STATUSES.get(resp.status) != resp.code:
        raise AssertionError(f"an untyped response: {resp!r}")
    return resp


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def phase_serve(sampler) -> dict:
    """GraphServer over the n = 2^15 session (chunks of 2^16): a burst of
    SERVE_SEEDS seeds against max_queue = SERVE_QUEUE, SERVE_SEQUENTIAL
    requests one after another, a retried InjectedFault, a DeviceLoss at
    quilt.dispatch (500, then ok), an expired deadline (408, no launch),
    garbage payloads (400), and the CLI as a subprocess."""
    out = {}
    ops.reset_kernel_launches()
    with serve.GraphServer(sampler, max_queue=SERVE_QUEUE, chunk_edges=RESUME_CHUNK) as srv:
        futures = [srv.submit(key=prng.PRNGKey(SEED + 400 + i)) for i in range(SERVE_SEEDS)]
        burst = [served(f) for f in futures]
        stats = dict(srv.stats)
    launches = ops.kernel_launches()["quilt_prng_descent_lookup"]
    ok = [(i, r) for i, r in enumerate(burst) if r.ok]
    if stats["accepted"] + stats["shed"] != SERVE_SEEDS or stats["accepted"] != len(ok) or not ok:
        raise AssertionError(f"burst: {stats}, {len(ok)} ok")
    if any(not r.ok and (r.status, r.code) != ("overloaded", 429) for r in burst):
        raise AssertionError(f"burst: a response neither ok nor shed: {[r.status for r in burst]}")
    if launches < len(ok):
        raise AssertionError(f"burst: {launches} launches of quilt_prng_descent_lookup for {len(ok)} samples")
    for i, r in ok:
        if not np.array_equal(r.edges, sampler.sample(prng.PRNGKey(SEED + 400 + i)).edges):
            raise AssertionError(f"burst: seed {SEED + 400 + i} served other edges than sample()")
    lat = [r.wait_s + r.service_s for _, r in ok]
    bound = (SERVE_QUEUE + 1) * max(r.service_s for _, r in ok)
    if percentile(lat, 0.99) > bound:
        raise AssertionError(f"burst: p99 {percentile(lat, 0.99)} s over (max_queue + 1) x max service {bound} s")
    out["burst"] = {"accepted": stats["accepted"], "shed": stats["shed"], "p99_latency_s": percentile(lat, 0.99),
                    "bound_s": bound, "launches": launches}
    log(f"serve burst n=2^{FULL_LOG2_N}: {json.dumps(out['burst'])} wait_s={[r.wait_s for _, r in ok]} "
        f"service_s={[r.service_s for _, r in ok]}")

    with serve.GraphServer(sampler, chunk_edges=RESUME_CHUNK) as srv:
        seq = [served(srv.submit(key=prng.PRNGKey(SEED + 420 + i))) for i in range(SERVE_SEQUENTIAL)]
        if not all(r.ok for r in seq):
            raise AssertionError(f"sequential requests: {[r.status for r in seq]}")
        svc = [r.service_s for r in seq]
        edges = sum(int(r.edges.shape[0]) for r in seq)
        out["sequential"] = {"service_s_p50": percentile(svc, 0.5), "service_s_p99": percentile(svc, 0.99),
                             "wait_s_p50": percentile([r.wait_s for r in seq], 0.5),
                             "edges_per_s": edges / sum(svc), "requests": len(seq)}
        log(f"serve sequential n=2^{FULL_LOG2_N}: {json.dumps(out['sequential'])} service_s={svc}")

        with chaos.active(chaos.FaultSchedule([chaos.FaultSpec("serve.request", (0,))])):
            r = served(srv.submit(key=prng.PRNGKey(SEED + 430)))
        if not r.ok or srv.stats["retries"] < 1:
            raise AssertionError(f"an InjectedFault was not retried to ok: {r.status} {srv.stats}")
        with chaos.active(chaos.FaultSchedule([chaos.FaultSpec("quilt.dispatch", (0,), "device_loss", 0)])):
            lost = served(srv.submit(key=prng.PRNGKey(SEED + 431)))
        after = served(srv.submit(key=prng.PRNGKey(SEED + 431)))
        if (lost.status, lost.code) != ("error", 500) or "DeviceLoss" not in lost.message or not after.ok:
            raise AssertionError(f"DeviceLoss: {lost.status} {lost.message}; next {after.status}")
        if not np.array_equal(after.edges, sampler.sample(prng.PRNGKey(SEED + 431)).edges):
            raise AssertionError("the request after a DeviceLoss served other edges than sample()")
        torch.cuda.synchronize()
        ops.reset_kernel_launches()
        late = served(srv.submit(key=prng.PRNGKey(SEED + 432), deadline_s=1e-9))
        torch.cuda.synchronize()
        if (late.status, late.code, late.service_s) != ("deadline_exceeded", 408, 0.0) or any(ops.kernel_launches().values()):
            raise AssertionError(f"an expired deadline: {late.status} service_s={late.service_s} {ops.kernel_launches()}")
        garbage = [None, 42, "sample please", {"kind": "train"}, {"bogus": 1}, {"chunk_edges": 0},
                   {"chunk_edges": "many"}, {"seed": "not-a-seed"}, {"deadline_s": -1.0}, {"num_edges": 10}]
        codes = [(r.status, r.code) for r in (served(srv.handle(p)) for p in garbage)]
        if any(c != ("bad_request", 400) for c in codes):
            raise AssertionError(f"garbage payloads: {codes}")
        out["faults"] = dict(srv.stats)
    log(f"serve faults: retried to ok, DeviceLoss -> 500 then ok, expired deadline -> 408 with no launch, "
        f"{len(garbage)} garbage payloads -> 400; stats={json.dumps(out['faults'])}")

    t = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--magm", "--graph-d", str(FULL_LOG2_N), "--requests", "4",
         "--chunk-edges", str(RESUME_CHUNK), "--device", str(sampler.device)],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")), capture_output=True, text=True, timeout=600,
    )
    for line in cli.stdout.splitlines():
        log(f"  cli: {line}")
    if cli.returncode != 0 or "[serve] OK" not in cli.stdout or "'errors': 0" not in cli.stdout:
        raise AssertionError(f"the serve CLI failed ({cli.returncode}): {cli.stderr[-2000:]}")
    out["cli_s"] = time.perf_counter() - t
    return out


def phase_resilience_and_serving(device, sampler) -> dict:
    """Kill and resume at size (the n = 2^15 default session, the split at
    mu = 0.5 and KPGM d = 16 with num_edges), across devices at n = 2^12,
    a fault inside a save, and the GraphServer over the n = 2^15 session;
    logs each part's seconds."""
    secs, out = {}, {}
    key = prng.PRNGKey(SEED + 300)
    kpgm_cfg = SamplerConfig(params=kpgm.make_params(THETA_1, KPGM_BATCH_D), device=device)
    parts = (
        (f"default n=2^{FULL_LOG2_N}", lambda: MAGMSampler(sampler.config.replace(F=sampler.F)), {}),
        # one split session for the run and its resumes: its plan takes seconds to build
        (f"split mu=0.5 n=2^{FULL_LOG2_N}", lambda s=MAGMSampler(split_config(FULL_LOG2_N, 0.5, device)): s, {}),
        (f"KPGM d={KPGM_BATCH_D}", lambda: KPGMSampler(kpgm_cfg), {"num_edges": RESUME_KPGM_EDGES}),
    )
    for name, make, kw in parts:
        t = time.perf_counter()
        out[name] = kill_and_resume(name, make, key, RESUME_CHUNK, **kw)
        secs[name] = time.perf_counter() - t
    t = time.perf_counter()
    phase_resume_cross_device(device)
    secs["resume_cross_device"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_save_fault(sampler)
    secs["save_fault"] = time.perf_counter() - t
    t = time.perf_counter()
    out["serve"] = phase_serve(sampler)
    secs["serve"] = time.perf_counter() - t
    log(f"resilience and serving phases: seconds={json.dumps(secs)} total={sum(secs.values())}")
    return out


# --- MAGFIT: variational EM, edge ingest and the round trip ---

THETA_FIT = np.array([[0.25, 0.55], [0.55, 0.82]], dtype=np.float32)  # benchmarks/bench_fit.py's
FIT_CHECK = (10, 3)  # (log2 n, d): the card against the CPU port, bench_fit's thetas
FIT_BENCH = (12, 4)  # bench_fit.py's setting: ~1.45 M exact edges
FIT_CLAIM = (12, 5)  # tests/test_magfit.py TestRecovery's setting
FIT_ROUNDTRIP_LOG2_N = 12  # the paper's THETA_1, mu = 0.5, d = log2 n
# the round trip's fits run one EM iteration (and the hardening refit) of
# the default options: at d = 12 an iteration takes ~6 s on the card (40
# E-step steps of ~83 ms, an M-step of ~2.8 s), and the phase's share of
# the run is ~90 s
FIT_ROUNDTRIP_OPTS = dict(em_iters=1)
FIT_CAP_LOG2_N = 13  # n 2^d = 2^26 at d = 13: FIT_STATE_CAP / 2
FIT_CLAIM_TOL = 2e-3  # TestRecovery's deterministic error budget, folded into the SE
# a known-F fit stops at iteration 2 by this relative tol: after iteration 1
# the ELBO gains ~1e-5 a step, within float noise of each other, so with the
# default tol the stop could differ between two evaluations
FIT_KNOWN_F = dict(order=3, em_iters=3, tol=1e-2)
# tolerances of tests/test_torch_magfit.py (see its notes for the fits')
FIT_RTOL, FIT_LOGITS_ATOL, FIT_MSTEP_ATOL, FIT_MU_ATOL = 1e-5, 1e-3, 1e-4, 1e-6
FIT_KNOWN_F_TRACE_RTOL, FIT_KNOWN_F_THETA_ATOL = 3e-5, 3e-2


def fit_graph(log2_n: int, d: int, theta, attr_seed: int, edge_seed: int):
    """(params, F, edges): attributes from PRNGKey(attr_seed) at mu = 0.5 and
    an exact per-pair Bernoulli graph (fit.recover.exact_edges, host)."""
    params = magm.make_params(theta, 0.5, d)
    F = magm.sample_attributes(prng.PRNGKey(attr_seed), 1 << log2_n, params.mu, device="cpu").numpy()
    return params, F, fit_recover.exact_edges(params, F, edge_seed)


def within(what: str, got, want, rtol: float = 0.0, atol: float = 0.0) -> float:
    """max |got - want|, raising past atol + rtol |want|."""
    g = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    w = np.asarray(want.detach().cpu() if isinstance(want, torch.Tensor) else want, dtype=np.float64)
    err = np.abs(g - w)
    if g.shape != w.shape or not np.all(np.isfinite(g)) or not np.all(err <= atol + rtol * np.abs(w)):
        raise AssertionError(f"{what}: max |diff| {err.max() if err.size else None} past rtol={rtol} atol={atol}")
    return float(err.max())


def same_fit(what: str, a, b) -> None:
    if not (np.array_equal(a.elbo_trace, b.elbo_trace) and torch.equal(a.params.thetas, b.params.thetas)
            and torch.equal(a.params.mu, b.params.mu) and np.array_equal(a.phi, b.phi)
            and (a.iterations, a.converged) == (b.iterations, b.converged)):
        raise AssertionError(f"{what}: two fits with the same key differ")


def fit_cross_device(device) -> dict:
    """Gates 1 and 2 at n = 2^10, d = 3: elbo (and elbo_dense through
    magm_logprob), edge_cell_counts, penalty_coeffs, estep(steps=5),
    mstep(steps=4) and a known-F magfit on the card against the CPU port;
    estep and the fit twice on the card, bit for bit."""
    log2_n, d = FIT_CHECK
    n = 1 << log2_n
    _, F, edges = fit_graph(log2_n, d, THETA_FIT, SEED, SEED + 1)
    cpu, gpu = magfit.shard_edges(edges, n, device="cpu"), magfit.shard_edges(edges, n, device=device)
    rng = np.random.default_rng(SEED + 400)
    phi = rng.uniform(0.05, 0.95, (n, d)).astype(np.float32)
    pl = (0.1 * rng.standard_normal((n, d))).astype(np.float32)
    th = rng.uniform(0.1, 0.9, (d, 2, 2)).astype(np.float32)
    mu = np.full(d, 0.5, dtype=np.float32)
    err = {}
    e_gpu = magfit.elbo(phi, th, mu, gpu, device=device)
    err["elbo"] = within("elbo", e_gpu, magfit.elbo(phi, th, mu, cpu, device="cpu"), FIT_RTOL)
    ops.reset_kernel_launches()
    dense = magfit.elbo_dense(phi, th, mu, edges, n, use_kernel=True, device=device)
    torch.cuda.synchronize()
    k3 = ops.kernel_launches()["magm_logprob"]
    err["elbo_dense_kernel"] = within("elbo_dense (magm_logprob) vs elbo", dense, e_gpu, FIT_RTOL)
    for name, fn in (("edge_cell_counts", lambda dt, dev: magfit.edge_cell_counts(phi, dt, device=dev)),
                     ("penalty_coeffs", lambda dt, dev: torch.stack(magfit.penalty_coeffs(phi, th, dt, order=3,
                                                                                           device=dev)))):
        err[name] = within(name, fn(gpu, device), fn(cpu, "cpu"), FIT_RTOL)
    e1 = magfit.estep(pl, th, mu, gpu, steps=5, device=device)
    e2 = magfit.estep(pl, th, mu, gpu, steps=5, device=device)
    ec = magfit.estep(pl, th, mu, cpu, steps=5, device="cpu")
    if not all(torch.equal(a, b) for a, b in zip(e1, e2)):
        raise AssertionError("estep: two runs on the card differ")
    err["estep_logits"] = within("estep logits", e1[0], ec[0], atol=FIT_LOGITS_ATOL)
    err["estep_value"] = within("estep value", e1[1], ec[1], FIT_RTOL)
    m_gpu = magfit.mstep(pl, th, mu, gpu, steps=4, device=device)
    m_cpu = magfit.mstep(pl, th, mu, cpu, steps=4, device="cpu")
    err["mstep_thetas"] = within("mstep thetas", m_gpu[0], m_cpu[0], atol=FIT_MSTEP_ATOL)
    err["mstep_mu"] = within("mstep mu", m_gpu[1], m_cpu[1], atol=FIT_MU_ATOL)
    kw = dict(key=prng.PRNGKey(SEED + 2), options=magfit.FitOptions(**FIT_KNOWN_F), phi_init=F.astype(np.float32),
              fit_phi=False)
    fits = [magfit.magfit(edges, n, d, device=device, **kw) for _ in range(2)]
    same_fit("known-F magfit", *fits)
    fc = magfit.magfit(edges, n, d, device="cpu", **kw)
    if (fits[0].iterations, fits[0].converged) != (fc.iterations, fc.converged):
        raise AssertionError(f"known-F magfit: card {fits[0].iterations, fits[0].converged} "
                             f"CPU {fc.iterations, fc.converged}")
    err["magfit_trace"] = within("magfit trace", fits[0].elbo_trace, fc.elbo_trace, FIT_KNOWN_F_TRACE_RTOL)
    err["magfit_thetas"] = within("magfit thetas", fits[0].params.thetas, fc.params.thetas,
                                  atol=FIT_KNOWN_F_THETA_ATOL)
    log(f"fit card vs CPU n=2^{log2_n} d={d} edges={edges.shape[0]}: max_abs_err {json.dumps(err)}; "
        f"estep and known-F magfit repeated bit for bit ({fits[0].iterations} iterations, "
        f"converged={fits[0].converged}); elbo_dense launches magm_logprob={k3}")
    return {"magm_logprob": k3}


def fit_bench(device) -> dict:
    """Gate 3, bench_fit.py's rows on the card: one estep (10 steps, order
    3) and a known-F magfit (em_iters=8); launches no kernel."""
    log2_n, d = FIT_BENCH
    n = 1 << log2_n
    t = time.perf_counter()
    _, F, edges = fit_graph(log2_n, d, THETA_FIT, SEED, SEED + 1)
    log(f"fit bench: exact_edges s={time.perf_counter() - t}")
    e = edges.shape[0]
    data = magfit.shard_edges(edges, n, device=device)
    pl = 0.1 * prng.normal(prng.PRNGKey(1), (n, d), device=device)
    thetas = torch.full((d, 2, 2), 0.4, device=device)
    mu = torch.full((d,), 0.5, device=device)
    est = lambda: magfit.estep(pl, thetas, mu, data, steps=10, order=3, device=device)  # noqa: E731
    est()
    torch.cuda.reset_peak_memory_stats()
    ms = statistics.median(timed_runs(lambda _: est(), range(2)))
    peak = torch.cuda.max_memory_allocated()
    # the idle share of a 3-step call: tracing a 10-step one takes ~13 s
    t = time.perf_counter()
    _, wall, busy, top = profiled_call(lambda: magfit.estep(pl, thetas, mu, data, steps=3, order=3, device=device))
    log(f"fit bench: profiled estep (3 steps) s={time.perf_counter() - t}")
    rows = [{"name": "fit_estep", "us_per_call": ms * 1e3,
             "derived": f"n={n};edges={e};steps=10;order=3;ms_per_edge={ms / e:.9f}"}]
    log(f"fit_estep: ms={ms} ms_per_step={ms / 10} peak_bytes={peak} idle_share (3 steps)={1 - busy / wall} "
        f"(profiled wall {wall} ms, device {busy} ms) top={top}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    fit = magfit.magfit(edges, n, d, key=prng.PRNGKey(2), options=magfit.FitOptions(order=3, em_iters=8),
                        phi_init=F.astype(np.float32), fit_phi=False, device=device)
    t_em = time.perf_counter() - t
    tr = fit.elbo_trace
    if not (np.all(np.isfinite(tr)) and np.all(np.diff(tr) >= 0)):
        raise AssertionError(f"fit_em: trace {tr}")
    rows.append({"name": "fit_em", "us_per_call": t_em * 1e6,
                 "derived": f"n={n};edges={e};iters={fit.iterations};converged={fit.converged};"
                            f"elbo_gain={float(tr[-1] - tr[0]):.1f}"})
    for row in rows:
        log("bench row " + json.dumps({"schema": "qkg-bench-v1", **row}))
    return {}


def fit_claim(device, keys=(0,)) -> dict:
    """Gate 4, the reference's recovery claim (TestRecovery, its fit keys
    0, 1, 2; the full run takes key 0, ``--fit`` all three): for each key a
    known-F fit of an exact graph at n = 2^12, d = 5, order 4, 6 EM
    iterations; every canonical theta within 3 sigma of the truth,
    sigma = sqrt(SE^2 + 0.002^2) from 24 bootstrap replicates."""
    log2_n, d = FIT_CLAIM
    params = magm.make_params(THETA_FIT, 0.5, d)
    truth = fit_recover.canonicalize(params.thetas, params.mu)[0]
    for key in keys:
        t = time.perf_counter()
        rep = fit_recover.recover(params, 1 << log2_n, key=prng.PRNGKey(key),
                                  options=magfit.FitOptions(order=4, em_iters=6), known_F=True, exact_observed=True,
                                  num_boot=24, device=device)
        secs = time.perf_counter() - t
        z = np.abs(rep.theta_hat - truth) / np.sqrt(rep.theta_se**2 + FIT_CLAIM_TOL**2)
        if not (np.all(np.diff(rep.fit.elbo_trace) >= 0) and z.max() < 3.0):
            raise AssertionError(f"recovery claim, key {key}: max z {z.max()} trace {rep.fit.elbo_trace}")
        log(f"recovery claim n=2^{log2_n} d={d} key={key}: edges={rep.edges.shape[0]} max_z={z.max()} "
            f"iterations={rep.fit.iterations} converged={rep.fit.converged} se_max={rep.theta_se.max()} "
            f"seconds={secs}")
    return {}  # exact_observed: the host sampler, no kernel


def k1_launches(fn):
    """(fn(), kernel 1's launches in it)."""
    before = ops.kernel_launches()["quilt_prng_descent_lookup"]
    out = fn()
    torch.cuda.synchronize()
    return out, ops.kernel_launches()["quilt_prng_descent_lookup"] - before


def fit_round_trip(device) -> dict:
    """Gate 5, the round trip through the session at the paper's setting
    (THETA_1, mu = 0.5, n = 2^12, d = 12, FIT_ROUNDTRIP_OPTS): recover's
    observed sample on the card and its latent fit, api.fit_config on the
    same edges and one resample of the fitted config; then the known-F
    round trip (recover(known_F=True)) and a resample of its config by the
    default session.  Every quilting sample must launch kernel 1, and the
    round trip at least twice.

    The latent fit's config is resampled by the section-5 split
    (split=True): a latent fit at d = log2 n drives some attributes' mu to
    the clip (0.001 or 0.999; the reference's fit does the same), so few
    configurations hold many nodes each, B is large, and the unobserved
    theta cells keep their starting values; the default session's
    proposal of B^2 KPGM graphs over all 4^d cells then asks the host path
    for more candidates than the card holds.  The split samples such heavy
    configurations by binomials and quilts only the light nodes (kernel 1
    runs only if there are any)."""
    log2_n = FIT_ROUNDTRIP_LOG2_N
    n = 1 << log2_n
    params = magm.make_params(THETA_1, DEFAULT_MU, log2_n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    k1 = {}
    t0 = time.perf_counter()
    opts = magfit.FitOptions(**FIT_ROUNDTRIP_OPTS)
    rep, k1["observed"] = k1_launches(lambda: fit_recover.recover(params, n, backend="auto", known_F=False,
                                                                  options=opts, device=device))
    t1 = time.perf_counter()
    cfg, fit = api_fit_config(rep.edges, n, log2_n, options=opts, device=device)
    t2 = time.perf_counter()
    resampled, k1["split_resample"] = k1_launches(
        lambda: MAGMSampler(cfg.replace(split=True)).sample(prng.PRNGKey(SEED + 5)))
    t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    known, k1["known_f_observed"] = k1_launches(lambda: fit_recover.recover(params, n, known_F=True, options=opts,
                                                                            device=device))
    t4 = time.perf_counter()
    known_resampled, k1["known_f_resample"] = k1_launches(
        lambda: MAGMSampler(known.config).sample(prng.PRNGKey(SEED + 5)))
    t5 = time.perf_counter()
    cfgs = np.unique(magm.configs_from_attributes(torch.from_numpy(cfg.F)).numpy(), return_counts=True)[1]
    log(f"round trip fitted config: mu={np.round(fit.params.mu.numpy(), 3).tolist()} configs={cfgs.size} "
        f"max_multiplicity={cfgs.max()} split stats={resampled.stats}")
    for f in (rep.fit, fit, known.fit):
        if not (np.all(np.isfinite(f.elbo_trace)) and np.all(np.diff(f.elbo_trace) >= 0)
                and torch.isfinite(f.params.thetas).all() and np.isfinite(f.phi).all()):
            raise AssertionError(f"round trip: fit not finite or trace decreasing: {f.elbo_trace}")
    check_edges(resampled.edges, n, "round trip split resample")
    check_edges(known_resampled.edges, n, "round trip known-F resample")
    quilted = {"observed": True, "split_resample": resampled.stats.light_nodes > 0,
               "known_f_observed": True, "known_f_resample": True}
    if any(k1[k] < 1 for k, q in quilted.items() if q) or sum(k1.values()) < 2:
        raise AssertionError(f"round trip: quilt_prng_descent_lookup launches {k1}")
    # the observed sample alone, timed on a session of the true config
    observed = MAGMSampler(rep.true_config)
    sample_ms = statistics.median(timed_runs(lambda k: observed.sample(prng.PRNGKey(k)), range(2)))
    data = magfit.shard_edges(rep.edges, n, device=device)
    pl = magfit._logit(torch.from_numpy(fit.phi).to(device))
    th, mu = fit.params.thetas.to(device), fit.params.mu.to(device)
    steps = 10
    e_ms = timed_runs(lambda _: magfit.estep(pl, th, mu, data, steps=steps, device=device), [0])[0] / steps
    m_ms = timed_runs(lambda _: magfit.mstep(pl, th, mu, data, device=device), [0])[0]
    _, wall, busy, top = profiled_call(lambda: magfit.estep(pl, th, mu, data, steps=3, device=device))
    log(f"round trip n=2^{log2_n} d={log2_n}: observed={rep.edges.shape[0]} split resample={resampled.num_edges} "
        f"known-F resample={known_resampled.num_edges} edges; recover s={t1 - t0} (iterations="
        f"{rep.fit.iterations} converged={rep.fit.converged}) fit_config s={t2 - t1} (iterations={fit.iterations} "
        f"converged={fit.converged} trace {fit.elbo_trace[0]} -> {fit.elbo_trace[-1]}) split resample ms "
        f"(session and sample)={(t3 - t2) * 1e3} known-F recover s={t4 - t3} (iterations={known.fit.iterations}) "
        f"known-F resample ms (session and sample)={(t5 - t4) * 1e3} sample ms={sample_ms}; "
        f"per E-step step ms={e_ms} per M-step ms={m_ms}; E-step (3 steps) idle_share={1 - busy / wall} "
        f"(wall {wall} ms, device {busy} ms) top={top}; latent part peak_bytes={peak}; "
        f"launches quilt_prng_descent_lookup={json.dumps(k1)}")
    return {"quilt_prng_descent_lookup": sum(k1.values())}


def fit_at_cap(device) -> dict:
    """Gate 6: one estep(steps=5) and one mstep at n = 2^13, d = 13 (THETA_1,
    mu = 0.5; n 2^d = 2^26), on the session's sample, timed, with peak
    memory; returns kernel 1's launches in the sample."""
    log2_n = FIT_CAP_LOG2_N
    n = 1 << log2_n
    ops.reset_kernel_launches()
    edges = MAGMSampler(paper_config(log2_n, device)).sample(prng.PRNGKey(SEED + 6)).edges
    launches = ops.kernel_launches()["quilt_prng_descent_lookup"]
    data = magfit.shard_edges(edges, n, device=device)
    pl, th, mu = magfit.init_state(prng.PRNGKey(SEED + 7), n, log2_n, edges.shape[0], device=device)
    out = {}
    for name, fn in (("estep", lambda: magfit.estep(pl, th, mu, data, steps=5, device=device)),
                     ("mstep", lambda: magfit.mstep(pl, th, mu, data, device=device))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = ((time.perf_counter() - t) * 1e3, torch.cuda.max_memory_allocated())
        if not all(torch.isfinite(x).all() for x in res):
            raise AssertionError(f"{name} at the cap: not finite")
    log(f"fit at the cap n=2^{log2_n} d={log2_n} edges={edges.shape[0]}: "
        + " ".join(f"{k} ms={v[0]} peak_bytes={v[1]}" for k, v in out.items()))
    return {"quilt_prng_descent_lookup": launches}


def phase_magfit(device, claim_keys=(0,)) -> dict:
    """MAGFIT on the card, gates 1-6 (each function's docstring), the
    recovery claim at ``claim_keys``; returns this phase's kernel launches
    (each part returns its own) and logs each part's seconds."""
    secs, launches = {}, {"quilt_prng_descent_lookup": 0, "magm_logprob": 0}
    for name, fn in (("cross_device", fit_cross_device), ("bench", fit_bench),
                     ("claim", lambda dev: fit_claim(dev, claim_keys)),
                     ("round_trip", fit_round_trip), ("cap", fit_at_cap)):
        t = time.perf_counter()
        for kernel, count in fn(device).items():
            launches[kernel] += count
        secs[name] = time.perf_counter() - t
    log(f"magfit phases: seconds={json.dumps(secs)} total={sum(secs.values())} launches={json.dumps(launches)}")
    return launches


# --- the LM: serve_lm at full width, its timings, gates 1-6 (the dense family's) ---

LM_BATCH, LM_PROMPT, LM_GEN = 4, 32, 16  # the serve CLI's defaults
LM_SMOKE = ("olmo_1b", "qwen3_14b", "yi_9b", "deepseek_67b")
LM_CHECK = (2, 20)  # (batch, prompt) of the smoke checks, as tests/test_torch_models.py
LM_F32_REL, LM_BF16_ATOL = 1e-4, 0.05  # the CPU tests' bounds (tests/test_torch_models.py)
LM_PARITY_REL = 0.05  # the reference's relative decode-parity bound (tests/test_models.py:78-80)
LM_CPU_LEG_S = 60.0  # gate 4's CPU leg: its depth is cut past this estimate
# deepseek-67b: 95 layers x 1.38 GB of bf16 weights do not fit one 80 GB card;
# 40 layers (55.4 GB) and the 1.68 GB embedding do, with room for the draw
LM_DEEPSEEK_LAYERS = 40


def events_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` by CUDA events around ``reps`` back-to-back calls,
    warm, with no spin ahead of them: where the host enqueues slower than
    the device runs, this is the host's pace, what a serve loop sees."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lm_close(what: str, got: torch.Tensor, want: torch.Tensor, bound: float) -> float:
    err = float((got.double().cpu() - want.double().cpu()).abs().max())
    log(f"lm check {what}: max |card - cpu| = {err} (bound {bound})")
    if tuple(got.shape) != tuple(want.shape) or not err <= bound:
        raise AssertionError(f"{what}: {err} > {bound} or shapes {tuple(got.shape)} != {tuple(want.shape)}")
    return err


def _port_frame(filename: str, lineno: int) -> str:
    """``path:line`` of the innermost frame of the call in ``src/repro_torch``
    (the port's line that reached the op), else of the op's caller."""
    port = os.path.join(ROOT, "src", "repro_torch") + os.sep
    for frame in reversed(traceback.extract_stack()):
        if frame.filename.startswith(port):
            return f"{os.path.relpath(frame.filename, ROOT)}:{frame.lineno}"
    return f"{os.path.relpath(filename, ROOT)}:{lineno}"


def sync_sites(fn) -> dict:
    """The host-device synchronisations one call of ``fn`` makes
    (``torch.cuda.set_sync_debug_mode("warn")``; a copy from pageable host
    memory syncs too): their count, and every site with its count, as the
    innermost line of ``src/repro_torch`` on the stack (else the line that
    called the op)."""
    hits = []

    def record(message, category, filename, lineno, file=None, line=None):
        # the first call in a process also warns that the mode is a
        # prototype ("... synchronizing operations"): a notice, not a sync
        text = str(message)
        if "synchroniz" in text and "prototype" not in text:
            hits.append(_port_frame(filename, lineno))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    per_site = collections.Counter(hits)
    return {"count": len(hits), "sites": dict(sorted(per_site.items()))}


def lm_timings(model, params, prompts, what: str, context=None) -> dict:
    """Warm timings of one served model: prefill and a decode step by CUDA
    events (as a loop sees them, and device-bound behind a spin kernel), the
    whole generation as serve_lm runs it (host clock), tokens/s, a decode
    step's device busy share, and each beside its bound."""
    cfg = model.cfg
    b, s = prompts.shape
    prefill = lm_steps.make_prefill_step(model, max_len=s + LM_GEN)
    decode = lm_steps.make_decode_step(model)
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": prompts, "context": context})
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]

        def step():  # rewrites position s: a decode step at the loop's first length
            return decode(params, {"cache": cache, "tokens": tok, "cache_len": s, "context": context})

        def pre():
            return prefill(params, {"tokens": prompts, "context": context})

        out = {
            "prefill_ms": events_ms(pre, 5), "prefill_device_ms": cuda_ms(pre, 5),
            "decode_ms": events_ms(step, 20), "decode_device_ms": cuda_ms(step, 20),
        }
        walls = timed_runs(lambda _: serve.greedy_generate(model, params, prompts, LM_GEN, context), range(3))
        _, wall, busy, top = profiled_call(step)
        syncs = sync_sites(step)
    gen_ms = statistics.median(walls)
    dshape = ShapeConfig("serve", s + LM_GEN, b, "decode")
    pshape = ShapeConfig("serve", s, b, "prefill")
    out.update({
        "generate_ms_host_clock": walls, "tokens_per_s": b * LM_GEN / (gen_ms / 1e3),
        "decode_bound_ms": model_min_bytes(cfg, dshape, chips=1) * 1e9 / HBM_BYTES_PER_S * 1e3,
        "prefill_bound_ms": max(model_flops(cfg, pshape, chips=1) * 1e9 / BF16_FLOPS_PER_S,
                                model_min_bytes(cfg, pshape, chips=1) * 1e9 / HBM_BYTES_PER_S) * 1e3,
        "decode_step_profiled": {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
                                 "top_device_ops": top},
        "decode_step_syncs": syncs,
        "params": cfg.param_count(), "layers": cfg.num_layers, "batch": b, "prompt": s, "gen": LM_GEN,
    })
    log(f"lm timing {what}: {json.dumps(out)}")
    return out


def lm_parity(model, params, device, what: str, context=None) -> None:
    """Gates 1-2 at full width: finite logits, and decode(prefill(x[:S]),
    x[S]) against forward(x[:S + 1])[-1] within LM_PARITY_REL x max|logit|
    (the reference's bound at its smoke configs).  The moe, ssm and hybrid
    families are held to gate 1, their parity logged: in bf16 the prefill's
    and the forward's activations differ by an ulp, which may move a token
    whose top-k router probabilities tie within it to another expert; and
    the SSM decode reads the reference's bf16 conv tails (and the hybrid's
    bf16 KV), whose rounding compounds over 54-64 layers (on the CPU at
    d = 1,024: zamba2 at 54 layers 16% of max|logit| in bf16 and 4.1% in
    float32, falcon-mamba at 16 layers 2.6% / 0.44%; with float32 caches
    1.4e-4 / 3.8e-6, so the scan and the recurrence agree)."""
    cfg = model.cfg
    x = prng.randint(prng.PRNGKey(SEED + 2), (LM_BATCH, LM_PROMPT + 1), 0, cfg.vocab_size, device=device)
    with torch.inference_mode():
        full, _ = model.forward(params, x, context=context)
        _, cache = model.prefill(params, x[:, :LM_PROMPT], context=context)
        dl, _ = model.decode(params, cache, x[:, LM_PROMPT:], LM_PROMPT, context=context)
    if not (bool(torch.isfinite(full).all()) and bool(torch.isfinite(dl).all())):
        raise AssertionError(f"{what}: non-finite logits")
    if cfg.family in ("moe", "ssm", "hybrid"):
        top = float(full[:, -1].abs().max())
        log(f"lm gate 2 {what}: not held ({cfg.family}); decode vs forward "
            f"{float((full[:, -1] - dl[:, 0]).abs().max()) / top} of max|logit| {top}")
        return
    top = float(full[:, -1].abs().max())
    rel = float((full[:, -1] - dl[:, 0]).abs().max()) / top
    log(f"lm gate 2 {what}: decode parity {rel} of max|logit| {top} (bound {LM_PARITY_REL})")
    if not rel <= LM_PARITY_REL:
        raise AssertionError(f"{what}: decode parity {rel} > {LM_PARITY_REL}")


def lm_serve(device, arch: str, layers=None, keep=False):
    """``serve_lm`` at the CLI's defaults for the full ``arch`` on the card
    (with ``layers``, the same serve loop through the model API at full
    width with the depth cut to ``layers``: the CLI serves whole configs),
    then its timings and gates 1-2; the weights freed after, or with
    ``keep`` returned beside the timings as ``(out, (model, params))``."""
    full = lm_configs.get(arch)
    what = arch if layers is None else f"{arch} ({layers} layers)"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    if layers is None:
        run = serve.serve_lm(serve.build_parser().parse_args(["--arch", arch, "--device", str(device)]))
        model, params, prompts, toks, logits, context = run
    else:
        log(f"lm serve {arch}: depth cut {full.num_layers} -> {layers} layers to fit one card")
        model = lm_model.build(dataclasses.replace(full, num_layers=layers))
        with torch.inference_mode():
            params = model.init(prng.PRNGKey(SEED), device=device)
            prompts = prng.randint(prng.PRNGKey(SEED + 1), (LM_BATCH, LM_PROMPT), 0, full.vocab_size, device=device)
        context = serve.serve_context(full, LM_BATCH, device)
        toks, logits = serve.greedy_generate(model, params, prompts, LM_GEN, context)
        toks = toks.cpu()
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{what}: non-finite prefill logits")
    if tuple(toks.shape) != (LM_BATCH, LM_GEN) or not bool(((toks >= 0) & (toks < full.vocab_size)).all()):
        raise AssertionError(f"{what}: bad tokens {tuple(toks.shape)}")
    out = lm_timings(model, params, prompts, what, context)
    out.update(serve_s=served_s, max_memory_allocated=peak)
    lm_parity(model, params, device, what, context)
    log(f"lm serve {what}: serve_s={served_s} (init and generation) max_memory_allocated={peak} "
        f"sample_row={toks[0].tolist()}")
    del logits
    if keep:
        return out, (model, params)
    del params
    torch.cuda.empty_cache()
    return out


def lm_prefill_decode(model, params, toks):
    """Prefill logits, the cache (as float32 on the host, before decode
    writes it) and the decode logits of one step at position S."""
    b, s1 = toks.shape
    with torch.inference_mode():
        logits, cache = model.prefill(params, toks[:, : s1 - 1])
        cache_host = {k: v.float().cpu() for k, v in cache.items()}
        dl, _ = model.decode(params, cache, toks[:, s1 - 1 :], s1 - 1)
    return logits, cache_host, dl


def lm_smoke_cross_device(device) -> None:
    """Gate 3: the four dense smoke configs, float32 and bf16, card against
    the CPU port (float32 matmuls without TF32), to the CPU tests' bounds;
    gate 5: the chunked init on the card bit-equal to the CPU's."""
    b, s = LM_CHECK
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in LM_SMOKE:
            for dt in ("float32", "bfloat16"):
                cfg = dataclasses.replace(lm_configs.get_smoke(arch), dtype=dt)
                model = lm_model.build(cfg)
                p_cpu = model.init(prng.PRNGKey(SEED), device="cpu")
                p_dev = lm_transformer.tree_map(lambda t: t.to(device), p_cpu)
                toks = prng.randint(prng.PRNGKey(SEED + 3), (b, s + 1), 0, cfg.vocab_size)
                got = lm_prefill_decode(model, p_dev, toks.to(device))
                want = lm_prefill_decode(model, p_cpu, toks)
                f32 = dt == "float32"
                what = f"gate 3 {arch} {dt}"
                lm_close(f"{what} prefill logits", got[0], want[0],
                         LM_F32_REL * float(want[0].abs().max()) if f32 else LM_BF16_ATOL)
                for name in ("k", "v"):
                    top = float(want[1][name].abs().max())
                    lm_close(f"{what} cache {name}", got[1][name], want[1][name], (2.0**-7 if f32 else 0.05) * top)
                lm_close(f"{what} decode logits", got[2], want[2],
                         10 * LM_F32_REL * float(want[2].abs().max()) if f32 else LM_BF16_ATOL)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for dt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(lm_configs.get_smoke("qwen3_14b"), dtype=dt)
        want = lm_transformer.init_model(prng.PRNGKey(SEED), cfg, device="cpu")
        chunk = lm_layers.INIT_CHUNK
        lm_layers.INIT_CHUNK = 1000  # many chunks, with one ending mid-row
        try:
            got = lm_transformer.init_model(prng.PRNGKey(SEED), cfg, device=device)
        finally:
            lm_layers.INIT_CHUNK = chunk
        for g, t in zip(lm_transformer.tree_leaves(got), lm_transformer.tree_leaves(want)):
            bits = torch.int16 if t.element_size() == 2 else torch.int32
            if not torch.equal(g.cpu().view(bits), t.view(bits)):
                raise AssertionError(f"gate 5: chunked init on the card differs from the CPU ({dt}, {tuple(t.shape)})")
        log(f"lm gate 5: qwen3 smoke {dt} init on the card (chunks of 1000) == CPU, bit for bit")


def lm_full_width_f32(device) -> None:
    """Gate 4: one float32 prefill of full-width olmo-1b, card against the
    CPU port; the weights drawn on the card and copied to the host.  The
    CPU leg's depth is cut if two layers predict more than LM_CPU_LEG_S."""
    cfg = dataclasses.replace(lm_configs.get("olmo-1b"), dtype="float32")
    b, s = LM_CHECK
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            p_dev = lm_model.build(cfg).init(prng.PRNGKey(SEED), device=device)
            p_cpu = lm_transformer.tree_map(lambda t: t.cpu(), p_dev)
            toks = prng.randint(prng.PRNGKey(SEED + 4), (b, s), 0, cfg.vocab_size)

            def depth(params, n):
                return {**params, "blocks": lm_transformer.tree_map(lambda a: a[:n], params["blocks"])}

            t = time.perf_counter()
            lm_model.build(dataclasses.replace(cfg, num_layers=2)).prefill(depth(p_cpu, 2), toks)
            est = (time.perf_counter() - t) / 2 * cfg.num_layers
            layers = cfg.num_layers if est <= LM_CPU_LEG_S else max(2, int(cfg.num_layers * LM_CPU_LEG_S / est))
            if layers < cfg.num_layers:
                log(f"lm gate 4: CPU leg estimated {est:.1f} s at {cfg.num_layers} layers: depth cut to {layers}")
            cut = dataclasses.replace(cfg, num_layers=layers)
            t = time.perf_counter()
            want, _ = lm_model.build(cut).prefill(depth(p_cpu, layers), toks)
            cpu_s = time.perf_counter() - t
            got, _ = lm_model.build(cut).prefill(depth(p_dev, layers), toks.to(device))
        lm_close(f"gate 4 olmo-1b float32 full width ({layers} layers, CPU leg {cpu_s:.1f} s) prefill logits",
                 got, want, LM_F32_REL * float(want.abs().max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    del p_dev, p_cpu
    torch.cuda.empty_cache()


def lm_dedup_cross_device(device) -> None:
    """Gate 6: dedup.segmented_unique on the card equals the CPU on the
    n = 2^12 plan's candidate stream (its exact-round budget per graph, the
    descent of one threefry draw), targets around the budget."""
    plan = MAGMSampler(paper_config(CHECK_LOG2_N, device)).plan
    budget = quilt._exact_budget(plan.p_max, plan.mean_edges)
    asks = np.full(plan.num_graphs, budget, dtype=np.int64)
    asks[1] = 0  # an empty graph
    src, dst = (x.cpu().numpy() for x in kpgm.descend_draw(prng.PRNGKey(SEED + 5), plan.cum, int(asks.sum())))
    targets = np.random.default_rng(SEED).integers(0, 2 * budget, plan.num_graphs)
    got = dedup.segmented_unique(src, dst, asks, targets, node_bits=plan.d, device=device)
    want = dedup.segmented_unique(src, dst, asks, targets, node_bits=plan.d, device="cpu")
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
        raise AssertionError("gate 6: segmented_unique on the card differs from the CPU")
    log(f"lm gate 6: segmented_unique card == CPU on {src.size} candidates of {plan.num_graphs} graphs "
        f"(taken {int(got[1].sum())})")


def phase_lm(device, archs=(), cut=False, keep=False):
    """The LM serving path (dense family): ``serve_lm`` at the reference
    CLI's default (full olmo-1b, batch 4, prompt 32, 16 tokens) with its
    timings and gates 1-2, then gates 3-6; ``archs`` are served at full
    width after it, and with ``cut`` deepseek-67b at LM_DEEPSEEK_LAYERS.
    With ``keep`` olmo-1b's model and weights come back beside the
    timings, ``(out, (model, params))``."""
    t = time.perf_counter()
    olmo = lm_serve(device, "olmo-1b", keep=keep)
    out = {"olmo-1b": olmo[0] if keep else olmo}
    lm_smoke_cross_device(device)
    lm_full_width_f32(device)
    lm_dedup_cross_device(device)
    for arch in archs:
        out[arch] = lm_serve(device, arch)
    if cut:
        out["deepseek-67b"] = lm_serve(device, "deepseek-67b", LM_DEEPSEEK_LAYERS)
    log(f"lm phase seconds={time.perf_counter() - t}")
    return (out, olmo[1]) if keep else out


# --- LM training (dense family): the corpus, the train step, flash's backward ---

TRAIN_BATCH, TRAIN_SEQ = 8, 128  # the reference train CLI's defaults
TRAIN_GRAPH_LOG2_N = 12  # the CLI's default --graph-nodes: the full run's corpus
TRAIN_FULL_GRAPH_LOG2_N = 15  # --train's corpus, the largest exact paper configuration
TRAIN_SMOKE_STEPS = 3  # the full run's steps of full olmo-1b
TRAIN_STEPS = 20  # --train's run at batch 8 x 128
TRAIN_4K = (4, 4096)  # train_4k's sequence, its global batch of 256 cut to 4
TRAIN_4K_STEPS = 6
TRAIN_LR = 3e-4  # the CLI's default, warmed up over 10 steps as the CLI does
TRAIN_REL = 1e-4  # card vs CPU in float32: loss (relative), gradients and mu (x max)
TRAIN_MASTER_ATOL = 1e-6
FLASH_BWD = (2, 1024, 16, 4, 64, 256, 512)  # (b, s, heads, kv heads, hd, q chunk, kv chunk)
FLASH_BWD_REL = 1e-5  # float32, x max|grad| (tests/test_torch_flash.py)
SUP_LAYERS, SUP_STEPS, SUP_FAULT, SUP_EVERY = 2, 14, 9, 5  # the supervisor gate (tests/test_system.py)
# the train CLI: at 12 steps of lr warm-up the smoke model's loss does not fall
# on the 512-node graph in either package, at 16 it does (tests/test_torch_train.py)
TRAIN_CLI_STEPS = 16


def trainable(params):
    """Copies of ``serve_lm``'s weights that autograd can use (it draws
    them under ``torch.inference_mode``)."""
    return lm_transformer.tree_map(torch.clone, params)


def train_corpus(device, log2_n: int, vocab: int, batch: int, seq: int):
    """A MAGMCorpus on the card with its build time and kernel 1's
    launches (its split's light quilt)."""
    t = time.perf_counter()
    corpus, k1 = k1_launches(lambda: MAGMCorpus(num_nodes=1 << log2_n, vocab_size=vocab, seq_len=seq,
                                                batch_size=batch, seed=SEED, device=device))
    info = {"build_s": time.perf_counter() - t, "n": corpus.num_nodes, "num_edges": corpus.num_edges,
            "B": corpus.quilt_stats.B, "light_nodes": corpus.quilt_stats.light_nodes,
            "quilt_prng_descent_lookup": k1}
    log(f"train corpus: {json.dumps(info)}")
    if k1 < 1 or corpus.num_edges <= 0:
        raise AssertionError(f"train corpus at n = 2^{log2_n}: {k1} kernel 1 launches, {corpus.num_edges} edges")
    b = corpus.batch(0)
    if tuple(b["tokens"].shape) != (batch, seq) or b["tokens"].device.type != torch.device(device).type:
        raise AssertionError(f"train corpus batch {tuple(b['tokens'].shape)} on {b['tokens'].device}")
    return corpus, info


def train_run(model, params, corpus, steps: int, what: str, *, profile: bool = True):
    """``steps`` train steps of ``model`` from ``params`` on the corpus's
    batches (made before the loop), AdamW at the CLI's schedule: per-step
    ms by CUDA events (as the loop sees them: no host sync in a step), the
    warm median, tokens/s, MFU and the share of the bound
    (``train_step_bound_ms``), a profiled step's idle share and top device
    ops, its host syncs, peak memory.  Returns (stats, params)."""
    cfg = model.cfg
    opt_cfg = opt_lib.OptConfig(lr=TRAIN_LR, warmup_steps=10, total_steps=steps)
    step_fn = lm_steps.make_train_step(model, opt_cfg)
    batches = [corpus.batch(s) for s in range(steps)]
    b, s_len = batches[0]["tokens"].shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt_state = opt_lib.init(params)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    metrics = []
    t = time.perf_counter()
    for i in range(steps):
        events[i][0].record()
        params, opt_state, m = step_fn(params, opt_state, batches[i])
        events[i][1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    step_ms = [a.elapsed_time(z) for a, z in events]
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"{what}: non-finite loss or grad norm: {losses} {gnorms}")
    warm = statistics.median(step_ms[2:]) if steps > 3 else step_ms[-1]
    bound, bound_by = train_step_bound_ms(cfg, b, s_len)
    flops = model_flops(cfg, ShapeConfig("train", s_len, b, "train"), chips=1) * 1e9
    out = {
        "params": cfg.param_count(), "layers": cfg.num_layers, "batch": b, "seq": s_len, "steps": steps,
        "losses": losses, "grad_norms": gnorms, "step_ms": step_ms, "warm_step_ms": warm, "wall_s": wall_s,
        "tokens_per_s": b * s_len / (warm / 1e3), "mfu": flops / (warm / 1e3) / BF16_FLOPS_PER_S,
        "bound_ms": bound, "bound_by": bound_by, "bound_share": bound / warm,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    if profile:
        (params, opt_state, _), wall, busy, top = profiled_call(lambda: step_fn(params, opt_state, batches[-1]))
        out["step_profiled"] = {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
                                "idle_share_of_warm_step": 1 - busy / warm, "top_device_ops": top}
        out["step_syncs"] = sync_sites(lambda: step_fn(params, opt_state, batches[-1]))
        # the step's two halves, as the loop sees them and device-bound
        grad_fn = lm_steps.make_grad_fn(model)
        grads = grad_fn(params, batches[-1])[2]

        def grad():
            return grad_fn(params, batches[-1])

        def update():
            return opt_lib.update(opt_cfg, grads, opt_state, params)

        out["breakdown_ms"] = {"grad": events_ms(grad, 3), "grad_device": cuda_ms(grad, 3),
                               "update": events_ms(update, 3), "update_device": cuda_ms(update, 3)}
        del grads
    log(f"train {what}: {json.dumps(out)}")
    del opt_state
    torch.cuda.empty_cache()
    return out, params


def train_smoke_cross_device(device) -> None:
    """The four dense smoke configs in float32 (no TF32): the gradients and
    one train step on the card against the CPU port, the loss to TRAIN_REL,
    each gradient leaf and mu within TRAIN_REL x its max, the master within
    TRAIN_MASTER_ATOL where the CPU's mu decides the entry's sign (else
    within 2 lr: AdamW's first step moves each entry by ~lr in its
    gradient's sign)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    opt_cfg = opt_lib.OptConfig(lr=3e-3, warmup_steps=2, total_steps=40)
    try:
        for arch in LM_SMOKE:
            cfg = dataclasses.replace(lm_configs.get_smoke(arch), dtype="float32")
            model = lm_model.build(cfg)
            p_cpu = model.init(prng.PRNGKey(SEED), device="cpu")
            p_dev = lm_transformer.tree_map(lambda t: t.to(device), p_cpu)
            toks = prng.randint(prng.PRNGKey(SEED + 6), (2, 32), 0, cfg.vocab_size)
            batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
            dbatch = {k: v.to(device) for k, v in batch.items()}
            grad_fn, step_fn = lm_steps.make_grad_fn(model), lm_steps.make_train_step(model, opt_cfg)
            (l_c, _, g_c), (l_d, _, g_d) = grad_fn(p_cpu, batch), grad_fn(p_dev, dbatch)
            what = f"train gate {arch} float32"
            lm_close(f"{what} loss", l_d, l_c, TRAIN_REL * abs(float(l_c)))
            worst = 0.0
            for a, c in zip(lm_transformer.tree_leaves(g_d), lm_transformer.tree_leaves(g_c)):
                worst = max(worst, float((a.cpu() - c).abs().max()) / float(c.abs().max()))
            if not worst <= TRAIN_REL:
                raise AssertionError(f"{what}: gradient leaf {worst} x max|g| > {TRAIN_REL}")
            _, s_c, m_c = step_fn(p_cpu, opt_lib.init(p_cpu), batch)
            _, s_d, m_d = step_fn(p_dev, opt_lib.init(p_dev), dbatch)
            lm_close(f"{what} grad_norm", m_d["grad_norm"], m_c["grad_norm"], TRAIN_REL * float(m_c["grad_norm"]))
            flipped = 0
            for mu_d, mu_c, ma_d, ma_c in zip(*(lm_transformer.tree_leaves(t) for t in
                                                (s_d.mu, s_c.mu, s_d.master, s_c.master))):
                top = float(mu_c.abs().max())
                if not float((mu_d.cpu() - mu_c).abs().max()) <= TRAIN_REL * top:
                    raise AssertionError(f"{what}: mu beyond {TRAIN_REL} x max")
                err = (ma_d.cpu() - ma_c).abs()
                sure = mu_c.abs() > TRAIN_REL * top
                if not (bool((err[sure] <= TRAIN_MASTER_ATOL).all())
                        and bool((err <= 2 * opt_cfg.lr + TRAIN_MASTER_ATOL).all())):
                    raise AssertionError(f"{what}: master beyond its bounds ({float(err.max())})")
                flipped += int((err > TRAIN_MASTER_ATOL).sum())
            log(f"{what}: worst gradient leaf {worst} x max|g| (bound {TRAIN_REL}); one step: "
                f"{flipped} master entries past {TRAIN_MASTER_ATOL}, all where |mu| is float noise")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def flash_bwd_cross_device(device) -> None:
    """flash attention's backward at one multi-chunk GQA shape (FLASH_BWD,
    causal), the card against the CPU port: float32 (no TF32) within
    FLASH_BWD_REL x max|grad|, bf16 within two bf16 ulps at max|grad|."""
    b, s, h, kv, hd, qc, kc = FLASH_BWD
    rng = np.random.default_rng(SEED + 7)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                     for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd)))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dt, rel in ((torch.float32, FLASH_BWD_REL), (torch.bfloat16, 2.0**-7)):
            grads = {}
            for dev in ("cpu", device):
                leaves = [x.to(dev, dt).detach().requires_grad_(True) for x in (q, k, v)]
                out = lm_flash.flash_attention(*leaves, True, 0, 0, qc, kc)
                out.backward(dout.to(dev, dt))
                grads[str(dev)] = [x.grad.float().cpu() for x in leaves]
            for name, a, c in zip(("dq", "dk", "dv"), grads[str(device)], grads["cpu"]):
                lm_close(f"flash backward {dt} {name} {FLASH_BWD}", a, c, rel * float(c.abs().max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def phase_train(device, model, params) -> dict:
    """The training path in the full run (reusing phase_lm's full olmo-1b
    weights): a MAGMCorpus at the CLI's default n = 2^12 (kernel 1 read
    around its build), TRAIN_SMOKE_STEPS train steps at batch 8 x 128
    (finite loss and grad norm, step ms), the smoke configs' train step
    card == CPU in float32 and flash's backward card == CPU."""
    t = time.perf_counter()
    corpus, info = train_corpus(device, TRAIN_GRAPH_LOG2_N, model.cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    run, _ = train_run(model, trainable(params), corpus, TRAIN_SMOKE_STEPS, "olmo-1b 8x128", profile=False)
    train_smoke_cross_device(device)
    flash_bwd_cross_device(device)
    log(f"train phase seconds={time.perf_counter() - t}")
    return {"corpus": info, "olmo-1b": run}


def supervisor_gate(device, corpus, workdir: str) -> dict:
    """The crash-restart supervisor at full width (olmo-1b cut to SUP_LAYERS
    layers): SUP_STEPS steps with an InjectedFault before step SUP_FAULT and
    checkpoints every SUP_EVERY (keep 2) end on the params and optimizer
    state of an uninterrupted run, bit for bit."""
    cfg = dataclasses.replace(lm_configs.get("olmo-1b"), num_layers=SUP_LAYERS)
    model = lm_model.build(cfg)
    with torch.no_grad():
        params = model.init(prng.PRNGKey(SEED), device=device)
    step_fn = lm_steps.make_train_step(model, opt_lib.OptConfig(lr=1e-3, warmup_steps=2, total_steps=30))
    p0, s0 = params, opt_lib.init(params)
    for i in range(SUP_STEPS):
        p0, s0, _ = step_fn(p0, s0, corpus.batch(i))
    fired = []

    def hook(step):
        if step == SUP_FAULT and not fired:
            fired.append(step)
            raise fault.InjectedFault(f"injected before step {step}")

    sup = fault.TrainSupervisor(step_fn, corpus.batch, workdir, ckpt_every=SUP_EVERY, fault_hook=hook, keep=2)
    t = time.perf_counter()
    p1, s1, metrics = sup.run(params, opt_lib.init(params), SUP_STEPS)
    sup_s = time.perf_counter() - t
    same = [bool(torch.equal(a, c)) for a, c in zip(ckpt_mod._flatten({"p": p0, "s": s0})[0],
                                                    ckpt_mod._flatten({"p": p1, "s": s1})[0])]
    ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(workdir) for f in fs)
    info = {"layers": SUP_LAYERS, "params": cfg.param_count(), "restarts": sup.restarts, "executed": len(metrics),
            "leaves_equal": sum(same), "leaves": len(same), "supervised_s": sup_s,
            "bytes_on_disk": ckpt_bytes, "losses": [m["loss"] for m in metrics]}
    log(f"train supervisor gate: {json.dumps(info)}")
    if not (fired and sup.restarts == 1 and all(same)):
        raise AssertionError(f"supervisor gate: replay differs from the uninterrupted run ({info})")
    return info


def train_cli(device, args: list, what: str) -> float:
    """``python -m repro_torch.launch.train`` on the card; its seconds."""
    t = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args, "--device", str(device)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    cli_s = time.perf_counter() - t
    for line in out.stdout.splitlines():
        log(f"train cli {what}: {line}")
    if out.returncode != 0 or "[train] OK" not in out.stdout:
        raise AssertionError(f"train cli {what} failed ({out.returncode}): {out.stderr[-2000:]}")
    return cli_s


def phase_train_full(device) -> dict:
    """--train: full olmo-1b on a MAGMCorpus at n = 2^15, TRAIN_STEPS steps
    at batch 8 x 128 (the loss falls) and TRAIN_4K_STEPS at train_4k's
    sequence (batch cut to 4), the supervisor gate, and the train CLI on
    the smoke config and at full width (disk permitting)."""
    out = {}
    cfg = lm_configs.get("olmo-1b")
    model = lm_model.build(cfg)
    t = time.perf_counter()
    with torch.no_grad():
        params = model.init(prng.PRNGKey(SEED), device=device)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t
    corpus, out["corpus"] = train_corpus(device, TRAIN_FULL_GRAPH_LOG2_N, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    out["8x128"], params = train_run(model, params, corpus, TRAIN_STEPS, "olmo-1b 8x128")
    losses = out["8x128"]["losses"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"olmo-1b 8x128: the loss did not fall ({losses})")
    b4k, s4k = TRAIN_4K
    log(f"train olmo-1b at train_4k's sequence: global batch cut from 256 to {b4k} to fit one card")
    corpus4k, out["corpus_4k"] = train_corpus(device, TRAIN_FULL_GRAPH_LOG2_N, cfg.vocab_size, b4k, s4k)
    out["4x4096"], params = train_run(model, params, corpus4k, TRAIN_4K_STEPS, "olmo-1b 4x4096")
    del params, corpus4k
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        out["disk_free_bytes"] = shutil.disk_usage(work).free
        log(f"train checkpoints in {work}: {out['disk_free_bytes']} bytes free")
        out["supervisor"] = supervisor_gate(device, corpus, os.path.join(work, "supervisor"))
        out["cli_smoke_s"] = train_cli(device, ["--smoke", "--steps", str(TRAIN_CLI_STEPS), "--batch", "2",
                                                "--seq", "32", "--graph-nodes", "512", "--ckpt-every", "4",
                                                "--ckpt-dir", os.path.join(work, "smoke")], "smoke")
        full_ckpt = 28 * cfg.param_count() // 2  # bf16 params + float32 mu, nu, master: 14 bytes a param
        if out["disk_free_bytes"] > 3 * full_ckpt:
            out["cli_full_s"] = train_cli(device, ["--steps", "20", "--ckpt-dir", os.path.join(work, "full")], "full")
        else:
            log(f"train cli full width left out: two checkpoints of {full_ckpt} bytes and a save's "
                f"temporary copy do not fit {out['disk_free_bytes']} free")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# --- LM families (moe, ssm, hybrid, vlm, audio): PyTorch ops; kernel 1 in the corpus ---

FAMILY_SMOKE = ("phi3_5_moe_42b", "mixtral_8x22b", "falcon_mamba_7b", "zamba2_2_7b", "llama_3_2_vision_90b",
                "whisper_base")
FAMILY_CHECK = (2, 20, 4)  # (batch, prompt, decode steps) of the smoke gate
FAMILY_GATE = 0.5  # the vlm's cross gates: tanh(0) at init would hide the cross layers
FAMILY_TRAIN_STEPS = 6  # --families' train steps at 8 x 128 (the full run's zamba2: TRAIN_SMOKE_STEPS)
# --families at full width, depth cut only as one 80 GB card forces: serving
# holds the bf16 weights and a step's float32 copy of the embedding; training
# peaks at ~33 bytes a parameter (olmo-1b at 8 x 128: bf16 weights and
# gradients, float32 mu, nu and master, and AdamW's out-of-place update)
FAMILY_SERVE_LAYERS = {
    "phi3.5-moe-42b-a6.6b": 22,  # 2.6 GB a layer (16 experts): 22 of 32
    "mixtral-8x22b": 11,  # 5.0 GB a layer (8 experts of d_ff 16,384): 11 of 56
    "falcon-mamba-7b": None, "zamba2-2.7b": None, "whisper-base": None,
    "llama-3.2-vision-90b": 35,  # 1.7 GB a layer: 7 of its 20 [4 self | 1 cross] segments
}
FAMILY_TRAIN_LAYERS = {  # mixtral (1 layer: 2.8 B params) and llama-vision (a segment: 5.3 B) do not fit
    "phi3.5-moe-42b-a6.6b": 1, "falcon-mamba-7b": 16, "zamba2-2.7b": None, "whisper-base": None,
}


def family_inputs(cfg, b: int, s: int, seed: int, device="cpu"):
    """Tokens (b, s) and, for the vlm and audio families, a normal context
    in the model's dtype (else None)."""
    toks = prng.randint(prng.PRNGKey(seed), (b, s), 0, cfg.vocab_size, device=device)
    n = lm_model.context_len(cfg)
    if n is None:
        return toks, None
    return toks, prng.normal(prng.PRNGKey(seed + 1), (b, n, cfg.d_model), device=device).to(lm_layers._dtype(cfg))


def moe_routes(calls: list):
    """Wrap ``layers.route_moe`` to append each call's gate_idx (on the
    host) to ``calls``; returns the function that undoes it."""
    real = lm_layers.route_moe

    def wrapped(p, x, cfg):
        r = real(p, x, cfg)
        calls.append(r.gate_idx.cpu())
        return r

    lm_layers.route_moe = wrapped
    return lambda: setattr(lm_layers, "route_moe", real)


def family_serve_steps(model, params, toks, ctx, steps: int):
    """Prefill toks[:, :-steps], then ``steps`` decode steps fed the rest:
    (prefill logits, the cache on the host before decode writes it, the
    decode logits, the MoE routes of every call)."""
    s = toks.shape[1] - steps
    routes = []
    undo = moe_routes(routes)
    try:
        with torch.inference_mode():
            logits, cache = model.prefill(params, toks[:, :s], context=ctx, max_len=s + steps)
            host = {k: v.float().cpu().clone() for k, v in cache.items()}
            dls = []
            for i in range(steps):
                dl, cache = model.decode(params, cache, toks[:, s + i : s + i + 1], s + i, context=ctx)
                dls.append(dl)
    finally:
        undo()
    return logits, host, dls, routes


def family_smoke_cross_device(device) -> None:
    """The families gate's smoke half: each non-dense smoke config in
    float32 (no TF32), the vlm's gates at FAMILY_GATE, on the card against
    the CPU port: forward and prefill logits within LM_F32_REL x max, the
    cache (bf16 leaves within one bf16 ulp at their top binade, the SSM
    state within LM_F32_REL x max), FAMILY_CHECK's decode steps within ten
    times the logit bound (the bf16 cache may round an entry the other way),
    the MoE routes equal, and the loss and every gradient leaf of one train
    step within TRAIN_REL."""
    b, s, steps = FAMILY_CHECK
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in FAMILY_SMOKE:
            t = time.perf_counter()
            cfg = dataclasses.replace(lm_configs.get_smoke(arch), dtype="float32")
            model = lm_model.build(cfg)
            p_cpu = model.init(prng.PRNGKey(SEED), device="cpu")
            if "cross_blocks" in p_cpu:
                p_cpu["cross_blocks"]["gate"] = torch.full_like(p_cpu["cross_blocks"]["gate"], FAMILY_GATE)
            p_dev = lm_transformer.tree_map(lambda a: a.to(device), p_cpu)
            toks, ctx = family_inputs(cfg, b, s + steps, SEED + 8)
            dctx = None if ctx is None else ctx.to(device)
            got = family_serve_steps(model, p_dev, toks.to(device), dctx, steps)
            want = family_serve_steps(model, p_cpu, toks, ctx, steps)
            what = f"families gate {arch} float32"
            if len(got[3]) != len(want[3]) or not all(torch.equal(a, c) for a, c in zip(got[3], want[3])):
                raise AssertionError(f"{what}: MoE routes differ between the card and the CPU")
            with torch.inference_mode():
                fwd = model.forward(p_dev, toks[:, :s].to(device), context=dctx)[0]
            if not torch.equal(fwd, got[0]):
                raise AssertionError(f"{what}: prefill logits are not the forward's")
            lm_close(f"{what} prefill logits", got[0], want[0], LM_F32_REL * float(want[0].abs().max()))
            for name, c in want[1].items():
                rel = LM_F32_REL if name == "h" else 2.0**-7
                lm_close(f"{what} cache {name}", got[1][name], c, rel * float(c.abs().max()))
            for i, (a, c) in enumerate(zip(got[2], want[2])):
                lm_close(f"{what} decode step {i}", a, c, 10 * LM_F32_REL * float(c.abs().max()))
            batch = {"tokens": toks[:, :16], "labels": torch.roll(toks[:, :16], -1, dims=1), "context": ctx}
            dbatch = {k: None if v is None else v.to(device) for k, v in batch.items()}
            grad_fn = lm_steps.make_grad_fn(model)
            (l_c, parts_c, g_c), (l_d, parts_d, g_d) = grad_fn(p_cpu, batch), grad_fn(p_dev, dbatch)
            lm_close(f"{what} loss", l_d, l_c, TRAIN_REL * abs(float(l_c)))
            lm_close(f"{what} aux", parts_d["aux"], parts_c["aux"], TRAIN_REL * abs(float(parts_c["aux"])))
            worst = 0.0
            for a, c in zip(lm_transformer.tree_leaves(g_d), lm_transformer.tree_leaves(g_c)):
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"{what}: non-finite gradient on the card")
                worst = max(worst, float((a.cpu() - c).abs().max()) / max(float(c.abs().max()), 1e-30))
            if not worst <= TRAIN_REL:
                raise AssertionError(f"{what}: gradient leaf {worst} x max|g| > {TRAIN_REL}")
            log(f"{what}: {len(got[3])} MoE routes equal; worst gradient leaf {worst} x max|g| (bound {TRAIN_REL}); "
                f"aux {float(parts_d['aux'])}; {time.perf_counter() - t:.1f} s")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _WithContext:
    """A corpus whose batches carry a normal context (the audio family's
    encoder frames), drawn once."""

    def __init__(self, corpus, context):
        self.corpus, self.context = corpus, context

    def batch(self, step: int) -> dict:
        return {**self.corpus.batch(step), "context": self.context}


def family_train(device, model, params, steps: int, what: str, corpus=None):
    """``steps`` train steps of ``model`` at the train CLI's batch 8 x 128
    on a MAGMCorpus at its default n = 2^12 (built here unless given), with
    the batch-0 loss before and after (it must fall).  Returns (stats,
    params, the corpus's info)."""
    cfg = model.cfg
    info = None
    if corpus is None:
        corpus, info = train_corpus(device, TRAIN_GRAPH_LOG2_N, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    if cfg.family == "audio":
        corpus = _WithContext(corpus, family_inputs(cfg, TRAIN_BATCH, 1, SEED + 9, device)[1])
    loss_fn = lm_steps.make_loss_fn(model)
    b0 = corpus.batch(0)
    with torch.no_grad():
        before = float(loss_fn(params, b0)[0])
    run, params = train_run(model, params, corpus, steps, what, profile=False)
    with torch.no_grad():
        after = float(loss_fn(params, b0)[0])
    run["batch0_loss"] = [before, after]
    log(f"train {what}: batch-0 loss {before} -> {after} after {steps} steps")
    if not (np.isfinite([before, after]).all() and after < before):
        raise AssertionError(f"{what}: the batch-0 loss did not fall ({before} -> {after})")
    return run, params, info


def phase_families(device) -> dict:
    """The families gate in the full run: the smoke configs card == CPU
    port, then full zamba2-2.7b uncut: ``serve_lm`` at the CLI's defaults
    (gate 1 and the logged parity; its timings are --families') and
    TRAIN_SMOKE_STEPS train steps at 8 x 128 on a MAGMCorpus at n = 2^12
    (kernel 1 read around its build), finite, with the batch-0 loss
    falling."""
    t = time.perf_counter()
    family_smoke_cross_device(device)
    t_serve = time.perf_counter()
    run = serve.serve_lm(serve.build_parser().parse_args(["--arch", "zamba2-2.7b", "--device", str(device)]))
    if not (bool(torch.isfinite(run.logits).all()) and tuple(run.tokens.shape) == (LM_BATCH, LM_GEN)):
        raise AssertionError("zamba2-2.7b: non-finite prefill logits or bad tokens")
    lm_parity(run.model, run.params, device, "zamba2-2.7b")
    served_s = time.perf_counter() - t_serve
    model, params = run.model, trainable(run.params)  # serve_lm's inference tensors, cloned
    del run
    torch.cuda.empty_cache()
    train, params, info = family_train(device, model, params, TRAIN_SMOKE_STEPS, "zamba2-2.7b 8x128")
    del params
    torch.cuda.empty_cache()
    log(f"families phase seconds={time.perf_counter() - t} (zamba2 served in {served_s:.1f} s)")
    return {"zamba2-2.7b": {"serve_s": served_s, "train": train}, "corpus": info}


def phase_families_full(device, archs) -> dict:
    """--families: the smoke gate, then each arch at full width, depth cut
    as FAMILY_SERVE_LAYERS / FAMILY_TRAIN_LAYERS say: serving at the CLI's
    defaults (prefill and decode ms, tokens/s, the decode step's byte
    bound), and FAMILY_TRAIN_STEPS train steps at 8 x 128 where it fits
    (step ms, MFU, the step's bound, peak memory)."""
    family_smoke_cross_device(device)
    out = {}
    for arch in archs:
        t = time.perf_counter()
        full = lm_configs.get(arch)
        layers = FAMILY_SERVE_LAYERS[arch]
        rec = {"serve": lm_serve(device, arch, layers), "serve_layers": layers or full.num_layers}
        if arch in FAMILY_TRAIN_LAYERS:
            n = FAMILY_TRAIN_LAYERS[arch]
            cfg = full if n is None else dataclasses.replace(full, num_layers=n)
            if n is not None:
                log(f"train {arch}: depth cut {full.num_layers} -> {n} layers to fit one card")
            model = lm_model.build(cfg)
            with torch.no_grad():
                params = model.init(prng.PRNGKey(SEED), device=device)
            rec["train"], params, rec["corpus"] = family_train(device, model, params, FAMILY_TRAIN_STEPS,
                                                               f"{arch} 8x128")
            rec["train_layers"] = cfg.num_layers
            del params
        else:
            log(f"train {arch}: not run, one layer (a segment for the vlm) with AdamW's state does not fit one card")
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t
        out[arch] = rec
        log(f"families {arch}: {rec['seconds']:.1f} s")
    return out


# --- the dry-run's predictions on the card ---

DRYRUN_SHAPE = "decode_32k"  # every arch's 16x16 row: decode traces fastest
DRYRUN_CHECK = {  # olmo-1b's steps of phase_train and phase_lm, on the 1-device mesh
    "train_8x128": ShapeConfig("train_8x128", TRAIN_SEQ, TRAIN_BATCH, "train"),
    "decode_4x48": ShapeConfig("decode_4x48", LM_PROMPT + LM_GEN, LM_BATCH, "decode"),
}
# the production cells --dryrun also traces on the card host's torch: the
# embedding's gather failed there on both meshes before it went vocab-parallel
DRYRUN_PRODUCTION = (("train_4k", False), ("train_4k", True), ("decode_32k", True))
DRYRUN_PEAK_REL = 0.15  # predicted peak bytes above the step's inputs vs the card's delta
DRYRUN_REPS = 5


def dryrun_rows() -> list:
    """(a) Every arch's dry-run row at DRYRUN_SHAPE on the 16x16 fake mesh
    (the traced per-device cost and the H100 roofline terms: modelled at
    the data sheet's peaks, not measured)."""
    from repro_torch.launch import dryrun

    rows = []
    t = time.perf_counter()
    for arch in lm_configs.ARCHS:
        rec = dryrun.run_cell(arch, DRYRUN_SHAPE, multi_pod=False)
        log(f"dryrun row: {json.dumps(rec)}")
        if rec["status"] == "failed":
            raise AssertionError(f"dry-run {arch} x {DRYRUN_SHAPE} x 16x16 failed: {rec['error']}")
        rows.append(rec)
    log(f"dryrun rows seconds={time.perf_counter() - t}")
    return rows


def dryrun_production() -> list:
    """(a') olmo-1b's DRYRUN_PRODUCTION cells on the 16x16 / 2x16x16 fake
    meshes, on this host's torch; a failed cell fails the phase."""
    from repro_torch.launch import dryrun

    rows = []
    t = time.perf_counter()
    for shape, multi_pod in DRYRUN_PRODUCTION:
        rec = dryrun.run_cell("olmo_1b", shape, multi_pod=multi_pod)
        log(f"dryrun production cell: {json.dumps(rec)}")
        if rec["status"] != "ok":
            raise AssertionError(f"dry-run olmo_1b x {shape} x {rec['mesh']} {rec['status']}: {rec.get('error')}")
        rows.append(rec)
    log(f"dryrun production cells seconds={time.perf_counter() - t}")
    return rows


def dryrun_card_check(device, model, params, shape: ShapeConfig) -> dict:
    """(b) The 1-device dry-run of full olmo-1b at ``shape`` against the
    same step on the card: the traced FLOPs equal, the predicted peak (its
    bytes above the step's inputs) within DRYRUN_PEAK_REL of the card's
    ``max_memory_allocated`` delta, and the step's CUDA-event time no less
    than the row's t_ideal and modelled step."""
    from repro_torch.analysis import op_cost
    from repro_torch.launch import dryrun

    pred = dryrun.lower_cell("olmo_1b", shape, mesh="host", full_depth=True)
    batch = model.input_specs(shape, device=device)
    if shape.kind == "train":
        batch["tokens"] = prng.randint(prng.PRNGKey(SEED + 3), batch["tokens"].shape, 0, model.cfg.vocab_size,
                                       device=device)
        batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
        opt_state = opt_lib.init(params)
        step_fn = lm_steps.make_train_step(model)

        def step():
            return step_fn(params, opt_state, batch)
    else:
        batch["cache_len"] = shape.seq_len - 1  # the dry-run's decode position
        decode_fn = lm_steps.make_decode_step(model)

        def step():
            with torch.no_grad():
                return decode_fn(params, batch)

    step()  # warm: cuBLAS workspaces, first-call allocations
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, tally = op_cost.count(step, device_type="cuda")
    torch.cuda.synchronize()
    delta = torch.cuda.max_memory_allocated() - base
    del out
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(DRYRUN_REPS):
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    if shape.kind == "train":
        del opt_state
    measured_s = statistics.median(times)
    out = {
        "shape": shape.name, "pred_gflops": pred["hlo_gflops_per_chip"], "card_gflops": tally.cost.flops / 1e9,
        "pred_temp_peak_bytes": pred["temp_peak_bytes_per_chip"], "card_peak_delta_bytes": delta,
        "peak_rel_err": (pred["temp_peak_bytes_per_chip"] - delta) / delta,
        "pred_gbytes": pred["hlo_gbytes_per_chip"], "card_traced_gbytes": tally.cost.bytes / 1e9,
        "t_ideal_s": pred["t_ideal_s"], "t_step_s": pred["t_step_s"], "bottleneck": pred["bottleneck"],
        "measured_step_s": measured_s, "step_s_all": times, "measured_over_modelled": measured_s / pred["t_step_s"],
        "trace_s": pred["trace_s"],
    }
    log(f"dryrun card check olmo_1b x {shape.name}: {json.dumps(out)}")
    if out["card_gflops"] != out["pred_gflops"]:
        raise AssertionError(f"{shape.name}: card FLOPs {tally.cost.flops} != dry-run {pred['hlo_gflops_per_chip']} G")
    if abs(out["peak_rel_err"]) > DRYRUN_PEAK_REL:
        raise AssertionError(f"{shape.name}: predicted peak {pred['temp_peak_bytes_per_chip']} vs card {delta}")
    if measured_s < max(pred["t_ideal_s"], pred["t_step_s"]):
        raise AssertionError(f"{shape.name}: measured {measured_s} s beats the bound {pred['t_step_s']} s")
    return out


def dryrun_collective(device) -> dict:
    """(c) ``compressed_grad_allreduce`` on card leaves over a world-size-1
    NCCL group against the CPU port's over gloo, bit for bit.  One card can
    hold the collective only in this degenerate form (each all-gather moves
    the rank's own payload); the payload, scale and mean arithmetic are the
    same code as on a real pod axis."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives

    g = {"blocks": {"w1": prng.normal(prng.PRNGKey(11), (64, 4096)) * 0.02,
                    "norm": prng.normal(prng.PRNGKey(12), (4096,))},
         "embed": (prng.normal(prng.PRNGKey(13), (50304, 64)) * 3).to(torch.bfloat16),
         "gate": torch.zeros((3,))}
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        want = collectives.compressed_grad_allreduce(g, prng.PRNGKey(3), init_device_mesh("cpu", (1,), mesh_dim_names=("pod",)))
        got = collectives.compressed_grad_allreduce(lm_transformer.tree_map(lambda t: t.to(device), g), prng.PRNGKey(3),
                                                    init_device_mesh("cuda", (1,), mesh_dim_names=("pod",)))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    leaves = 0
    for (a, b) in zip(lm_transformer.tree_leaves(want), lm_transformer.tree_leaves(got)):
        if a.dtype != b.dtype or not torch.equal(a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                                                 b.cpu().view(torch.int16 if b.element_size() == 2 else torch.int32)):
            raise AssertionError("compressed_grad_allreduce: the card's mean differs from the CPU's")
        leaves += 1
    out = {"leaves": leaves, "elements": sum(t.numel() for t in lm_transformer.tree_leaves(g)), "bit_equal": True}
    log(f"dryrun collective (world size 1, nccl vs gloo): {json.dumps(out)}")
    return out


def phase_dryrun(device) -> dict:
    """``--dryrun``: (a) the rows, (a') olmo-1b's production cells, (b) the
    card checks, (c) the collective."""
    from repro_torch.launch import mesh as mesh_lib

    t = time.perf_counter()
    try:
        rows = dryrun_rows()
        production = dryrun_production()
        model = lm_model.build(lm_configs.get("olmo_1b"))
        params = model.init(prng.PRNGKey(SEED), device=device)
        checks = {k: dryrun_card_check(device, model, params, s) for k, s in DRYRUN_CHECK.items()}
        del params
        torch.cuda.empty_cache()
    finally:
        mesh_lib.release()
    coll = dryrun_collective(device)
    log(f"dryrun seconds={time.perf_counter() - t}")
    return {"rows": rows, "production": production, "checks": checks, "collective": coll}


LINT_STEP_RULES = {"host-sync-in-step", "dynamic-shape-in-step"}


def lint_static() -> tuple:
    """``repro_torch.lint`` over ``src/repro_torch``: the catalog, the
    findings, and a map of which lines lie in step-reachable functions and
    which of those the two step rules flag or carry a pragma of."""
    from repro_torch.lint import ALL_RULES, lint_paths
    from repro_torch.lint.engine import LintEngine, iter_python_files, parse_file_info

    src = os.path.join(ROOT, "src", "repro_torch")
    for rule in ALL_RULES:
        log(f"lint rule {rule.name}: {rule.description}")
    findings = lint_paths([src])
    for f in findings:
        log(f"lint finding {os.path.relpath(f.path, ROOT)}:{f.line}:{f.col}: {f.rule}: {f.message}")
    log(f"lint static: {len(ALL_RULES)} rules, {len(findings)} finding(s)")
    files = []
    for path in iter_python_files([src]):
        with open(path, encoding="utf-8") as fh:
            files.append(parse_file_info(path, fh.read()))
    project = LintEngine(ALL_RULES).build_context(files)
    step_rules = [r for r in ALL_RULES if r.name in LINT_STEP_RULES]
    lines = {}
    for info in files:
        spans, stmts, marked = [], [], set()
        for node in ast.walk(info.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                spans.append((node.lineno, node.end_lineno, node.name))
            if isinstance(node, ast.stmt):
                body = getattr(node, "body", None)
                # a compound statement owns its header lines only
                end = body[0].lineno - 1 if isinstance(body, list) and body else node.end_lineno
                stmts.append((node.lineno, max(end, node.lineno)))
        for rule in step_rules:
            for _, node in rule.check(info, project):
                marked.update(range(node.lineno, node.end_lineno + 1))
        marked.update(ln for ln, rules in info.line_pragmas.items() if rules & (LINT_STEP_RULES | {"all"}))
        whole = bool(info.file_pragmas & (LINT_STEP_RULES | {"all"}))
        lines[os.path.relpath(info.path, ROOT)] = (spans, stmts, marked, whole)
    return findings, lines, project.step_reachable


def lint_site(lines: dict, reachable: set, site: str) -> tuple:
    """(innermost function, in a step, covered) of a ``path:line`` sync site:
    in a step when the innermost function holding the line is step-reachable;
    covered when a step rule flags, or a pragma of one marks, a line of the
    innermost statement holding it."""
    path, _, ln = site.rpartition(":")
    if path not in lines:
        return None, False, False
    spans, stmts, marked, whole = lines[path]
    ln = int(ln)
    fns = [sp for sp in spans if sp[0] <= ln <= sp[1]]
    if not fns:
        return None, False, False
    fn = min(fns, key=lambda sp: sp[1] - sp[0])[2]
    around = [st for st in stmts if st[0] <= ln <= st[1]]
    lo, hi = min(around, key=lambda st: st[1] - st[0]) if around else (ln, ln)
    return fn, fn in reachable, whole or any(x in marked for x in range(lo, hi + 1))


@contextlib.contextmanager
def build_counters():
    """Counts of ``_build._nvcc`` runs and ``ctypes.CDLL`` loads in the block."""
    counts = {"nvcc": 0, "cdll": 0}
    nvcc, cdll = _build._nvcc, ctypes.CDLL

    def counted_nvcc(*args, **kwargs):
        counts["nvcc"] += 1
        return nvcc(*args, **kwargs)

    class CountedCDLL(cdll):
        def __init__(self, *args, **kwargs):
            counts["cdll"] += 1
            super().__init__(*args, **kwargs)

    _build._nvcc, ctypes.CDLL = counted_nvcc, CountedCDLL
    try:
        yield counts
    finally:
        _build._nvcc, ctypes.CDLL = nvcc, cdll


def htod_copies(fn) -> tuple:
    """(fn(), host -> device copies in one call by torch.profiler: their
    count, the device events seen and the memcpy events by kind).  A copy
    from pageable memory also syncs, so its site is among sync_sites'."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type != torch.autograd.DeviceType.CPU and not e.is_user_annotation]
    kinds = collections.Counter(e.name for e in device if e.name.startswith("Memcpy"))
    copies = sum(n for k, n in kinds.items() if k.startswith("Memcpy HtoD"))
    return out, {"count": copies, "device_events": len(device), "memcpy_kinds": dict(kinds)}


def lint_path(fn, keys) -> dict:
    """Two warm calls of ``fn`` on ``keys[0]`` and ``keys[1]``, then a third on
    ``keys[2]`` under the three instruments: the build and load counters,
    the profiler's host -> device copies and the sync debug mode's sites."""
    for k in keys[:2]:
        fn(k)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with build_counters() as built:
        syncs, copies = htod_copies(lambda: sync_sites(lambda: fn(keys[2])))
    return {"builds": dict(built), "htod": copies, "seconds": time.perf_counter() - t, "syncs": syncs}


MESH_KPGM_D = 16  # kpgm_sample_distributed on the card against the CPU port: ~1.2 M edges
MESH_LAYOUTS = (4, 3)  # shard counts whose gid chunks run one after another (3: padding rows at n = 2^15)


def collective_ms(fn) -> tuple:
    """(result, device ms of the NCCL kernels, their launches) of one call
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if "nccl" in e.key.lower() and e.self_device_time_total > 0]
    return out, sum(e.self_device_time_total for e in hits) / 1e3, sum(e.count for e in hits)


def mesh_vs_plain(what: str, plain, meshed, keys) -> dict:
    """``meshed`` (a world-size-1 NCCL mesh session) against ``plain`` (the
    same config, no mesh) on ``keys``: the edges equal, kernel 1 launched
    by the mesh run, host-clock ms of both, the NCCL kernels' device ms."""
    for i, k in enumerate(keys):
        want = plain.sample(k).edges
        ops.reset_kernel_launches()
        got = meshed.sample(k).edges
        torch.cuda.synchronize()
        launches = ops.kernel_launches()
        if not np.array_equal(got, want):
            raise AssertionError(f"mesh {what}: the mesh session's edges differ from the unsharded session's")
        if i == 0 and launches["quilt_prng_descent_lookup"] < 1:
            raise AssertionError(f"mesh {what}: the mesh run launched no quilt_prng_descent_lookup")
    plain_ms = timed_runs(plain.sample, keys)
    mesh_ms = timed_runs(meshed.sample, keys)
    _, nccl_ms, nccl_launches = collective_ms(lambda: meshed.sample(keys[0]))
    out = {"edges": int(want.shape[0]), "plain_ms": plain_ms, "mesh_ms": mesh_ms,
           "plain_ms_median": statistics.median(plain_ms), "mesh_ms_median": statistics.median(mesh_ms),
           "nccl_device_ms": nccl_ms, "nccl_launches": nccl_launches, "launches": launches}
    log(f"mesh {what} n=2^{FULL_LOG2_N}: mesh == no mesh, {json.dumps(out)}")
    return out


def mesh_chunks(plan, device) -> dict:
    """(b) The exact round of ``plan`` as each layout's ranks run it: the
    padded gids cut into equal chunks, each through _round_body (kernel 1)
    in turn; their concatenation equals the whole round and the padding
    rows take nothing; the last chunk's kernel 1 against its plain version."""
    from repro_torch.dist import hints, sharding

    key = prng.PRNGKey(SEED + 3)
    k, _ = prng.split(key)
    _, rkey = prng.split(k)
    budget = quilt._exact_budget(plan.p_max, plan.mean_edges)
    gtot = plan.num_graphs
    ops.reset_kernel_launches()
    whole = quilt._round_body(rkey, torch.arange(gtot, dtype=torch.int32, device=device),
                              torch.full((gtot,), budget, dtype=torch.int64, device=device), plan,
                              a_tot=budget, budget=budget, use_kernel=True)
    out = {}
    for shards in MESH_LAYOUTS:
        layout = sharding.graph_layout(hints.MeshShape(("graphs",), (shards,)), gtot)
        gids, tdev = quilt._pad_inputs(gtot, layout.padded, None, budget, device)
        chunk = layout.padded // shards
        parts = [quilt._round_body(rkey, gids[r * chunk:(r + 1) * chunk], tdev[r * chunk:(r + 1) * chunk], plan,
                                   a_tot=budget, budget=budget, use_kernel=True) for r in range(shards)]
        rows = gtot * budget
        for j, name in enumerate(("scfg", "dcfg", "snode", "dnode", "take", "counts")):
            cat = torch.cat([p[j] for p in parts])
            n_real = gtot if name == "counts" else rows
            if not torch.equal(cat[:n_real], whole[j]):
                raise AssertionError(f"mesh chunks ({shards} ranks): {name} differs from the whole round")
            if name in ("take", "counts") and bool(cat[n_real:].any()):
                raise AssertionError(f"mesh chunks ({shards} ranks): a padding row took {name}")
        seed = ops.counter_seed(rkey)
        last = gids[(shards - 1) * chunk:]
        args = (seed, last, plan.cum, plan.table_cfg, plan.table_node)
        got = qd.quilt_prng_descent_lookup(*args, a_tot=budget, num_blocks=plan.B)
        want = qd.quilt_prng_descent_lookup_plain(*args, a_tot=budget, num_blocks=plan.B)
        torch.cuda.synchronize()
        equal_or_raise(got, want, f"quilt_prng_descent_lookup on the last of {shards} gid chunks")
        out[shards] = {"padded": layout.padded, "padding_rows": layout.padded - gtot, "chunk_graphs": chunk}
        log(f"mesh chunks: {shards} ranks' chunks of {chunk} graphs ({layout.padded - gtot} padding) == "
            f"the whole round of {gtot} graphs x {budget} slots; kernel == plain on the last chunk")
    out["launches"] = ops.kernel_launches()["quilt_prng_descent_lookup"]
    return out


def mesh_kpgm(mesh) -> dict:
    """(c) kpgm_sample_distributed on the card's NCCL mesh against the CPU
    port's on a gloo mesh over the same 1-rank world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core import distributed

    cpu_mesh = DeviceMesh.from_group(dist.new_group(backend="gloo"), "cpu", mesh=[0], mesh_dim_names=("graphs",))
    params = kpgm.make_params(THETA_1, MESH_KPGM_D)
    key = prng.PRNGKey(SEED + 150)
    ops.reset_kernel_launches()
    t = time.perf_counter()
    got = distributed.kpgm_sample_distributed(key, params, mesh)
    card_ms = (time.perf_counter() - t) * 1e3
    launches = ops.kernel_launches()
    t = time.perf_counter()
    want = distributed.kpgm_sample_distributed(key, params, cpu_mesh)
    cpu_ms = (time.perf_counter() - t) * 1e3
    if not np.array_equal(got, want):
        raise AssertionError("kpgm_sample_distributed: the card's edges differ from the CPU port's")
    if launches["quadrant_descent"] < 1:
        raise AssertionError("kpgm_sample_distributed launched no quadrant_descent on the card")
    check_edges(got, params.num_nodes, f"kpgm_sample_distributed d={MESH_KPGM_D}")
    out = {"edges": int(got.shape[0]), "card_ms": card_ms, "cpu_ms": cpu_ms, "launches": launches}
    log(f"mesh kpgm_sample_distributed d={MESH_KPGM_D}: card == CPU, {json.dumps(out)}")
    return out


def mesh_restore(mesh, device) -> dict:
    """(d) restore(shardings=) onto the card mesh: placed leaves come back
    as DTensors on the card with the saved bits, the unplaced one as the
    target's kind."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    tree = {"w": prng.normal(prng.PRNGKey(SEED + 160), (1024, 64)).to(device),
            "b": prng.normal(prng.PRNGKey(SEED + 161), (512,)).to(torch.bfloat16).to(device),
            "n": np.arange(6, dtype=np.int32)}
    with tempfile.TemporaryDirectory() as d:
        ckpt_mod.save(d, 3, tree)
        got, _ = ckpt_mod.restore(d, 3, tree, shardings={"w": (mesh, (Shard(0),)), "b": (mesh, (Replicate(),)),
                                                         "n": None})
    for k in ("w", "b"):
        g = got[k]
        if not (isinstance(g, DTensor) and g.device.type == device.type and g.dtype == tree[k].dtype):
            raise AssertionError(f"restore(shardings=): {k} came back as {type(g).__name__} {g.dtype}")
        if not torch.equal(g.to_local(), tree[k]):
            raise AssertionError(f"restore(shardings=): {k}'s shard differs from the saved bits")
    if not np.array_equal(got["n"], tree["n"]):
        raise AssertionError("restore(shardings=): the unplaced leaf differs")
    log("mesh restore(shardings=): w Shard(0), b Replicate() as card DTensors with the saved bits")
    return {"leaves": 3, "placed": 2}


def phase_mesh(device) -> dict:
    """``--mesh``: the sampler on a world-size-1 NCCL ``graphs`` mesh that
    the session starts.  (a) the exact session, ball dropping and the split
    at n = 2^15 equal to the unsharded sessions, with both times; (b) the
    4- and 3-rank layouts' gid chunks through _round_body on the card,
    concatenated, equal to the whole round; (c) kpgm_sample_distributed on
    the card against the CPU port; (d) restore(shardings=) onto the card
    mesh.  The world is torn down at the end."""
    from repro_torch.launch import mesh as mesh_lib

    t0 = time.perf_counter()
    out = {}
    try:
        keys = [prng.PRNGKey(SEED + 170 + i) for i in range(5)]
        for what, cfg in (("exact", paper_config(FULL_LOG2_N, device)),
                          ("balldrop", balldrop_config(FULL_LOG2_N, device)),
                          ("split", split_config(FULL_LOG2_N, 0.5, device))):
            plain, meshed = MAGMSampler(cfg), MAGMSampler(cfg.replace(mesh="auto"))
            want = mesh_lib.SamplerWorld("nccl" if device.type == "cuda" else "gloo", 1, 0, True)
            if meshed.world != want or meshed.mesh.device_type != device.type:
                raise AssertionError(f"mesh {what}: the session took {meshed.world} on {meshed.mesh}")
            out[what] = mesh_vs_plain(what, plain, meshed, keys)
            if what == "exact":
                mesh = meshed.mesh
                out["chunks"] = mesh_chunks(plain.plan, device)
            del plain, meshed
        out["kpgm_distributed"] = mesh_kpgm(mesh)
        out["restore"] = mesh_restore(mesh, device)
    finally:
        mesh_lib.release()
    log(f"mesh seconds={time.perf_counter() - t0}")
    return out


def phase_lint(device) -> dict:
    """``--lint``: the linter's static half over ``src/repro_torch`` and its
    runtime halves on the card, on warm calls at full size (gates: no
    finding; no build or library load in a warm call; every sync site in a
    step-reachable function flagged by a step rule or under its pragma;
    no host -> device copy in a warm sample() / sample_stream() of the
    quilt, split and ball-dropping sessions, as the reference's transfer
    guard holds them)."""
    t0 = time.perf_counter()
    findings, lines, reachable = lint_static()
    failures = [f"{len(findings)} lint finding(s)"] if findings else []
    keys = [prng.PRNGKey(SEED + i) for i in range(3)]
    sessions = {
        "quilt": MAGMSampler(paper_config(FULL_LOG2_N, device)),
        "split": MAGMSampler(split_config(FULL_LOG2_N, 0.5, device)),
        "balldrop": MAGMSampler(balldrop_config(FULL_LOG2_N, device)),
    }
    paths = {}
    for what, sampler in sessions.items():
        paths[f"{what} sample"] = (lambda k, s=sampler: s.sample(k), True)
        paths[f"{what} sample_stream"] = (
            lambda k, s=sampler: list(s.sample_stream(k, chunk_edges=RESUME_CHUNK)), True)
    kpgm_s = KPGMSampler(SamplerConfig(params=kpgm.make_params(THETA_1, KPGM_D), backend="host", device=device))
    paths[f"kpgm host sample d={KPGM_D}"] = (lambda k: kpgm_s.sample(k), False)

    model = lm_model.build(lm_configs.get("olmo-1b"))
    params = model.init(prng.PRNGKey(SEED), device=device)
    cfg = model.cfg
    prompts = prng.randint(prng.PRNGKey(SEED + 1), (LM_BATCH, LM_PROMPT), 0, cfg.vocab_size, device=device)
    prefill = lm_steps.make_prefill_step(model, max_len=LM_PROMPT + LM_GEN)
    decode = lm_steps.make_decode_step(model)
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": prompts})
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    del logits

    def decode_step(_):
        with torch.inference_mode():
            return decode(params, {"cache": cache, "tokens": tok, "cache_len": LM_PROMPT})

    paths["olmo-1b decode_step"] = (decode_step, False)
    toks = prng.randint(prng.PRNGKey(SEED + 2), (TRAIN_BATCH, TRAIN_SEQ + 1), 0, cfg.vocab_size, device=device)
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    train_step = lm_steps.make_train_step(model, opt_lib.OptConfig(lr=TRAIN_LR, warmup_steps=10, total_steps=100))
    state = {"params": trainable(params), "opt": None}
    state["opt"] = opt_lib.init(state["params"])

    def train(_):
        state["params"], state["opt"], m = train_step(state["params"], state["opt"], batch)
        return m

    paths[f"olmo-1b train_step {TRAIN_BATCH}x{TRAIN_SEQ}"] = (train, False)

    out = {}
    for what, (fn, held) in paths.items():
        r = lint_path(fn, keys)
        sites = {}
        for site, n in r["syncs"]["sites"].items():
            fn_name, in_step, covered = lint_site(lines, reachable, site)
            sites[site] = {"count": n, "function": fn_name, "in_step": in_step, "covered": covered}
        r["sync_sites"] = sites
        log(f"lint path {what}: syncs={r['syncs']['count']} htod={r['htod']['count']} builds={r['builds']} "
            f"seconds={r['seconds']}")
        for site, v in sites.items():
            log(f"lint path {what}: sync site {site} x{v['count']} in {v['function']} "
                f"{'(step, ' + ('flagged)' if v['covered'] else 'NOT FLAGGED)') if v['in_step'] else '(outside the steps)'}")
        log(f"lint path {what}: htod {json.dumps(r['htod'])}")
        if r["builds"] != {"nvcc": 0, "cdll": 0}:
            failures.append(f"{what}: a warm call built or loaded a library: {r['builds']}")
        missed = [site for site, v in sites.items() if v["in_step"] and not v["covered"]]
        if missed:
            failures.append(f"{what}: sync sites in steps that no step rule flags: {missed}")
        if held:
            if r["htod"]["device_events"] == 0:
                failures.append(f"{what}: the profiler saw no device event")
            if r["htod"]["count"]:
                failures.append(f"{what}: {r['htod']['count']} host -> device copies")
        out[what] = {"syncs": r["syncs"]["count"],
                     "sites_in_steps": sum(v["in_step"] for v in sites.values()),
                     "sites_outside": sum(not v["in_step"] for v in sites.values()),
                     "htod": r["htod"]["count"], "builds": r["builds"], "seconds": r["seconds"]}
    log(f"lint seconds={time.perf_counter() - t0}")
    if failures:
        raise AssertionError("lint gates failed:\n" + "\n".join(failures))
    return {"findings": len(findings), "paths": out}


def ok_line() -> str:
    """The contracted last line."""
    return json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


def main(argv) -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = nvidia_smi()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    phase_build()
    if argv == ["--tiles"]:
        tiles = phase_tiles_vs_plain(device)
        log(nvidia_smi())
        log(json.dumps({"tiles": tiles}))
        return 0
    if argv == ["--accept"]:
        accept = phase_exact_accept(device)
        log(nvidia_smi())
        log(json.dumps({"exact_accept": accept}))
        return 0
    if argv == ["--lookup"]:
        plans = [MAGMSampler(paper_config(lg, device)).plan for lg in (HOST_LOG2_N, CHECK_LOG2_N)]
        lookup = phase_lookup_vs_plain(device, plans)
        log(nvidia_smi())
        log(json.dumps({"quilt_descent_lookup": lookup}))
        return 0
    if argv == ["--serve"]:
        t = time.perf_counter()
        res = phase_resilience_and_serving(device, MAGMSampler(paper_config(FULL_LOG2_N, device)))
        log(f"resilience and serving seconds={time.perf_counter() - t}")
        log(nvidia_smi())
        log(json.dumps({"serve": res}))
        return 0
    if argv == ["--fit"]:
        t = time.perf_counter()
        fit = phase_magfit(device, claim_keys=(0, 1, 2))
        log(f"magfit seconds={time.perf_counter() - t}")
        log(nvidia_smi())
        log(json.dumps({"magfit": fit}))
        return 0
    if argv == ["--lm"]:
        t = time.perf_counter()
        lm = phase_lm(device, archs=("qwen3-14b", "yi-9b"), cut=True)
        log(f"lm seconds={time.perf_counter() - t}")
        log(nvidia_smi())
        log(json.dumps({"lm": {k: {m: v[m] for m in ("prefill_ms", "decode_ms", "tokens_per_s", "decode_bound_ms")}
                               for k, v in lm.items()}}))
        return 0
    if argv == ["--train"]:
        t = time.perf_counter()
        tr = phase_train_full(device)
        log(f"train seconds={time.perf_counter() - t}")
        log(nvidia_smi())
        log(json.dumps({"train": {k: {m: v[m] for m in ("warm_step_ms", "tokens_per_s", "mfu", "bound_ms",
                                                          "max_memory_allocated")}
                                  for k, v in tr.items() if k in ("8x128", "4x4096")}}))
        return 0
    if argv[:1] == ["--families"]:
        t = time.perf_counter()
        fams = phase_families_full(device, argv[1:] or list(FAMILY_SERVE_LAYERS))
        log(f"families seconds={time.perf_counter() - t}")
        log(nvidia_smi())
        keys_s, keys_t = ("prefill_ms", "decode_ms", "tokens_per_s", "decode_bound_ms"), (
            "warm_step_ms", "mfu", "bound_ms", "max_memory_allocated")
        log(json.dumps({"families": {a: {"serve_layers": r["serve_layers"], **{k: r["serve"][k] for k in keys_s},
                                         **({"train_layers": r["train_layers"], **{k: r["train"][k] for k in keys_t}}
                                            if "train" in r else {})} for a, r in fams.items()}}))
        return 0
    if argv == ["--dryrun"]:
        dr = phase_dryrun(device)
        log(nvidia_smi())
        row_keys = ("arch", "shape", "mesh", "status", "bottleneck", "t_step_s", "t_ideal_s", "peak_bytes_per_chip")
        log(json.dumps({"dryrun": {"rows": [{k: r.get(k) for k in row_keys} for r in dr["rows"]],
                                   "production": [{k: r.get(k) for k in row_keys + ("coll_breakdown",)}
                                                  for r in dr["production"]],
                                   "checks": dr["checks"], "collective": dr["collective"]}}))
        return 0
    if argv == ["--lint"]:
        lint = phase_lint(device)
        log(nvidia_smi())
        log(json.dumps({"lint": lint}))
        log(ok_line())
        return 0
    if argv == ["--mesh"]:
        mesh = phase_mesh(device)
        log(nvidia_smi())
        log(json.dumps({"mesh": mesh}))
        log(ok_line())
        return 0
    if argv == ["--split"]:
        split = phase_split_and_batches(device, MAGMSampler(paper_config(FULL_LOG2_N, device)))
        t = time.perf_counter()
        phase_validation_suite(device)
        log(f"3-sigma suite seconds={time.perf_counter() - t}")
        log(nvidia_smi())
        log(json.dumps({"split": split}))
        return 0
    check = phase_kernel_vs_plain(device)
    accept = phase_exact_accept(device)
    tiles = phase_tiles_vs_plain(device)
    descent = phase_descent_prng(device)
    native = phase_native(device, descent["ms"])
    phase_cross_device(device)
    full, sampler, quilt_edges = phase_full_size(device)
    naive_launches = phase_naive_full_size(sampler, quilt_edges)
    phase_naive_cross_device(device)
    dense_launches = phase_dense_scoring(device)
    plans = [MAGMSampler(paper_config(lg, device)).plan for lg in (HOST_LOG2_N, CHECK_LOG2_N)]
    uniform = phase_uniform_kernels_vs_plain(device, plans)
    del plans
    phase_legacy_cross_device(device)
    phase_ranked(device)
    host_launches = phase_host_session(device)
    kpgm_launches = phase_kpgm_host(device)
    bd_launches, bd_err = phase_balldrop_full_size(device)
    bd_host_launches = phase_balldrop_host(device)
    phase_balldrop_cross_device(device)
    split = phase_split_and_batches(device, sampler)
    phase_validation_suite(device)
    phase_resilience_and_serving(device, sampler)
    fit_launches = phase_magfit(device)
    _, (olmo, olmo_params) = phase_lm(device, keep=True)
    train = phase_train(device, olmo, olmo_params)
    del olmo_params
    torch.cuda.empty_cache()
    families = phase_families(device)
    log(f"balldrop launches: n=2^{FULL_LOG2_N} {bd_launches} n=2^{HOST_LOG2_N} {bd_host_launches}")

    kernels = [
        {
            "name": "quilt_prng_descent_lookup",
            "route": "cuda",
            "source": "src/repro_torch/csrc/quilt_prng_descent_lookup.cu",
            "replaces": "src/repro/kernels/quadrant_descent.py:516",
            # the main path's exact sample, MAGFIT's round trip and cap
            # sample, and the training corpora's splits (olmo-1b, zamba2)
            "launches": full["launches"] + fit_launches["quilt_prng_descent_lookup"]
            + train["corpus"]["quilt_prng_descent_lookup"] + families["corpus"]["quilt_prng_descent_lookup"],
            "max_abs_err": max(check["max_abs_err"], bd_err, split["max_abs_err"]),
            "ms": full["ms"],
            "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"],
            "bound_by": full["bound_by"],
            "library_ms": None,  # no single PyTorch call computes this function
        },
        {
            "name": "quadrant_descent_prng",
            "route": "cuda",
            "source": "src/repro_torch/csrc/quadrant_descent_prng.cu",
            "replaces": "src/repro/kernels/quadrant_descent.py:390",
            **descent,
        },
        {
            "name": "magm_logprob",
            "route": "cuda",
            "source": "src/repro_torch/csrc/magm_logprob.cu",
            "replaces": "src/repro/kernels/magm_logprob.py:46",
            # its user path: one (n, n) launch per dense scoring call, and
            # MAGFIT's elbo_dense check (the 256 launches of the sum-Q walk
            # are this script's own check)
            "launches": dense_launches + fit_launches["magm_logprob"],
            **tiles["magm_logprob"],
        },
        {
            "name": "bernoulli_tile",
            "route": "cuda",
            "source": "src/repro_torch/csrc/bernoulli_tile.cu",
            "replaces": "src/repro/kernels/bernoulli_tile.py:44",
            "launches": naive_launches["bernoulli_tile"],
            **tiles["bernoulli_tile"],
        },
        {
            "name": "quadrant_descent",
            "route": "cuda",
            "source": "src/repro_torch/csrc/quadrant_descent.cu",
            "replaces": "src/repro/kernels/quadrant_descent.py:188",
            "launches": kpgm_launches["quadrant_descent"],
            **uniform["quadrant_descent"],
        },
        {
            "name": "quilt_descent_lookup",
            "route": "cuda",
            "source": "src/repro_torch/csrc/quilt_descent_lookup.cu",
            "replaces": "src/repro/kernels/quadrant_descent.py:131",
            "launches": host_launches["quilt_descent_lookup"],
            **uniform["quilt_descent_lookup"],
        },
        {
            "name": "quadrant_descent_native",
            "route": "cuda",
            "source": "src/repro_torch/csrc/quadrant_descent_native.cu",
            "replaces": "src/repro/kernels/quadrant_descent.py:369",
            **native,
        },
        {
            "name": "exact_accept",
            "route": "cuda",
            "source": "src/repro_torch/csrc/exact_accept.cu",
            # port-only: the reference computes the acceptance in jnp
            "replaces": "none (src/repro/core/quilt.py::_exact_cell_valid, jnp)",
            "launches": full["exact_accept_launches"],
            **accept,
        },
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    log(f"full run seconds={time.perf_counter() - t0}")
    log(nvidia_smi())
    log(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    log(ok_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
