"""Roofline bounds on one NVIDIA H100 SXM: the least time the card could
take for some work, the larger of its bytes over the HBM rate and its
operations over the peak rate for their type.

- The kernels' bounds (``*_bound_ms``), which ``chip_smoke.py`` prints
  beside each kernel's time: each returns ``(ms, "bytes" | "operations")``.
- The LM's useful work per step (:func:`model_flops`, GFLOPs) and its
  unavoidable HBM traffic (:func:`model_min_bytes`, GB), the reference's
  ``repro.analysis.roofline`` arithmetic on the config and the cache
  shapes, with no allocation (the cache is laid out on the ``meta``
  device); a train step's bound (:func:`train_step_bound_ms`).
- The dry-run's step terms (:class:`Roofline`, :func:`build`,
  :func:`save_rows`), with the reference's fields and ``row()`` keys:

      compute term    = FLOPs per chip / BF16_FLOPS_PER_S
      memory term     = bytes per chip / HBM_BYTES_PER_S
      collective term = collective bytes per chip / LINK_BYTES_PER_S

  ``hlo_*`` in the row names the op-traced count (``analysis.op_cost``,
  which reads aten ops, not HLO).  The reference's TPU v5e constants and
  its HLO-text parsing have no counterpart here: :func:`collective_bytes`
  takes the traced cost's per-kind dict.
"""

from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING, Dict, Optional

if TYPE_CHECKING:
    from repro_torch.core import quilt

# H100 SXM peaks: HBM 3.35 TB/s and dense bf16 tensor-core math 989 TFLOP/s
# (NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, without sparsity);
# 32-bit operations at 128 lanes per SM x 132 SMs x 1.98 GHz = 33.5 T ops/s,
# half the 67 TFLOP/s float32 rate (which counts an FMA as two): integer
# multiplies run on the FMA pipe beside the 64 INT32 lanes, so no mix of
# 32-bit ops goes faster
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
INT32_OPS_PER_S = 128 * 132 * 1.98e9
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores, an FMA counted as two
# One link rate for every mesh axis: NVLink 4 at 450 GB/s a direction (the
# data sheet's 900 GB/s is both directions), the counterpart of the
# reference's one ICI rate.  An axis that spans nodes would run at the
# InfiniBand rate instead; the one-rate model does not split it out, as
# the reference's one ICI rate does not split its inter-pod links.
LINK_BYTES_PER_S = 450e9
# a Philox4x32-10 call: 10 rounds of 4 multiplies and 4 XORs; the round keys
# depend on the seed alone, so the kernel computes them outside the calls
PHILOX_OPS = 10 * 8


# --- the kernels ---


def kernel_bound_ms(plan: "quilt.QuiltPlan", rows: int) -> tuple:
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


def accept_terms_ms(rows: int, hits: int, d: int) -> tuple:
    """exact_accept's work on this card as ``(ops_ms, bytes_ms)``: its
    32-bit operations at the 32-bit peak and its bytes at the HBM rate.
    Counted from the source: every row reads snode and dnode and writes one
    byte (9 B) in ~10 operations (loads, compares, the store, loop
    control); a row that hits both lookups also reads scfg and dcfg (8 B)
    and runs 8 operations a level for the table sum (two shifts, two masks,
    the index, the shared read, the add, loop control) and ~250 more: the
    row decode and cell ~25, the 64-bit hash and its uniform ~45, the five
    transcendentals with their clamps and selects ~180."""
    ops_ = rows * 10 + hits * (8 * d + 250)
    bytes_ = rows * 9 + hits * 8 + d * 16 + 8
    return ops_ / INT32_OPS_PER_S * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3


def accept_bound_ms(rows: int, hits: int, d: int) -> tuple:
    """Least time for exact_accept's work: the larger term of
    :func:`accept_terms_ms`."""
    t_ops, t_bytes = accept_terms_ms(rows, hits, d)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tile_bound_ms(M: int, N: int, d: int, cell_bytes: int) -> tuple:
    """Least time for a log-Q tile: its bytes (cell_bytes per output cell,
    each attribute row read once) at the HBM rate, or its float32 work (d
    FMAs per cell for the product, d for each of the M row and N column
    terms, 3 adds per cell) at the float32 peak, whichever is larger."""
    bytes_ = M * N * cell_bytes + (M + N) * d * 4 + 3 * d * 4 + 4
    flops = 2 * M * N * d + 2 * (M + N) * d + 3 * M * N
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def descent_bound_ms(slots: int, d: int) -> tuple:
    """Least time for quadrant_descent_prng: ~35 int32 operations per level
    (counted as for quilt_prng_descent_lookup) plus ~10 per slot, or 8 B of
    output per slot, whichever is larger."""
    t_ops = slots * (35 * d + 10) / INT32_OPS_PER_S * 1e3
    t_bytes = (slots * 8 + d * 16) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def uniform_bound_ms(rows: int, d: int, tables=None) -> tuple:
    """Least time for quadrant_descent (tables None) or quilt_descent_lookup
    on ``rows`` rows: its bytes (4 d of uniforms read and 8 of ids written
    per row; with a lookup also 8 of block ids read, 8 of node ids written
    and the tables read once) at the HBM rate, or its int32 operations at
    the int32 peak, whichever is larger.  Operations counted from the
    source: 8 per uniform to stage it through shared memory and 13 to
    descend its level (load, three compares, the bit updates, the loop),
    10 per row for the index and the stores; a search step 10, twice per
    row, and 10 for the block ids.  The searches run a fixed number of
    steps, so the count does not depend on the data."""
    bytes_ = rows * (4 * d + 8) + d * 16
    ops_ = rows * (21 * d + 10)
    if tables is not None:
        steps = max(tables.shape[1] - 1, 1).bit_length() + 1
        bytes_ += rows * 16 + tables.numel() * 8
        ops_ += rows * (2 * 10 * steps + 10)
    t_ops, t_bytes = ops_ / INT32_OPS_PER_S * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def native_bound_ms(slots: int, d: int) -> tuple:
    """Least time for quadrant_descent_native: ceil(d / 4) Philox calls a
    slot (PHILOX_OPS each), ~21 int32 operations a level for the uniform
    and the descent, ~10 a slot for the index and the stores; or 8 B of
    output a slot; whichever is larger."""
    t_ops = slots * (-(-d // 4) * PHILOX_OPS + 21 * d + 10) / INT32_OPS_PER_S * 1e3
    t_bytes = (slots * 8 + d * 16) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --- the LM ---


def model_flops(cfg, shape, *, chips: int) -> float:
    """Useful GFLOPs per chip: 6·N·D training, 2·N·D per forward token.

    N = active params (MoE counts routed experts only); D = tokens processed
    by the step (decode: batch tokens; prefill: B*S)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        factor = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        factor = 2.0
    return factor * n_active * tokens / chips / 1e9


def model_min_bytes(cfg, shape, *, chips: int) -> float:
    """Unavoidable per-chip HBM GB per step: weights (bf16, read once) plus,
    for decode, the full cache stream (``kvcache.init_cache``'s layout, any
    family: KV, SSM state and conv tails, the encoder output)."""
    from repro_torch.models import kvcache

    pbytes = cfg.param_count() * 2.0  # bf16 weights
    cbytes = 0.0
    if shape.kind == "decode":
        cache = kvcache.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
        for leaf in cache.values():
            cbytes += float(leaf.numel()) * leaf.element_size()
    return (pbytes + cbytes) / chips / 1e9


# AdamW's least traffic a parameter: read the bf16 gradient (2) and the
# float32 mu, nu and master (12); write mu, nu and master (12) and the bf16
# parameter (2)
OPT_BYTES_PER_PARAM = 28


def train_step_bound_ms(cfg, batch: int, seq: int) -> tuple:
    """Least time of one train step of ``batch`` x ``seq`` tokens on this
    card: its useful FLOPs (:func:`model_flops`, 6 N D) at the bf16 peak, or
    the optimizer's bytes (``OPT_BYTES_PER_PARAM`` a parameter) at the HBM
    rate, whichever is larger."""
    from repro_torch.configs.base import ShapeConfig

    flops = model_flops(cfg, ShapeConfig("train", seq, batch, "train"), chips=1) * 1e9
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = OPT_BYTES_PER_PARAM * cfg.param_count() / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --- the dry-run's step terms ---

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def collective_bytes(coll: Dict[str, float]) -> Dict[str, int]:
    """Bytes per collective kind, every one of the reference's five kinds
    present, from the traced cost's per-kind dict (``op_cost.Cost.coll``)."""
    unknown = set(coll) - set(KINDS)
    if unknown:
        raise ValueError(f"unknown collective kinds {sorted(unknown)}")
    return {k: int(coll.get(k, 0)) for k in KINDS}  # lint: disable=host-sync-in-step -- not a step: reached by the name build (kernels._build.build)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float  # per-chip GFLOPs (op-traced, local shards)
    hlo_gbytes: float  # per-chip GB accessed
    coll_gbytes: float  # per-chip GB through collectives
    coll_breakdown: Dict[str, int]
    model_gflops: float  # 6*N*D (or 6*N_active*D) useful flops per chip
    min_gbytes: float  # unavoidable per-chip HBM traffic (params + cache)
    peak_bytes_per_chip: Optional[float]  # live bytes' high-water mark

    @property
    def t_compute(self) -> float:
        return self.hlo_gflops * 1e9 / BF16_FLOPS_PER_S

    @property
    def t_memory(self) -> float:
        return self.hlo_gbytes * 1e9 / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return self.coll_gbytes * 1e9 / LINK_BYTES_PER_S

    @property
    def t_step(self) -> float:
        """The modelled step: the largest term (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_gflops / max(self.hlo_gflops, 1e-9)

    @property
    def t_ideal(self) -> float:
        """Best achievable step time: useful flops at the bf16 peak or the
        unavoidable HBM stream (weights + cache), whichever is larger."""
        return max(self.model_gflops * 1e9 / BF16_FLOPS_PER_S, self.min_gbytes * 1e9 / HBM_BYTES_PER_S)

    @property
    def roofline_fraction(self) -> float:
        """t_ideal / the modelled step (a lower bound on the achievable
        efficiency, since the step assumes perfect overlap)."""
        return self.t_ideal / max(self.t_step, 1e-12)

    def row(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_gflops_per_chip": self.hlo_gflops,
            "hlo_gbytes_per_chip": self.hlo_gbytes,
            "coll_gbytes_per_chip": self.coll_gbytes,
            "coll_breakdown": self.coll_breakdown,
            "model_gflops_per_chip": self.model_gflops,
            "min_gbytes_per_chip": self.min_gbytes,
            "t_ideal_s": self.t_ideal,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_bytes_per_chip": self.peak_bytes_per_chip,
        }


def build(arch: str, shape, cfg, mesh_name: str, chips: int, cost: Dict, coll: Dict[str, float],
          mem_bytes: Optional[float]) -> Roofline:
    """One row from a traced cost: ``cost`` holds ``"flops"`` and ``"bytes
    accessed"`` per chip, ``coll`` the collective bytes per kind."""
    coll = collective_bytes(coll)
    return Roofline(
        arch=arch,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        hlo_gflops=float(cost.get("flops", 0.0)) / 1e9,  # lint: disable=host-sync-in-step -- not a step: reached by the name build (kernels._build.build)
        hlo_gbytes=float(cost.get("bytes accessed", 0.0)) / 1e9,  # lint: disable=host-sync-in-step -- not a step: reached by the name build (kernels._build.build)
        coll_gbytes=sum(coll.values()) / 1e9,
        coll_breakdown=coll,
        model_gflops=model_flops(cfg, shape, chips=chips),
        min_gbytes=model_min_bytes(cfg, shape, chips=chips),
        peak_bytes_per_chip=mem_bytes,
    )


def save_rows(path: str, rows) -> None:
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
