"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on the
production mesh and record its per-device cost and roofline terms (the
reference's ``repro.launch.dryrun`` in PyTorch).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --both-meshes   # its 8 cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out /tmp/dryrun.json

Where the reference compiles on 512 fake XLA host devices and reads the
SPMD-partitioned HLO, a cell here runs one step of the port on DTensors:

- a named ``DeviceMesh`` over the first 256 or 512 ranks of a fake
  process group (this process is rank 0; ``launch.mesh``);
- params placed by ``sharding.param_specs``, inputs by
  ``sharding.input_specs``, every local shard a ``meta`` tensor (shapes,
  dtypes and storages, no memory, no arithmetic);
- under ``hints.use_mesh``, one train step (loss, backward through
  ``torch.utils.checkpoint`` and flash's ``autograd.Function``, AdamW),
  prefill or decode step, with DTensor's sharding propagation choosing
  each op's local computation and redistributions;
- each rank-0 local op counted by ``analysis.op_cost.Counter``, and a
  ``roofline.Roofline`` row built from the counts.

Plain tensors that the model makes (masks, positions) count as replicated
(DTensor's implicit replication).  Attention, the SSM scans and the MoE
experts run on each rank's shards (``hints.local_map``, the counterpart
of ``shard_map``), and so do the ops whose DTensor strategy some torch
release lacks or refuses on these meshes (the embedding's gather, the
SSM conv, the sequence-parallel attention's output product); every other
op of the six families' steps (the MoE's sort, top-k and gathers among
them) has a DTensor sharding strategy, so nothing is replicated around an
op by hand: an op without one ends its cell ``failed`` with the op named.

DTensor on a "cpu" mesh replaces an all-to-all by an all-gather and a
chunk (gloo has no all-to-all), so a Shard(i) -> Shard(j) reshard counts
as an all-gather of the whole tensor: the all-to-all kind stays 0 here.

Cells run at full depth unless one would trace for more than
``FULL_DEPTH_LIMIT_S``; then the record holds the costs of unit cells
(``num_layers`` = 2u and 3u, :func:`pattern_unit`) extrapolated linearly to
the config's depth, and says ``extrapolated: true``.  The units are 2u
and 3u: DTensor places a stack of one layer unlike a deeper one.  FLOPs
are linear in the depth from there; the bytes and a collective's bytes
may drift by a few percent, as DTensor's choice between two
redistributions can turn with a stack's size.

Process-group setup is inside the functions (``launch.mesh``: one fake
world per process); importing this module starts nothing, and
:func:`main` tears the world down at its end.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.analysis import op_cost, roofline
from repro_torch.configs.base import ShapeConfig, get_shape
from repro_torch.dist import hints, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build as build_model
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps as steps_lib

# cells skipped as the reference skips them (long_500k needs sub-quadratic mixing)
SKIPS: Dict[tuple, str] = {}
for _a in configs.ARCHS:
    if not configs.get(_a).sub_quadratic:
        SKIPS[(_a, "long_500k")] = (
            "full softmax attention: 500k dense KV cache is not sub-quadratic"
            " (DESIGN.md section 5)"
        )

FULL_DEPTH_LIMIT_S = 120.0  # a cell estimated to trace longer is extrapolated

MESHES = {"16x16": mesh_lib.PRODUCTION[False], "2x16x16": mesh_lib.PRODUCTION[True],
          "host": ((1,), ("data",))}


def pattern_unit(cfg) -> int:
    """Smallest layer count that tiles the arch's block schedule."""
    if cfg.family == "vlm":
        return cfg.cross_attn_segment
    if cfg.family == "hybrid":
        return cfg.shared_attn_every
    return 1


def _mesh_spec(multi_pod: bool, mesh) -> tuple:
    if mesh is None:
        return mesh_lib.PRODUCTION[multi_pod]
    return MESHES[mesh] if isinstance(mesh, str) else mesh


def _place(tree: Any, specs: Any, dmesh) -> Any:
    """DTensors of ``tree``'s (meta) shapes and dtypes, placed by
    ``specs``: each local shard a ``meta`` tensor of its own."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    flat = {}
    sharding.map_with_path(lambda path, s: flat.__setitem__(path, s), specs)

    def put(path, t):
        pl = hints.placements(flat[path], dmesh)
        local, _ = compute_local_shape_and_global_offset(tuple(t.shape), dmesh, pl)
        shard = torch.empty(local, dtype=t.dtype, device="meta")
        return DTensor.from_local(shard, dmesh, pl, run_check=False, shape=t.shape,
                                  stride=torch.empty(t.shape, device="meta").stride())

    return sharding.map_with_path(put, tree)


def _step(model, shape: ShapeConfig, params, batch, opt_state=None):
    """Run one step of ``shape.kind``; returns its outputs."""
    if shape.kind == "train":
        return steps_lib.make_train_step(model)(params, opt_state, batch)
    with torch.no_grad():
        if shape.kind == "prefill":
            return steps_lib.make_prefill_step(model)(params, batch)
        return steps_lib.make_decode_step(model)(params, batch)


def trace_cell(cfg, shape: ShapeConfig, mesh_spec: tuple) -> Dict[str, Any]:
    """One step of ``cfg`` at ``shape`` on a fake mesh of ``mesh_spec``
    (sizes, names): the rank-0 tally's cost, peak and trace time."""
    from torch.distributed.tensor.experimental import implicit_replication

    dmesh = mesh_lib.make_fake_mesh(*mesh_spec)
    model = build_model(cfg)
    inference = shape.kind != "train"
    params_abs = model.abstract_params()
    inputs_abs = model.input_specs(shape, abstract=True)
    pspecs = sharding.param_specs(cfg, params_abs, dmesh, inference=inference)
    ispecs = sharding.input_specs(cfg, shape, inputs_abs, dmesh)
    tally = op_cost.Tally()
    t0 = time.perf_counter()
    with op_cost.Counter(tally, "meta"), implicit_replication(), hints.use_mesh(dmesh):
        params = _place(params_abs, pspecs, dmesh)
        batch = _place(inputs_abs, ispecs, dmesh)
        if shape.kind == "decode":
            batch["cache_len"] = shape.seq_len - 1  # a full cache: the longest attention
        # the optimizer state is an argument of the step, as the reference's
        opt_state = opt_lib.init(params) if shape.kind == "train" else None
        tally.reset()
        _step(model, shape, params, batch, opt_state)
    return {
        "cost": tally.cost,
        "peak": tally.peak,
        "temp_peak": tally.temp_peak,
        "arg_bytes": tally.base,
        "ops": tally.ops,
        "trace_s": time.perf_counter() - t0,
    }


def _extrapolate(a: Dict[str, Any], b: Dict[str, Any], k: float) -> Dict[str, Any]:
    """``a + (k - 2) (b - a)``: the cost at depth k u from depths 2u and 3u
    (one unit is no base: DTensor places a stack of one layer otherwise)."""

    def lin(x, y):
        return x + (k - 2) * (y - x)

    cost = op_cost.Cost(lin(a["cost"].flops, b["cost"].flops), lin(a["cost"].bytes, b["cost"].bytes),
                        {kk: lin(a["cost"].coll[kk], b["cost"].coll[kk]) for kk in a["cost"].coll})
    return {
        "cost": cost,
        **{f: lin(a[f], b[f]) for f in ("peak", "temp_peak", "arg_bytes", "ops")},
        "trace_s": a["trace_s"] + b["trace_s"],
    }


def lower_cell(
    arch: str,
    shape: ShapeConfig,
    *,
    multi_pod: bool = False,
    mesh=None,
    verbose: bool = True,
    num_layers: Optional[int] = None,
    smoke: bool = False,
    full_depth: bool = False,
) -> Dict[str, Any]:
    """Trace one cell; returns its record.

    ``mesh`` overrides the production mesh: a key of ``MESHES`` or a
    ``(sizes, names)`` pair.  ``num_layers`` cuts the depth; ``smoke``
    takes the arch's smoke config.  The cell traces at full depth when
    ``full_depth`` is set or the unit cells' times say it takes at most
    ``FULL_DEPTH_LIMIT_S``; else it extrapolates."""
    cfg = (configs.get_smoke if smoke else configs.get)(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    sizes, names = _mesh_spec(multi_pod, mesh)
    chips = 1
    for s in sizes:
        chips *= s
    mesh_name = "x".join(str(s) for s in sizes)

    u, depth = pattern_unit(cfg), cfg.num_layers
    extrapolated = False
    if full_depth or depth <= 3 * u:
        t = trace_cell(cfg, shape, (sizes, names))
    else:
        a = trace_cell(dataclasses.replace(cfg, num_layers=2 * u), shape, (sizes, names))
        b = trace_cell(dataclasses.replace(cfg, num_layers=3 * u), shape, (sizes, names))
        k = depth / u
        est = a["trace_s"] + (k - 2) * (b["trace_s"] - a["trace_s"])
        if est <= FULL_DEPTH_LIMIT_S:
            t = trace_cell(cfg, shape, (sizes, names))
        else:
            t, extrapolated = _extrapolate(a, b, k), True

    cost = t["cost"]
    rf = roofline.build(arch, shape, cfg, mesh_name, chips,
                        {"flops": cost.flops, "bytes accessed": cost.bytes}, cost.coll, t["peak"])
    record = rf.row() | {
        "trace_s": t["trace_s"],
        "status": "ok",
        "extrapolated": extrapolated,
        "num_layers": cfg.num_layers,
        "temp_peak_bytes_per_chip": t["temp_peak"],
        "arg_bytes_per_chip": t["arg_bytes"],
        "ops_per_chip": t["ops"],
        "t_step_s": rf.t_step,
    }
    if verbose:
        print(
            f"[{arch} x {shape.name} x {mesh_name}] ok trace={t['trace_s']:.1f}s"
            f"{' (extrapolated)' if extrapolated else ''} "
            f"t_comp={rf.t_compute:.4f}s t_mem={rf.t_memory:.4f}s "
            f"t_coll={rf.t_collective:.4f}s bottleneck={rf.bottleneck} "
            f"useful={rf.useful_flop_ratio:.3f} roofline_frac={rf.roofline_fraction:.3f} "
            f"peak={t['peak'] / 2**30:.2f}GiB",
            flush=True,
        )
    return record


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, mesh=None) -> Dict[str, Any]:
    mesh_name = "x".join(str(s) for s in _mesh_spec(multi_pod, mesh)[0])
    if (arch, shape_name) in SKIPS:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skipped",
                "reason": SKIPS[(arch, shape_name)]}
    try:
        return lower_cell(arch, get_shape(shape_name), multi_pod=multi_pod, mesh=mesh)
    except Exception as e:  # a failure here is a bug in the system
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "failed",
                "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (assignment spelling ok)")
    ap.add_argument("--shape", default=None, choices=[s.name for s in configs.SHAPES],
                    help="one shape (default: every shape of --arch)")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--host-mesh", action="store_true", help="the 1-device mesh instead")
    ap.add_argument("--out", default=None, help="write JSON records here")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = [(a, s.name) for a in configs.ARCHS for s in configs.SHAPES]
    elif args.arch:
        shapes = [args.shape] if args.shape else [s.name for s in configs.SHAPES]
        cells = [(configs.ALIASES.get(args.arch, args.arch), s) for s in shapes]
    else:
        ap.error("--arch required unless --all")

    torch.set_num_threads(1)
    records = []
    try:
        for multi_pod in meshes:
            for arch, shape_name in cells:
                records.append(run_cell(arch, shape_name, multi_pod=multi_pod,
                                        mesh="host" if args.host_mesh else None))
                if args.out:
                    roofline.save_rows(args.out, records)
    finally:
        mesh_lib.release()

    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_fail = sum(r["status"] == "failed" for r in records)
    print(f"dry-run: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
