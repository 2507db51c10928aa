"""Partitioning rules: spec trees for params and inputs (the reference's
``repro.dist.sharding`` in PyTorch).

One rule table covers all six families.  Dims carry LOGICAL roles
("fsdp" over the data axis, "tp" over the model axis); resolution against
the target mesh drops any role whose axis is absent or whose size does not
divide the dim, so the same rules serve the 16x16 pod, the 2x16x16
multi-pod mesh and the 1-device host mesh without special cases.

Weight layout follows the Megatron convention: column-parallel in
(wq/wk/wv/w1/w3), row-parallel out (wo/w2/out_proj), embedding sharded
vocab-over-model.  The remaining dim of every 2D weight is FSDP-sharded
over "data".  Inference drops the FSDP factor for models whose TP-sharded
bf16 weights fit the per-chip budget (:func:`inference_drop_fsdp`).

A tree is a nested dict of tensors (the port's params carry the
reference's leaf names); a spec is a tuple (``hints``), and
:func:`param_shardings` turns specs into DTensor placements on a named
``DeviceMesh``; :func:`distribute` places a tree by them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist import hints
from repro_torch.dist.hints import build_spec, mesh_axes

# bf16 weight budget per chip under pure TP; above this, serving keeps FSDP
_INFERENCE_WEIGHT_BUDGET_BYTES = 4 << 30


class GraphLayout(NamedTuple):
    """Resolved placement of a batch of iid sampler graphs on a mesh."""

    axes: Tuple[str, ...]  # mesh axes carrying the "graphs" role (may be ())
    nshards: int  # product of those axes' sizes (1 when unsharded)
    padded: int  # num_graphs rounded up to a multiple of nshards


def graph_layout(mesh, num_graphs: int) -> GraphLayout:
    """:func:`graph_shard_axes` plus the graph count padded to a multiple
    of the shard count (zero-target padding rows emit nothing)."""
    axes, nshards = graph_shard_axes(mesh)
    g = int(num_graphs)
    return GraphLayout(axes, nshards, g + (-g) % max(nshards, 1))


def graph_shard_axes(mesh) -> Tuple[Tuple[str, ...], int]:
    """Mesh axes carrying the quilting sampler's ``graphs`` role and the
    product of their sizes; ``((), 1)`` for no mesh or no usable axis."""
    if mesh is None:
        return (), 1
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in hints.logical_axis_candidates("graphs") if a in sizes)
    if not axes:
        return (), 1
    return axes, int(math.prod(sizes[a] for a in axes))


def map_with_path(fn: Callable, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a nested dict, ``path`` the keys from the
    root."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def _leaf_roles(names: Tuple[str, ...], cfg: ModelConfig) -> Tuple[Optional[str], ...]:
    """Logical roles for the TRAILING dims of one param leaf.

    Leading stack dims (layer axes) are padded with None by the caller.
    Returning () replicates (norm scales, biases, small vectors)."""
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""

    if leaf == "embed":
        return ("tp", "fsdp")  # (vocab, d_model)
    if leaf == "enc_pos":
        return (None, "fsdp")  # (Se, d_model)

    # attention projections
    if leaf in ("wq", "wk", "wv"):
        return ("fsdp", "tp")  # (d, heads*hd)
    if leaf == "wo":
        return ("tp", "fsdp")  # (heads*hd, d)

    # MoE expert stacks: (E, d, f) / (E, f, d)
    if parent == "moe":
        if leaf == "router":
            return ()  # (d, E) f32, tiny: replicate
        ep = cfg.expert_sharding == "ep"
        if leaf in ("w1", "w3"):
            return ("tp", "fsdp", None) if ep else (None, "fsdp", "tp")
        if leaf == "w2":
            return ("tp", None, "fsdp") if ep else (None, "tp", "fsdp")

    # dense SwiGLU MLP: (d, f) / (f, d)
    if leaf in ("w1", "w3"):
        return ("fsdp", "tp")
    if leaf == "w2":
        return ("tp", "fsdp")

    # SSM mixers: d_inner is the TP axis
    if leaf in ("in_x", "in_z", "w_z", "w_x"):
        return ("fsdp", "tp")  # (d, di)
    if leaf in ("w_B", "w_C", "w_dt"):
        return ("fsdp", None)  # (d, ns|nh): state/head dims too small to cut
    if leaf in ("xp_dt", "xp_B", "xp_C"):
        return ("tp", None)  # (di, r|ns)
    if leaf == "dt_proj":
        return (None, "tp")  # (r, di)
    if leaf == "out_proj":
        return ("tp", "fsdp")  # (di, d)
    if leaf in ("conv_w", "conv_x"):
        return (None, "tp")  # (K, di) depthwise
    if leaf == "A_log" and cfg.ssm_version == 1:
        return ("tp", None)  # mamba1: (di, ns); mamba2's (nh,) replicates

    # norm scales, q/k norms, conv biases, dt_bias, D, gate scalars, ...
    return ()


def _resolve(roles, shape, mesh, *, drop_fsdp: bool = False) -> hints.Spec:
    """Logical roles -> spec, guarded by presence + divisibility."""
    if len(roles) > len(shape):  # defensive: replicate odd-rank leaves
        roles = ()
    return build_spec(roles, shape, mesh, pad_left=True, drop=("fsdp",) if drop_fsdp else ())


def inference_drop_fsdp(cfg: ModelConfig, mesh) -> bool:
    """True when pure-TP bf16 weights fit the per-chip serving budget."""
    tp = mesh_axes(mesh).get("model", 1)
    per_chip_bytes = cfg.param_count() * 2 / max(tp, 1)
    return per_chip_bytes <= _INFERENCE_WEIGHT_BUDGET_BYTES


def param_specs(cfg: ModelConfig, params: Any, mesh, *, inference: bool = False) -> Any:
    """Spec tree mirroring ``params``."""
    drop = inference and inference_drop_fsdp(cfg, mesh)
    return map_with_path(
        lambda path, leaf: _resolve(_leaf_roles(path, cfg), tuple(leaf.shape), mesh, drop_fsdp=drop), params
    )


def param_shardings(cfg: ModelConfig, params: Any, mesh, *, inference: bool = False) -> Any:
    """Placement tree (DTensor placements per leaf) on a named DeviceMesh."""
    specs = param_specs(cfg, params, mesh, inference=inference)
    return map_with_path(lambda _, s: hints.placements(s, mesh), specs)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, inputs: Any, mesh) -> Any:
    """Spec tree for one cell's inputs (tokens/labels/cache/...).

    Batch dims shard over every data-parallel axis present; everything
    else is unconstrained (internal activation sharding is steered by
    ``hints.shard`` inside the model).  Cache stacks are (L, B, ...), with
    batch on dim 1, except ``enc_out`` (B, ...)."""

    def spec(path, leaf):
        leaf_name = path[-1] if path else ""
        if not leaf.shape:  # cache_len and friends
            return ()
        batch_dim = 1 if ("cache" in path and leaf_name != "enc_out") else 0
        roles = [None] * len(leaf.shape)
        roles[batch_dim] = "batch"
        return _resolve(tuple(roles), tuple(leaf.shape), mesh)

    return map_with_path(spec, inputs)


def distribute(tree: Any, placements_tree: Any, mesh) -> Any:
    """Place every leaf of ``tree`` on ``mesh`` by ``placements_tree``
    (:func:`param_shardings`' output): each rank keeps its shard."""
    from torch.distributed.tensor import distribute_tensor

    flat = {}
    map_with_path(lambda path, pl: flat.__setitem__(path, pl), placements_tree)
    return map_with_path(lambda path, leaf: distribute_tensor(leaf, mesh, flat[path]), tree)
