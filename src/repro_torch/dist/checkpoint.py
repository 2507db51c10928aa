"""Step checkpoints: atomic save, shape-checked restore, pruning.

Layout, byte for byte the reference's (``repro.dist.checkpoint``):
``<dir>/step_<N>/`` holding one raw-bytes file per tree leaf
(``NNNNN.bin``) plus ``meta.json`` (``{"step", "leaves": [{"shape",
"dtype"}]}``).  Writes land in a ``.tmp`` sibling and are renamed into
place, so a crash mid-save never leaves a directory that ``latest_step``
would offer for restore; a crash between the two renames is finished by
:func:`_recover`.  The chaos sites ``checkpoint.write`` and
``checkpoint.rename`` sit where the reference has them.

A tree is nested dicts, lists and tuples (named tuples too) of torch
tensors (on any device), numpy arrays or scalars; ``None`` holds no leaf.
Leaves are numbered in ``jax.tree``'s order (dict keys sorted), so leaf
``i`` names the same field in both packages and each restores the other's
checkpoints (a training state too: bf16 params and an ``OptState``).  A
bfloat16 leaf is written as its raw 16-bit words under dtype
``"bfloat16"``, the reference's bytes, without ``ml_dtypes``.
:func:`restore` takes a TARGET tree that fixes the structure and the
expected leaf shapes and dtypes; a mismatch raises ValueError.  A torch
target leaf comes back as a tensor on its device in its dtype, any other
as a numpy array; with ``shardings=``, a placed leaf comes back as a
DTensor on its mesh (the elastic restart onto another mesh).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist import chaos

_PREFIX = "step_"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_PREFIX}{step}")


_BF16 = "bfloat16"


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype whose bytes a leaf of dtype ``name`` holds: bfloat16
    leaves are read as their 16-bit words."""
    if name == _BF16:
        return np.dtype(np.int16)
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"checkpoint dtype {name!r} is not a numpy dtype") from None


def _dtype_name(leaf: Any) -> str:
    """A leaf's dtype as the checkpoint names it (numpy's names)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.dtype(leaf.dtype))


def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """``(array holding the leaf's bytes, dtype name)``; a tensor is copied
    to the host, a bfloat16 tensor as its int16 words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()  # lint: disable=host-sync-in-step -- not a step: a checkpoint's host copy, reached by the name save
        name = _dtype_name(t)
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy(), name  # lint: disable=host-sync-in-step -- not a step: a checkpoint's host copy, reached by the name save
    arr = np.asarray(leaf)  # lint: disable=host-sync-in-step -- not a step: a checkpoint's host copy, reached by the name save
    return arr, str(arr.dtype)


def _flatten(
    tree: Any, is_leaf: Callable[[Any], bool] = lambda x: False
) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """``(leaves, unflatten)`` of ``tree`` in ``jax.tree.flatten``'s order;
    ``is_leaf`` marks subtrees that count as one leaf."""
    if is_leaf(tree):
        return [tree], lambda leaves: leaves[0]
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k], is_leaf) for k in keys]
        return _join(parts, lambda vals: dict(zip(keys, vals)))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, is_leaf) for v in tree]
        if hasattr(tree, "_fields"):  # a named tuple
            return _join(parts, lambda vals: type(tree)(*vals))
        return _join(parts, type(tree))
    return [tree], lambda leaves: leaves[0]


def _treedef(tree: Any, is_leaf: Callable[[Any], bool] = lambda x: False) -> Any:
    """A comparable description of ``tree``'s containers, in
    :func:`_flatten`'s order, with ``"*"`` for each leaf (``is_leaf``
    marks subtrees that count as one leaf)."""
    if is_leaf(tree):
        return "*"
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _treedef(tree[k], is_leaf)) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_treedef(v, is_leaf) for v in tree))
    return "*"


def _is_sharding(x: Any) -> bool:
    """A leaf of a ``shardings`` tree: None or a (DeviceMesh, placements) pair."""
    from torch.distributed.device_mesh import DeviceMesh

    return x is None or (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], DeviceMesh))


def _join(parts, build) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    leaves = [leaf for sub, _ in parts for leaf in sub]
    sizes = [len(sub) for sub, _ in parts]

    def unflatten(new: List[Any]) -> Any:
        vals, at = [], 0
        for (_, unf), k in zip(parts, sizes):
            vals.append(unf(new[at:at + k]))
            at += k
        return build(vals)

    return leaves, unflatten


def _complete(path: str) -> bool:
    return os.path.exists(os.path.join(path, "meta.json"))


def _recover(directory: str) -> None:
    """Finish a save interrupted between its two renames.

    A crash after ``final -> final.old`` but before ``tmp -> final`` leaves
    the step only under ``.old`` (and usually a complete ``.tmp``); promote
    whichever complete copy exists back to ``final`` so latest_step never
    loses a restorable checkpoint, then drop the leftovers.
    """
    for name in os.listdir(directory):
        if not (name.startswith(_PREFIX) and name.endswith(".old")):
            continue
        final = os.path.join(directory, name[:-len(".old")])
        tmp, old = final + ".tmp", final + ".old"
        if not _complete(final):
            if _complete(tmp):
                os.rename(tmp, final)
            elif _complete(old):
                os.rename(old, final)
        for leftover in (tmp, old):
            if os.path.exists(leftover):
                shutil.rmtree(leftover, ignore_errors=True)


def save(directory: str, step: int, tree: Any) -> str:
    """Atomically write ``tree`` as checkpoint ``step``; returns its path."""
    chaos.maybe_fail("checkpoint.write")
    leaves, _ = _flatten(tree)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta: Dict[str, Any] = {"step": int(step), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, name = _host_array(leaf)
        meta["leaves"].append({"shape": list(arr.shape), "dtype": name})
        with open(os.path.join(tmp, f"{i:05d}.bin"), "wb") as f:
            f.write(arr.tobytes())
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    chaos.maybe_fail("checkpoint.rename")
    # never a window without a complete checkpoint at this step: move the
    # old dir ASIDE (not rmtree) so a crash between renames still leaves
    # either the old or the new copy restorable
    aside = final + ".old"
    if os.path.exists(aside):
        shutil.rmtree(aside)
    if os.path.exists(final):
        os.rename(final, aside)
    os.rename(tmp, final)
    if os.path.exists(aside):
        shutil.rmtree(aside)
    return final


def restore(directory: str, step: int, target: Any, *, shardings: Optional[Any] = None) -> Tuple[Any, Dict[str, Any]]:
    """Load checkpoint ``step`` into the structure of ``target``.

    Returns (tree, meta): where the target's leaf is a tensor, a tensor on
    its device and in its dtype, else a numpy array (a bfloat16 leaf in the
    target's own bfloat16 numpy dtype, or as a CPU tensor).  Raises
    ValueError when the stored leaves do not match the target's count,
    shapes or dtypes.

    ``shardings`` is a tree matching ``target`` whose leaves are None
    (default placement) or ``(DeviceMesh, placements)`` pairs, the
    placements as ``dist.sharding.param_shardings`` gives them: such a
    leaf comes back as a DTensor on that mesh, each rank keeping its shard
    of the bytes it read (no collective).  A tree of another structure
    raises ValueError.
    """
    path = _step_dir(directory, step)
    if not _complete(path):
        _recover(directory)  # the step may sit under .old/.tmp post-crash
    if not _complete(path):
        raise ValueError(
            f"no checkpoint at step {step} in {directory}; "
            f"available: {available_steps(directory)}"
        )
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    t_leaves, unflatten = _flatten(target)
    if len(meta["leaves"]) != len(t_leaves):
        raise ValueError(
            f"checkpoint {path} has {len(meta['leaves'])} leaves, "
            f"target has {len(t_leaves)}"
        )
    s_leaves = [None] * len(t_leaves)
    if shardings is not None:
        if _treedef(shardings, _is_sharding) != _treedef(target):
            raise ValueError(
                f"shardings tree structure {_treedef(shardings, _is_sharding)} does not match "
                f"target structure {_treedef(target)}"
            )
        s_leaves = _flatten(shardings, _is_sharding)[0]
    out = []
    for i, (entry, t_leaf, place) in enumerate(zip(meta["leaves"], t_leaves, s_leaves)):
        shape = tuple(entry["shape"])
        if shape != tuple(np.shape(t_leaf)):
            raise ValueError(
                f"leaf {i}: checkpoint shape {shape} != target shape "
                f"{tuple(np.shape(t_leaf))}"
            )
        name = entry["dtype"]
        words = _np_dtype(name)
        if getattr(t_leaf, "dtype", None) is not None and _dtype_name(t_leaf) != name:
            raise ValueError(
                f"leaf {i}: checkpoint dtype {name} != target dtype {_dtype_name(t_leaf)}"
            )
        with open(os.path.join(path, f"{i:05d}.bin"), "rb") as f:
            arr = np.frombuffer(bytearray(f.read()), dtype=words).reshape(shape)
        leaf = _leaf_like(arr, name, t_leaf)
        if place is not None:
            leaf = _placed(leaf, *place)
        out.append(leaf)
    return unflatten(out), meta


def _placed(leaf: Any, mesh, placements) -> torch.Tensor:
    """``leaf`` as a DTensor of ``placements`` on ``mesh``: every rank read
    the same bytes, so each keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor

    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(leaf)
    return distribute_tensor(t.to(mesh.device_type), mesh, placements, src_data_rank=None)


def _leaf_like(arr: np.ndarray, name: str, target: Any) -> Any:
    """The stored words ``arr`` as the target's kind of leaf."""
    bf16 = name == _BF16
    if isinstance(target, torch.Tensor):
        t = torch.from_numpy(arr)
        return (t.view(torch.bfloat16) if bf16 else t).to(target.device)
    if bf16:  # a numpy bfloat16 target (ml_dtypes' dtype, which the port does not import)
        dt = getattr(target, "dtype", None)
        return arr.view(dt) if dt is not None else torch.from_numpy(arr).view(torch.bfloat16)
    return arr


def available_steps(directory: str) -> list[int]:
    """Sorted step numbers of complete checkpoints under ``directory``."""
    if not os.path.isdir(directory):
        return []
    _recover(directory)
    steps = []
    for name in os.listdir(directory):
        if not name.startswith(_PREFIX) or name.endswith((".tmp", ".old")):
            continue
        if not _complete(os.path.join(directory, name)):
            continue
        try:
            steps.append(int(name[len(_PREFIX):]))
        except ValueError:
            continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """Newest complete checkpoint step, or None."""
    steps = available_steps(directory)
    return steps[-1] if steps else None


def prune(directory: str, *, keep: int) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    for step in available_steps(directory)[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(directory, step))
