"""Logical sharding hints resolved against the ambient mesh (the
reference's ``repro.dist.hints`` in PyTorch).

Model code annotates activations with LOGICAL axis names ("batch", "tp")
instead of mesh axis names, so the same forward pass runs on plain tensors
on one device and on DTensors over the 16x16 / 2x16x16 production meshes.
Resolution rules:

- "batch" -> every data-parallel mesh axis present, major-to-minor
             (("pod", "data") on the multi-pod mesh, ("data",) otherwise)
- "tp"    -> the tensor-parallel axis ("model",) when present
- None    -> unconstrained

A hint is dropped (dim left unconstrained) whenever the dim does not divide
the resolved axis-size product, so shape oddities (qwen3's 40 heads on
16-way TP, whisper's 51865-token vocab) degrade to replication instead of
erroring.

A spec is a plain tuple with one entry per dim: ``None``, an axis name, or
a tuple of names, which is exactly ``tuple(jax.sharding.PartitionSpec)``.
The rules read only axis names and sizes, so a :class:`MeshShape` (names
and sizes, no devices) serves the spec tests as well as a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``.

The ambient mesh (:func:`use_mesh`, :func:`current_mesh`) is thread-local:
the counterpart of the reference's ``with mesh:``.  :func:`shard` is the
identity on a plain tensor or without a mesh; on a DTensor it
redistributes to the resolved placements, the counterpart of
``with_sharding_constraint``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

# logical name -> candidate mesh axes, major first (greedily truncated from
# the left until the dim divides the remaining axis-size product).
# "graphs" carries the quilting sampler's B^2 iid block-pair streams: a
# dedicated "graphs" axis when the mesh has one, otherwise any
# data-parallel axis (the streams have no model-parallel structure).
_LOGICAL_AXES = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
    "graphs": ("graphs", "pod", "data", "dev"),
}

Spec = Tuple[object, ...]


class MeshShape(NamedTuple):
    """A device-less mesh: axis names, major first, and their sizes."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a :class:`MeshShape`, a named ``DeviceMesh``
    or any object with ``axis_names`` and a ``shape`` mapping (the
    reference's ``Mesh`` / ``AbstractMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # DeviceMesh: shape is a tuple of sizes
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def logical_axis_candidates(name: str) -> Tuple[str, ...]:
    """Candidate mesh axes for one logical role, major first; () for
    unknown names."""
    return _LOGICAL_AXES.get(name, ())


_STATE = threading.local()


def current_mesh():
    """The mesh installed by :func:`use_mesh`, or None outside any."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as this thread's ambient mesh for the block."""
    saved = current_mesh()
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = saved


def resolve_axes(name: Optional[str], dim: int, mesh) -> Optional[Tuple[str, ...]]:
    """Mesh axes for one logical name on one dim, or None if unshardable."""
    if name is None:
        return None
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in _LOGICAL_AXES.get(name, ()) if a in sizes)
    # drop major axes until the product divides the dim
    while axes:
        total = math.prod(sizes[a] for a in axes)
        if total > 1 and dim % total == 0:
            return axes
        axes = axes[1:]
    return None


def build_spec(names, shape, mesh, *, pad_left: bool = False, drop: Tuple[str, ...] = ()) -> Spec:
    """Spec from per-dim logical names.

    Missing names pad with None: on the right for activations (trailing
    dims unconstrained), on the left for stacked params (leading layer dims
    unconstrained).  Names in ``drop`` resolve to None (inference FSDP
    drop)."""
    names = tuple(names)
    pad = (None,) * (len(shape) - len(names))
    names = pad + names if pad_left else names + pad
    entries = []
    for dim, name in zip(shape, names):
        axes = resolve_axes(None if name in drop else name, dim, mesh)
        if axes is None:
            entries.append(None)
        elif len(axes) == 1:
            entries.append(axes[0])
        else:
            entries.append(axes)
    return tuple(entries)


def logical_spec(names, shape, mesh) -> Spec:
    """Spec from per-dim logical names (right-padded with None)."""
    return build_spec(names, shape, mesh)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on a named ``DeviceMesh``: per mesh
    dim, ``Shard(d)`` for the tensor dim ``d`` that names it, else
    ``Replicate()``.  A dim named by several axes is split over them
    major-to-minor, which is the mesh-dim order of their names."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *names) -> torch.Tensor:
    """Constrain ``x``'s sharding by logical axis names: the identity on a
    plain tensor or without a mesh, else ``x`` redistributed to the
    resolved placements.  ``names`` give one logical name per leading dim;
    trailing dims are unconstrained (replicated)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    want = placements(logical_spec(names, x.shape, mesh), x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def spec_placements(names, x: torch.Tensor) -> tuple:
    """``placements(logical_spec(names, x.shape, mesh), x's mesh)`` for a
    DTensor ``x`` under the ambient mesh."""
    return placements(logical_spec(names, x.shape, current_mesh()), x.device_mesh)


def local_map(fn, args, in_placements, out_placements, grad_placements=None):
    """``fn`` on each rank's local shards (the counterpart of the
    reference's ``shard_map``), for a function of DTensors whose work
    splits along their sharded dims (attention per batch row and head, a
    scan per channel).

    ``args``: tensors (DTensors, or plain tensors taken as replicated) or
    None; ``in_placements[i]``: the placements ``args[i]`` is redistributed
    to first; ``grad_placements[i]`` (default: its placements): those its
    gradient takes, e.g. ``Partial()`` where a replicated input feeds
    different work on each rank.  ``out_placements``: one placements tuple
    for a tensor result, or one per element of a tuple result.  Call it
    only on DTensors: on plain tensors call ``fn`` itself."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    grads = grad_placements or [None] * len(args)
    local = []
    for a, pl, gp in zip(args, in_placements, grads):
        if a is None:
            local.append(None)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        local.append(a.to_local(grad_placements=gp))
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, pl, run_check=False) for o, pl in zip(out, out_placements))
    return DTensor.from_local(out, mesh, out_placements, run_check=False)
