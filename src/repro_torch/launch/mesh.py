"""Mesh construction (the reference's ``repro.launch.mesh``).

Two worlds, never in one process:

- **The production meshes** are DeviceMeshes over a fake process group
  (every collective a no-op, no devices touched), for the dry-run and the
  train CLI's host mesh: one process plays rank 0 of a fake world of
  ``FAKE_WORLD`` ranks, and each mesh takes the first ranks of it.
- **The sampler meshes** (:func:`make_sampler_mesh`,
  :func:`resolve_sampler_mesh`, :func:`degrade_sampler_mesh`) are 1-D
  DeviceMeshes over the REAL default process group: the ranks a launcher
  started (one process per rank), or, where none is running, a 1-rank
  group this module starts (``nccl`` for a CUDA session, ``gloo`` for a CPU
  one, over a ``HashStore``).  :func:`sampler_world` says which.

Kept as FUNCTIONS, so importing this module starts no process group.
:func:`make_fake_mesh` refuses while a real group runs, and the sampler
meshes refuse while the fake world runs.

One fake world serves a whole process and each mesh is made once: DTensor
keys its redistribution plans by meshes that compare equal across worlds,
so a mesh rebuilt over a new world would meet plans that name the old
world's groups.  :func:`release` tears the world down and drops those
plans.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
FAKE_WORLD = 512  # the largest production mesh

_MESHES: dict = {}
_GROUPS: dict = {}  # sampler-mesh subgroups by their ranks: a rank set gets one group a world
_STARTED: list = []  # the 1-rank sampler world this module started, if any


def make_fake_mesh(shape, names):
    """A named DeviceMesh of ``shape`` over the first ranks of the fake
    world (this process is rank 0), made once per process.  Its device
    type is "cpu" (DTensor's cost model knows no "meta" mesh); the
    dry-run's DTensors on it hold ``meta`` shards."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    key = (tuple(shape), tuple(names))
    if not dist.is_initialized():
        _MESHES.clear()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=FAKE_WORLD)
    elif dist.get_backend() != "fake":
        raise RuntimeError(f"a {dist.get_backend()!r} process group is running; release it first")
    if key not in _MESHES:
        ranks = torch.arange(math.prod(shape)).view(*shape)
        _MESHES[key] = DeviceMesh("cpu", ranks, mesh_dim_names=tuple(names))
    return _MESHES[key]


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips per pod; multi_pod stacks 2 pods -> 512 chips.

    Axes: pod (inter-pod DP), data (FSDP + batch), model (TP/EP)."""
    return make_fake_mesh(*PRODUCTION[multi_pod])


def make_host_mesh():
    """A 1-device 'data' mesh (the card check's and the tests' mesh)."""
    return make_fake_mesh((1,), ("data",))


class SamplerWorld(NamedTuple):
    """The real process group the sampler meshes span: its backend, size,
    this process's rank, and whether this module started it (a 1-rank
    group for a session that found none running)."""

    backend: str
    size: int
    rank: int
    started_here: bool


def sampler_world(device=None) -> SamplerWorld:
    """The default process group the sampler meshes use, started as a
    1-rank group (``nccl`` for a CUDA ``device``, default ``"cuda"``, else
    ``gloo``) when none is running.  Raises RuntimeError while the
    dry-run's fake world runs."""
    if not dist.is_initialized():
        cuda = resolve_device(device).type == "cuda"
        extra = {"device_id": torch.device("cuda", torch.cuda.current_device())} if cuda else {}
        dist.init_process_group("nccl" if cuda else "gloo", store=dist.HashStore(), rank=0,
                                world_size=1, **extra)
        _STARTED[:] = [True]
    backend = dist.get_backend()
    if backend == "fake":
        raise RuntimeError("the dry-run's fake process group is running: release() it before a sampler mesh")
    return SamplerWorld(backend, dist.get_world_size(), dist.get_rank(), bool(_STARTED))


def _real_mesh(ranks, device_type: str, names):
    """A 1-D DeviceMesh named ``names`` over the real ``ranks`` (every
    rank of the world, or a subgroup made once per rank set by its members
    alone)."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = [int(r) for r in ranks]
    if ranks == list(range(dist.get_world_size())):
        group = dist.group.WORLD
    else:
        group = _GROUPS.get(tuple(ranks))
        if group is None:
            group = _GROUPS[tuple(ranks)] = dist.new_group(ranks, use_local_synchronization=True)
    return DeviceMesh.from_group(group, device_type, mesh=torch.tensor(ranks), mesh_dim_names=tuple(names))


def make_sampler_mesh(num_devices: Optional[int] = None, *, device=None):
    """1-D ``graphs`` mesh for the quilting sampler's B^2 iid block streams
    over the first ``num_devices`` ranks of the running world (default:
    all of them; see :func:`sampler_world`), of ``device``'s type (default
    ``"cuda"``; raises without a card).  ``core.quilt.quilt_run(..., mesh=...)``
    gives each rank its chunk of the graphs; sampling has no
    model-parallel structure.  Raises ValueError for more ranks than the
    world has or on a rank outside the mesh."""
    world = sampler_world(device)
    n = world.size if num_devices is None else int(num_devices)
    if not 1 <= n <= world.size:
        raise ValueError(f"a {n}-rank sampler mesh needs 1..{world.size} ranks (the world has {world.size})")
    if world.rank >= n:
        raise ValueError(f"rank {world.rank} is outside a {n}-rank sampler mesh")
    return _real_mesh(range(n), resolve_device(device).type, ("graphs",))


def resolve_sampler_mesh(spec, *, device=None):
    """A ``SamplerConfig.mesh`` value as a DeviceMesh (or None).

    ``None`` -> unsharded; ``"auto"`` -> :func:`make_sampler_mesh` over
    every rank of the world; ``"host"`` -> a real 1-D ``data`` mesh over
    the same world (not :func:`make_host_mesh`'s fake one); a DeviceMesh
    passes through.  ``device`` (the session's) picks the device type and,
    with no world running, the backend of the 1-rank group started."""
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec == "auto":
            return make_sampler_mesh(device=device)
        if spec == "host":
            world = sampler_world(device)
            return _real_mesh(range(world.size), resolve_device(device).type, ("data",))
        raise ValueError(f"unknown mesh spec {spec!r}: expected None, 'auto', 'host' or a DeviceMesh")
    return spec


def degrade_sampler_mesh(mesh, lost: int):
    """The sampler mesh over the ranks that survive losing one.

    ``lost`` indexes the dead rank in ``mesh``'s flattened rank list
    (``repro_torch.dist.chaos.DeviceLoss.device``).  Whatever axes the
    source mesh had, the result is a 1-D ``graphs`` mesh over the
    survivors, built by the survivors alone; on the lost rank itself the
    result is None (that rank leaves the run).  The engines re-run the
    failed round on it, and per-graph streams that never depend on the
    layout keep the edges bit-identical.

    Raises ValueError when ``lost`` is out of range or no rank survives (a
    1-rank mesh cannot degrade: the caller re-raises)."""
    ranks = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
    if not 0 <= int(lost) < len(ranks):
        raise ValueError(f"lost device index {lost} out of range for a {len(ranks)}-device mesh")
    survivors = ranks[: int(lost)] + ranks[int(lost) + 1:]
    if not survivors:
        raise ValueError("cannot degrade a 1-device mesh: no survivors")
    if dist.get_rank() not in survivors:
        return None
    return _real_mesh(survivors, mesh.device_type, ("graphs",))


def release() -> None:
    """Destroy the default process group, if any, and forget the meshes,
    the subgroups and DTensor's redistribution plans over it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESHES.clear()
    _GROUPS.clear()
    _STARTED.clear()
    from torch.distributed.tensor import _redistribute

    clear = getattr(_redistribute, "clear_redistribute_planner_cache", None)
    if clear is not None:
        clear()
