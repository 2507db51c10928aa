"""Production mesh construction (the reference's ``repro.launch.mesh``).

The production meshes are DeviceMeshes over a fake process group (every
collective a no-op, no devices touched), for the dry-run only: one
process plays rank 0 of a fake world of ``FAKE_WORLD`` ranks, and each
mesh takes the first ranks of it.  Kept as FUNCTIONS, so importing this
module starts no process group.

One world serves a whole process and each mesh is made once: DTensor keys
its redistribution plans by meshes that compare equal across worlds, so a
mesh rebuilt over a new world would meet plans that name the old world's
groups.  :func:`release` tears the world down and drops those plans.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
FAKE_WORLD = 512  # the largest production mesh

_MESHES: dict = {}


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


def release() -> None:
    """Destroy the default process group, if any, and forget the meshes
    and DTensor's redistribution plans over it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESHES.clear()
    from torch.distributed.tensor import _redistribute

    clear = getattr(_redistribute, "clear_redistribute_planner_cache", None)
    if clear is not None:
        clear()
