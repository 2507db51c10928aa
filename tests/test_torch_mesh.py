"""The sampler on meshes (``repro_torch.launch.mesh``'s sampler meshes,
``quilt_run(mesh=)``, ``balldrop_run(mesh=)``, ``core.distributed``,
``restore(shardings=)``, ``shard_edges(mesh=)``) against the unsharded
port and the reference, on the CPU:

- one 4-rank gloo group (``torch.multiprocessing.spawn`` over a
  ``FileStore``) runs every scenario of :data:`SCENARIOS` on a
  ``("graphs",)`` mesh of the four ranks, while one subprocess runs the
  reference's on 4 virtual devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, under
  ``reference_package``); every rank's edges equal the port's unsharded
  run and the reference's 4-device run bit for bit;
- the scenarios: the exact session, the ranked rounds with a forced device
  top-up and with the host fallback (``max_rounds=1``), ball dropping, the
  section-5 split (``quilt_sample_fast(mesh=)``), ``sample_batch(4)``,
  ``sample_stream`` killed at a chunk and resumed in a fresh session,
  ``kpgm_sample_distributed``, a ``DeviceLoss`` of rank 2 at the first
  dispatch (a simulated loss: every rank's schedule fires at the same
  visit, the survivors rebuild the mesh over ranks 0, 1, 3 and re-run the
  round, rank 2 leaves by re-raising), ``restore(shardings=)`` onto
  DTensor placements and ``shard_edges(mesh=)``;
- in-process, on a 1-rank gloo world: a 1-rank mesh equals no mesh,
  ``degrade_sampler_mesh``'s ValueErrors, a 1-rank loss re-raising in
  quilting and ball dropping, ``graph_shard_axes`` on the sampler meshes,
  and the sampler meshes refusing the dry-run's fake world.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from repro_torch.api import KPGMSampler, MAGMSampler, SamplerConfig  # noqa: F401  (used by the ranks)
from repro_torch.core import balldrop, kpgm, magm, prng, quilt
from repro_torch.dist import chaos, hints, sharding
from repro_torch.launch import mesh as mesh_lib
from test_torch_reference import SRC

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
THETA = np.array([[0.35, 0.52], [0.52, 0.95]], dtype=np.float32)  # tests/test_quilt_mesh.py's
DENSE = np.full((2, 2), 0.95, dtype=np.float32)  # the collision-heavy top-up regime
# name -> (theta, mu, d, n, key, session options); F is drawn in the parent
SAMPLERS = {
    "exact": (THETA, 0.5, 8, 192, 7, {}),
    "topup": (DENSE, 0.5, 3, 16, 5, {"exact_cells": False}),
    "topup_host": (DENSE, 0.5, 3, 16, 5, {"exact_cells": False, "max_rounds": 1}),
    "balldrop": (THETA, 0.5, 6, 128, 2, {"backend": "balldrop"}),
    "split": (THETA, 0.8, 8, 256, 11, None),  # quilt_sample_fast
    "batch": (THETA, 0.5, 8, 192, 9, {}),  # sample_batch(4)
    "stream": (THETA, 0.5, 8, 192, 13, {}),  # killed at its third chunk, resumed
    "device_loss": (THETA, 0.5, 8, 192, 7, {}),  # rank 2 lost at the first dispatch
}
KPGM_D, KPGM_KEY = 8, 1
STREAM_CHUNK, STREAM_KILL = 64, 2
SCENARIOS = tuple(SAMPLERS) + ("kpgm_distributed", "restore", "shard_edges")
SHARD_SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(path: str) -> None:
    """F of every sampler scenario, an edge list, and a checkpoint, saved
    for the ranks and the reference."""
    from repro_torch.dist import checkpoint as ckpt

    out = {}
    for name, (theta, mu, d, n, _, _) in SAMPLERS.items():
        p = magm.make_params(theta, mu, d)
        out[f"F:{name}"] = magm.sample_attributes(prng.PRNGKey(3), n, p.mu, device="cpu").numpy()
    rng = np.random.default_rng(0)
    out["edges"] = rng.integers(0, 192, (300, 2)).astype(np.int64)
    np.savez(path + "/inputs.npz", **out)
    ckpt.save(path + "/ckpt", 1, {"w": np.arange(24, dtype=np.float32).reshape(8, 3),
                                  "b": np.arange(5, dtype=np.float32) / 7, "r": np.arange(6, dtype=np.int32)})


def _config(name: str, F: np.ndarray, **extra) -> SamplerConfig:
    theta, mu, d, _, _, opts = SAMPLERS[name]
    return SamplerConfig(params=magm.make_params(theta, mu, d), F=F, device="cpu", **(opts or {}), **extra)


def _run_scenario(name: str, F, mesh, tmp: str, rank: int) -> dict:
    """One scenario on ``mesh`` (None: unsharded): arrays to compare."""
    theta, mu, d, n, k, _ = SAMPLERS.get(name, (THETA, 0.5, 8, 192, 0, None))
    key = prng.PRNGKey(k)
    if name == "split":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return {"": quilt.quilt_sample_fast(key, magm.make_params(theta, mu, d), F, mesh=mesh, device="cpu")}
    if name == "batch":
        return {str(i): g.edges for i, g in enumerate(MAGMSampler(_config(name, F, mesh=mesh)).sample_batch(4, key))}
    if name == "stream":
        if mesh is None:
            return {"": MAGMSampler(_config(name, F)).sample(key).edges}
        d_ck, got = os.path.join(tmp, f"stream_rank{rank}"), []
        sched = chaos.FaultSchedule([chaos.FaultSpec("stream.chunk", (STREAM_KILL,))])
        try:
            with chaos.active(sched):
                for c in MAGMSampler(_config(name, F, mesh=mesh)).sample_stream(
                        key, chunk_edges=STREAM_CHUNK, checkpoint_dir=d_ck):
                    got.append(c)
        except chaos.InjectedFault:
            pass
        assert len(got) == STREAM_KILL
        got += list(MAGMSampler(_config(name, F, mesh=mesh)).resume_stream(d_ck))
        return {"": np.concatenate(got), "killed_after": np.array(STREAM_KILL)}
    if name == "device_loss":
        plan = quilt.get_quilt_plan(F, magm.make_params(theta, mu, d).thetas, device="cpu")
        if mesh is None:
            return {"": quilt.quilt_run(key, plan).edges()}
        sched = chaos.FaultSchedule([chaos.FaultSpec("quilt.dispatch", (0,), "device_loss", 2)])
        before = quilt.DISPATCH_COUNTERS["mesh_degrades"]
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            try:
                with chaos.active(sched):
                    edges = quilt.quilt_run(key, plan, mesh=mesh).edges()
            except chaos.DeviceLoss as exc:
                assert rank == 2 and exc.device == 2
                return {"lost": np.array(1)}
        warned = any("surviving device" in str(x.message) for x in w if x.category is RuntimeWarning)
        return {"": edges, "mesh_degrades": np.array(quilt.DISPATCH_COUNTERS["mesh_degrades"] - before),
                "warned": np.array(int(warned))}
    c = _config(name, F, mesh=mesh)
    qc, bc = dict(quilt.DISPATCH_COUNTERS), dict(balldrop.DISPATCH_COUNTERS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # topup_host's "device rounds exhausted"
        edges = MAGMSampler(c).sample(key).edges
    # the reference's keys; the port's registry also counts the candidates
    # drawn and the edges handed to the host, which every rank counts alike
    counters = balldrop.DISPATCH_COUNTERS if name == "balldrop" else quilt.DISPATCH_COUNTERS
    before = bc if name == "balldrop" else qc
    keys = sorted(balldrop.DISPATCH_COUNTERS) if name == "balldrop" else sorted(quilt.ROUND_COUNTERS)
    return {"": edges, "counters": np.array([counters[k] - before[k] for k in keys]),
            "drawn_kept": np.array([quilt.DISPATCH_COUNTERS[k] - qc[k] for k in ("candidates", "edges_out")])}


def _rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank: every scenario on the 4-rank ``graphs`` mesh (and,
    on rank 0, unsharded); saves ``rank{r}.npz``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.core import distributed
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.fit import magfit

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", world), rank=rank, world_size=world)
    try:
        inputs = np.load(tmp + "/inputs.npz")
        mesh = mesh_lib.make_sampler_mesh(device="cpu")
        assert mesh_lib.sampler_world("cpu") == mesh_lib.SamplerWorld("gloo", world, rank, False)
        out = {}
        for name in SAMPLERS:
            for k, v in _run_scenario(name, inputs[f"F:{name}"], mesh, tmp, rank).items():
                out[f"{name}:{k}"] = v
            if rank == 0:
                for k, v in _run_scenario(name, inputs[f"F:{name}"], None, tmp, rank).items():
                    out[f"{name}:{k}:nomesh"] = v
        out["kpgm_distributed:"] = distributed.kpgm_sample_distributed(
            prng.PRNGKey(KPGM_KEY), kpgm.make_params(THETA, KPGM_D), mesh)
        target = {"w": np.zeros((8, 3), np.float32), "b": np.zeros(5, np.float32), "r": np.zeros(6, np.int32)}
        shardings = {"w": (mesh, (Shard(0),)), "b": None, "r": (mesh, (Replicate(),))}
        tree, _ = ckpt.restore(tmp + "/ckpt", 1, target, shardings=shardings)
        assert isinstance(tree["w"], DTensor) and isinstance(tree["r"], DTensor) and isinstance(tree["b"], np.ndarray)
        out["restore:w_local"] = tree["w"].to_local().numpy()
        out["restore:w_full"] = tree["w"].full_tensor().numpy()
        out["restore:r_local"] = tree["r"].to_local().numpy()
        out["restore:b"] = tree["b"]
        data = magfit.shard_edges(inputs["edges"], 192, shard_size=SHARD_SIZE, mesh=mesh, device="cpu")
        for f, x in zip(data._fields, data):
            out[f"shard_edges:{f}"] = x.numpy()
        np.savez(f"{tmp}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


_REFERENCE = """
import importlib, os, sys, warnings
sys.path[:0] = [{tests!r}, {src!r}]
import numpy as np, jax
from test_torch_reference import reference_package
from test_torch_mesh import SAMPLERS, KPGM_D, KPGM_KEY, STREAM_CHUNK, SHARD_SIZE, THETA
assert len(jax.devices()) == 4, jax.devices()
tmp = {tmp!r}
inputs = np.load(tmp + "/inputs.npz")
with reference_package() as ref:
    mesh_mod = importlib.import_module("repro.launch.mesh")
    distributed = importlib.import_module("repro.core.distributed")
    bd = importlib.import_module("repro.core.balldrop")
    mesh = mesh_mod.make_sampler_mesh()
    out = {{}}
    for name, (theta, mu, d, n, k, opts) in SAMPLERS.items():
        F = inputs["F:" + name]
        params = ref.magm.make_params(theta, mu, d)
        key = jax.random.PRNGKey(k)
        cfg = lambda: ref.api.SamplerConfig(params=params, F=F, mesh="auto", **(opts or {{}}))
        if name == "split":
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                out[name + ":"] = ref.quilt.quilt_sample_fast(key, params, F, mesh=mesh)
        elif name == "batch":
            for i, g in enumerate(ref.api.MAGMSampler(cfg()).sample_batch(4, key)):
                out[name + ":" + str(i)] = g.edges
        elif name == "stream":
            chunks = ref.api.MAGMSampler(cfg()).sample_stream(key, chunk_edges=STREAM_CHUNK)
            out[name + ":"] = np.concatenate(list(chunks))
        elif name == "device_loss":
            plan = ref.quilt.get_quilt_plan(F, params.thetas)
            sched = ref.chaos.FaultSchedule([ref.chaos.FaultSpec("quilt.dispatch", (0,), "device_loss", 2)])
            before = ref.quilt.DISPATCH_COUNTERS["mesh_degrades"]
            with ref.chaos.active(sched):
                out[name + ":"] = ref.quilt.quilt_run(key, plan, mesh=mesh).edges()
            out[name + ":mesh_degrades"] = np.array(ref.quilt.DISPATCH_COUNTERS["mesh_degrades"] - before)
        else:
            counters = bd.DISPATCH_COUNTERS if name == "balldrop" else ref.quilt.DISPATCH_COUNTERS
            before = dict(counters)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                out[name + ":"] = ref.api.MAGMSampler(cfg()).sample(key).edges
            out[name + ":counters"] = np.array([counters[c] - before[c] for c in sorted(counters)])
    out["kpgm_distributed:"] = distributed.kpgm_sample_distributed(
        jax.random.PRNGKey(KPGM_KEY), importlib.import_module("repro.core.kpgm").make_params(THETA, KPGM_D), mesh)
    spec = jax.sharding.PartitionSpec
    sh = {{"w": jax.sharding.NamedSharding(mesh, spec("graphs")), "b": None,
           "r": jax.sharding.NamedSharding(mesh, spec())}}
    target = {{"w": np.zeros((8, 3), np.float32), "b": np.zeros(5, np.float32), "r": np.zeros(6, np.int32)}}
    tree, _ = ref.ckpt.restore(tmp + "/ckpt", 1, target, shardings=sh)
    for s in tree["w"].addressable_shards:
        out["restore:w_local%d" % mesh.devices.tolist().index(s.device)] = np.asarray(s.data)
    out["restore:w_full"] = np.asarray(tree["w"])
    out["restore:b"] = np.asarray(tree["b"])
    data = ref.magfit.shard_edges(inputs["edges"], 192, shard_size=SHARD_SIZE, mesh=mesh)
    for f, x in zip(data._fields, data):
        out["shard_edges:" + f] = np.asarray(x)
    np.savez(tmp + "/ref.npz", **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks' outputs and the reference's, from one spawn and one
    subprocess run side by side."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path_factory.mktemp("mesh"))
    _inputs(tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4").strip()
    script = textwrap.dedent(_REFERENCE.format(tests=TESTS, src=os.path.abspath(SRC), tmp=tmp))
    proc = subprocess.Popen([sys.executable, "-c", script], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(_rank, args=(WORLD, tmp), nprocs=WORLD, join=True)
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    return [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(WORLD)], dict(np.load(f"{tmp}/ref.npz"))


def _keys(got: dict, name: str):
    return sorted(k for k in got if k.startswith(name + ":") and not k.endswith(":nomesh"))


@pytest.mark.parametrize("name", SCENARIOS)
def test_mesh_run_matches_the_unsharded_port_on_every_rank(runs, name):
    ranks, _ = runs
    zero = ranks[0]
    for r, got in enumerate(ranks):
        keys = _keys(got, name)
        assert keys, (r, name)
        if name == "device_loss" and r == 2:
            assert keys == ["device_loss:lost"]  # the lost rank left the run
            continue
        for k in keys:
            if k == "restore:w_local":
                continue  # each rank's own shard: checked below
            want = zero.get(k + ":nomesh")
            if want is not None:
                np.testing.assert_array_equal(got[k], want, err_msg=f"rank {r} {k}")
            else:  # no unsharded counterpart: every rank holds rank 0's result
                np.testing.assert_array_equal(got[k], zero[k], err_msg=f"rank {r} {k}")
    if name in SAMPLERS:
        assert zero[f"{name}:"].shape[0] > 0 if f"{name}:" in zero else zero[f"{name}:0"].shape[0] > 0
    if f"{name}:drawn_kept" in zero:  # the registry's own counters (equal on every rank: above)
        drawn, kept = zero[f"{name}:drawn_kept"]
        assert kept == zero[f"{name}:"].shape[0] and (drawn > 0) == (name != "balldrop")
    if name == "device_loss":
        assert all(int(ranks[r]["device_loss:mesh_degrades"]) == 1 for r in (0, 1, 3))
        assert all(int(ranks[r]["device_loss:warned"]) for r in (0, 1, 3))
    if name == "topup":
        c = dict(zip(sorted(quilt.ROUND_COUNTERS), zero["topup:counters"]))
        assert c["device_topup_rounds"] >= 1 and c["host_topup_rounds"] == 0 and c["degraded_fallbacks"] == 0
    if name == "topup_host":
        c = dict(zip(sorted(quilt.ROUND_COUNTERS), zero["topup_host:counters"]))
        assert c["degraded_fallbacks"] == 1 and c["host_topup_rounds"] >= 1
    if name == "restore":
        w = np.arange(24, dtype=np.float32).reshape(8, 3)
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got["restore:w_local"], w[2 * r: 2 * r + 2])
            np.testing.assert_array_equal(got["restore:w_full"], w)
            np.testing.assert_array_equal(got["restore:r_local"], np.arange(6, dtype=np.int32))


@pytest.mark.parametrize("name", SCENARIOS)
def test_mesh_run_matches_the_reference_4_devices(runs, name):
    ranks, want = runs
    got = ranks[0]
    keys = sorted(k for k in want if k.startswith(name + ":"))
    assert keys, name
    for k in keys:
        if k.startswith("restore:w_local"):
            r = int(k[len("restore:w_local"):])
            np.testing.assert_array_equal(ranks[r]["restore:w_local"], want[k], err_msg=k)
            continue
        assert k in got, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# --- in-process: a 1-rank gloo world ------------------------------------------


@pytest.fixture
def world():
    """A clean process: no group before the test, none after."""
    mesh_lib.release()
    yield
    mesh_lib.release()


def _session_config(**kw) -> SamplerConfig:
    return SamplerConfig(params=magm.make_params(THETA, 0.5, 6), num_nodes=96, device="cpu", **kw)


@pytest.mark.parametrize("opts", [{}, {"exact_cells": False}, {"backend": "balldrop"}, {"split": True}],
                         ids=["exact", "ranked", "balldrop", "split"])
def test_one_rank_mesh_equals_no_mesh(world, opts):
    key = prng.PRNGKey(5)
    want = MAGMSampler(_session_config(**opts)).sample(key).edges
    s = MAGMSampler(_session_config(mesh="auto", **opts))
    assert s.world == mesh_lib.SamplerWorld("gloo", 1, 0, True)
    assert s.mesh.mesh_dim_names == ("graphs",) and s.mesh.device_type == "cpu"
    np.testing.assert_array_equal(s.sample(key).edges, want)
    host = MAGMSampler(_session_config(mesh="host", **opts))
    assert host.mesh.mesh_dim_names == ("data",)
    np.testing.assert_array_equal(host.sample(key).edges, want)


def test_degrade_sampler_mesh_errors(world):
    mesh = mesh_lib.make_sampler_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="no survivors"):
        mesh_lib.degrade_sampler_mesh(mesh, 0)
    with pytest.raises(ValueError, match="out of range"):
        mesh_lib.degrade_sampler_mesh(mesh, 5)
    with pytest.raises(ValueError, match="needs 1..1 ranks"):
        mesh_lib.make_sampler_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="unknown mesh spec"):
        mesh_lib.resolve_sampler_mesh("everywhere")
    if not torch.cuda.is_available():  # the default device is the card, never a silent CPU
        with pytest.raises(RuntimeError, match="is_available"):
            mesh_lib.make_sampler_mesh()
    assert mesh_lib.resolve_sampler_mesh(None) is None and mesh_lib.resolve_sampler_mesh(mesh) is mesh


@pytest.mark.parametrize("engine", ["quilt", "balldrop"])
def test_one_rank_loss_reraises(world, engine):
    p = magm.make_params(THETA, 0.5, 6)
    F = magm.sample_attributes(prng.PRNGKey(3), 128, p.mu, device="cpu").numpy()
    plan = quilt.get_quilt_plan(F, p.thetas, device="cpu")
    run = quilt.quilt_run if engine == "quilt" else balldrop.balldrop_run
    counters = quilt.DISPATCH_COUNTERS if engine == "quilt" else balldrop.DISPATCH_COUNTERS
    before = counters["mesh_degrades"]
    sched = chaos.FaultSchedule([chaos.FaultSpec("quilt.dispatch", (0,), "device_loss", 0)])
    with chaos.active(sched), pytest.raises(chaos.DeviceLoss):
        run(prng.PRNGKey(2), plan, mesh=mesh_lib.make_sampler_mesh(1, device="cpu"))
    assert sched.fired and counters["mesh_degrades"] == before


def test_graph_shard_axes_on_sampler_meshes(world):
    assert sharding.graph_shard_axes(None) == ((), 1)
    assert sharding.graph_shard_axes(mesh_lib.make_sampler_mesh(device="cpu")) == (("graphs",), 1)
    assert sharding.graph_shard_axes(mesh_lib.resolve_sampler_mesh("host", device="cpu")) == (("data",), 1)
    # a model-only mesh has no graph-parallel axis: the unsharded program
    assert sharding.graph_shard_axes(hints.MeshShape(("model",), (4,))) == ((), 1)
    assert sharding.graph_layout(hints.MeshShape(("pod", "data"), (2, 3)), 16) == (("pod", "data"), 6, 18)


def test_sampler_meshes_and_the_fake_world_do_not_meet(world):
    p = magm.make_params(THETA, 0.5, 6)
    F = magm.sample_attributes(prng.PRNGKey(3), 64, p.mu, device="cpu").numpy()
    plan = quilt.get_quilt_plan(F, p.thetas, device="cpu")
    fake = mesh_lib.make_host_mesh()  # the dry-run's world
    with pytest.raises(RuntimeError, match="fake process group"):
        mesh_lib.make_sampler_mesh(device="cpu")
    with pytest.raises(ValueError, match="real process group"):
        quilt.quilt_run(prng.PRNGKey(1), plan, mesh=fake)
    mesh_lib.release()
    mesh_lib.make_sampler_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="'gloo' process group is running"):
        mesh_lib.make_host_mesh()
