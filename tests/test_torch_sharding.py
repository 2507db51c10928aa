"""The port's sharding rules (``repro_torch.dist.hints`` / ``sharding``)
against the reference's ``repro.dist.hints`` / ``sharding``, on the CPU:

- ``param_specs`` leaf for leaf (``tuple(PartitionSpec)`` against the
  port's tuple spec) for all ten archs on the 16x16, 2x16x16 and 1-device
  meshes, training and inference, the reference on its
  ``transformer.abstract_params`` and a ``jax.sharding.AbstractMesh``
  (as ``tests/test_sharding.py`` builds it), the port on
  ``Model.abstract_params()`` and a ``hints.MeshShape``;
- ``input_specs`` for each shape on each mesh, all ten archs;
- ``graph_layout`` / ``graph_shard_axes`` on meshes with and without a
  ``graphs`` axis;
- ``shard`` as the identity on plain tensors, with and without a mesh;
- ``placements`` on a 2x2 fake ``DeviceMesh``; ``param_shardings`` and
  ``distribute`` over it.
"""

from __future__ import annotations

import jax
import pytest
import torch

from repro_torch import configs
from repro_torch.dist import hints, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build
from test_torch_reference import ref  # noqa: F401  (fixture)
from torch_lm_families import flat

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1": ((1,), ("data",)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _ref_mesh(name):
    sizes, names = MESHES[name]
    return jax.sharding.AbstractMesh(sizes, names)


def _port_mesh(name):
    return hints.MeshShape(*reversed(MESHES[name]))


_ABSTRACT = {}


def _abstract(ref, arch):
    """(reference abstract params, port abstract params), cached per arch."""
    if arch not in _ABSTRACT:
        rp = ref.transformer.abstract_params(ref.lm_configs.get(arch))
        pp = build(configs.get(arch)).abstract_params()
        _ABSTRACT[arch] = (rp, pp)
    return _ABSTRACT[arch]


def test_mesh_shape_sizes():
    m = _port_mesh("2x16x16")
    assert m.axis_names == ("pod", "data", "model") and m.shape == {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("inference", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_match_reference(ref, arch, mesh, inference):
    rp, pp = _abstract(ref, arch)
    rspecs = ref.sharding.param_specs(ref.lm_configs.get(arch), rp, _ref_mesh(mesh), inference=inference)
    pspecs = sharding.param_specs(configs.get(arch), pp, _port_mesh(mesh), inference=inference)
    got = {}
    sharding.map_with_path(lambda path, s: got.__setitem__(path, s), pspecs)
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
        rspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        want[tuple(str(k.key) for k in path)] = tuple(spec)
    assert got == want
    # and the shapes the specs were resolved on are the reference's
    for path, leaf in flat(pp):
        r = rp
        for k in path:
            r = r[k]
        assert tuple(leaf.shape) == tuple(r.shape) and str(leaf.dtype).split(".")[-1] == str(r.dtype)
    if mesh == "16x16" and arch == "deepseek_67b" and not inference:
        assert pspecs["embed"] == ("model", "data")
        assert pspecs["blocks"]["mlp"]["w1"] == (None, "data", "model")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", [s.name for s in configs.SHAPES])
def test_input_specs_match_reference(ref, shape, mesh):
    for arch in configs.ARCHS:
        rcfg, pcfg = ref.lm_configs.get(arch), configs.get(arch)
        rshape, pshape = ref.lm_configs.get_shape(shape), configs.get_shape(shape)
        rin = ref.lm.build(rcfg).input_specs(rshape)
        pin = build(pcfg).input_specs(pshape, abstract=True)
        rspecs = ref.sharding.input_specs(rcfg, rshape, rin, _ref_mesh(mesh))
        pspecs = sharding.input_specs(pcfg, pshape, pin, _port_mesh(mesh))
        want = {}
        for path, spec in jax.tree_util.tree_flatten_with_path(
            rspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        )[0]:
            want[tuple(str(k.key) for k in path)] = tuple(spec)
        got = {}
        sharding.map_with_path(lambda path, s: got.__setitem__(path, s), pspecs)
        assert got == want, (arch, shape, mesh)


@pytest.mark.parametrize(
    "sizes,names",
    [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")), ((8,), ("graphs",)),
     ((1,), ("data",)), ((4, 2), ("model", "x")), ((3, 2), ("graphs", "data"))],
)
@pytest.mark.parametrize("num_graphs", [1, 7, 64, 257])
def test_graph_layout_matches_reference(ref, sizes, names, num_graphs):
    rmesh = jax.sharding.AbstractMesh(sizes, names)
    pmesh = hints.MeshShape(names, sizes)
    assert sharding.graph_shard_axes(pmesh) == ref.sharding.graph_shard_axes(rmesh)
    assert tuple(sharding.graph_layout(pmesh, num_graphs)) == tuple(ref.sharding.graph_layout(rmesh, num_graphs))
    assert sharding.graph_shard_axes(None) == ref.sharding.graph_shard_axes(None) == ((), 1)


@pytest.mark.parametrize("names", [(), ("batch",), ("batch", None, "tp")])
def test_shard_is_identity_on_plain_tensors(names):
    x = torch.randn(4, 6, 8)
    assert hints.current_mesh() is None and hints.shard(x, *names) is x
    with hints.use_mesh(_port_mesh("16x16")):
        assert hints.current_mesh() == _port_mesh("16x16")
        assert hints.shard(x, *names) is x
    assert hints.current_mesh() is None


@pytest.mark.parametrize(
    "spec,want",
    [((None, None), ("R", "R")), (("data", None), ("S0", "R")), ((None, "model"), ("R", "S1")),
     (("data", "model"), ("S0", "S1")), (("model", "data"), ("S1", "S0")),
     ((("data", "model"), None), ("S0", "S0"))],
)
def test_placements_on_fake_mesh(spec, want):
    from torch.distributed.tensor import Replicate, Shard

    try:
        dmesh = mesh_lib.make_fake_mesh((2, 2), ("data", "model"))
        got = hints.placements(spec, dmesh)
        assert got == tuple(Replicate() if w == "R" else Shard(int(w[1])) for w in want)
    finally:
        mesh_lib.release()


def test_param_shardings_distribute_on_fake_mesh():
    """A smoke olmo's params placed on a 2x2 fake mesh: each leaf's
    placements are its spec's, its local shard the matching piece."""
    from repro_torch.core import prng

    cfg = configs.get_smoke("olmo_1b")
    params = build(cfg).init(prng.PRNGKey(0), device="cpu")
    try:
        dmesh = mesh_lib.make_fake_mesh((2, 2), ("data", "model"))
        pl = sharding.param_shardings(cfg, params, dmesh)
        placed = sharding.distribute(params, pl, dmesh)
        for (path, leaf), (_, d) in zip(flat(params), flat(placed)):
            assert tuple(d.shape) == tuple(leaf.shape)
            local = d.to_local()
            div = [1] * leaf.ndim
            for p in d.placements:
                if p.is_shard():
                    div[p.dim] *= 2
            assert tuple(local.shape) == tuple(s // k for s, k in zip(leaf.shape, div)), path
        assert placed["blocks"]["mlp"]["w1"].placements == hints.placements((None, "data", "model"), dmesh)
    finally:
        mesh_lib.release()


def test_adamw_on_replicated_dtensors_is_bit_equal():
    """AdamW on DTensor leaves replicated over a 1-rank mesh (the update
    runs on their local shards) equals the plain update bit for bit, a
    leaf past ``UPDATE_CHUNK`` elements included."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.train import optimizer as opt

    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(64, 48, generator=g).to(torch.bfloat16),
              "b": {"c": torch.randn(opt.UPDATE_CHUNK + 77, generator=g)}}
    grads = {"a": torch.randn(64, 48, generator=g).to(torch.bfloat16),
             "b": {"c": torch.randn(opt.UPDATE_CHUNK + 77, generator=g) * 1e-3}}
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=1)
    want_p, want_s, want_m = opt.update(cfg, grads, opt.init(params), params)
    try:
        dmesh = mesh_lib.make_host_mesh()

        def rep(t):
            return DTensor.from_local(t, dmesh, [Replicate()], run_check=False)

        dp, dg = opt._map(rep, params), opt._map(rep, grads)
        got_p, got_s, got_m = opt.update(cfg, dg, opt.init(dp), dp)
        pairs = [(got_p, want_p), (got_s.mu, want_s.mu), (got_s.nu, want_s.nu), (got_s.master, want_s.master)]
        for got, want in pairs:
            for x, y in zip(opt._leaves(got), opt._leaves(want)):
                assert isinstance(x, DTensor) and x.dtype == y.dtype
                assert torch.equal(x.to_local().view(torch.int16 if y.element_size() == 2 else torch.int32),
                                   y.view(torch.int16 if y.element_size() == 2 else torch.int32))
        assert torch.equal(got_m["grad_norm"].to_local(), want_m["grad_norm"])
    finally:
        mesh_lib.release()
