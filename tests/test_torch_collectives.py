"""The port's int8 compressed collectives (``repro_torch.dist.collectives``)
against the reference's ``repro.dist.collectives``, on the CPU:

- ``_stochastic_round_int8``'s payload and scale bit for bit, over shapes,
  dtypes and keys (the rounding draws the reference's threefry uniforms);
- the reference's unbiasedness check (200 keys, mean within 0.15 of x);
- ``compressed_grad_allreduce`` on a 4-rank gloo group (four processes,
  ``torch.multiprocessing.spawn`` over a ``FileStore``) against the
  reference's on a 4-virtual-device ``pod`` mesh, run in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` under the ``ref``
  aliases: each device's payload and scale equal, and the means equal to
  the bit (the port sums the four dequantised payloads in rank order).
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.dist import collectives
from test_torch_reference import SRC, ref  # noqa: F401  (fixture)

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tree(seed=0):
    """A small gradient tree: float32, bfloat16, a scalar-sized leaf and a
    zero leaf (its scale is 1), in nested dicts."""
    rng = np.random.default_rng(seed)
    return {
        "blocks": {"w1": (rng.standard_normal((6, 40)) * 0.02).astype(np.float32),
                   "norm": rng.standard_normal((40,)).astype(np.float32)},
        "embed": (rng.standard_normal((33, 8)) * 3).astype(np.float32),
        "gate": np.zeros((3,), np.float32),
        "half": rng.standard_normal((5, 7)).astype(np.float32),
    }


def _to_torch(tree):
    out = {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}
    if "half" in out:
        out["half"] = out["half"].to(torch.bfloat16)
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("shape,scale", [((37, 53), 3.0), ((1000,), 1e-3), ((8, 16, 4), 100.0), ((5,), 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stochastic_round_matches_reference(ref, seed, shape, scale, dtype):
    import jax
    import jax.numpy as jnp

    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    qr, sr = ref.collectives._stochastic_round_int8(xj, jax.random.PRNGKey(seed))
    qp, sp = collectives._stochastic_round_int8(xt, prng.PRNGKey(seed))
    assert qp.dtype == torch.int8 and sp.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(qr), qp.numpy())
    assert np.asarray(sr, np.float32).view(np.uint32) == sp.numpy().view(np.uint32)


def test_stochastic_round_unbiased():
    """The reference's check, on the port's rounding."""
    key = prng.PRNGKey(0)
    x = prng.normal(prng.PRNGKey(1), (512,)) * 3.0
    acc = torch.zeros_like(x)
    trials = 200
    for i in range(trials):
        q, scale = collectives._stochastic_round_int8(x, prng.fold_in(key, i))
        acc = acc + q.to(torch.float32) * scale
    err = float((acc / trials - x).abs().max())
    assert err < 0.15, err  # unbiased up to MC noise


def _rank(rank: int, world: int, store_path: str, out_path: str) -> None:
    """One gloo rank: the shared tree's compressed mean over a 1-D ``pod``
    mesh of ``world`` ranks; rank 0 saves it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
        out = collectives.compressed_grad_allreduce(_to_torch(_tree()), prng.PRNGKey(3), mesh, axis="pod")
        if rank == 0:
            flat = {}

            def walk(t, pre=""):
                for k, v in t.items():
                    if isinstance(v, dict):
                        walk(v, pre + k + "/")
                    else:
                        flat[pre + k] = v.float().numpy()
                        flat[pre + k + ":dtype"] = np.array(str(v.dtype))

            walk(out)
            np.savez(out_path, **flat)
    finally:
        dist.destroy_process_group()


_REFERENCE = """
import sys
sys.path[:0] = [{tests!r}, {src!r}]
import numpy as np, jax, jax.numpy as jnp
from test_torch_reference import reference_package
from test_torch_collectives import _tree
with reference_package() as ref:
    tree = jax.tree.map(jnp.asarray, _tree())
    tree["half"] = tree["half"].astype(jnp.bfloat16)
    mesh = jax.make_mesh((4,), ("pod",))
    out = ref.collectives.compressed_grad_allreduce(tree, jax.random.PRNGKey(3), mesh, axis="pod")
    leaves, _ = jax.tree_util.tree_flatten_with_path(out)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    flat, src = {{}}, jax.tree_util.tree_flatten_with_path(tree)[0]
    for i, ((path, leaf), (_, x)) in enumerate(zip(leaves, src)):
        name = "/".join(str(p.key) for p in path)
        flat[name] = np.asarray(leaf.astype(jnp.float32))
        for r in range(4):  # device r's payload and scale (axis_index = r)
            q, s = ref.collectives._stochastic_round_int8(x, jax.random.fold_in(keys[i], r))
            flat[name + ":q%d" % r] = np.asarray(q)
            flat[name + ":s%d" % r] = np.asarray(s)
    np.savez({out!r}, **flat)
"""


def test_compressed_grad_allreduce_4_ranks_matches_reference(tmp_path):
    import torch.multiprocessing as mp

    port_out, ref_out = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    mp.spawn(_rank, args=(4, str(tmp_path / "store"), port_out), nprocs=4, join=True)

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4").strip()
    script = textwrap.dedent(_REFERENCE.format(tests=TESTS, src=os.path.abspath(SRC), out=ref_out))
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got, want = np.load(port_out), np.load(ref_out)

    keys = prng.split(prng.PRNGKey(3), 5)
    leaves = collectives._leaves(_to_torch(_tree()))
    names = sorted(k for k in want.files if ":" not in k)
    assert names == sorted(k for k in got.files if ":" not in k)
    for i, (name, leaf) in enumerate(zip(names, leaves)):
        for r in range(4):  # the payload each rank puts on the wire
            q, s = collectives._stochastic_round_int8(leaf, prng.fold_in(keys[i], r))
            np.testing.assert_array_equal(q.numpy(), want[f"{name}:q{r}"])
            assert s.numpy().view(np.uint32) == want[f"{name}:s{r}"].view(np.uint32)
        # the mean, to the bit; the leaf keeps its dtype
        np.testing.assert_array_equal(got[name].view(np.uint32), want[name].view(np.uint32), err_msg=name)
        assert str(got[name + ":dtype"]) == str(leaf.dtype)
