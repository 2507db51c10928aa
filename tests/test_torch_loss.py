"""The port's ``train.steps.cross_entropy`` on plain tensors and on
vocab-sharded DTensors, on the CPU:

- plain tensors keep the bits of the function as it was before the
  vocab-parallel path (a frozen copy below): nll, accuracy and the
  logits' gradient, with ties for the argmax;
- a 2-rank gloo group (``torch.multiprocessing.spawn`` over a
  ``FileStore``) with the logits' vocab sharded over ``model`` (evenly and
  unevenly) and, as a control, with the batch sharded over ``data``: nll
  against the unsharded loss at rtol 1e-6 (the vocab sums change order),
  the logits' gradient at rtol 1e-6 plus one ulp of the largest |logz|
  (its softmax carries logz's rounding), the accuracy exact with an argmax
  tie across the two shards;
- the sharded values against the reference's ``cross_entropy`` under
  ``ref`` at the LM tests' tolerance (``CE_RTOL``,
  ``tests/test_torch_train.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.train import steps
from test_torch_reference import ref  # noqa: F401  (fixture)

CE_RTOL = 1e-6
# (mesh names, logits placements by mesh dim, vocab size)
LAYOUTS = {
    "vocab_even": (("model",), ("shard2",), 52),
    "vocab_uneven": (("model",), ("shard2",), 53),
    "batch_only": (("data",), ("shard0",), 52),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _frozen_cross_entropy(logits, labels):
    """``cross_entropy`` as it was before its vocab-parallel path."""
    logz = torch.logsumexp(logits, dim=-1)
    vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
    hit = vocab_ids == labels[..., None]
    gold = torch.where(hit, logits, 0.0).sum(dim=-1)
    nll = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))
    return nll, acc


def _inputs(v: int, seed: int = 0):
    """float32 (4, 6, v) logits with a max tied between the two halves of
    the vocab in row (0, 0), and labels hitting the argmax in a few rows."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((4, 6, v)) * 3).astype(np.float32)
    labels = rng.integers(0, v, (4, 6)).astype(np.int64)
    logits[0, 0, 3] = logits[0, 0, v - 2] = 40.0
    labels[0, 0] = 3  # the first of the tied maxima, as torch.argmax picks
    labels[1, :3] = logits[1, :3].argmax(-1)
    return logits, labels


def _value_and_grad(fn, logits: np.ndarray, labels: np.ndarray):
    x = torch.from_numpy(logits).requires_grad_(True)
    nll, acc = fn(x, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(nll, x)
    return nll.detach(), acc, g


@pytest.mark.parametrize("v, seed", [(53, 0), (52, 1), (7, 2)])
def test_plain_tensors_keep_their_bits(v, seed):
    logits, labels = _inputs(v, seed)
    got = _value_and_grad(steps.cross_entropy, logits, labels)
    want = _value_and_grad(_frozen_cross_entropy, logits, labels)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert float(got[1]) > 0


def _rank(rank: int, world: int, store: str, out: str) -> None:
    """One gloo rank: every layout's loss and gradient as DTensors; rank 0
    saves the full results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        res = {}
        for name, (names, pls, v) in LAYOUTS.items():
            mesh = init_device_mesh("cpu", (world,), mesh_dim_names=names)
            placements = [Shard(int(p[-1])) if p.startswith("shard") else Replicate() for p in pls]
            logits, labels = _inputs(v)
            x = distribute_tensor(torch.from_numpy(logits), mesh, placements).requires_grad_(True)
            nll, acc = steps.cross_entropy(x, torch.from_numpy(labels))
            (g,) = torch.autograd.grad(nll, x)
            if name.startswith("vocab"):  # each rank's gradient is its own vocab shard
                assert g.placements == x.placements
            full = [t.full_tensor().detach().numpy() for t in (nll, acc, g)]
            res.update({f"{name}:{k}": f for k, f in zip(("nll", "acc", "grad"), full)})
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("loss")
    mp.spawn(_rank, args=(2, str(tmp / "store"), str(tmp / "out.npz")), nprocs=2, join=True)
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("name", LAYOUTS)
def test_sharded_loss_matches_the_unsharded_loss(sharded, name):
    logits, labels = _inputs(LAYOUTS[name][2])
    nll, acc, g = _value_and_grad(steps.cross_entropy, logits, labels)
    np.testing.assert_allclose(sharded[f"{name}:nll"], nll.numpy(), rtol=1e-6)
    assert sharded[f"{name}:acc"] == acc.numpy() and float(acc) > 0
    # the gradient exp(l - logz) * g carries logz's rounding, which the new
    # sum order may move by one ulp: past |logz| = 8 one ulp exceeds 1e-6
    logz = torch.logsumexp(torch.from_numpy(logits), dim=-1).abs().max().numpy()
    np.testing.assert_allclose(sharded[f"{name}:grad"], g.numpy(), rtol=1e-6 + float(np.spacing(logz)))


@pytest.mark.parametrize("name", LAYOUTS)
def test_sharded_loss_matches_the_reference(ref, sharded, name):
    import importlib

    import jax.numpy as jnp

    ref_steps = importlib.import_module("repro.train.steps")  # under the ref fixture's scope
    logits, labels = _inputs(LAYOUTS[name][2])
    want_nll, want_acc = (float(x) for x in ref_steps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(float(sharded[f"{name}:nll"]), want_nll, rtol=CE_RTOL)
    assert float(sharded[f"{name}:acc"]) == want_acc
