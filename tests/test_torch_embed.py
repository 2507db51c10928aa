"""The port's token embedding (``repro_torch.models.embed``) on plain
tensors and on vocab-sharded DTensors, on the CPU:

- plain tensors keep the bits of the gather as it was before the
  vocab-parallel path (a frozen copy of ``transformer.forward``'s line
  below): rows and the table's gradient, float32 and bfloat16, repeated
  tokens;
- an 8-rank gloo group (``torch.multiprocessing.spawn`` over a
  ``FileStore``) on a ``(pod, data, model) = (2, 2, 2)`` mesh, the table
  placed as ``dist.sharding`` places the embedding (vocab over ``model``,
  d_model over ``data``) and the tokens' batch over ``pod`` and ``data``:
  the rows, reduced by the model's own ``shard(..., "batch", None, None)``,
  equal the plain gather exactly (``torch.equal``); the table's gradient
  has the leaf's placements and matches the plain gather's at rtol 1e-6
  of each row's sum of |cotangent| (the repeated tokens' sums change
  order, and a row whose terms cancel keeps their rounding, not its own).  Vocabs that the model dim
  divides and does not, train-shaped (B, S) and decode-shaped (B, 1)
  tokens, and tokens given as a plain (replicated) tensor;
- on the same ranks, the SSM mixers' causal conv (``models.ssm``), which
  runs per (batch, channel) shard on DTensors for the same reason: its
  output and its input's gradient equal the plain conv's exactly, its
  weights' gradients (reduced from Partial() over the batch axes, as the
  MoE experts' are) to the same sum-of-magnitudes bound.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.dist import hints
from repro_torch.models import ssm
from repro_torch.models.embed import embed

D = 8
MESH = ((2, 2, 2), ("pod", "data", "model"))
# name -> (vocab size, tokens shape, tokens as a DTensor over the batch axes)
LAYOUTS = {
    "vocab_even": (16, (8, 6), True),
    "vocab_uneven": (13, (8, 6), True),
    "decode": (16, (8, 1), True),
    "tokens_replicated": (13, (4, 5), False),
}
GRAD_RTOL = 1e-6
CONV = (8, 6, 4, 4)  # (batch, seq, channels, kernel)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _frozen_embed(table, tokens):
    """``transformer.forward``'s embedding as it was before its
    vocab-parallel path (``hints.shard`` is the identity on a plain
    tensor)."""
    return hints.shard(table[tokens], "batch", None, None)


def _inputs(v: int, shape, seed: int = 0, dtype=torch.float32):
    """A (v, D) table, tokens with repeats (ids drawn from a third of the
    vocab plus its first and last), and the output's cotangent."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((v, D)).astype(np.float32)).to(dtype)
    tokens = rng.integers(0, max(v // 3, 1), shape)
    tokens.flat[0], tokens.flat[-1] = 0, v - 1
    cot = torch.from_numpy(rng.standard_normal(shape + (D,)).astype(np.float32)).to(dtype)
    return table, torch.from_numpy(tokens.astype(np.int32)), cot


def _rows_and_grad(fn, table, tokens, cot):
    t = table.clone().requires_grad_(True)
    out = fn(t, tokens)
    (g,) = torch.autograd.grad((out * cot).sum(), t)
    return out.detach(), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", LAYOUTS)
def test_plain_tensors_keep_their_bits(name, dtype):
    v, shape, _ = LAYOUTS[name]
    table, tokens, cot = _inputs(v, shape, dtype=dtype)
    got = _rows_and_grad(embed, table, tokens, cot)
    want = _rows_and_grad(_frozen_embed, table, tokens, cot)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        assert torch.equal(g.view(bits), w.view(bits))


def _rank(rank: int, world: int, store: str, out: str) -> None:
    """One gloo rank: every layout's rows and table gradient as DTensors;
    rank 0 saves the full results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
        res = {}
        for name, (v, shape, sharded) in LAYOUTS.items():
            table, tokens, cot = _inputs(v, shape)
            # dist.sharding's ("tp", "fsdp"): vocab over model (unevenly for
            # 13 rows, which the rules would replicate), d_model over data
            t_pl = (Replicate(), Shard(1), Shard(0))
            t = distribute_tensor(table, mesh, t_pl).requires_grad_(True)
            if sharded:
                tokens = distribute_tensor(tokens, mesh, (Shard(0), Shard(0), Replicate()))
            with hints.use_mesh(mesh):
                x = hints.shard(embed(t, tokens), "batch", None, None)
            assert not any(p.is_partial() for p in x.placements), x.placements
            rows = x.redistribute(mesh, (Replicate(),) * 3).to_local()
            (g,) = torch.autograd.grad((rows * cot).sum(), t)
            assert g.placements == t.placements, (g.placements, t.placements)
            res[f"{name}:rows"] = rows.detach().numpy()
            res[f"{name}:grad"] = g.full_tensor().numpy()
        x, w, b, cot = (torch.from_numpy(a) for a in _conv_inputs())
        xs = distribute_tensor(x, mesh, (Shard(0), Shard(0), Shard(2))).requires_grad_(True)
        ws = distribute_tensor(w, mesh, (Replicate(), Replicate(), Shard(1))).requires_grad_(True)
        bs = distribute_tensor(b, mesh, (Replicate(),) * 3).requires_grad_(True)
        y = ssm._causal_conv(xs, ws, bs).redistribute(mesh, (Replicate(),) * 3).to_local()
        grads = torch.autograd.grad((y * cot).sum(), (xs, ws, bs))
        assert grads[0].placements == xs.placements  # the weights' may stay Partial() over the batch axes
        res["conv:out"] = y.detach().numpy()
        res.update({f"conv:grad_{k}": g.full_tensor().numpy() for k, g in zip("xwb", grads)})
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("embed")
    mp.spawn(_rank, args=(8, str(tmp / "store"), str(tmp / "out.npz")), nprocs=8, join=True)
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("name", LAYOUTS)
def test_sharded_rows_equal_the_plain_gather(sharded, name):
    v, shape, _ = LAYOUTS[name]
    table, tokens, _ = _inputs(v, shape)
    want = table[tokens].numpy()
    assert sharded[f"{name}:rows"].shape == want.shape
    assert torch.equal(torch.from_numpy(sharded[f"{name}:rows"]), torch.from_numpy(want))


@pytest.mark.parametrize("name", LAYOUTS)
def test_sharded_grad_matches_the_plain_gather(sharded, name):
    v, shape, _ = LAYOUTS[name]
    table, tokens, cot = _inputs(v, shape)
    _, want = _rows_and_grad(_frozen_embed, table, tokens, cot)
    _, scale = _rows_and_grad(_frozen_embed, table, tokens, cot.abs())  # each entry's sum of |terms|
    want, scale = want.numpy(), scale.numpy()
    assert np.count_nonzero(np.abs(want).sum(-1)) > 1
    err = np.abs(sharded[f"{name}:grad"] - want)
    assert np.all(err <= GRAD_RTOL * scale), (err.max(), (err / np.maximum(scale, 1e-30)).max())


def _conv_inputs(seed: int = 1):
    """x (B, S, C), w (K, C), b (C) and the output's cotangent, float32."""
    bsz, s_len, c, k = CONV
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((bsz, s_len, c), (k, c), (c,), (bsz, s_len, c)))


def _conv_value_and_grads(x, w, b, cot):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    y = ssm._causal_conv(*ts)
    return y.detach(), torch.autograd.grad((y * torch.from_numpy(cot)).sum(), ts)


def test_sharded_causal_conv_matches_the_plain_conv(sharded):
    x, w, b, cot = _conv_inputs()
    y, grads = _conv_value_and_grads(x, w, b, cot)
    _, scales = _conv_value_and_grads(np.abs(x), np.abs(w), np.abs(b), np.abs(cot))  # sums of |terms|
    assert torch.equal(torch.from_numpy(sharded["conv:out"]), y)
    assert torch.equal(torch.from_numpy(sharded["conv:grad_x"]), grads[0])
    for k, g, sc in zip("wb", grads[1:], scales[1:]):
        err = np.abs(sharded[f"conv:grad_{k}"] - g.numpy())
        assert np.all(err <= GRAD_RTOL * sc.numpy()), (k, err.max())
