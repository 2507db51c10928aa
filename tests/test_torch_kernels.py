"""The fused descent + lookup: its plain PyTorch version against the
reference's Pallas kernel (interpret mode, at most ~2k rows) and against the
reference's jnp twin at larger row counts; the CUDA kernel against the
plain version on a card (marked ``cuda``, skipped elsewhere)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import cuda_device, ref  # noqa: F401  (fixtures)

from repro_torch.core import kpgm, partition, prng
from repro_torch.kernels import ops
from repro_torch.kernels import quadrant_descent as qd

SEED = (0x9E3779B9, 0x0BADF00D)


def _case(d=10, n=300, seed=0):
    """Tables of a random attribute sample (most configs miss at n << 2^d)."""
    rng = np.random.default_rng(seed)
    lam = rng.integers(0, 1 << d, n)
    part = partition.build_partition(lam)
    tab = partition.padded_lookup_tables(part)
    th = rng.uniform(0.1, 1.0, (d, 2, 2)).astype(np.float32)
    cum = kpgm._level_cumprobs(torch.from_numpy(th))
    return part, tab, cum


def _plain(gids, cum, tab, a_tot, num_blocks, ranks):
    return qd.quilt_prng_descent_lookup_plain(
        SEED, torch.tensor(gids, dtype=torch.int32), cum,
        torch.from_numpy(tab.configs), torch.from_numpy(tab.nodes),
        a_tot=a_tot, num_blocks=num_blocks, ranks=ranks,
    )


@pytest.mark.parametrize(
    "gc, a_tot, ranks",
    [(3, 300, False), (4, 250, True), (1, 1000, False)],
    ids=["quilt-a300", "ranks-a250", "gc1-a1000"],
)
def test_plain_matches_pallas_kernel(ref, gc, a_tot, ranks):
    import jax.numpy as jnp

    part, tab, cum = _case()
    nb = part.B if ranks else min(part.B, 2)
    gids = np.arange(gc, dtype=np.int32) * 3 + 1
    seed = np.array([SEED], dtype=np.uint32).astype(np.int32)
    out = ref.qd.quilt_prng_descent_lookup(
        jnp.asarray(seed), jnp.asarray(gids), jnp.asarray(cum.numpy()),
        jnp.asarray(tab.configs), jnp.asarray(tab.nodes),
        a_tot=a_tot, num_blocks=nb, ranks=ranks, interpret=True,
    )
    got = _plain(gids, cum, tab, a_tot, nb, ranks)
    for r, p in zip(out, got):
        assert p.dtype == torch.int32
        assert np.array_equal(np.asarray(r), p.numpy())
    snode = got[2].numpy()
    assert (snode < 0).any() and (snode >= 0).any()  # misses and hits both


@pytest.mark.parametrize("ranks", [False, True])
def test_plain_matches_jnp_twin_at_scale(ref, ranks):
    """~60k rows against descent_uniforms + kpgm._descend + the dense
    inverse gather of the reference's jnp round."""
    import jax.numpy as jnp

    d = 12
    rng = np.random.default_rng(7)
    lam = rng.integers(0, 1 << d, 3000)
    part = partition.build_partition(lam)
    tab = partition.padded_lookup_tables(part)
    th = rng.uniform(0.1, 1.0, (d, 2, 2)).astype(np.float32)
    cum = kpgm._level_cumprobs(torch.from_numpy(th))
    B = part.B
    gids = np.arange(B * B, dtype=np.int32)
    a_tot = 60_000 // (B * B) + 13
    inv = ref.partition.dense_inverse(ref.partition.build_partition(lam), d)

    n = gids.size * a_tot
    local = np.arange(n) // a_tot
    gid = jnp.asarray(gids[local])
    slot = jnp.asarray(np.arange(n) - local * a_tot)
    s0, s1 = jnp.uint32(SEED[0]), jnp.uint32(SEED[1])
    scfg, dcfg = ref.kpgm._descend(ref.qd.descent_uniforms(s0, s1, gid, slot, d), jnp.asarray(cum.numpy()))
    if ranks:
        kb, lb = ref.qd.rank_pair(s0, s1, gid, slot, B)
    else:
        blk = gid % (B * B)
        kb, lb = blk // B, blk % B
    flat = jnp.asarray(inv).reshape(-1)
    want = (scfg, dcfg, flat[(kb << d) | scfg], flat[(lb << d) | dcfg])
    got = _plain(gids, cum, tab, a_tot, B, ranks)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_descend_matches_reference(ref):
    """Quadrant descent alone, with uniforms that hit the cumulative
    thresholds exactly (the compares are >=)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    d = 13
    cum = kpgm._level_cumprobs(torch.from_numpy(rng.uniform(0.05, 1, (d, 2, 2)).astype(np.float32)))
    u = rng.random((5000, d)).astype(np.float32)
    u[:300] = cum.numpy()[None, :, rng.integers(0, 3)]
    want = ref.kpgm._descend(jnp.asarray(u), jnp.asarray(cum.numpy()))
    got = kpgm._descend(torch.from_numpy(u), cum)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32 and np.array_equal(np.asarray(w), g.numpy())


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    part, tab, cum = _case(seed=3)
    before = ops.kernel_launches()["quilt_prng_descent_lookup"]
    gids = torch.arange(4, dtype=torch.int32)
    got = ops.quilt_prng_descent_lookup(
        SEED, gids, cum, torch.from_numpy(tab.configs), torch.from_numpy(tab.nodes),
        a_tot=77, num_blocks=2,
    )
    want = _plain(gids.numpy(), cum, tab, 77, 2, False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.kernel_launches()["quilt_prng_descent_lookup"] == before


def test_wrapper_raises_on_other_devices():
    part, tab, cum = _case(seed=4)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.quilt_prng_descent_lookup(
            SEED, torch.arange(2, dtype=torch.int32, device=meta), cum.to(meta),
            torch.from_numpy(tab.configs).to(meta), torch.from_numpy(tab.nodes).to(meta),
            a_tot=8, num_blocks=1,
        )


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [False, True])
@pytest.mark.parametrize("n_nodes, d", [(300, 10), (30_000, 15)], ids=["smem", "global"])
def test_cuda_kernel_equals_plain(cuda_device, ranks, n_nodes, d):
    part, tab, cum = _case(d=d, n=n_nodes, seed=5)
    B = part.B
    gids = torch.arange(B * B, dtype=torch.int32, device=cuda_device)
    args = (cum.to(cuda_device), torch.from_numpy(tab.configs).to(cuda_device),
            torch.from_numpy(tab.nodes).to(cuda_device))
    before = qd.LAUNCHES
    got = qd.quilt_prng_descent_lookup(SEED, gids, *args, a_tot=1001, num_blocks=B, ranks=ranks)
    torch.cuda.synchronize()
    assert qd.LAUNCHES == before + 1
    want = qd.quilt_prng_descent_lookup_plain(SEED, gids, *args, a_tot=1001, num_blocks=B, ranks=ranks)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert qd.tables_in_shared_memory(args[1]) == (n_nodes == 300)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    part, tab, cum = _case(seed=6)
    cfg = torch.from_numpy(tab.configs).to(cuda_device)
    node = torch.from_numpy(tab.nodes).to(cuda_device)
    gids = torch.arange(2, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        qd.quilt_prng_descent_lookup(SEED, gids, cum.to(cuda_device), cfg, node, a_tot=8, num_blocks=1)
    with pytest.raises(ValueError):
        qd.quilt_prng_descent_lookup(
            SEED, gids.int(), cum.to(cuda_device), cfg, node, a_tot=8, num_blocks=part.B + 1
        )


# --- quadrant_descent_prng: the plain KPGM descent with counter uniforms ---


def _batch_thetas(d, seed):
    return np.random.default_rng(seed).uniform(0.05, 1.0, (d, 2, 2)).astype(np.float32)


@pytest.mark.parametrize("d", [3, 6, 15])
def test_quadrant_descent_prng_plain_matches_pallas(ref, d):
    """Bit for bit against the Pallas kernel in interpret mode, at a ragged
    slot count: the reference runs whole 512-slot tiles, the port exactly
    the slots asked for, and a slot's draw does not depend on the count."""
    import jax.numpy as jnp

    cum = ops._batch_cumprobs(_batch_thetas(d, d))
    seed = (0x9E3779B9, (0xDEADBEEF + d) & 0xFFFFFFFF)
    slots = 1000
    padded = -(-slots // ref.qd.TILE) * ref.qd.TILE
    seed_arr = np.array([seed], dtype=np.uint32).astype(np.int32)
    want = ref.qd.quadrant_descent_prng(jnp.asarray(seed_arr), jnp.asarray(cum.numpy()),
                                        num_slots=padded, interpret=True)
    got = qd.quadrant_descent_prng_plain(seed, cum, num_slots=slots, chunk=384)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32 and g.shape == (slots,)
        assert torch.equal(torch.from_numpy(np.array(w)[:slots]), g)


def test_batch_cumprobs_bits_match_reference():
    """The eager (d, 4) table of the reference's sample_edge_batch_prng: its
    sum and cumulative sum run sequentially (not the plan's pairwise sums)."""
    import jax.numpy as jnp

    th = _batch_thetas(31, 1)
    flat = jnp.asarray(th).reshape(-1, 4)
    want = np.asarray(jnp.cumsum(flat / jnp.sum(flat, axis=1, keepdims=True), axis=1))
    got = ops._batch_cumprobs(torch.from_numpy(th)).numpy()
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("num_edges", [100, 8000])
def test_sample_edge_batch_prng_matches_reference(ref, num_edges):
    """The KPGM entry point, same key, same (src, dst); the 100-edge batch
    is a prefix of the 8000-edge one (tests/test_counter_prng.py:194)."""
    import jax
    import jax.numpy as jnp

    th = _batch_thetas(10, 5)
    kd = np.asarray(jax.random.key_data(jax.random.PRNGKey(21)))
    want = ref.ops.sample_edge_batch_prng(jnp.asarray(kd), jnp.asarray(th), num_edges)
    key = torch.from_numpy(kd.astype(np.int64))
    got = ops.sample_edge_batch_prng(key, torch.from_numpy(th), num_edges, device="cpu")
    longer = ops.sample_edge_batch_prng(key, torch.from_numpy(th), 8000, device="cpu")
    for w, g, ln in zip(want, got, longer):
        assert g.shape == (num_edges,) and torch.equal(torch.from_numpy(np.array(w)), g)
        assert torch.equal(ln[:num_edges], g)


def test_quadrant_descent_prng_native_raises_and_cpu_counts_no_launch():
    cum = ops._batch_cumprobs(_batch_thetas(4, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        ops.sample_edge_batch_prng(prng.PRNGKey(0), _batch_thetas(4, 2), 64, tpu_native=True, device="cpu")
    with pytest.raises(NotImplementedError, match="tpu_native"):
        qd.quadrant_descent_prng(SEED, cum, num_slots=64, tpu_native=True)
    before = ops.kernel_launches()["quadrant_descent_prng"]
    got = qd.quadrant_descent_prng(SEED, cum, num_slots=777)
    want = qd.quadrant_descent_prng_plain(SEED, cum, num_slots=777)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.kernel_launches()["quadrant_descent_prng"] == before
    with pytest.raises(ValueError, match="no kernel for device"):
        qd.quadrant_descent_prng(SEED, cum.to("meta"), num_slots=8)
    if torch.cuda.is_available():
        assert ops.sample_edge_batch_prng(prng.PRNGKey(0), _batch_thetas(4, 2), 8)[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.sample_edge_batch_prng(prng.PRNGKey(0), _batch_thetas(4, 2), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("d, slots", [(3, 1), (15, 100_003), (31, 1 << 20)])
def test_cuda_quadrant_descent_prng_equals_plain(cuda_device, d, slots):
    cum = ops._batch_cumprobs(_batch_thetas(d, d)).to(cuda_device)
    before = qd.PRNG_LAUNCHES
    got = qd.quadrant_descent_prng(SEED, cum, num_slots=slots)
    torch.cuda.synchronize()
    assert qd.PRNG_LAUNCHES == before + 1
    want = qd.quadrant_descent_prng_plain(SEED, cum, num_slots=slots)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
