"""The fused descent + lookup: its plain PyTorch version against the
reference's Pallas kernel (interpret mode, at most ~2k rows) and against the
reference's jnp twin at larger row counts; the CUDA kernel against the
plain version on a card (marked ``cuda``, skipped elsewhere)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import cuda_device, ref  # noqa: F401  (fixtures)

from repro_torch.configs import magm_paper
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
    """tpu_native=True runs the Philox variant: its plain version on a CPU
    tensor, with no launch counted; on other devices, and on the default
    device without a card, it raises."""
    cum = ops._batch_cumprobs(_batch_thetas(4, 2))
    key = prng.PRNGKey(0)
    got = ops.sample_edge_batch_prng(key, _batch_thetas(4, 2), 64, tpu_native=True, device="cpu")
    want = qd.quadrant_descent_native_plain(ops.counter_seed(key), cum, num_slots=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    before = dict(ops.kernel_launches())
    for tpu_native in (False, True):
        got = qd.quadrant_descent_prng(SEED, cum, num_slots=777, tpu_native=tpu_native)
        plain = qd.quadrant_descent_native_plain if tpu_native else qd.quadrant_descent_prng_plain
        want = plain(SEED, cum, num_slots=777)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.kernel_launches() == before
    for tpu_native in (False, True):
        with pytest.raises(ValueError, match="no kernel for device"):
            qd.quadrant_descent_prng(SEED, cum.to("meta"), num_slots=8, tpu_native=tpu_native)
    for tpu_native in (None, True):
        if torch.cuda.is_available():
            assert ops.sample_edge_batch_prng(key, _batch_thetas(4, 2), 8, tpu_native=tpu_native)[0].is_cuda
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                ops.sample_edge_batch_prng(key, _batch_thetas(4, 2), 8, tpu_native=tpu_native)


# --- the device-native variant: Philox4x32-10 in place of the TPU's PRNG ---


@pytest.mark.parametrize(
    "ctr, key, want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for philox4x32-10."""
    assert tuple(int(w) for w in qd.philox4x32(ctr, key)) == want


def test_philox_vectorised_equals_scalar():
    rng = np.random.default_rng(3)
    ctr = rng.integers(0, 1 << 32, (4, 50), dtype=np.int64)
    key = tuple(int(k) for k in rng.integers(0, 1 << 32, 2))
    got = qd.philox4x32(tuple(torch.from_numpy(c) for c in ctr), key)
    for i in range(50):
        one = qd.philox4x32(tuple(int(c[i]) for c in ctr), key)
        assert [int(g[i]) for g in got] == [int(o) for o in one]


@pytest.mark.parametrize("d", [1, 4, 7, 31])
def test_native_plain_uniforms_and_prefix(d):
    """Level k of slot s is word k % 4 of Philox((s, k // 4, 0, 0), seed),
    u = (bits >> 8) 2^-24; a shorter batch is a prefix of a longer one."""
    cum = ops._batch_cumprobs(_batch_thetas(d, d))
    slot = torch.arange(300, dtype=torch.int64)
    u = qd.native_uniforms(SEED, slot, d)
    for k in (0, d // 2, d - 1):
        words = qd.philox4x32((slot, torch.full_like(slot, k // 4), 0 * slot, 0 * slot), SEED)
        assert torch.equal(u[:, k], (words[k % 4] >> 8).to(torch.float32) * 2.0**-24)
    short = qd.quadrant_descent_native_plain(SEED, cum, num_slots=1000, chunk=333)
    long = qd.quadrant_descent_native_plain(SEED, cum, num_slots=5000)
    assert all(torch.equal(a, b[:1000]) for a, b in zip(short, long))
    assert all(torch.equal(a, b) for a, b in zip(qd._descend_body(u, cum), (x[:300] for x in long)))


def _cell_law(src, dst, thetas):
    """(per-level quadrant fractions, their expected values, chi-square
    p-value over the 4^d cells, max |z| of a cell) of a batch against
    P_xy / m."""
    from scipy import stats

    d = thetas.shape[0]
    src, dst = src.cpu().numpy().astype(np.int64), dst.cpu().numpy().astype(np.int64)
    bits = np.arange(d - 1, -1, -1)
    quad = ((src[:, None] >> bits) & 1) * 2 + ((dst[:, None] >> bits) & 1)
    frac = np.stack([(quad == q).mean(axis=0) for q in range(4)], axis=1)
    t = np.asarray(thetas, dtype=np.float64).reshape(d, 4)
    want = t / t.sum(axis=1, keepdims=True)
    P = np.ones((1, 1))
    for th in np.asarray(thetas, dtype=np.float64):
        P = np.kron(P, th)
    expect = src.size * P.reshape(-1) / P.sum()
    got = np.bincount(src * (1 << d) + dst, minlength=1 << (2 * d))
    chi2 = float(((got - expect) ** 2 / expect).sum())
    z = float(np.abs((got - expect) / np.sqrt(expect * (1 - P.reshape(-1) / P.sum()))).max())
    return frac, want, float(stats.chi2.sf(chi2, expect.size - 1)), z


@pytest.mark.parametrize("tpu_native", [False, True], ids=["counter_hash", "philox"])
def test_descent_prng_law_at_d6(tpu_native):
    """Both streams draw cell (x, y) with probability P_xy / m: the level
    quadrant fractions within 0.01 over 2^16 slots, and a chi-square over
    the 4096 cells."""
    th = magm_paper.THETA_1[None].repeat(6, axis=0)
    src, dst = ops.sample_edge_batch_prng(prng.PRNGKey(11), th, 1 << 16, tpu_native=tpu_native, device="cpu")
    frac, want, p, z = _cell_law(src, dst, th)
    np.testing.assert_allclose(frac, want, atol=0.01)
    assert p > 1e-4, (p, z)


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


@pytest.mark.cuda
@pytest.mark.parametrize("d, slots", [(1, 1), (4, 1000), (6, 100_003), (15, 1 << 20), (31, 300_001)])
def test_cuda_quadrant_descent_native_equals_plain(cuda_device, d, slots):
    """The Philox kernel bit for bit against its plain version, through
    ``tpu_native=True``; one launch counted."""
    cum = ops._batch_cumprobs(_batch_thetas(d, d)).to(cuda_device)
    before = qd.NATIVE_LAUNCHES
    got = qd.quadrant_descent_prng(SEED, cum, num_slots=slots, tpu_native=True)
    torch.cuda.synchronize()
    assert qd.NATIVE_LAUNCHES == before + 1
    want = qd.quadrant_descent_native_plain(SEED, cum, num_slots=slots)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# --- quadrant_descent / quilt_descent_lookup: the uniforms-operand kernels ---


def _uniforms(n, d, seed, cum=None):
    """(n, d) float32 uniforms; with ``cum``, some set exactly on a threshold
    (the compares are >=)."""
    rng = np.random.default_rng(seed)
    u = rng.random((n, d), dtype=np.float32)
    if cum is not None:
        rows = rng.integers(0, n, n // 10)
        u[rows] = cum.numpy()[None, :, rng.integers(0, 3)]
    return torch.from_numpy(u)


def _pad_rows(x, tile):
    return np.concatenate([x, np.zeros((-x.shape[0] % tile,) + x.shape[1:], x.dtype)])


@pytest.mark.parametrize("n, d", [(1000, 3), (1537, 12), (512, 20)], ids=["ragged-d3", "ragged-d12", "tile-d20"])
def test_quadrant_descent_plain_matches_pallas(ref, n, d):
    """Against the Pallas kernel in interpret mode (the reference pads N to
    its 512-row tile; the port takes N as it is) and kernels/ref.py."""
    import jax.numpy as jnp
    cum = kpgm._level_cumprobs(torch.from_numpy(_batch_thetas(d, d)))
    u = _uniforms(n, d, n + d, cum)
    padded = jnp.asarray(_pad_rows(u.numpy(), ref.qd.TILE))
    want = ref.qd.quadrant_descent(padded, jnp.asarray(cum.numpy()), interpret=True)
    oracle = ref.kref.quadrant_descent_ref(jnp.asarray(u.numpy()), jnp.asarray(cum.numpy()))
    got = qd.quadrant_descent_plain(u, cum)
    for w, o, g in zip(want, oracle, got):
        assert g.dtype == torch.int32 and g.shape == (n,)
        assert np.array_equal(np.asarray(w)[:n], g.numpy())
        assert np.array_equal(np.asarray(o), g.numpy())


def _lookup_case(d, n_nodes, rows, seed, width_one=False):
    """Tables of a random attribute sample and per-row block ids; with
    ``width_one`` every config is distinct, so B = 1."""
    rng = np.random.default_rng(seed)
    lam = rng.permutation(1 << d)[:n_nodes] if width_one else rng.integers(0, 1 << d, n_nodes)
    part = partition.build_partition(lam)
    tab = partition.padded_lookup_tables(part)
    kb = rng.integers(0, part.B, rows).astype(np.int32)
    lb = rng.integers(0, part.B, rows).astype(np.int32)
    return part, tab, kb, lb


@pytest.mark.parametrize(
    "d, n_nodes, rows, width_one",
    [(10, 300, 1000, False), (12, 1500, 1100, False), (6, 5, 700, True)],
    ids=["misses-ragged", "ragged-d12", "B1-L8"],
)
def test_quilt_descent_lookup_plain_matches_pallas(ref, d, n_nodes, rows, width_one):
    """Descent + lookup against the Pallas kernel (interpret mode), padded
    as ops.quilt_descent_lookup_pallas pads, and against kernels/ref.py."""
    import jax.numpy as jnp
    part, tab, kb, lb = _lookup_case(d, n_nodes, rows, seed=d, width_one=width_one)
    cum = kpgm._level_cumprobs(torch.from_numpy(_batch_thetas(d, d + 1)))
    u = _uniforms(rows, d, rows, cum)
    j = dict(cum=jnp.asarray(cum.numpy()), cfg=jnp.asarray(tab.configs), node=jnp.asarray(tab.nodes))
    want = ref.ops.quilt_descent_lookup_pallas(
        jnp.asarray(u.numpy()), j["cum"], jnp.asarray(kb), jnp.asarray(lb), j["cfg"], j["node"]
    )
    oracle = ref.kref.quilt_descent_lookup_ref(
        jnp.asarray(u.numpy()), j["cum"], jnp.asarray(kb), jnp.asarray(lb), j["cfg"], j["node"]
    )
    got = qd.quilt_descent_lookup_plain(
        u, cum, torch.from_numpy(kb), torch.from_numpy(lb),
        torch.from_numpy(tab.configs), torch.from_numpy(tab.nodes),
    )
    for w, o, g in zip(want, oracle, got):
        assert g.dtype == torch.int32 and g.shape == (rows,)
        assert np.array_equal(np.asarray(w), g.numpy())
        assert np.array_equal(np.asarray(o), g.numpy())
    snode = got[2].numpy()
    assert (snode >= 0).any() and ((snode < 0).any() or width_one)
    # the host oracle: partition.lookup_nodes row by row
    for b in range(part.B):
        sel = kb == b
        nodes = partition.lookup_nodes(part.sorted_configs[b], part.sorted_nodes[b], got[0].numpy()[sel])
        assert np.array_equal(nodes, snode[sel])


def test_quilt_descent_lookup_wide_rows(ref):
    """A 41,432-wide block row (the n = 2^16 paper plan's width) against the
    reference's oracle; rows outside [0, B) miss."""
    import jax.numpy as jnp
    d, width, rows = 16, 41_432, 4000
    rng = np.random.default_rng(16)
    cfg = np.sort(rng.choice(1 << d, width, replace=False)).astype(np.int32)[None, :]
    node = rng.permutation(width).astype(np.int32)[None, :]
    cum = kpgm._level_cumprobs(torch.from_numpy(_batch_thetas(d, 3)))
    u = _uniforms(rows, d, 5)
    kb = np.zeros(rows, np.int32)
    want = ref.kref.quilt_descent_lookup_ref(
        jnp.asarray(u.numpy()), jnp.asarray(cum.numpy()), jnp.asarray(kb), jnp.asarray(kb),
        jnp.asarray(cfg), jnp.asarray(node),
    )
    got = qd.quilt_descent_lookup_plain(
        u, cum, torch.from_numpy(kb), torch.from_numpy(kb), torch.from_numpy(cfg), torch.from_numpy(node)
    )
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert (got[2] >= 0).any() and (got[2] < 0).any()
    outside = qd.quilt_descent_lookup_plain(
        u[:5], cum, torch.full((5,), 1, dtype=torch.int32), torch.full((5,), -1, dtype=torch.int32),
        torch.from_numpy(cfg), torch.from_numpy(node),
    )
    assert (outside[2] == -1).all() and (outside[3] == -1).all()


def test_sample_edge_batch_matches_pallas_batch(ref):
    """ops.sample_edge_batch against the reference's sample_edge_batch_pallas
    (threefry draw padded to 512 rows, eager cum) at a ragged N; the CPU
    wrapper counts no launch."""
    import jax

    th = _batch_thetas(9, 8)
    key = jax.random.PRNGKey(31)
    want = ref.ops.sample_edge_batch_pallas(key, jax.numpy.asarray(th), 1300)
    before = ops.kernel_launches()["quadrant_descent"]
    got = ops.sample_edge_batch(prng.PRNGKey(31), th, 1300, device="cpu")
    assert ops.kernel_launches()["quadrant_descent"] == before
    for w, g in zip(want, got):
        assert torch.equal(torch.from_numpy(np.array(w)), g)


@pytest.mark.parametrize("chunk_elems", [1, 7 * 11, 1 << 26], ids=["row", "ragged", "whole"])
def test_chunked_draw_equals_whole_draw(ref, monkeypatch, chunk_elems):
    """kpgm.descend_draw in row chunks (prng.uniform's offset) equals the
    reference's one-shot sample_edge_batch; chunk offsets land mid-draw."""
    import jax

    monkeypatch.setattr(kpgm, "DRAW_CHUNK_ELEMS", chunk_elems)
    th = _batch_thetas(11, 9)
    want = ref.kpgm.sample_edge_batch(jax.random.PRNGKey(8), jax.numpy.asarray(th), 1300)
    cum = kpgm._level_cumprobs(torch.from_numpy(th))
    got = kpgm.descend_draw(prng.PRNGKey(8), cum, 1300)
    for w, g in zip(want, got):
        assert torch.equal(torch.from_numpy(np.array(w)), g)


def test_uniform_offset_equals_slice_of_whole_draw(ref):
    import jax

    whole = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (300, 7)))
    for row0, rows in ((0, 300), (37, 100), (299, 1)):
        part = prng.uniform(prng.PRNGKey(2), (rows, 7), offset=row0 * 7)
        assert np.array_equal(whole[row0 : row0 + rows], part.numpy())


def test_uniforms_wrappers_run_plain_on_cpu_and_raise_elsewhere():
    cum = kpgm._level_cumprobs(torch.from_numpy(_batch_thetas(5, 4)))
    u = _uniforms(100, 5, 1)
    part, tab, kb, lb = _lookup_case(5, 20, 100, seed=2)
    tables = (torch.from_numpy(tab.configs), torch.from_numpy(tab.nodes))
    before = ops.kernel_launches()
    assert all(torch.equal(a, b) for a, b in zip(qd.quadrant_descent(u, cum), qd.quadrant_descent_plain(u, cum)))
    got = qd.quilt_descent_lookup(u, cum, torch.from_numpy(kb), torch.from_numpy(lb), *tables)
    want = qd.quilt_descent_lookup_plain(u, cum, torch.from_numpy(kb), torch.from_numpy(lb), *tables)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    inv = torch.from_numpy(partition.dense_inverse(part, 5))
    got = qd.quilt_descent_lookup(u, cum, torch.from_numpy(kb), torch.from_numpy(lb), *tables, inv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.kernel_launches() == before
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        qd.quadrant_descent(u.to(meta), cum.to(meta))
    with pytest.raises(ValueError, match="no kernel for device"):
        qd.quilt_descent_lookup(u.to(meta), cum.to(meta), *(t.to(meta) for t in (
            torch.from_numpy(kb), torch.from_numpy(lb), *tables)))


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", [(1, 3), (100_003, 16), (1 << 20, 31), (3_355_443, 20)])
def test_cuda_quadrant_descent_equals_plain(cuda_device, n, d):
    """The kernel against its plain version; d = 20 at the KPGM host loop's
    draw chunk (DRAW_CHUNK_ELEMS // 20 rows), where a 256-row tile ends
    mid-row and load_tile carries a remainder."""
    cum = kpgm._level_cumprobs(torch.from_numpy(_batch_thetas(d, d))).to(cuda_device)
    u = _uniforms(n, d, d, cum.cpu()).to(cuda_device)
    before = qd.DESCENT_LAUNCHES
    got = qd.quadrant_descent(u, cum)
    torch.cuda.synchronize()
    assert qd.DESCENT_LAUNCHES == before + 1
    want = qd.quadrant_descent_plain(u, cum)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", ["random", "contiguous"])
@pytest.mark.parametrize("arm", ["search", "inverse"])
@pytest.mark.parametrize("n_nodes, d", [(300, 10), (30_000, 15)], ids=["smem", "global"])
def test_cuda_quilt_descent_lookup_equals_plain(cuda_device, n_nodes, d, arm, ranks):
    """Both arms of the kernel (the dense inverse's gather, the tables'
    search) against the plain version, which searches the tables: a ragged
    row count, rows on the thresholds, block ids outside [0, B), and block
    ids at random (ball dropping) or grouped by graph (the quilt host
    path)."""
    rows = 100_003
    part, tab, kb, lb = _lookup_case(d, n_nodes, rows, seed=d)
    if ranks == "contiguous":
        g = np.sort(np.random.default_rng(d).integers(0, part.B * part.B, rows)).astype(np.int32)
        kb, lb = g // part.B, g % part.B
    cum = kpgm._level_cumprobs(torch.from_numpy(_batch_thetas(d, 7))).to(cuda_device)
    u = _uniforms(rows, d, 3, cum.cpu()).to(cuda_device)
    args = [torch.from_numpy(x).to(cuda_device) for x in (kb, lb, tab.configs, tab.nodes)]
    args[1][:7] = part.B  # rows outside the tables miss
    args[0][7:9] = -1
    inv = torch.from_numpy(partition.dense_inverse(part, d)).to(cuda_device) if arm == "inverse" else None
    before = qd.LOOKUP_LAUNCHES
    got = qd.quilt_descent_lookup(u, cum, *args, inv)
    torch.cuda.synchronize()
    assert qd.LOOKUP_LAUNCHES == before + 1
    want = qd.quilt_descent_lookup_plain(u, cum, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (got[3][:7] == -1).all() and (got[2][7:9] == -1).all()
    assert (got[2] >= 0).any()
    assert qd.descent_tables_in_shared_memory(d, args[2]) == (n_nodes == 300)


@pytest.mark.cuda
def test_cuda_quilt_descent_lookup_rejects_bad_inverse(cuda_device):
    part, tab, kb, lb = _lookup_case(10, 300, 1000, seed=1)
    cum = kpgm._level_cumprobs(torch.from_numpy(_batch_thetas(10, 7))).to(cuda_device)
    u = _uniforms(1000, 10, 3).to(cuda_device)
    args = [torch.from_numpy(x).to(cuda_device) for x in (kb, lb, tab.configs, tab.nodes)]
    inv = torch.from_numpy(partition.dense_inverse(part, 10)).to(cuda_device)
    with pytest.raises(ValueError, match="inv must be"):
        qd.quilt_descent_lookup(u, cum, *args, inv[:, :512].contiguous())
    with pytest.raises(TypeError, match="inv must be contiguous int32"):
        qd.quilt_descent_lookup(u, cum, *args, inv.long())


@pytest.mark.cuda
def test_cuda_chunked_draw_equals_cpu(cuda_device):
    th = torch.from_numpy(_batch_thetas(12, 2))
    got = kpgm.sample_edge_batch(prng.PRNGKey(4), th, 300_001, device=cuda_device)
    want = kpgm.sample_edge_batch(prng.PRNGKey(4), th, 300_001, device="cpu")
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
