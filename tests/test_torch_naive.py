"""The naive O(n^2) baseline: ``prng.uniform`` with the naive draw's
subnormal ``minval`` bit for bit, ``naive.sample_tile``, ``naive_sample``
and ``quilt.naive_reference_sample`` against the reference, and the card
against the CPU (marked ``cuda``, skipped elsewhere).

Tolerance: the edges are equal except in cells where |log u - log q| <=
2e-4, where the log-Q products, summed in another order than the
reference's, can flip the compare (``test_torch_tiles.assert_band_only``
also bounds how many cells that band may hold).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import cuda_device, ref  # noqa: F401  (fixtures)
from test_torch_tiles import assert_band_only

from repro_torch.configs.magm_paper import THETA_1
from repro_torch.core import f32math, magm, naive, prng, quilt


def _adj(edges, n):
    a = np.zeros((n, n), dtype=bool)
    a[edges[:, 0], edges[:, 1]] = True
    return a


def _case(n=300, d=8, mu=0.5, seed=0):
    """THETA_1 at depth d, attributes drawn with numpy from a seed."""
    F = (np.random.default_rng(seed).random((n, d)) < mu).astype(np.int8)
    return magm.make_params(THETA_1, mu, d), F


@pytest.mark.parametrize(
    "seed, shape, lo, hi",
    [(0, (1 << 20,), 1e-38, 1.0), (0, (4276094,), 1e-38, 1.0), (9, (1024, 1024), 1e-38, 1.0),
     (3, (1 << 16,), -2.5, 3.0)],
    ids=["naive-2^20", "naive-zero-draw", "naive-2d", "affine"],
)
def test_uniform_bits_match_jax(seed, shape, lo, hi):
    """``naive-zero-draw`` ends at the first zero mantissa of key 0: the
    reference reads the subnormal 1e-38 as 0 there (denormals-are-zero) and
    returns +0.0.  ``affine`` checks the fused (f * span + minval)."""
    import jax

    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=lo, maxval=hi))
    got = prng.uniform(prng.PRNGKey(seed), shape, minval=lo, maxval=hi).numpy()
    assert got.dtype == np.float32 and got.shape == tuple(shape)
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))
    if shape == (4276094,):
        assert got[-1] == 0.0 and got.view(np.uint32)[-1] == 0


def _tile_logs(key, F_rows, F_cols, thetas):
    logu = f32math.log(prng.uniform(key, (F_rows.shape[0], F_cols.shape[0]), minval=1e-38, maxval=1.0))
    logq = magm.log_edge_prob(torch.as_tensor(F_rows), torch.as_tensor(F_cols), thetas)
    return logu.numpy(), logq.numpy()


def _walk_logs(key, F, thetas, tile):
    """(n, n) log u and log q of every cell, by naive_sample's key walk."""
    n = F.shape[0]
    logu, logq = np.zeros((n, n)), np.zeros((n, n))
    for i0 in range(0, n, tile):
        for j0 in range(0, n, tile):
            key, sub = prng.split(key)
            cells = np.s_[i0:i0 + tile, j0:j0 + tile]
            logu[cells], logq[cells] = _tile_logs(sub, F[i0:i0 + tile], F[j0:j0 + tile], thetas)
    return logu, logq


def test_sample_tile_matches_reference(ref):
    import jax.numpy as jnp

    params, F = _case(n=200, d=10, seed=1)
    kd = np.array([0, 77], dtype=np.uint32)
    key = torch.from_numpy(kd.astype(np.int64))
    rows, cols = F[:130], F[50:]
    want = np.asarray(ref.naive.sample_tile(jnp.asarray(kd), jnp.asarray(rows), jnp.asarray(cols),
                                            jnp.asarray(params.thetas.numpy())))
    got = naive.sample_tile(key, torch.from_numpy(rows), torch.from_numpy(cols), params.thetas)
    assert got.dtype == torch.bool and got.shape == (130, 150)
    assert_band_only(got.numpy(), want, *_tile_logs(key, rows, cols, params.thetas), "sample_tile")
    count = naive.count_edges_tile(key, torch.from_numpy(rows), torch.from_numpy(cols), params.thetas)
    assert int(count) == int(got.sum()) > 0


def test_naive_sample_matches_reference_ragged_tiles(ref):
    """n = 300 in tiles of 128: nine tiles, five of them ragged."""
    import jax.numpy as jnp

    n, tile = 300, 128
    params, F = _case(n=n, seed=2)
    kd = np.array([0, 5], dtype=np.uint32)
    want = ref.naive.naive_sample(jnp.asarray(kd), ref.magm.MAGMParams(
        jnp.asarray(params.thetas.numpy()), jnp.asarray(params.mu.numpy())), F, tile=tile)
    key = torch.from_numpy(kd.astype(np.int64))
    got = naive.naive_sample(key, params, F, tile=tile, device="cpu")
    assert got.dtype == np.int64 and got.shape[1] == 2 and got.shape[0] > 500
    logu, logq = _walk_logs(key, F, params.thetas, tile)
    flips, _ = assert_band_only(_adj(got, n), _adj(want, n), logu, logq, "naive_sample")
    if not flips:
        assert np.array_equal(got, want)  # same cells, same order


def test_naive_reference_sample_matches_reference(ref):
    import jax.numpy as jnp

    n = 150
    params, F = _case(n=n, d=7, seed=3)
    kd = np.array([0, 11], dtype=np.uint32)
    want = ref.quilt.naive_reference_sample(jnp.asarray(kd), ref.magm.MAGMParams(
        jnp.asarray(params.thetas.numpy()), jnp.asarray(params.mu.numpy())), F)
    key = torch.from_numpy(kd.astype(np.int64))
    got = quilt.naive_reference_sample(key, params, F, device="cpu")
    assert got.dtype == np.int64 and got.shape[0] > 100
    logu = np.log(prng.uniform(key, (n, n)).numpy().astype(np.float64))
    logq = magm.log_edge_prob(torch.from_numpy(F), torch.from_numpy(F), params.thetas).numpy()
    flips, _ = assert_band_only(_adj(got, n), _adj(want, n), logu, logq, "naive_reference_sample")
    if not flips:
        assert np.array_equal(got, want)


def test_naive_counts_agree_with_expected_edges():
    """Sanity of the law, not of the bits: the naive count at n = 512 lies
    within 4 sigma of sum Q (computed in float64 from the dense log Q)."""
    params, F = _case(n=512, d=9, seed=4)
    e = naive.naive_sample(prng.PRNGKey(3), params, F, device="cpu")
    q = np.exp(magm.log_edge_prob(torch.from_numpy(F), torch.from_numpy(F), params.thetas).numpy().astype(np.float64))
    mean, sd = q.sum(), np.sqrt((q * (1 - q)).sum())
    assert abs(e.shape[0] - mean) <= 4 * sd, (e.shape[0], mean, sd)
    assert len({(a, b) for a, b in e.tolist()}) == e.shape[0]


def test_entry_points_default_to_cuda():
    params, F = _case(n=16, d=4)
    calls = [
        lambda: naive.naive_sample(prng.PRNGKey(0), params, F),
        lambda: quilt.naive_reference_sample(prng.PRNGKey(0), params, F),
    ]
    for call in calls:
        if torch.cuda.is_available():
            assert call().ndim == 2
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


@pytest.mark.cuda
def test_cuda_naive_sample_equals_cpu(cuda_device):
    """The bernoulli_tile kernel through naive_sample, against the CPU run:
    the same key walk and draws, so equal edges outside the band."""
    from repro_torch.kernels import ops

    n, tile = 1 << 10, 384
    params, F = _case(n=n, d=10, seed=5)
    ops.reset_kernel_launches()
    got = naive.naive_sample(prng.PRNGKey(8), params, F, tile=tile, device=cuda_device)
    assert ops.kernel_launches()["bernoulli_tile"] == 9
    want = naive.naive_sample(prng.PRNGKey(8), params, F, tile=tile, device="cpu")
    logu, logq = _walk_logs(prng.PRNGKey(8), F, params.thetas, tile)
    assert_band_only(_adj(got, n), _adj(want, n), logu, logq, "cuda naive_sample")
