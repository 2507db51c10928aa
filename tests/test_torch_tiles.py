"""The log-Q tile kernels: ``magm_logprob`` and the naive sampler's fused
``bernoulli_tile``.  Their plain versions (and the ``ops`` entry points)
against the reference's Pallas kernels in interpret mode, the bilinear
terms bit for bit, and the CUDA kernels against the plain versions on a
card (marked ``cuda``, skipped elsewhere).

Tolerances:
- log Q: ``atol=2e-4``, the reference's own (``tests/test_kernels.py``),
  for float32 dots summed in another order (the Pallas kernel pads d to
  128 and reduces with XLA's dot, the port sums sequentially).
- Bernoulli masks: equal outside the band |log u - log q| <= 2e-4, where
  that log-Q difference can flip the compare; the band must hold no more
  cells than three times its expected count (2 * 2e-4 * sum Q) plus five.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import cuda_device, ref  # noqa: F401  (fixtures)

from repro_torch.core import f32math, magm, prng
from repro_torch.kernels import bernoulli_tile as bt
from repro_torch.kernels import magm_logprob as ml
from repro_torch.kernels import ops

LOGQ_ATOL = 2e-4
BAND = 2e-4
SHAPES = [
    (8, 8, 3), (100, 260, 7), (256, 256, 12), (300, 513, 20),
    # one row and one column past the CUDA tile's 128 x 128 edges; d > 32
    # (three 16-deep chunks); a single row
    (129, 257, 15), (130, 70, 33), (1, 300, 15),
]
SHAPE_IDS = [f"{m}x{n}x{d}" for m, n, d in SHAPES]
# (M, N, d, F row offset, extra log-u row stride): every path of the CUDA
# tile kernels.  N % 4 != 0 (513, 257, 70, 258) and an odd log-u stride take
# the scalar stores and loads; N % 16 == 0 with log u contiguous the vector
# ones; an offset of one row at d = 15 gives F bases that are not 16 B
# aligned; d = 0 leaves only c0; 8192^2 is MAGFIT's dense scoring.
CUDA_CASES = [(m, n, d, 0, 37) for m, n, d in SHAPES] + [
    (2048, 2048, 15, 0, 37), (70, 90, 40, 0, 37), (2048, 2048, 15, 0, 0), (256, 258, 12, 0, 0),
    (2048, 2048, 15, 1, 37), (300, 512, 15, 1, 0), (200, 300, 0, 0, 0), (8192, 8192, 15, 0, 0),
]
CUDA_IDS = SHAPE_IDS + ["2048x2048x15", "70x90x40"] + [
    f"{m}x{n}x{d}-off{o}-ld{n + x}" for m, n, d, o, x in CUDA_CASES[len(SHAPES) + 2:]
]


def _thetas(rng, d):
    """Thetas whose product over d levels stays near the size of three
    levels' product, so Q is far from 0 at every d (masks have many ones)."""
    return (rng.uniform(0.05, 1.0, (d, 2, 2)) ** (3.0 / max(d, 1))).astype(np.float32)


def _inputs(M, N, d, seed=0, hard=False):
    rng = np.random.default_rng(seed)
    if hard:
        fs, ft = (rng.integers(0, 2, (m, d)).astype(np.int8) for m in (M, N))
    else:
        fs, ft = (rng.random((m, d)).astype(np.float32) for m in (M, N))
    return fs, ft, _thetas(rng, d)


def _packed(th):
    return ops._packed_bilinear(torch.from_numpy(th), torch.device("cpu"))


def assert_band_only(got, want, logu, logq, what):
    """Masks equal outside |logu - logq| <= BAND; the band is small."""
    got, want = np.asarray(got).astype(bool), np.asarray(want).astype(bool)
    logu, logq = np.asarray(logu, np.float64), np.asarray(logq, np.float64)
    band = np.abs(logu - logq) <= BAND
    outside = (got != want) & ~band
    assert not outside.any(), f"{what}: {int(outside.sum())} mismatches outside the band"
    expected = 2 * BAND * np.exp(np.minimum(logq, 0.0)).sum()
    assert band.sum() <= 3 * expected + 5, (
        f"{what}: band holds {int(band.sum())} cells, expected ~{expected:.1f}"
    )
    return int((got != want).sum()), int(band.sum())


@pytest.mark.parametrize("d", [1, 3, 15, 31])
def test_bilinear_decompose_bit_identical(ref, d):
    import jax.numpy as jnp

    th = _thetas(np.random.default_rng(d), d)
    th[0, 0, 0] = 0.0  # clipped to eps before the log
    want = ref.magm.bilinear_decompose(jnp.asarray(th))
    got = magm.bilinear_decompose(torch.from_numpy(th))
    for name in ("c0", "u", "v", "w"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == np.float32 and np.array_equal(w.view(np.uint32), g.view(np.uint32)), name


def test_dense_magm_math_matches_reference(ref):
    """log_edge_prob, edge_prob_matrix, log_prob_pairs within the log-Q
    tolerance; expected_edges to float32 rounding (rtol 1e-6)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    d, n = 9, 70
    th = _thetas(rng, d)
    F = rng.integers(0, 2, (n, d)).astype(np.int8)
    Fj, thj = jnp.asarray(F), jnp.asarray(th)
    Ft, tht = torch.from_numpy(F), torch.from_numpy(th)
    np.testing.assert_allclose(
        magm.log_edge_prob(Ft[:40], Ft, tht).numpy(),
        np.asarray(ref.magm.log_edge_prob(Fj[:40], Fj, thj)), rtol=0, atol=LOGQ_ATOL,
    )
    np.testing.assert_allclose(
        magm.edge_prob_matrix(Ft, tht).numpy(), np.asarray(ref.magm.edge_prob_matrix(Fj, thj)),
        rtol=0, atol=LOGQ_ATOL,
    )
    src, dst = rng.integers(0, n, 500), rng.integers(0, n, 500)
    np.testing.assert_allclose(
        magm.log_prob_pairs(Ft, tht, torch.from_numpy(src), torch.from_numpy(dst)).numpy(),
        np.asarray(ref.magm.log_prob_pairs(Fj, thj, jnp.asarray(src), jnp.asarray(dst))),
        rtol=0, atol=LOGQ_ATOL,
    )
    mu = rng.uniform(0.1, 0.9, d).astype(np.float32)
    want = ref.magm.expected_edges(ref.magm.MAGMParams(thj, jnp.asarray(mu)), 1 << 12)
    got = magm.expected_edges(magm.MAGMParams(tht, torch.from_numpy(mu)), 1 << 12)
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("M, N, d", SHAPES, ids=SHAPE_IDS)
def test_magm_logprob_plain_and_ops_match_pallas(ref, M, N, d):
    import jax.numpy as jnp

    fs, ft, th = _inputs(M, N, d, seed=M + N + d)
    want = np.asarray(ref.ops.magm_logprob_pallas(jnp.asarray(fs), jnp.asarray(ft), jnp.asarray(th)))
    plain = ml.magm_logprob_plain(torch.from_numpy(fs), torch.from_numpy(ft), *_packed(th)).numpy()
    via_ops = ops.magm_logprob(torch.from_numpy(fs), torch.from_numpy(ft), torch.from_numpy(th)).numpy()
    for name, got in (("plain", plain), ("ops", via_ops)):
        err = float(np.abs(got - want).max())
        assert got.shape == (M, N) and got.dtype == np.float32
        assert err <= LOGQ_ATOL, f"{name}: max |err| {err:.3g} > {LOGQ_ATOL} at {M}x{N}x{d}"


@pytest.mark.parametrize("M, N, d", SHAPES[1:], ids=SHAPE_IDS[1:])
def test_bernoulli_tile_plain_matches_pallas(ref, M, N, d):
    """The same log-uniforms (numpy, from a seed) into both tiles; the
    reference's kernel takes its padded operands as its ``ops`` pads them."""
    import jax.numpy as jnp

    fs, ft, th = _inputs(M, N, d, seed=7 * d, hard=True)
    rng = np.random.default_rng(d)
    logu = np.log(rng.uniform(1e-7, 1.0, (M, N))).astype(np.float32)
    pad = ref.ops._pad_to
    fsj = pad(pad(jnp.asarray(fs, jnp.float32), 0, ref.bt.BM), 1, 128)
    ftj = pad(pad(jnp.asarray(ft, jnp.float32), 0, ref.bt.BN), 1, 128)
    luj = pad(pad(jnp.asarray(logu), 0, ref.bt.BM), 1, ref.bt.BN)
    want = np.asarray(
        ref.bt.bernoulli_tile(fsj, ftj, *ref.ops._packed_bilinear(jnp.asarray(th), 128), luj, interpret=True)
    )[:M, :N]
    got = bt.bernoulli_tile_plain(
        torch.from_numpy(fs).float(), torch.from_numpy(ft).float(), *_packed(th), torch.from_numpy(logu)
    )
    assert got.dtype == torch.int8 and got.shape == (M, N)
    logq = ml.magm_logprob_plain(torch.from_numpy(fs).float(), torch.from_numpy(ft).float(), *_packed(th))
    assert_band_only(got.numpy(), want, logu, logq.numpy(), f"bernoulli_tile_plain {M}x{N}x{d}")
    assert 0.01 < want.mean() < 0.99


@pytest.mark.parametrize("M, N, d", SHAPES, ids=SHAPE_IDS)
def test_bernoulli_sample_matches_pallas_for_same_key(ref, M, N, d):
    """ops.bernoulli_sample draws over the 256-padded shape as the reference
    does, so one key gives one mask (outside the band)."""
    import jax.numpy as jnp

    fs, ft, th = _inputs(M, N, d, seed=3 * d, hard=True)
    kd = np.array([0, 1000 + d], dtype=np.uint32)
    want = np.asarray(ref.ops.bernoulli_sample_pallas(jnp.asarray(kd), fs, ft, jnp.asarray(th)))
    key = torch.from_numpy(kd.astype(np.int64))
    got = ops.bernoulli_sample(key, torch.from_numpy(fs), torch.from_numpy(ft), torch.from_numpy(th))
    assert got.dtype == torch.int8 and got.shape == (M, N)
    shape = tuple(-(-m // 256) * 256 for m in (M, N))
    logu = f32math.log(prng.uniform(key, shape, minval=1e-38, maxval=1.0))[:M, :N]
    logq = ml.magm_logprob_plain(torch.from_numpy(fs).float(), torch.from_numpy(ft).float(), *_packed(th))
    assert_band_only(got.numpy(), want, logu.numpy(), logq.numpy(), f"bernoulli_sample {M}x{N}x{d}")


def test_tile_wrappers_run_plain_on_cpu_and_count_no_launch():
    fs, ft, th = _inputs(40, 70, 5, seed=2)
    args = (torch.from_numpy(fs), torch.from_numpy(ft), *_packed(th))
    before = ops.kernel_launches()
    assert torch.equal(ml.magm_logprob(*args), ml.magm_logprob_plain(*args))
    logu = torch.log(torch.rand(40, 70, generator=torch.Generator().manual_seed(0)))
    assert torch.equal(bt.bernoulli_tile(*args, logu), bt.bernoulli_tile_plain(*args, logu))
    assert ops.kernel_launches() == before


def test_tile_wrappers_raise_on_other_devices():
    meta = torch.device("meta")
    fs, ft, th = _inputs(4, 4, 2)
    args = [torch.from_numpy(fs).to(meta), torch.from_numpy(ft).to(meta), *(t.to(meta) for t in _packed(th))]
    with pytest.raises(ValueError, match="no kernel for device"):
        ml.magm_logprob(*args)
    with pytest.raises(ValueError, match="no kernel for device"):
        bt.bernoulli_tile(*args, torch.zeros(4, 4, device=meta))
    with pytest.raises(TypeError, match="torch.Tensor"):
        ops.magm_logprob(fs, ft, torch.from_numpy(th))


@pytest.mark.cuda
@pytest.mark.parametrize("M, N, d, off, pad", CUDA_CASES, ids=CUDA_IDS)
def test_cuda_tiles_equal_plain(cuda_device, M, N, d, off, pad):
    fs, ft, th = _inputs(M + off, N + off, d, seed=d, hard=M == 2048)
    # d = 0 has no thetas to decompose: c0 alone, the bilinear terms empty
    packed = _packed(th) if d else (*(torch.zeros(0) for _ in range(3)), torch.tensor([-1.5]))
    args = [torch.from_numpy(fs).float().to(cuda_device)[off:], torch.from_numpy(ft).float().to(cuda_device)[off:],
            *(t.to(cuda_device) for t in packed)]
    before = ops.kernel_launches()
    got = ml.magm_logprob(*args)
    want = ml.magm_logprob_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= LOGQ_ATOL, f"max |err| {err:.3g} at {M}x{N}x{d}"
    # log u as a corner of a wider draw (row stride N + pad), as
    # ops.bernoulli_sample reads it
    wide = prng.uniform(prng.PRNGKey(d), (M, N + pad), minval=1e-38, maxval=1.0, device=cuda_device)
    logu = f32math.log(wide)[:, :N]
    mask = bt.bernoulli_tile(*args, logu)
    plain = bt.bernoulli_tile_plain(*args, logu)
    torch.cuda.synchronize()
    assert_band_only(mask.cpu().numpy(), plain.cpu().numpy(), logu.cpu().numpy(), want.cpu().numpy(), "cuda tile")
    after = ops.kernel_launches()
    assert after["magm_logprob"] == before["magm_logprob"] + 1
    assert after["bernoulli_tile"] == before["bernoulli_tile"] + 1
