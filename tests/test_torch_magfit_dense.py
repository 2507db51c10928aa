"""MAGFIT's dense scoring: ``dense_expected_logprob`` (plain products and the
``magm_logprob`` tile) and ``elbo_dense`` against the reference at n = 24,
the soft attributes carried over by ``interop.from_reference``, and the
tile kernel on the card against its plain version (marked ``cuda``).

Tolerance: ``rtol=1e-5`` (with ``atol=1e-5`` for log-Q entries near 0):
float32 products and sums taken in another order than the reference's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import cuda_device, ref  # noqa: F401  (fixtures)

from repro_torch import interop
from repro_torch.fit import magfit
from repro_torch.kernels import ops

RTOL = 1e-5
N = 24


def _case(d=6, seed=0):
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0.02, 0.98, (N, d)).astype(np.float32)
    th = rng.uniform(0.1, 0.95, (d, 2, 2)).astype(np.float32)
    mu = rng.uniform(0.2, 0.8, d).astype(np.float32)
    pairs = rng.integers(0, N, (60, 2))
    edges = np.unique(pairs, axis=0)
    return phi, th, mu, edges


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_dense_expected_logprob_matches_reference(ref, use_kernel):
    import jax.numpy as jnp

    phi, th, _, _ = _case()
    want = np.asarray(ref.magfit.dense_expected_logprob(jnp.asarray(phi), jnp.asarray(th), use_kernel=use_kernel))
    before = ops.kernel_launches()
    got = magfit.dense_expected_logprob(phi, th, use_kernel=use_kernel, device="cpu")
    assert ops.kernel_launches() == before  # the CPU runs the plain version
    assert got.shape == (N, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_elbo_dense_matches_reference(ref, order, use_kernel):
    import jax.numpy as jnp

    phi, th, mu, edges = _case(d=5, seed=order)
    want = float(ref.magfit.elbo_dense(jnp.asarray(phi), jnp.asarray(th), jnp.asarray(mu), edges, N,
                                       order=order, use_kernel=use_kernel))
    got = magfit.elbo_dense(phi, th, mu, edges, N, order=order, use_kernel=use_kernel, device="cpu")
    assert got.ndim == 0 and got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=RTOL)


def test_interop_carries_soft_attributes(ref):
    """MAGFIT's phi goes through from_reference unchanged and scores the
    same as on the reference."""
    import jax
    import jax.numpy as jnp

    phi, th, mu, edges = _case(d=4, seed=9)
    params, phi_t, key = interop.from_reference(th, phi, np.asarray(jax.random.key_data(jax.random.PRNGKey(3))))
    assert phi_t.dtype == np.float32 and np.array_equal(phi_t, phi)
    assert np.array_equal(params.thetas.numpy(), th) and key.tolist() == [0, 3]
    np.testing.assert_allclose(params.mu.numpy(), phi.mean(axis=0), rtol=1e-6)
    want = float(ref.magfit.elbo_dense(jnp.asarray(phi), jnp.asarray(th), jnp.asarray(mu), edges, N))
    got = magfit.elbo_dense(phi_t, params.thetas, mu, edges, N, device="cpu")
    assert float(got) == pytest.approx(want, rel=RTOL)


def test_dense_scoring_defaults_to_cuda():
    phi, th, mu, edges = _case()
    calls = [
        lambda: magfit.dense_expected_logprob(phi, th, use_kernel=True),
        lambda: magfit.elbo_dense(phi, th, mu, edges, N),
    ]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


@pytest.mark.cuda
def test_cuda_dense_scoring_uses_the_kernel(cuda_device):
    phi, th, mu, edges = _case(d=12, seed=4)
    ops.reset_kernel_launches()
    got = magfit.dense_expected_logprob(phi, th, use_kernel=True, device=cuda_device)
    assert ops.kernel_launches()["magm_logprob"] == 1
    want = magfit.dense_expected_logprob(phi, th, use_kernel=False, device=cuda_device)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2e-4
    e_kernel = magfit.elbo_dense(phi, th, mu, edges, N, use_kernel=True, device=cuda_device)
    e_plain = magfit.elbo_dense(phi, th, mu, edges, N, device="cpu")
    assert float(e_kernel) == pytest.approx(float(e_plain), rel=RTOL)
