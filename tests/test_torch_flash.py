"""The port's flash attention (``repro_torch.models.flash``) against the
reference's ``repro.models.flash`` and both packages' dense softmax oracle
``ref_attention``: mask modes, GQA ratios, a ``q_offset`` continuation,
chunk shapes and extreme logits; and the backward (``_Flash``, the
reference's custom VJP) against ``jax.vjp`` of the reference's
``flash_attention``, and a float64 ``torch.autograd.gradcheck``.  Inputs
from a seeded numpy generator; the reference runs under the ``ref``
fixture.  Tolerances: the forward 1e-5 abs (float32 sums in another
order); dq, dk, dv in float32 within 1e-5 x max|grad|, in bf16 within
BF16_GRAD_REL x max|grad| (bf16 inputs and outputs, ``ds`` and ``p``
rounded to bf16 before their products, as the reference rounds them).
"""

from __future__ import annotations

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.models import flash
from test_torch_reference import ref  # noqa: F401  (fixture)

ATOL = 1e-5
GRAD_REL = 1e-5
BF16_GRAD_REL = 2.0**-7  # two bf16 ulps at max|grad|


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def rflash(ref):
    """The reference's ``repro.models.flash`` (unloaded with ``ref``), its
    ``flash_attention`` compiled whole, once per static configuration."""
    import jax

    mod = importlib.import_module("repro.models.flash")
    def vjp(q, k, v, dout, *static):
        out, back = jax.vjp(lambda q, k, v: mod.flash_attention(q, k, v, *static), q, k, v)
        return (out, *back(dout))

    return types.SimpleNamespace(
        flash_attention=jax.jit(mod.flash_attention, static_argnums=(3, 4, 5, 6, 7)),
        vjp=jax.jit(vjp, static_argnums=(4, 5, 6, 7, 8)),
        ref_attention=jax.jit(mod.ref_attention, static_argnames=("causal", "window", "q_offset")),
    )


def _inputs(b, sq, sk, h, kv, hd, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sq, h, hd)) * scale).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    return q, k, v


def _both(rflash, q, k, v, *args):
    """(port, reference) flash_attention outputs as numpy arrays."""
    import jax.numpy as jnp

    got = flash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), *args).numpy()
    want = np.asarray(rflash.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), *args))
    return got, want


def _close(what, got, want, atol=ATOL):
    err = float(np.abs(got - want).max())
    print(f"{what}: max |port - reference| = {err:.3g} (bound {atol})")
    assert got.shape == want.shape and err <= atol, (what, err)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
def test_forward_matches_reference_and_oracle(rflash, causal, window, h, kv):
    import jax.numpy as jnp

    q, k, v = _inputs(2, 32, 32, h, kv, 8, seed=h * 10 + window)
    got, want = _both(rflash, q, k, v, causal, window, 0, 8, 16)
    _close("flash_attention", got, want)
    rep = h // kv
    kr, vr = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    oracle = flash.ref_attention(torch.from_numpy(q), torch.from_numpy(kr), torch.from_numpy(vr),
                                 causal=causal, window=window).numpy()
    ref_oracle = np.asarray(rflash.ref_attention(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
                                                 causal=causal, window=window))
    _close("ref_attention", oracle, ref_oracle)
    _close("flash vs the port's oracle", got, oracle, atol=2e-5)  # the reference test's bound


def test_q_offset_prefill_continuation(rflash):
    """q_offset shifts the causal frontier like a cache continuation."""
    q, k, v = _inputs(1, 8, 32, 4, 4, 8, seed=2)
    got, want = _both(rflash, q, k, v, True, 0, 24, 8, 16)
    _close("q_offset=24", got, want)
    oracle = flash.ref_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, q_offset=24).numpy()
    _close("q_offset vs oracle", got, oracle, atol=2e-5)


@pytest.mark.parametrize("qc,kc", [(8, 8), (16, 8), (32, 16), (16, 32)])
def test_chunking_invariance(rflash, qc, kc):
    """The output does not depend on the chunk decomposition, and each
    decomposition equals the reference's."""
    q, k, v = _inputs(1, 32, 32, 4, 2, 8, seed=qc + 7 * kc)
    got, want = _both(rflash, q, k, v, True, 0, 0, qc, kc)
    _close(f"chunks ({qc}, {kc})", got, want)
    whole = flash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), True, 0, 0, 32, 32).numpy()
    _close("against one chunk", got, whole, atol=2e-5)


@pytest.mark.parametrize("scale", [30.0, 1e3])
def test_extreme_logits(rflash, scale):
    """Scores of hundreds to ~1e4: the running max keeps every exp finite,
    and the port stays within the bound of the reference (outputs are
    convex combinations of v, near one-hot here)."""
    q, k, v = _inputs(2, 32, 32, 8, 2, 8, seed=int(scale), scale=scale)
    got, want = _both(rflash, q, k, v, True, 16, 0, 8, 8)
    assert np.isfinite(got).all()
    _close(f"q x {scale}", got, want)


def test_lse_is_the_log_normaliser():
    """The carried statistics: lse = log sum_k exp(s_k) over the unmasked keys."""
    q, k, v = _inputs(1, 16, 16, 4, 4, 8, seed=5)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = flash._flash_fwd_impl(qt, kt, vt, True, 0, 0, 4, 8)
    s = torch.einsum("bqhd,bkhd->bhqk", qt, kt) * 8**-0.5
    mask = torch.arange(16)[None, :] <= torch.arange(16)[:, None]
    want = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    assert float((lse - want).abs().max()) <= ATOL


# --- the backward ---------------------------------------------------------------

BWD_CASES = [  # (causal, window, q_offset, h, kv, sq, sk, qc, kc)
    (True, 0, 0, 4, 4, 32, 32, 8, 16),  # causal, several chunks both ways
    (True, 12, 0, 8, 2, 32, 32, 8, 8),  # sliding window, GQA rep 4
    (False, 0, 0, 6, 3, 16, 48, 8, 16),  # non-causal, GQA rep 2, Sk != Sq
    (True, 0, 24, 4, 2, 8, 32, 4, 8),  # a q_offset continuation
]


def _grads(q, k, v, dout, *static):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash.flash_attention(qt, kt, vt, *static)
    out.backward(torch.from_numpy(dout))
    return out.detach(), qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("case", BWD_CASES, ids=["causal", "window_gqa4", "noncausal_gqa2", "q_offset"])
def test_backward_matches_reference_vjp(rflash, case):
    import jax.numpy as jnp

    causal, window, q_offset, h, kv, sq, sk, qc, kc = case
    q, k, v = _inputs(2, sq, sk, h, kv, 8, seed=sum(case))
    q, k, v = q[:, :sq], k[:, :sk], v[:, :sk]
    dout = np.random.default_rng(sum(case) + 1).standard_normal(q.shape).astype(np.float32)
    static = (causal, window, q_offset, qc, kc)
    want = [np.asarray(x) for x in rflash.vjp(*(jnp.asarray(a) for a in (q, k, v, dout)), *static)]
    got = _grads(q, k, v, dout, *static)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        bound = ATOL if name == "out" else GRAD_REL * float(np.abs(w).max())
        _close(f"{case} {name}", g.numpy(), w, atol=bound)
        assert g.dtype == torch.float32


def test_backward_bf16_matches_reference_vjp(rflash):
    import jax.numpy as jnp

    case = BWD_CASES[1]
    causal, window, q_offset, h, kv, sq, sk, qc, kc = case
    q, k, v = _inputs(2, sq, sk, h, kv, 8, seed=3)
    dout = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    static = (causal, window, q_offset, qc, kc)
    want = [np.asarray(x.astype(jnp.float32))
            for x in rflash.vjp(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, dout)), *static)]
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in (q, k, v))
    out = flash.flash_attention(qt, kt, vt, *static)
    out.backward(torch.from_numpy(dout).to(torch.bfloat16))
    for name, g, w in zip(("out", "dq", "dk", "dv"), (out.detach(), qt.grad, kt.grad, vt.grad), want):
        assert g.dtype == torch.bfloat16, name
        _close(f"bf16 {name}", g.float().numpy(), w, atol=BF16_GRAD_REL * float(np.abs(w).max()))


def test_backward_gradcheck_float64():
    """The Function's backward is the derivative of its forward (float64,
    finite differences), causal with GQA and several chunks."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 8, 4, 4))).requires_grad_(True)
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 4))).requires_grad_(True)
    v = torch.from_numpy(rng.standard_normal((1, 8, 2, 4))).requires_grad_(True)
    for static in ((True, 0, 0, 4, 4), (False, 3, 0, 2, 4)):
        assert torch.autograd.gradcheck(lambda q, k, v: flash._Flash.apply(q, k, v, *static), (q, k, v))


def test_serving_calls_skip_the_function():
    """Without autograd (serving) the forward runs alone and returns the
    same output as under autograd."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 4, 2, 8, seed=9))
    with torch.no_grad():
        plain = flash.flash_attention(q, k, v, True, 0, 0, 8, 8)
    assert plain.grad_fn is None
    tracked = flash.flash_attention(q.requires_grad_(True), k, v, True, 0, 0, 8, 8)
    assert type(tracked.grad_fn).__name__ == "_FlashBackward"
    assert torch.equal(plain, tracked.detach())
