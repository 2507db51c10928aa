"""The port's state-space families (falcon-mamba: Mamba-1, ``ssm``;
zamba2: Mamba-2 with a shared attention block, ``hybrid``;
``models/ssm.py``) against the reference's ``repro.models.ssm``, on the
CPU at the smoke configs:

- ``associative_scan`` against ``jax.lax.associative_scan`` at even and
  odd lengths, and ``softplus`` against ``jax.nn.softplus`` past the
  threshold where ``torch.nn.functional.softplus`` returns x;
- ``apply_mamba1`` / ``apply_mamba2`` (several chunks, and one odd chunk)
  with their prefill caches, and ``decode_mamba1`` / ``decode_mamba2``
  from a random state, in float32 (within 1e-4 x max) and bf16 (0.05 x
  max);
- each family's prefill, cache and decode, the loss and every gradient
  leaf (``torch_lm_families`` states the tolerances; the CLIs:
  ``test_torch_families_cli.py``);
- the hybrid's SSD gradient where the reference's is NaN: the reference
  masks the intra-chunk decay as ``where(causal, exp(rel), 0)``, whose
  gradient is 0 x inf wherever an above-diagonal ``rel`` overflows (so
  its zamba2 training diverges to NaN); the port takes ``exp`` of ``rel``
  masked to -inf (the same values), and its gradient is held to the
  reference's with every exp argument clamped at 80 (the same values,
  finite gradients).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import torch_lm_families as fam
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.models import ssm
from repro_torch.models import model as pmodel
from repro_torch.train import steps
from test_torch_reference import ref  # noqa: F401  (fixture)

SSM = ("falcon_mamba_7b", "zamba2_2_7b")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def lm(ref):
    return fam.reference_lm(ref)


@pytest.mark.parametrize("n", [1, 2, 7, 16, 21])
def test_associative_scan_matches_jax(n):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = ssm.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    seq = np.cumprod(a, axis=1)  # the a part is the running product
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), seq, rtol=1e-5)


def test_softplus_is_logaddexp():
    import jax
    import jax.numpy as jnp

    x = np.array([-90.0, -30.0, -5.0, -1e-3, 0.0, 1e-3, 3.0, 19.9, 20.5, 35.0, 90.0], dtype=np.float32)
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2e-7, atol=1e-38)


def _mixer_inputs(lm, arch, dtype, s):
    """(reference cfg, port cfg, reference mixer params, port mixer params,
    x (2, s, d) in the model dtype) from the smoke init of layer 0."""
    import jax
    import jax.numpy as jnp

    rcfg, pcfg, rp, pp = fam.pair(lm, arch, dtype)
    rm = jax.tree.map(lambda a: a[0], rp["blocks"]["mixer"])
    pm = {k: v[0] for k, v in pp["blocks"]["mixer"].items()}
    x = torch.from_numpy(np.random.default_rng(s).standard_normal((2, s, pcfg.d_model)).astype(np.float32))
    x = x.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    rx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return rcfg, pcfg, rm, pm, rx, x


def _rel(dtype):
    return fam.F32_REL if dtype == "float32" else 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 21], ids=["two_chunks", "odd_chunk"])
@pytest.mark.parametrize("arch", SSM)
def test_mixer_forward_and_cache_match_reference(lm, arch, s, dtype):
    rcfg, pcfg, rm, pm, rx, x = _mixer_inputs(lm, arch, dtype, s)
    kind = 1 if pcfg.family == "ssm" else 2
    r_apply = lm.ssm.apply_mamba1 if kind == 1 else lm.ssm.apply_mamba2
    p_apply = ssm.apply_mamba1 if kind == 1 else ssm.apply_mamba2
    r_out, r_cache = r_apply(rm, rx, rcfg, return_cache=True)
    with torch.no_grad():
        out, cache = p_apply(pm, x, pcfg, return_cache=True)
        assert torch.equal(p_apply(pm, x, pcfg), out)
    what = f"mamba{kind} {dtype} S={s} (chunks of {ssm._chunk_len(pcfg, s)})"
    want = np.asarray(r_out, np.float32)
    fam.close(f"{what} output", out.float().numpy(), want, _rel(dtype) * float(np.abs(want).max()))
    for name in ("h", "conv"):
        w = np.asarray(r_cache[name], np.float32)
        assert cache[name].dtype == (torch.float32 if name == "h" else torch.bfloat16)
        fam.close(f"{what} cache {name}", cache[name].float().numpy(), w, fam.cache_bound(name, dtype, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SSM)
def test_mixer_decode_step_matches_reference(lm, arch, dtype):
    import jax.numpy as jnp

    rcfg, pcfg, rm, pm, rx, x = _mixer_inputs(lm, arch, dtype, 1)
    kind = 1 if pcfg.family == "ssm" else 2
    shapes = (ssm.mamba1_cache_shape if kind == 1 else ssm.mamba2_cache_shape)(pcfg, 2)
    rng = np.random.default_rng(3)
    h = rng.standard_normal(shapes["h"]).astype(np.float32)
    conv = torch.from_numpy(rng.standard_normal(shapes["conv"]).astype(np.float32)).to(torch.bfloat16)
    r_step = lm.ssm.decode_mamba1 if kind == 1 else lm.ssm.decode_mamba2
    p_step = ssm.decode_mamba1 if kind == 1 else ssm.decode_mamba2
    r_out, r_new = r_step(rm, rx, {"h": jnp.asarray(h), "conv": jnp.asarray(conv.float().numpy()).astype(jnp.bfloat16)},
                          rcfg)
    cache = {"h": torch.from_numpy(h), "conv": conv}
    with torch.no_grad():
        out, new = p_step(pm, x, cache, pcfg)
    assert torch.equal(cache["h"], torch.from_numpy(h))  # the step leaves its input cache alone
    what = f"decode_mamba{kind} {dtype}"
    want = np.asarray(r_out, np.float32)
    fam.close(f"{what} output", out.float().numpy(), want, _rel(dtype) * float(np.abs(want).max()))
    for name in ("h", "conv"):
        w = np.asarray(r_new[name], np.float32)
        fam.close(f"{what} new {name}", new[name].float().numpy(), w, fam.cache_bound(name, dtype, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SSM)
def test_ssm_prefill_and_decode_match_reference(lm, arch, dtype):
    fam.check_prefill_decode(lm, arch, dtype)


@pytest.mark.parametrize("arch", SSM)
def test_ssm_loss_and_gradients_match_reference(lm, arch):
    fam.check_loss_and_gradients(lm, arch)


def test_hybrid_gradient_finite_where_the_reference_is_nan(lm):
    """At 64 tokens (two 32-token chunks) the reference's zamba2 smoke
    gradient is NaN in most leaves; the port's is finite and equal, leaf by
    leaf, to the reference's with its masked decay clamped below overflow
    (``torch_lm_families.reference_safe_decay``: the same values)."""
    import jax

    rm, pm, rp, pp, rbatch, pbatch = fam.f32_batch(lm, "zamba2_2_7b", 4, 64)
    r_grads = jax.jit(jax.grad(lambda p: lm.steps.make_loss_fn(rm)(p, rbatch)[0]))(rp)
    nan_leaves = [p for p, g in fam.flat(jax.tree.map(np.asarray, r_grads)) if not np.isfinite(g).all()]
    print(f"reference gradient NaN in {len(nan_leaves)} leaves, e.g. {nan_leaves[:3]}")
    assert nan_leaves
    fam.check_loss_and_gradients(lm, "zamba2_2_7b", 4, 64)  # the port's finite, held leaf by leaf


def test_decode_writes_the_ssm_cache_in_place():
    """decode_step writes each layer's new state and conv tail into the
    cache it was given (as the dense KV cache), for both SSM families."""
    for arch in SSM:
        cfg = configs.get_smoke(arch)
        m = pmodel.build(cfg)
        params = m.init(prng.PRNGKey(0), device="cpu")
        toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9)))
        with torch.inference_mode():
            _, cache = m.prefill(params, toks[:, :8])
            before = {k: v.clone() for k, v in cache.items()}
            ptrs = {k: v.data_ptr() for k, v in cache.items()}
            _, new = m.decode(params, cache, toks[:, 8:], 8)
        assert {k: v.data_ptr() for k, v in new.items()} == ptrs
        assert not torch.equal(cache["h"], before["h"]) and not torch.equal(cache["conv"], before["conv"])
        if arch == "zamba2_2_7b":
            assert not torch.equal(cache["shared_k"], before["shared_k"])
        assert dataclasses.asdict(cfg) == dataclasses.asdict(m.cfg)
