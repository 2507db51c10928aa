"""The port's cross-attention families (llama-3.2-vision: ``vlm``, gated
cross layers over image-token embeddings; whisper: ``audio``, a
non-causal encoder and ``dec_cross`` decoder blocks) against the
reference, and what every family shares, on the CPU at the smoke configs:

- each family's prefill, cache and decode, the loss and every gradient
  leaf (the vlm's gates at 0.5, with a random context;
  ``torch_lm_families`` states the tolerances; the CLIs:
  ``test_torch_families_cli.py``);
- ``build`` and ``init_cache`` for all ten archs (every family is ported:
  none raises), ``input_specs`` with ``context``, and
  ``interop.lm_params_from_reference`` on every family's tree (the vlm's
  0-d float32 ``gate`` leaves, the hybrid's unstacked ``shared_attn``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import torch_lm_families as fam
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.interop import lm_params_from_reference
from repro_torch.models import kvcache
from repro_torch.models import model as pmodel
from test_torch_reference import ref  # noqa: F401  (fixture)

CROSS = ("llama_3_2_vision_90b", "whisper_base")
OTHERS = ("phi3_5_moe_42b", "mixtral_8x22b", "falcon_mamba_7b", "zamba2_2_7b") + CROSS


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", CROSS)
def test_cross_prefill_and_decode_match_reference(lm, arch, dtype):
    fam.check_prefill_decode(lm, arch, dtype)


@pytest.mark.parametrize("arch", CROSS)
def test_cross_loss_and_gradients_match_reference(lm, arch):
    grads = fam.check_loss_and_gradients(lm, arch)
    if arch == "llama_3_2_vision_90b":  # the gate is live: tanh'(0.5) x <a, dL/dx>
        assert bool((grads["cross_blocks"]["gate"] != 0).all())
    else:
        assert float(grads["enc_pos"].abs().max()) > 0


def test_vlm_gate_hides_the_cross_layers_at_init():
    """With the init's gate = 0 the context changes nothing; at 0.5 it
    does (the reason every vlm parity check sets it)."""
    cfg = dataclasses.replace(configs.get_smoke("llama_3_2_vision_90b"), dtype="float32")
    m = pmodel.build(cfg)
    params = m.init(prng.PRNGKey(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)))
    ctx = [torch.from_numpy(np.random.default_rng(s).standard_normal((2, cfg.num_image_tokens, cfg.d_model))
                            .astype(np.float32)) for s in (2, 3)]
    with torch.inference_mode():
        a, b = (m.forward(params, toks, context=c)[0] for c in ctx)
        assert torch.equal(a, b)
        params["cross_blocks"]["gate"] = torch.full_like(params["cross_blocks"]["gate"], fam.GATE)
        a, b = (m.forward(params, toks, context=c)[0] for c in ctx)
        assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_build_and_init_cache_for_every_arch(lm, arch):
    """Every family builds and has a decode cache: its leaves' shapes and
    dtypes are the reference's ``init_cache(abstract=True)``'s, at the
    full config (on ``meta``) and the smoke config (allocated)."""
    for get in ("get", "get_smoke"):
        cfg, rcfg = getattr(configs, get)(arch), getattr(lm.configs, get)(arch)
        assert pmodel.build(cfg).cfg == cfg
        device = "meta" if get == "get" else "cpu"
        mine = kvcache.init_cache(cfg, 3, 40, device=device)
        theirs = lm.model.kvcache.init_cache(rcfg, 3, 40, abstract=True)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[1]) for k, v in mine.items()} == {
            k: (tuple(v.shape), v.dtype.name) for k, v in theirs.items()}
        if device == "cpu":
            assert all(not bool(v.any()) for v in mine.values())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", OTHERS)
def test_input_specs_match_reference_shapes(lm, arch, kind):
    import jax

    shape = configs.ShapeConfig("t", 24, 2, kind)
    mine = pmodel.build(configs.get_smoke(arch)).input_specs(shape, device="meta")
    theirs = lm.model.build(lm.configs.get_smoke(arch)).input_specs(lm.configs.ShapeConfig("t", 24, 2, kind))
    flat_t = dict(fam.flat(jax.tree.map(lambda a: (a.shape, a.dtype.name), theirs, is_leaf=lambda a: hasattr(a, "shape"))))
    flat_m = {p: (tuple(v.shape), str(v.dtype).split(".")[1]) for p, v in fam.flat(mine)}
    assert flat_m == flat_t
    assert ("context",) in flat_m or arch not in CROSS or (arch == "whisper_base" and kind == "decode")


@pytest.mark.parametrize("arch", OTHERS)
def test_params_round_trip_through_interop(lm, arch):
    """``lm_params_from_reference`` carries each family's tree over bit for
    bit (the vlm's (nseg,) and single 0-d float32 gates, the hybrid's
    unstacked shared block) and equals the port's own init."""
    src = lm.get_params(arch)
    got = lm_params_from_reference(src)
    mine = pmodel.build(configs.get_smoke(arch)).init(prng.PRNGKey(0), device="cpu")
    assert sorted(p for p, _ in fam.flat(got)) == sorted(p for p, _ in fam.flat(mine))
    for path, leaf in fam.flat(src):
        t = fam.get(got, path)
        assert np.array_equal(fam.tbits(t), fam.bits(leaf)) and torch.equal(t, fam.get(mine, path)), path
    if arch == "llama_3_2_vision_90b":
        gate = lm_params_from_reference({"gate": np.float32(0.25)})["gate"]
        assert gate.ndim == 0 and gate.dtype == torch.float32 and float(gate) == 0.25
        assert got["cross_blocks"]["gate"].shape == (1,)
    if arch == "zamba2_2_7b":
        assert got["shared_attn"]["attn"]["wq"].ndim == 2 and got["blocks"]["mixer"]["w_x"].ndim == 3
