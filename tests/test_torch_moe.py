"""The port's MoE family (phi3.5-moe, mixtral: ``models.layers.route_moe`` /
``apply_moe``, the ``attn_moe`` blocks) against the reference's, on the
CPU at the smoke configs:

- ``_capacity`` equal over token counts on both sides of the lossless
  regime (S * k <= 128);
- ``apply_moe`` alone on inputs drawn to route unevenly: the routing
  indices (``gate_idx``, captured from the reference's ``jax.lax.top_k``)
  equal, with every token's top-k probability gap above the two packages'
  largest router probability difference; the kept slots equal to the
  capacity rule applied to the reference's indices (one case drops slots,
  S * k > 128); the output and the aux loss within the float32 / bf16
  bounds;
- the family's prefill, cache and decode, the loss with the router's aux
  loss live and every gradient leaf, and the reference's
  ``test_moe_train_step_finite`` (``torch_lm_families`` states the
  tolerances; the CLIs: ``test_torch_families_cli.py``).
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
from repro_torch.models import layers
from repro_torch.models import model as pmodel
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps
from test_torch_reference import ref  # noqa: F401  (fixture)

MOE = ("phi3_5_moe_42b", "mixtral_8x22b")


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


@pytest.mark.parametrize("arch", MOE)
def test_capacity_matches_reference(lm, arch):
    for tokens in (1, 4, 20, 64, 65, 80, 128, 512, 4096, 32768):
        for cf in (1.0, 1.25, 2.0):
            mine = dataclasses.replace(configs.get(arch), capacity_factor=cf)
            theirs = dataclasses.replace(lm.configs.get(arch), capacity_factor=cf)
            assert layers._capacity(tokens, mine) == lm.layers._capacity(tokens, theirs), (tokens, cf)


def _moe_inputs(arch, dtype, s, skew):
    """Smoke MoE params (bf16 draw, in ``dtype``) and x (2, s, d) from a
    numpy seed; ``skew`` adds a multiple of router column 0's direction to
    every token, so expert 0 takes most first choices."""
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=dtype)
    dt = layers._dtype(cfg)
    p = {k: v.to(dt) if v.dtype == torch.bfloat16 else v
         for k, v in layers.init_moe(prng.PRNGKey(3), cfg, device="cpu").items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, s, cfg.d_model)).astype(np.float32))
    r0 = p["router"][:, 0]
    x = (x + skew * r0 / r0.norm()).to(dt)
    return cfg, p, x


def _keep_rule(gate_idx: np.ndarray, c: int) -> np.ndarray:
    """The capacity rule from the routing alone: each row's S*k slots in
    token order, stably sorted by expert, keep the first c of each expert."""
    b = gate_idx.shape[0]
    flat = gate_idx.reshape(b, -1)
    keep = np.zeros(flat.shape, dtype=bool)
    for r in range(b):
        order = np.argsort(flat[r], kind="stable")
        seen = {}
        for j, e in enumerate(flat[r][order]):
            keep[r, j] = seen.get(e, 0) < c
            seen[e] = seen.get(e, 0) + 1
    return keep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,skew", [(80, 6.0), (20, 0.0)], ids=["drops", "lossless"])
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_reference(lm, arch, s, skew, dtype):
    import jax.numpy as jnp

    cfg, p, x = _moe_inputs(arch, dtype, s, skew)
    rcfg = dataclasses.replace(lm.configs.get_smoke(arch), dtype=dtype)
    rp = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
          for k, v in p.items()}
    rx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    got = {}
    ref_routes = fam.reference_routes(lambda: got.update(zip(("out", "aux"), lm.layers.apply_moe(rp, rx, rcfg))))
    r_out, r_aux = got["out"], got["aux"]
    with torch.no_grad(), fam.port_routes() as routes:
        route = layers.route_moe(p, x, cfg)
        out, aux = layers.apply_moe(p, x, cfg)
    fam.check_routes(f"{arch} {dtype} S={s}", routes[:1], ref_routes)
    c = layers._capacity(s, cfg)
    keep = _keep_rule(ref_routes[0][1], c)
    drops = int((~keep).sum())
    print(f"{arch} {dtype} S={s}: capacity {c} of {s * cfg.experts_per_token} slots a row, {drops} dropped")
    assert np.array_equal(route.keep.numpy(), keep)
    assert (drops > 0) == (s * cfg.experts_per_token > 128)
    bound = fam.F32_REL * float(np.abs(np.asarray(r_out, np.float32)).max()) if dtype == "float32" else fam.BF16_ATOL
    fam.close(f"{arch} {dtype} S={s} apply_moe", out.float().numpy(), np.asarray(r_out, np.float32), bound)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=fam.LOSS_RTOL)
    assert out.dtype == x.dtype and aux.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_and_decode_match_reference(lm, arch, dtype):
    fam.check_prefill_decode(lm, arch, dtype)


@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_and_gradients_match_reference(lm, arch):
    grads = fam.check_loss_and_gradients(lm, arch)
    assert float(grads["blocks"]["moe"]["router"].abs().max()) > 0  # the aux loss and the gates reach the router


def test_moe_train_step_finite():
    """The reference's ``test_moe_train_step_finite`` (tests/test_train.py)
    in the port: one train step of the phi3.5-moe smoke model, a finite
    loss, the router's aux loss live, the params still bf16 and changed."""
    cfg = configs.get_smoke("phi3_5_moe_42b")
    model = pmodel.build(cfg)
    params = model.init(prng.PRNGKey(0), device="cpu")
    before = params["blocks"]["moe"]["router"].clone()
    step = steps.make_train_step(model)
    toks = prng.randint(prng.PRNGKey(1), (2, 32), 0, cfg.vocab_size)
    params, _, metrics = step(params, opt_lib.init(params), {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)})
    assert np.isfinite(float(metrics["loss"])) and float(metrics["aux"]) > 0
    assert params["blocks"]["moe"]["w1"].dtype == torch.bfloat16
    assert not torch.equal(params["blocks"]["moe"]["router"], before)


def test_moe_params_round_trip_through_interop(lm):
    """``lm_params_from_reference`` carries the MoE tree (float32 router,
    (E, d, f) bf16 experts) over bit for bit."""
    src = lm.get_params("mixtral_8x22b")
    got = lm_params_from_reference(src)
    for path, leaf in fam.flat(src):
        assert np.array_equal(fam.tbits(fam.get(got, path)), fam.bits(leaf)), path
