"""The port's LM serving path (dense family) against the reference's
``repro.models`` / ``repro.train.steps`` / ``repro.launch.serve``, on the
CPU at the smoke configs:

- ``init_model`` bit for bit (bf16) for all ten archs, its chunked draw
  equal to one draw, and ``interop.lm_params_from_reference``'s bits;
- prefill logits, the prefill cache and the decode logits after prefill,
  from the same params (carried over) and tokens, for the four dense smoke
  configs in float32 and bf16 and a sliding-window variant whose decode
  writes the ring;
- decode parity inside the port, for all ten archs (the other families'
  parity with the reference: ``test_torch_moe.py``, ``test_torch_ssm.py``,
  ``test_torch_families.py``);
- ``serve_lm --device cpu --smoke --arch qwen3-14b`` against the
  reference's greedy loop, teacher-forced with the reference's tokens;
- the config registry and its arithmetic (``param_count``,
  ``active_param_count``, ``analysis.roofline.model_flops`` /
  ``model_min_bytes``) for all ten archs.

Tolerances: float32 logits within 1e-4 x max|logit|; bf16 within 0.05 abs,
the bound of the reference's own decode-parity test
(``tests/test_models.py``).  Each test prints its measured error.
"""

from __future__ import annotations

import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.analysis import roofline
from repro_torch.core import prng
from repro_torch.interop import lm_params_from_reference
from repro_torch.launch import serve
from repro_torch.models import kvcache, layers, model as pmodel, transformer
from repro_torch.train import steps
from test_torch_reference import ref  # noqa: F401  (fixture)

DENSE = ("olmo_1b", "qwen3_14b", "yi_9b", "deepseek_67b")
B, S = 2, 20  # prompt length S; the decode step writes position S
WINDOW = 16  # the sliding-window variant: S > WINDOW, so decode writes the ring
F32_REL = 1e-4
BF16_ATOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def lm(ref):
    """The reference's LM modules (unloaded with ``ref``) and a cache of
    its bf16 smoke params per arch, drawn once by ``jax.jit(init)``
    (``test_init_model_bit_equal_to_the_eager_reference`` holds the port to
    the eager draw the reference's CLI makes)."""
    import jax

    ns = types.SimpleNamespace(
        configs=importlib.import_module("repro.configs"),
        model=importlib.import_module("repro.models.model"),
        steps=importlib.import_module("repro.train.steps"),
        roofline=importlib.import_module("repro.analysis.roofline"),
        params={},
    )

    def params(arch):
        if arch not in ns.params:
            m = ns.model.build(ns.configs.get_smoke(arch))
            ns.params[arch] = jax.tree.map(np.asarray, jax.jit(m.init)(jax.random.PRNGKey(0)))
        return ns.params[arch]

    ns.get_params = params
    return ns


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _tbits(t: torch.Tensor):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _bound(cfg_dtype: str, want: np.ndarray) -> float:
    if cfg_dtype == "float32":
        return F32_REL * float(np.abs(want).max())
    return BF16_ATOL


def _close(what, got, want, bound):
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    print(f"{what}: max |port - reference| = {err:.4g} (bound {bound:.4g})")
    assert got.shape == want.shape and err <= bound, (what, err, bound)
    return err


# --- parameters -----------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_init_model_bit_equal_to_reference(lm, arch):
    """Every arch's init, bit for bit, against the reference's jitted init;
    falcon-mamba's ``A_log = log(arange(1, 9))`` is a constant that XLA
    folds under ``jit`` through another ``log`` than the compiled one: there
    the port holds the eager init's bits (what the reference's CLIs draw)
    and the jitted ones lie within an ulp."""
    import jax

    want = lm.get_params(arch)
    got = pmodel.build(configs.get_smoke(arch)).init(prng.PRNGKey(0), device="cpu")
    paths = [p for p, _ in _flat(want)]
    assert sorted(paths) == sorted(p for p, _ in _flat(got))
    folded = [("blocks", "mixer", "A_log")] if arch == "falcon_mamba_7b" else []
    for path, leaf in _flat(want):
        t = _get(got, path)
        assert tuple(t.shape) == leaf.shape and str(t.dtype).split(".")[1] == leaf.dtype.name, path
        if path in folded:
            eager = np.asarray(_get(lm.model.build(lm.configs.get_smoke(arch)).init(jax.random.PRNGKey(0)), path))
            assert np.array_equal(_tbits(t), _bits(eager)), path
            ulps = np.abs(_tbits(t).astype(np.int64) - _bits(leaf).astype(np.int64))
            print(f"{arch} {path}: {int((ulps > 0).sum())} of {ulps.size} jitted entries differ, by at most "
                  f"{int(ulps.max())} ulp")
            assert ulps.max() <= 1
        else:
            assert np.array_equal(_tbits(t), _bits(leaf)), path


def test_init_model_bit_equal_to_the_eager_reference(lm):
    """The reference's CLI draws its weights eagerly (``model.init(key)``
    outside ``jit``); the port's bits are those too."""
    import jax

    rm = lm.model.build(lm.configs.get_smoke("yi_9b"))
    got = pmodel.build(configs.get_smoke("yi_9b")).init(prng.PRNGKey(0), device="cpu")
    for path, leaf in _flat(jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(0)))):
        assert np.array_equal(_tbits(_get(got, path)), _bits(leaf)), path


def test_chunked_draw_equals_one_draw(monkeypatch):
    """Under partitionable threefry element i's bits depend on i alone, so a
    leaf drawn in chunks (``INIT_CHUNK``) is the one whole draw."""
    key = prng.PRNGKey(7)
    whole = (prng.normal(key, (37, 29)) * torch.tensor(37**-0.5, dtype=torch.float32)).to(torch.bfloat16)
    for chunk in (100, 37 * 29 - 1, 1 << 24):
        monkeypatch.setattr(layers, "INIT_CHUNK", chunk)
        got = layers.draw_normal(key, (37, 29), 37**-0.5, torch.bfloat16, "cpu")
        assert torch.equal(got.view(torch.int16), whole.view(torch.int16)), chunk
    cfg = configs.get_smoke("qwen3_14b")
    monkeypatch.setattr(layers, "INIT_CHUNK", 1000)
    small = transformer.init_model(prng.PRNGKey(0), cfg, device="cpu")
    monkeypatch.setattr(layers, "INIT_CHUNK", 1 << 24)
    big = transformer.init_model(prng.PRNGKey(0), cfg, device="cpu")
    for path, t in _flat(big):
        assert torch.equal(_get(small, path), t), path


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lm_params_from_reference_round_trips_bits(lm, dtype):
    import jax
    import jax.numpy as jnp

    src = lm.get_params("qwen3_14b")
    if dtype == "float32":
        src = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), src)
    got = lm_params_from_reference(src)
    for path, leaf in _flat(src):
        t = _get(got, path)
        assert t.device.type == "cpu" and t.element_size() == leaf.dtype.itemsize
        assert np.array_equal(_tbits(t), _bits(leaf)), path
    assert lm_params_from_reference(src, "meta")["embed"].device.type == "meta"


# --- forward, prefill and decode against the reference ---------------------

VARIANTS = [(a, dt, 0) for a in DENSE for dt in ("float32", "bfloat16")] + [("olmo_1b", "float32", WINDOW)]


def _variant(lm, arch, dtype, window):
    """(reference cfg, port cfg, reference params (jnp), port params)."""
    import jax
    import jax.numpy as jnp

    kw = dict(dtype=dtype, sliding_window=window)
    rcfg = dataclasses.replace(lm.configs.get_smoke(arch), **kw)
    pcfg = dataclasses.replace(configs.get_smoke(arch), **kw)
    rp = jax.tree.map(jnp.asarray, lm.get_params(arch))
    if dtype == "float32":  # the bf16 draw widened: the same values in both packages
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    pp = lm_params_from_reference(jax.tree.map(np.asarray, rp))
    return rcfg, pcfg, rp, pp


@pytest.mark.parametrize("arch,dtype,window", VARIANTS)
def test_prefill_and_decode_match_reference(lm, arch, dtype, window):
    """The prefill's logits and cache, and the decode step's logits, from
    the same params and tokens.  The cache is bf16 whatever the model
    dtype, so in float32 a K/V entry within an ulp of a bf16 rounding
    boundary can round the other way (measured: up to 5 of ~4,000 entries,
    one ulp each; the bound is one bf16 ulp at the cache's top binade,
    since near-zero entries carry float32 cancellation); the decode step is therefore held to the float32 bound
    from the reference's own cache, and after the port's prefill to ten
    times it (a flipped entry moved qwen3's decode logits 1.13e-4 x
    max|logit|).  In bf16 the reference's compiled program keeps some
    intermediates in float32 (XLA's excess precision), so a third of the
    cache entries differ by an ulp or more: the cache is held to 0.05 x
    max|entry|, the relative form of the reference's bound."""
    import jax
    import jax.numpy as jnp

    rcfg, pcfg, rp, pp = _variant(lm, arch, dtype, window)
    toks = np.random.default_rng(DENSE.index(arch) + window).integers(0, pcfg.vocab_size, (B, S + 1), dtype=np.int32)
    rm = lm.model.build(rcfg)
    prefill, decode = lm.steps.make_prefill_step(rm), lm.steps.make_decode_step(rm)

    def reference(params, t):  # one compiled program: prefill, then one decode step
        logits, cache = prefill(params, {"tokens": t[:, :S]})
        _, dl, _ = decode(params, {"cache": cache, "tokens": t[:, S:], "cache_len": jnp.int32(S)})
        return logits, cache, dl

    r_logits, r_cache, r_dl = jax.tree.map(np.asarray, jax.jit(reference)(rp, jnp.asarray(toks)))

    pm = pmodel.build(pcfg)
    p_decode = steps.make_decode_step(pm)
    with torch.inference_mode():
        tt = torch.from_numpy(toks).long()
        p_logits, p_cache = steps.make_prefill_step(pm)(pp, {"tokens": tt[:, :S]})
        fwd, _ = pm.forward(pp, tt[:, :S])
        assert torch.equal(fwd, p_logits)  # prefill's logits are the forward's
        want_w = kvcache.attn_cache_len(pcfg, S + 1)
        assert tuple(p_cache["k"].shape) == (pcfg.num_layers, B, want_w, pcfg.num_kv_heads, pcfg.head_dim)
        ck = {k: v.float().numpy() for k, v in p_cache.items()}  # before decode writes into it
        nxt, p_dl, _ = p_decode(pp, {"cache": p_cache, "tokens": tt[:, S:], "cache_len": S})
        _, p_dl_same, _ = p_decode(pp, {"cache": lm_params_from_reference(r_cache), "tokens": tt[:, S:],
                                      "cache_len": S})

    what = f"{arch} {dtype} w={window}"
    _close(f"{what} prefill logits", p_logits.numpy(), r_logits, _bound(dtype, r_logits))
    for name in ("k", "v"):
        want = r_cache[name].astype(np.float32)
        print(f"{what} cache {name}: {int((ck[name] != want).sum())} of {want.size} entries differ")
        top = float(np.abs(want).max())
        # float32: one bf16 ulp at the top binade; bf16: the relative bound
        _close(f"{what} cache {name}", ck[name], want, (2.0**-7 if dtype == "float32" else 0.05) * top)
    _close(f"{what} decode logits, the reference's cache", p_dl_same.numpy(), r_dl, _bound(dtype, r_dl))
    chain = _bound(dtype, r_dl) * (10 if dtype == "float32" else 1)
    _close(f"{what} decode logits after the port's prefill", p_dl.numpy(), r_dl, chain)
    assert torch.equal(nxt, torch.argmax(p_dl[:, -1], dim=-1).to(torch.int32))


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_decode_parity_inside_the_port(arch):
    """decode(prefill(x[:S]), x[S]) == forward(x[:S+1])[-1] to the
    reference's bound (bf16: the forward's flat-head chunks against the
    decode's factored cache path; the SSM families' chunked scans against
    their recurrences), with a context for the vlm (gates at 0.5) and audio."""
    cfg = configs.get_smoke(arch)
    m = pmodel.build(cfg)
    params = m.init(prng.PRNGKey(0), device="cpu")
    if "cross_blocks" in params:
        params["cross_blocks"]["gate"] = torch.full_like(params["cross_blocks"]["gate"], 0.5)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))).long()
    n = {"vlm": cfg.num_image_tokens, "audio": cfg.encoder_seq}.get(cfg.family)
    ctx = None if n is None else torch.from_numpy(rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)).to(
        torch.bfloat16)
    with torch.inference_mode():
        full, _ = m.forward(params, toks, context=ctx)
        _, cache = m.prefill(params, toks[:, :S], context=ctx)
        dl, _ = m.decode(params, cache, toks[:, S:], S, context=ctx)
    _close(f"{arch} decode parity", dl[:, 0].numpy(), full[:, -1].numpy(), BF16_ATOL)


# --- serve_lm end to end ----------------------------------------------------

GEN = 12


def test_serve_lm_follows_the_reference_greedy_tokens(lm, capsys):
    """The port's CLI (``--device cpu --smoke --arch qwen3-14b --gen 12``)
    against the reference's serve loop (its init's bits, ``randint``
    prompts, jitted prefill and greedy decode).  The port is fed the reference's
    tokens step by step: every step's logits within the bf16 bound, and
    where the reference's top-2 margin exceeds twice it, the same argmax.
    Its own free-running tokens equal the reference's up to the first step
    below that margin."""
    import jax
    import jax.numpy as jnp

    rcfg = lm.configs.get_smoke("qwen3-14b")
    rm = lm.model.build(rcfg)
    r_params = jax.tree.map(jnp.asarray, lm.get_params("qwen3_14b"))
    bsz, s = 4, 32
    prompts = jax.random.randint(jax.random.PRNGKey(1), (bsz, s), 0, rcfg.vocab_size)
    r_prefill = jax.jit(lm.steps.make_prefill_step(rm, max_len=s + GEN))
    r_decode = jax.jit(lm.steps.make_decode_step(rm))
    logits, cache = r_prefill(r_params, {"tokens": prompts})
    r_steps = [np.asarray(logits[:, -1])]
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    r_toks = [np.asarray(tok)]
    for i in range(GEN - 1):
        tok, dl, cache = r_decode(r_params, {"cache": cache, "tokens": tok[:, None], "cache_len": jnp.int32(s + i)})
        r_steps.append(np.asarray(dl[:, -1]))
        r_toks.append(np.asarray(tok))
    r_toks = np.stack(r_toks, axis=1)

    run = serve.serve_lm(serve.build_parser().parse_args(
        ["--device", "cpu", "--smoke", "--arch", "qwen3-14b", "--gen", str(GEN)]))
    assert "[serve] OK" in capsys.readouterr().out
    assert np.array_equal(run.prompts.numpy(), np.asarray(prompts))
    for path, leaf in _flat(lm.get_params("qwen3_14b")):
        assert np.array_equal(_tbits(_get(run.params, path)), _bits(leaf)), path

    # teacher-forced: the port decodes the reference's tokens
    pm = run.model
    decided, errs = [], []
    with torch.inference_mode():
        p_logits, p_cache = steps.make_prefill_step(pm, max_len=s + GEN)(run.params, {"tokens": run.prompts})
        p_steps = [p_logits[:, -1].numpy()]
        for i in range(GEN - 1):
            fed = torch.from_numpy(r_toks[:, i : i + 1]).long()
            _, dl, p_cache = steps.make_decode_step(pm)(run.params, {"cache": p_cache, "tokens": fed, "cache_len": s + i})
            p_steps.append(dl[:, -1].numpy())
    for i, (got, want) in enumerate(zip(p_steps, r_steps)):
        errs.append(float(np.abs(got - want).max()))
        top2 = np.sort(want, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        sure = margin > 2 * BF16_ATOL
        decided.append(sure)
        assert np.array_equal(got.argmax(-1)[sure], r_toks[sure, i]), i
    print(f"serve_lm teacher-forced: max step error {max(errs):.4g} (bound {BF16_ATOL}); "
          f"decided steps {int(np.sum(decided))} of {len(decided) * bsz}")
    assert max(errs) <= BF16_ATOL
    decided = np.stack(decided, axis=1)
    for row in range(bsz):  # free running: equal up to the first undecided step
        upto = GEN if decided[row].all() else int(np.argmin(decided[row]))
        assert np.array_equal(run.tokens[row, :upto].numpy(), r_toks[row, :upto]), row


def test_serve_cli_without_a_card_raises(monkeypatch):
    """The default LM mode runs on cuda and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main([])


# --- configs and their arithmetic -------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_configs_and_param_counts_match_reference(lm, arch):
    for get in ("get", "get_smoke"):
        mine, theirs = getattr(configs, get)(arch), getattr(lm.configs, get)(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()
    assert configs.ALIASES == lm.configs.ALIASES and configs.ARCHS == lm.configs.ARCHS


@pytest.mark.parametrize("shape", [s.name for s in configs.SHAPES])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_model_flops_and_min_bytes_match_reference(lm, arch, shape):
    cfg, rcfg = configs.get(arch), lm.configs.get(arch)
    ps, rs = configs.get_shape(shape), lm.configs.get_shape(shape)
    assert dataclasses.asdict(ps) == dataclasses.asdict(rs)
    for chips in (1, 4):
        assert roofline.model_flops(cfg, ps, chips=chips) == lm.roofline.model_flops(rcfg, rs, chips=chips)
        assert roofline.model_min_bytes(cfg, ps, chips=chips) == lm.roofline.model_min_bytes(rcfg, rs, chips=chips)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference_shapes(lm, kind):
    import jax

    cfg = configs.get_smoke("yi_9b")
    shape = configs.ShapeConfig("t", 24, 2, kind)
    mine = pmodel.build(cfg).input_specs(shape, device="meta")
    theirs = lm.model.build(lm.configs.get_smoke("yi_9b")).input_specs(
        lm.configs.ShapeConfig("t", 24, 2, kind))
    flat_t = {p: v for p, v in _flat(jax.tree.map(lambda a: (a.shape, a.dtype.name), theirs,
                                                  is_leaf=lambda a: hasattr(a, "shape")))}
    flat_m = {p: (tuple(v.shape), str(v.dtype).split(".")[1]) for p, v in _flat(mine)}
    assert flat_m == flat_t
