"""Shared checks of the port's non-dense LM families (moe, ssm, hybrid, vlm,
audio) against the reference, on the CPU at the smoke configs; the test
files ``test_torch_moe.py``, ``test_torch_ssm.py``,
``test_torch_families.py`` and ``test_torch_families_cli.py`` parametrise
them.

The reference's params are its eager ``init`` (what its CLIs draw): the
jitted init constant-folds falcon-mamba's ``A_log = log(arange)`` through
another ``log`` (``test_init_model_bit_equal_to_reference``).  Contexts
(vlm image tokens, audio frames) are standard normals from a numpy seed
rounded to bfloat16, in the model's dtype.  The vlm's cross layers are
gated by ``tanh(gate)`` with ``gate = 0`` at init, which would hide them:
every parity check sets ``gate = GATE`` in both packages first.

Tolerances (each check prints its measured error):
- float32 logits within 1e-4 x max|logit|, the decode after the port's own
  prefill within ten times that (its bf16 cache can round an entry the
  other way, as in ``test_torch_models.py``); bf16 logits within 0.05, the
  reference's own decode-parity bound, except the hybrid's bf16 decode
  logits: within twice the distance between the reference's own compiled
  and op-by-op runs of the same step (XLA keeps the fused step's bf16
  intermediates in float32; that distance is ~0.06 at the smoke config);
- bf16 cache leaves (K/V, conv tails, the encoder output) within one bf16
  ulp at their top binade (2^-7 x max) in float32, 0.05 x max in bf16; the
  float32 SSM state ``h`` within 1e-4 x max in float32, 0.05 x max in
  bf16;
- the loss to rtol 1e-5 and every gradient leaf within 1e-4 x its max|g|
  (float32).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import types

import numpy as np
import torch

from repro_torch import configs
from repro_torch.interop import lm_params_from_reference
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import layers
from repro_torch.models import model as pmodel
from repro_torch.train import steps

B, S = 2, 20  # prompt length S; the decode step writes position S
TRAIN_S = 16
GATE = 0.5
F32_REL = 1e-4
BF16_ATOL = 0.05
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
CLI_LOSS_ATOL = 2e-3  # bf16 smoke model: XLA keeps some intermediates in float32
CLI_ARGS = ["--smoke", "--batch", "2", "--seq", "32", "--graph-nodes", "512", "--ckpt-every", "4"]
GEN = 8


def reference_lm(ref):
    """The reference's LM modules (unloaded with ``ref``) and a cache of
    its eager bf16 smoke params per arch."""
    import jax

    ns = types.SimpleNamespace(
        configs=importlib.import_module("repro.configs"),
        model=importlib.import_module("repro.models.model"),
        steps=importlib.import_module("repro.train.steps"),
        layers=importlib.import_module("repro.models.layers"),
        ssm=importlib.import_module("repro.models.ssm"),
        roofline=importlib.import_module("repro.analysis.roofline"),
        cache={},
    )

    def params(arch):
        if arch not in ns.cache:
            m = ns.model.build(ns.configs.get_smoke(arch))
            ns.cache[arch] = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0)))
        return ns.cache[arch]

    ns.get_params = params
    return ns


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def bits(a):
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def tbits(t: torch.Tensor):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()


def close(what, got, want, bound):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    print(f"{what}: max |port - reference| = {err:.4g} (bound {bound:.4g})")
    assert got.shape == want.shape and err <= bound, (what, err, bound)
    return err


def logit_bound(dtype: str, want) -> float:
    return F32_REL * float(np.abs(want).max()) if dtype == "float32" else BF16_ATOL


def cache_bound(name: str, dtype: str, want) -> float:
    top = float(np.abs(want).max())
    if dtype == "bfloat16":
        return 0.05 * top
    return (F32_REL if name == "h" else 2.0**-7) * top


def pair(lm, arch, dtype):
    """(reference cfg, port cfg, reference params (jnp), port params): the
    bf16 draw of seed 0 (widened for float32), the vlm's gates at GATE."""
    import jax
    import jax.numpy as jnp

    rcfg = dataclasses.replace(lm.configs.get_smoke(arch), dtype=dtype)
    pcfg = dataclasses.replace(configs.get_smoke(arch), dtype=dtype)
    rp = jax.tree.map(jnp.asarray, lm.get_params(arch))
    if dtype == "float32":
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    if "cross_blocks" in rp:
        rp["cross_blocks"]["gate"] = jnp.full_like(rp["cross_blocks"]["gate"], GATE)
    return rcfg, pcfg, rp, lm_params_from_reference(jax.tree.map(np.asarray, rp))


def context(cfg, b: int, seed: int, dtype: str):
    """(reference context (jnp), port context) in the model's dtype, or
    (None, None) for the families without one."""
    import jax.numpy as jnp

    n = {"vlm": cfg.num_image_tokens, "audio": cfg.encoder_seq}.get(cfg.family)
    if n is None:
        return None, None
    raw = np.random.default_rng(seed).standard_normal((b, n, cfg.d_model)).astype(np.float32)
    t = torch.from_numpy(raw).to(torch.bfloat16)
    t = t if dtype == "bfloat16" else t.float()
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32), t


@contextlib.contextmanager
def port_routes():
    """Record (probs, gate_idx) of every ``route_moe`` call of the port."""
    calls = []
    real = layers.route_moe

    def wrapped(p, x, cfg):
        r = real(p, x, cfg)
        calls.append((r.probs.detach().double().numpy(), r.gate_idx.numpy()))
        return r

    layers.route_moe = wrapped
    try:
        yield calls
    finally:
        layers.route_moe = real


def reference_routes(fn):
    """Run ``fn`` with jit off (the layer scans run as loops) and record
    (probs, gate_idx) of every ``jax.lax.top_k`` call of the reference."""
    import jax

    calls = []
    real = jax.lax.top_k

    def top_k(a, k):
        out = real(a, k)
        calls.append((np.asarray(a, np.float64), np.asarray(out[1])))
        return out

    jax.lax.top_k = top_k
    try:
        with jax.disable_jit():
            fn()
    finally:
        jax.lax.top_k = real
    return calls


def check_routes(what, port, reference, dtype="float32"):
    """Every MoE layer's routing indices equal where the route is decided.

    Layer by layer, over the positions not yet shadowed: ``err`` is the
    largest difference of the two packages' router probabilities, and a
    token is undecided where the gap between its k-th and (k+1)-th
    reference probability is at most 2 err.  In float32 (the router's own
    float error, ~1e-7) no token may be undecided, so every route is held
    equal.  In bf16 the router's input carries the residual stream's bf16
    rounding (~1e-3 in probability); a route may differ only at an
    undecided token, and its row is shadowed from that position on (a
    token's route reaches the later positions only).  Returns the first
    shadowed position of each batch row (S if none)."""
    assert len(port) == len(reference) > 0, (len(port), len(reference))
    b, s = port[0][1].shape[:2]
    first = np.full(b, s)
    pos = np.arange(s)[None, :]
    gaps, errs = [], []
    for (pp, pi), (rp, ri) in zip(port, reference):
        live = pos < first[:, None]
        k = pi.shape[-1]
        top = -np.sort(-rp, axis=-1)
        gap = top[..., k - 1] - top[..., k]
        err = float(np.abs(pp - rp).max(-1)[live].max())
        undecided = live & (gap <= 2 * err)
        differ = live & (pi != ri).any(-1)
        assert not (differ & ~undecided).any(), (what, np.argwhere(differ & ~undecided)[:3])
        first = np.minimum(first, np.where(undecided.any(1), np.argmax(undecided, axis=1), s))
        gaps.append(float(gap[live].min()))
        errs.append(err)
    print(f"{what}: {len(port)} MoE calls; smallest top-k gap {min(gaps):.3g}, largest router "
          f"probability difference {max(errs):.3g}; rows shadowed from positions {first.tolist()} of {s}")
    if dtype == "float32":
        assert (first == s).all()
    assert first.max() > 0  # something is compared
    return first


def check_prefill_decode(lm, arch, dtype):
    """The prefill's logits (== the forward's) and cache, and the decode
    step's logits from the reference's cache and after the port's prefill."""
    import jax
    import jax.numpy as jnp

    rcfg, pcfg, rp, pp = pair(lm, arch, dtype)
    toks = np.random.default_rng(7).integers(0, pcfg.vocab_size, (B, S + 1), dtype=np.int32)
    rctx, pctx = context(pcfg, B, 8, dtype)
    rm = lm.model.build(rcfg)
    prefill, decode = lm.steps.make_prefill_step(rm), lm.steps.make_decode_step(rm)

    def reference(params, t, ctx):  # one compiled program: prefill, then one decode step
        logits, cache = prefill(params, {"tokens": t[:, :S], "context": ctx})
        _, dl, _ = decode(params, {"cache": cache, "tokens": t[:, S:], "cache_len": jnp.int32(S), "context": ctx})
        return logits, cache, dl

    r_logits, r_cache, r_dl = jax.tree.map(np.asarray, jax.jit(reference)(rp, jnp.asarray(toks), rctx))

    pm = pmodel.build(pcfg)
    p_decode = steps.make_decode_step(pm)
    with torch.inference_mode():
        tt = torch.from_numpy(toks).long()
        with port_routes() as routes:
            p_logits, p_cache = steps.make_prefill_step(pm)(pp, {"tokens": tt[:, :S], "context": pctx})
        fwd, _ = pm.forward(pp, tt[:, :S], context=pctx)
        assert torch.equal(fwd, p_logits)  # prefill's logits are the forward's
        assert sorted(p_cache) == sorted(r_cache)
        ck = {k: v.float().numpy().copy() for k, v in p_cache.items()}  # before decode writes into it
        batch = {"tokens": tt[:, S:], "cache_len": S, "context": pctx}
        nxt, p_dl, new = p_decode(pp, {"cache": p_cache, **batch})
        with port_routes() as step_routes:
            _, p_dl_same, _ = p_decode(pp, {"cache": lm_params_from_reference(r_cache), **batch})
    what = f"{arch} {dtype}"
    first = np.full(B, S)
    if pcfg.family == "moe":
        first = check_routes(f"{what} prefill", routes, reference_routes(
            lambda: rm.forward(rp, jnp.asarray(toks[:, :S]), context=rctx, remat=False)), dtype)
    rows = first == S  # the decode step attends to every position

    def shadowed(a, axis):  # positions at or past each row's first shadowed one set to 0
        keep = np.arange(a.shape[axis])[None, :] < first[:, None]  # (B, S)
        shape = [1] * a.ndim
        shape[axis - 1], shape[axis] = B, a.shape[axis]
        return np.where(keep.reshape(shape), a, 0)

    close(f"{what} prefill logits", shadowed(p_logits.numpy(), 1), shadowed(r_logits, 1),
          logit_bound(dtype, r_logits))
    for name in sorted(r_cache):
        want = r_cache[name].astype(np.float32)
        assert ck[name].shape == want.shape and p_cache[name].dtype == {2: torch.bfloat16, 4: torch.float32}[
            r_cache[name].dtype.itemsize], name
        got = ck[name]
        if not rows.all():  # the attention families' (L, B, S_cache, kv, hd)
            got, want = shadowed(got, 2), shadowed(want, 2)
        close(f"{what} cache {name}", got, want, cache_bound(name, dtype, want))
    step_rows = np.ones(B, dtype=bool)
    if pcfg.family == "moe":  # the step's own routes, from the reference's cache
        step_rows = check_routes(f"{what} decode step", step_routes, reference_routes(lambda: rm.decode(
            rp, jax.tree.map(jnp.asarray, r_cache), jnp.asarray(toks[:, S:]), S, context=rctx)), dtype) == 1
    bound = logit_bound(dtype, r_dl)
    if pcfg.family == "hybrid" and dtype == "bfloat16":
        # XLA fuses the bf16 Mamba-2 step and keeps its intermediates in
        # float32: the reference's own compiled and op-by-op steps differ by
        # ~0.06 here (measured), so the port is held to twice that spread
        with jax.disable_jit():
            _, eager, _ = decode(rp, {"cache": jax.tree.map(jnp.asarray, r_cache), "tokens": jnp.asarray(toks[:, S:]),
                                      "cache_len": jnp.int32(S), "context": rctx})
            eager_chain = reference(rp, jnp.asarray(toks), rctx)[2]
        spread = float(np.abs(np.asarray(eager, np.float64) - r_dl).max())
        spread_chain = float(np.abs(np.asarray(eager_chain, np.float64) - r_dl).max())
        print(f"{what}: the reference's compiled vs op-by-op decode logits: {spread:.4g} from its cache, "
              f"{spread_chain:.4g} after its prefill")
        bound, chain = max(bound, 2 * spread), max(bound, 2 * spread_chain)
    else:
        chain = bound * (10 if dtype == "float32" else 1)
    close(f"{what} decode logits, the reference's cache", p_dl_same.numpy()[step_rows], r_dl[step_rows], bound)
    rows &= step_rows
    if rows.any():
        close(f"{what} decode logits after the port's prefill", p_dl.numpy()[rows], r_dl[rows], chain)
    assert torch.equal(nxt, torch.argmax(p_dl[:, -1], dim=-1).to(torch.int32))
    assert sorted(new) == sorted(p_cache)


@contextlib.contextmanager
def reference_safe_decay(lm):
    """The reference's ``models/ssm.py`` with every ``jnp.exp`` argument
    clamped at 80.  No value changes (every exponent there is <= log 16,
    except the SSD's masked above-diagonal ``rel``, whose exp the
    ``where`` discards), but the masked entries' gradient becomes 0 x
    e^80 = 0 instead of 0 x inf = NaN: the oracle for the port's hybrid
    gradients, which mask ``rel`` before ``exp`` (``ssm._ssd_chunk``)."""
    import jax.numpy as jnp

    class Clamped:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def exp(x):
            return jnp.exp(jnp.minimum(x, 80.0))

    saved = lm.ssm.jnp
    lm.ssm.jnp = Clamped()
    try:
        yield
    finally:
        lm.ssm.jnp = saved


def f32_batch(lm, arch, seed: int, tokens: int = TRAIN_S):
    """(reference model, port model, reference params, port params,
    reference batch, port batch) in float32 for the loss checks."""
    import jax.numpy as jnp

    rcfg, pcfg, rp, pp = pair(lm, arch, "float32")
    toks = np.random.default_rng(seed).integers(0, pcfg.vocab_size, (B, tokens), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    rctx, pctx = context(pcfg, B, seed + 1, "float32")
    rbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), "context": rctx}
    pbatch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels), "context": pctx}
    return lm.model.build(rcfg), pmodel.build(pcfg), rp, pp, rbatch, pbatch


def check_loss_and_gradients(lm, arch, seed: int = 11, tokens: int = TRAIN_S):
    """The loss (with the MoE aux loss live), its parts and every gradient
    leaf against the reference's ``value_and_grad`` in float32 (for the
    hybrid, under :func:`reference_safe_decay`).  Returns the port's
    gradients."""
    import jax

    rm, pm, rp, pp, rbatch, pbatch = f32_batch(lm, arch, seed, tokens)
    with reference_safe_decay(lm):
        (r_loss, r_parts), r_grads = jax.jit(jax.value_and_grad(lm.steps.make_loss_fn(rm), has_aux=True))(rp, rbatch)
    with port_routes() as routes:
        loss, parts, grads = steps.make_grad_fn(pm)(pp, pbatch)
    if pm.cfg.family == "moe":  # the forward's routes (remat recomputes each layer's once more)
        ref_routes = reference_routes(lambda: rm.forward(rp, rbatch["tokens"], remat=False))
        check_routes(f"{arch} loss", routes[: len(ref_routes)], ref_routes)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=LOSS_RTOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(parts[k]), float(r_parts[k]), rtol=LOSS_RTOL, err_msg=k)
    assert float(parts["acc"]) == float(r_parts["acc"])
    assert (float(parts["aux"]) > 0) == (pm.cfg.family == "moe")  # the router's aux loss is live
    r_flat = dict(flat(jax.tree.map(np.asarray, r_grads)))
    assert sorted(r_flat) == sorted(p for p, _ in flat(grads))
    worst = 0.0
    for path, g in flat(grads):
        assert g.dtype == torch.float32 and not g.requires_grad and bool(torch.isfinite(g).all()), path
        want = np.asarray(r_flat[path], np.float64)
        err = float(np.abs(g.double().numpy() - want).max())
        top = float(np.abs(want).max())
        assert g.shape == want.shape and err <= GRAD_REL * top, (path, err, top)
        worst = max(worst, err / max(top, 1e-30))
    print(f"{arch}: loss {float(loss)} vs {float(r_loss)}, aux {float(parts['aux'])}; worst gradient leaf "
          f"{worst:.3g} x max|g| (bound {GRAD_REL})")
    return grads


def check_serve_cli(lm, arch, capsys):
    """``serve_lm --device cpu --smoke --arch <arch> --gen GEN`` against the
    reference's serve loop (its eager init's bits, ``randint`` prompts, the
    zero context, jitted prefill and greedy decode), teacher-forced: every
    step's logits within the bf16 bound, the same argmax where the
    reference's top-2 margin exceeds twice it; the free-running tokens equal
    up to the first step below that margin."""
    import jax
    import jax.numpy as jnp

    rcfg = lm.configs.get_smoke(arch)
    rm = lm.model.build(rcfg)
    r_params = jax.tree.map(jnp.asarray, lm.get_params(arch))
    bsz, s = 4, 32
    prompts = jax.random.randint(jax.random.PRNGKey(1), (bsz, s), 0, rcfg.vocab_size)
    n = {"vlm": rcfg.num_image_tokens, "audio": rcfg.encoder_seq}.get(rcfg.family)
    ctx = None if n is None else jnp.zeros((bsz, n, rcfg.d_model), jnp.bfloat16)
    r_prefill = jax.jit(lm.steps.make_prefill_step(rm, max_len=s + GEN))
    r_decode = jax.jit(lm.steps.make_decode_step(rm))
    logits, cache = r_prefill(r_params, {"tokens": prompts, "context": ctx})
    r_steps = [np.asarray(logits[:, -1])]
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    r_toks = [np.asarray(tok)]
    for i in range(GEN - 1):
        tok, dl, cache = r_decode(r_params, {"cache": cache, "tokens": tok[:, None], "cache_len": jnp.int32(s + i),
                                             "context": ctx})
        r_steps.append(np.asarray(dl[:, -1]))
        r_toks.append(np.asarray(tok))
    r_toks = np.stack(r_toks, axis=1)

    run = serve.serve_lm(serve.build_parser().parse_args(
        ["--device", "cpu", "--smoke", "--arch", arch, "--gen", str(GEN)]))
    assert "[serve] OK" in capsys.readouterr().out
    assert np.array_equal(run.prompts.numpy(), np.asarray(prompts))
    assert (run.context is None) == (ctx is None)
    for path, leaf in flat(lm.get_params(arch)):
        assert np.array_equal(tbits(get(run.params, path)), bits(leaf)), path

    pm = run.model
    decided, errs = [], []
    with torch.inference_mode():
        p_logits, p_cache = steps.make_prefill_step(pm, max_len=s + GEN)(
            run.params, {"tokens": run.prompts, "context": run.context})
        p_steps = [p_logits[:, -1].numpy()]
        for i in range(GEN - 1):
            fed = torch.from_numpy(r_toks[:, i : i + 1]).long()
            _, dl, p_cache = steps.make_decode_step(pm)(
                run.params, {"cache": p_cache, "tokens": fed, "cache_len": s + i, "context": run.context})
            p_steps.append(dl[:, -1].numpy())
    for i, (got, want) in enumerate(zip(p_steps, r_steps)):
        errs.append(float(np.abs(got - want).max()))
        top2 = np.sort(want, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * BF16_ATOL
        decided.append(sure)
        assert np.array_equal(got.argmax(-1)[sure], r_toks[sure, i]), i
    print(f"{arch} serve_lm teacher-forced: max step error {max(errs):.4g} (bound {BF16_ATOL}); "
          f"decided steps {int(np.sum(decided))} of {len(decided) * bsz}")
    assert max(errs) <= BF16_ATOL
    decided = np.stack(decided, axis=1)
    for row in range(bsz):  # free running: equal up to the first undecided step
        upto = GEN if decided[row].all() else int(np.argmin(decided[row]))
        assert np.array_equal(run.tokens[row, :upto].numpy(), r_toks[row, :upto]), row


def supervisor_losses(module, monkeypatch):
    """Record the metrics every TrainSupervisor.run of ``module`` returns."""
    got = []
    real = module.TrainSupervisor.run

    def run(self, *a, **k):
        out = real(self, *a, **k)
        got.append([m["loss"] for m in out[2]])
        return out

    monkeypatch.setattr(module.TrainSupervisor, "run", run)
    return got


def run_train_clis(arch, steps_: int, tmp_path, monkeypatch):
    """The reference's train CLI, then the port's (``--device cpu``), with
    ``--arch arch --steps steps_`` and CLI_ARGS.  Returns, for each, the
    outcome ("fell", "rose" or the exception) and the per-step losses."""
    fault = importlib.import_module("repro.dist.fault")
    rtrain = importlib.import_module("repro.launch.train")
    from repro_torch.dist import fault as pfault

    losses = (supervisor_losses(fault, monkeypatch), supervisor_losses(pfault, monkeypatch))
    outcomes = []
    for main, extra in ((None, []), (train_cli.main, ["--device", "cpu"])):
        argv = ["--arch", arch, "--steps", str(steps_), "--ckpt-dir", str(tmp_path / str(len(outcomes))),
                *CLI_ARGS, *extra]
        try:
            if main is None:
                monkeypatch.setattr("sys.argv", ["train", *argv])
                rtrain.main()
            else:
                main(argv)
            outcomes.append("fell")
        except AssertionError as e:
            assert "loss did not decrease" in str(e)
            outcomes.append("rose")
        except Exception as e:  # noqa: BLE001  (compared between the packages)
            outcomes.append(e)
    return outcomes, losses
