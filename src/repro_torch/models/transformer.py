"""Model assembly for all six families: block init, the layer loops of the
forward (train / prefill) and single-token decode — the reference's
``repro.models.transformer`` in PyTorch.

The reference stacks each homogeneous group of layers (leading axis L) and
scans it with ``lax.scan``; the port keeps the stacked layout, so that the
reference's params map onto the port's leaf by leaf, and runs the scan as
a Python loop over the leading axis.  Under autograd the forward runs each
block under ``torch.utils.checkpoint`` (``remat``: the reference's
``jax.checkpoint`` per layer, full remat, nothing saved inside a block).  ``init_model`` draws the reference's
bits: ``jax.vmap`` over ``split(key, L)`` equals a loop over the split
keys.  The vlm's cross layers, the hybrid's shared (weight-tied)
attention block and the audio encoder are groups of their own, as in the
reference (:func:`init_model`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.device import resolve_device
from repro_torch.dist.hints import shard
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.embed import embed

Params = Dict[str, Any]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    """The tensor leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def layer(stack: Params, i: int) -> Params:
    """Layer ``i`` of a stacked group (views, no copy)."""
    return tree_map(lambda a: a[i], stack)


def unbind_layers(stack: Params) -> List[Params]:
    """Every layer of a stacked group, from one ``torch.unbind`` per leaf.
    Under autograd the views' gradients flow back as one ``stack`` per
    leaf; indexing each layer (:func:`layer`) would instead write a
    full-size zero tensor per layer and leaf in the backward."""
    parts = tree_map(lambda a: a.unbind(0), stack)  # a tuple of L views per leaf
    return [tree_map(lambda views, i=i: views[i], parts) for i in range(num_layers(stack))]


def num_layers(stack: Params) -> int:
    return next(tree_leaves(stack)).shape[0]


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------


def block_kind(cfg: ModelConfig) -> str:
    return {
        "dense": "attn_mlp",
        "vlm": "attn_mlp",
        "moe": "attn_moe",
        "ssm": "mamba1",
        "hybrid": "mamba2",
        "audio": "dec_cross",  # decoder blocks: self + cross + mlp
    }[cfg.family]


def init_block(key: torch.Tensor, cfg: ModelConfig, kind: str, *, device=None) -> Params:
    ks = prng.split(key, 4)
    d = cfg.d_model

    def norm():
        return L.init_norm(cfg, d, device=device)

    if kind == "attn_mlp":
        return {"ln1": norm(), "attn": L.init_attention(ks[0], cfg, device=device), "ln2": norm(),
                "mlp": L.init_mlp(ks[1], cfg, device=device)}
    if kind == "attn_moe":
        return {"ln1": norm(), "attn": L.init_attention(ks[0], cfg, device=device), "ln2": norm(),
                "moe": L.init_moe(ks[1], cfg, device=device)}
    if kind == "mamba1":
        return {"ln1": norm(), "mixer": S.init_mamba1(ks[0], cfg, device=device)}
    if kind == "mamba2":
        return {"ln1": norm(), "mixer": S.init_mamba2(ks[0], cfg, device=device)}
    if kind == "cross_mlp":  # vlm cross-attention layer
        return {"ln1": norm(), "xattn": L.init_attention(ks[0], cfg, cross=True, device=device), "ln2": norm(),
                "mlp": L.init_mlp(ks[1], cfg, device=device),
                "gate": torch.zeros((), dtype=torch.float32, device=device)}  # zero-init gated cross
    if kind == "dec_cross":  # whisper decoder layer
        return {"ln1": norm(), "attn": L.init_attention(ks[0], cfg, device=device), "lnx": norm(),
                "xattn": L.init_attention(ks[1], cfg, cross=True, device=device), "ln2": norm(),
                "mlp": L.init_mlp(ks[2], cfg, device=device)}
    raise ValueError(kind)


def apply_block(
    bp: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: str,
    *,
    positions: torch.Tensor,
    context: Optional[torch.Tensor] = None,  # image / encoder embeddings
    causal: bool = True,
    collect_cache: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Full-sequence block.  Returns (x, aux_loss, cache_piece): the roped
    (K, V) for the attention kinds, {h, conv} for the SSM kinds with
    ``collect_cache`` (prefill), else None."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kv = None
    if kind in ("attn_mlp", "attn_moe", "dec_cross"):
        h = L.apply_norm(bp["ln1"], x, cfg)
        a, kv = L.apply_attention(bp["attn"], h, cfg, positions=positions, causal=causal)
        x = x + a
        if kind == "dec_cross":
            h = L.apply_norm(bp["lnx"], x, cfg)
            x = x + L.apply_attention(bp["xattn"], h, cfg, positions=positions, kv_source=context)[0]
        h = L.apply_norm(bp["ln2"], x, cfg)
        if kind == "attn_moe":
            m, aux = L.apply_moe(bp["moe"], h, cfg)
        else:
            m = L.apply_mlp(bp["mlp"], h)
        x = x + m
    elif kind == "cross_mlp":
        h = L.apply_norm(bp["ln1"], x, cfg)
        a, _ = L.apply_attention(bp["xattn"], h, cfg, positions=positions, kv_source=context)
        x = x + torch.tanh(bp["gate"]).to(x.dtype) * a
        h = L.apply_norm(bp["ln2"], x, cfg)
        x = x + L.apply_mlp(bp["mlp"], h)
    elif kind in ("mamba1", "mamba2"):
        mix = S.apply_mamba1 if kind == "mamba1" else S.apply_mamba2
        h = L.apply_norm(bp["ln1"], x, cfg)
        if collect_cache:
            o, kv = mix(bp["mixer"], h, cfg, return_cache=True)
        else:
            o = mix(bp["mixer"], h, cfg)
        x = x + o
    else:
        raise ValueError(kind)
    return x, aux, kv


def decode_block(
    bp: Params,
    x: torch.Tensor,
    cache: Params,
    cfg: ModelConfig,
    kind: str,
    *,
    positions: torch.Tensor,
    cache_len,
    context: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Params]:
    """Single-step block over this layer's cache, written in place
    ({k, v} for the attention kinds, {h, conv} for the SSM kinds)."""
    if kind in ("attn_mlp", "attn_moe", "dec_cross"):
        h = L.apply_norm(bp["ln1"], x, cfg)
        a, new_kv = L.apply_attention(
            bp["attn"], h, cfg, positions=positions, cache=(cache["k"], cache["v"]), cache_len=cache_len
        )
        x = x + a
        if kind == "dec_cross":
            h = L.apply_norm(bp["lnx"], x, cfg)
            x = x + L.apply_attention(bp["xattn"], h, cfg, positions=positions, kv_source=context)[0]
        h = L.apply_norm(bp["ln2"], x, cfg)
        m = L.apply_moe(bp["moe"], h, cfg)[0] if kind == "attn_moe" else L.apply_mlp(bp["mlp"], h)
        return x + m, {"k": new_kv[0], "v": new_kv[1]}
    if kind in ("mamba1", "mamba2"):
        step = S.decode_mamba1 if kind == "mamba1" else S.decode_mamba2
        h = L.apply_norm(bp["ln1"], x, cfg)
        o, nc = step(bp["mixer"], h, {"h": cache["h"], "conv": cache["conv"]}, cfg)
        cache["h"].copy_(nc["h"])
        cache["conv"].copy_(nc["conv"])
        return x + o, cache
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------


def _stack_init(key: torch.Tensor, cfg: ModelConfig, kind: str, n: int, *, device=None) -> Params:
    """The reference's ``vmap(init_block)(split(key, n))``: layer i from
    split key i, written into a preallocated stack so that the peak is the
    stack plus one layer."""
    keys = prng.split(key, n)
    first = init_block(keys[0], cfg, kind, device=device)
    stack = tree_map(lambda a: torch.empty((n, *a.shape), dtype=a.dtype, device=a.device), first)
    if first and next(tree_leaves(first)).is_meta:  # shapes only: one block tells them
        return stack

    def put(i, block):
        for dst, src in zip(tree_leaves(stack), tree_leaves(block)):
            dst[i] = src

    put(0, first)
    del first
    for i in range(1, n):
        put(i, init_block(keys[i], cfg, kind, device=device))
    return stack


def init_model(key: torch.Tensor, cfg: ModelConfig, *, device=None) -> Params:
    """Build the full parameter tree (stacked per homogeneous group) on
    ``device`` (default ``"cuda"``; raises without a card), the reference's
    ``init_model(jax.random.PRNGKey(seed), cfg)`` bit for bit.  On
    ``device="meta"`` only the shapes and dtypes: nothing is drawn (``key``
    may be None) and nothing allocated."""
    dev = resolve_device(device)
    if dev.type == "meta":  # nothing is drawn: any key will do
        key = prng.PRNGKey(0) if key is None else key
    ks = prng.split(key, 8)
    dt = L._dtype(cfg)
    params: Params = {
        "embed": L.draw_normal(ks[0], (cfg.vocab_size, cfg.d_model), 0.02, dt, dev),
        "final_norm": L.init_norm(cfg, cfg.d_model, device=dev),
    }
    if cfg.family == "vlm":
        seg = cfg.cross_attn_segment
        nseg = cfg.num_layers // seg
        params["blocks"] = _stack_init(ks[1], cfg, "attn_mlp", nseg * (seg - 1), device=dev)
        params["cross_blocks"] = _stack_init(ks[2], cfg, "cross_mlp", nseg, device=dev)
    elif cfg.family == "hybrid":
        params["blocks"] = _stack_init(ks[1], cfg, "mamba2", cfg.num_layers, device=dev)
        params["shared_attn"] = init_block(ks[2], cfg, "attn_mlp", device=dev)
    elif cfg.family == "audio":
        params["enc_pos"] = L.draw_normal(ks[3], (cfg.encoder_seq, cfg.d_model), 0.02, dt, dev)
        params["enc_blocks"] = _stack_init(ks[4], cfg, "attn_mlp", cfg.encoder_layers, device=dev)
        params["enc_norm"] = L.init_norm(cfg, cfg.d_model, device=dev)
        params["blocks"] = _stack_init(ks[1], cfg, "dec_cross", cfg.num_layers, device=dev)
    else:
        params["blocks"] = _stack_init(ks[1], cfg, block_kind(cfg), cfg.num_layers, device=dev)
    return params


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then float32 logits against the tied embedding."""
    x = L.apply_norm(params["final_norm"], x, cfg)
    embed = shard(params["embed"], "tp", None)  # FSDP-gathered, vocab over TP
    return shard(x.float() @ embed.float().T, "batch", None, "tp")  # vocab stays TP-sharded


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _runner(cfg: ModelConfig, positions: torch.Tensor, recompute: bool, collect: bool = False):
    """``run(bp, x, kind, context=None, causal=True) -> (x, aux, piece)``:
    one block, under ``torch.utils.checkpoint`` when ``recompute``."""

    def run(bp, x, kind, context=None, causal=True):
        kw = dict(positions=positions, context=context, causal=causal, collect_cache=collect)
        if recompute:
            return checkpoint(apply_block, bp, x, cfg, kind, use_reentrant=False, **kw)
        return apply_block(bp, x, cfg, kind, **kw)

    return run


def _stack_pieces(pieces: List[Any]):
    """Per-layer cache pieces stacked on a leading axis: (K, V) pairs or
    {h, conv} dicts."""
    if isinstance(pieces[0], dict):
        return {k: torch.stack([p[k] for p in pieces]) for k in pieces[0]}
    return tuple(torch.stack(t) for t in zip(*pieces))


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S) int
    *,
    context: Optional[torch.Tensor] = None,  # vlm image / audio frame embeddings
    collect_kv: bool = False,
    remat: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Full-sequence forward.  Returns (logits (B, S, V) float32, aux_loss,
    (pieces, context)); with ``collect_kv`` the cache pieces stacked over
    layers (leading axis): (K, V) (L, B, S, KV, hd) for the attention
    families (the vlm's self layers only), {h, conv} for ssm, ({h, conv},
    (K, V) of the shared block's applications) for hybrid; ``context`` is
    the audio encoder's output (else as given).  With ``remat`` and
    autograd on, each block runs under ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward, not
    kept.  Serving runs without autograd, where ``remat`` changes nothing.

    Layer schedules (the reference's nested scans, as loops):
      vlm    : [ (segment - 1) self layers | 1 cross layer ] x n_segments
      hybrid : [ k mamba2 layers | shared (weight-tied) attention block ] x n_seg
    """
    b, s_len = tokens.shape
    x = shard(embed(params["embed"], tokens), "batch", None, None)
    positions = _positions(b, s_len, x.device)
    if cfg.family == "audio":
        context = _encode_audio(params, cfg, context)
    run = _runner(cfg, positions, remat and torch.is_grad_enabled(), collect_kv)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pieces, shared = [], []  # the cache pieces, kept only with collect_kv
    keep, keep_shared = (pieces.append, shared.append) if collect_kv else ((lambda _: None),) * 2
    layers = unbind_layers(params["blocks"])
    if cfg.family == "vlm":
        per = cfg.cross_attn_segment - 1
        for si, cp in enumerate(unbind_layers(params["cross_blocks"])):
            for bp in layers[si * per : (si + 1) * per]:
                x, a, kv = run(bp, x, "attn_mlp")
                aux = aux + a
                keep(kv)
            x, a, _ = run(cp, x, "cross_mlp", context)
            aux = aux + a
    elif cfg.family == "hybrid":
        every = cfg.shared_attn_every
        for si in range(cfg.num_layers // every):
            for bp in layers[si * every : (si + 1) * every]:
                x, a, sc = run(bp, x, "mamba2")
                aux = aux + a
                keep(sc)
            x, a, kv = run(params["shared_attn"], x, "attn_mlp")
            aux = aux + a
            keep_shared(kv)
    else:
        kind = block_kind(cfg)
        for bp in layers:
            x, a, piece = run(bp, x, kind, context)
            aux = aux + a
            keep(piece)
    out = None
    if collect_kv:
        out = _stack_pieces(pieces)
        if cfg.family == "hybrid":
            out = (out, _stack_pieces(shared))
    return _logits(params, cfg, x), aux, (out, context)


def _encode_audio(params: Params, cfg: ModelConfig, frames: Optional[torch.Tensor]) -> torch.Tensor:
    """Whisper encoder (non-causal) over stub conv-frontend frame
    embeddings (B, Se, D); each block recomputed in the backward, as the
    reference's ``jax.checkpoint`` does whatever ``remat`` says."""
    if frames is None:
        # the reference fails here too (``None.dtype``): its train CLI feeds no context
        raise ValueError(f"the audio family ({cfg.name}) needs a context: encoder frame embeddings (B, Se, D)")
    x = frames + params["enc_pos"][None].to(frames.dtype)
    b, se = x.shape[:2]
    run = _runner(cfg, _positions(b, se, x.device), torch.is_grad_enabled())
    for bp in unbind_layers(params["enc_blocks"]):
        x = run(bp, x, "attn_mlp", causal=False)[0]
    return L.apply_norm(params["enc_norm"], x, cfg)


# ---------------------------------------------------------------------------
# Decode (single token over cache)
# ---------------------------------------------------------------------------


def decode_step(
    params: Params,
    cfg: ModelConfig,
    cache: Params,
    tokens: torch.Tensor,  # (B, 1)
    cache_len,  # int (or 0-d tensor): tokens already in the cache
    *,
    context: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Params]:
    """One decode step.  Returns (logits (B, 1, V) float32, new cache): the
    new K/V and SSM states are written into ``cache``'s tensors in place;
    the returned dict holds the same tensors (for the vlm, views of its
    self layers' K/V, as the reference returns the n_self entries)."""
    b = tokens.shape[0]
    x = shard(embed(params["embed"], tokens), "batch", None, None)
    positions = torch.full((b, 1), int(cache_len), dtype=torch.int32, device=x.device)  # lint: disable=host-sync-in-step -- cache_len is the serve loop's host int
    if cfg.family == "audio":
        context = cache["enc_out"]

    def step(bp, x, kind, i, k="k", v="v"):  # layer i's cache entries, written in place
        names = {"h": "h", "conv": "conv"} if kind in ("mamba1", "mamba2") else {"k": k, "v": v}
        sl = {a: cache[n][i] for a, n in names.items()}
        return decode_block(bp, x, sl, cfg, kind, positions=positions, cache_len=cache_len, context=context)[0]

    new_cache = dict(cache)
    blocks = params["blocks"]
    if cfg.family == "vlm":
        per = cfg.cross_attn_segment - 1
        for si, cp in enumerate(unbind_layers(params["cross_blocks"])):
            for i in range(si * per, (si + 1) * per):
                x = step(layer(blocks, i), x, "attn_mlp", i)
            x, _, _ = apply_block(cp, x, cfg, "cross_mlp", positions=positions, context=context)
        n_self = num_layers(blocks)
        new_cache["k"], new_cache["v"] = cache["k"][:n_self], cache["v"][:n_self]
    elif cfg.family == "hybrid":
        every = cfg.shared_attn_every
        for si in range(cfg.num_layers // every):
            for i in range(si * every, (si + 1) * every):
                x = step(layer(blocks, i), x, "mamba2", i)
            x = step(params["shared_attn"], x, "attn_mlp", si, "shared_k", "shared_v")
    else:
        kind = block_kind(cfg)
        for i in range(num_layers(blocks)):
            x = step(layer(blocks, i), x, kind, i)
    return _logits(params, cfg, x), new_cache
