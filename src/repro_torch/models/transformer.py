"""Model assembly of the dense family: block init, the layer loop of the
forward (train / prefill) and single-token decode — the reference's
``repro.models.transformer`` in PyTorch.

The reference stacks each homogeneous group of layers (leading axis L) and
scans it with ``lax.scan``; the port keeps the stacked layout, so that the
reference's params map onto the port's leaf by leaf, and runs the scan as
a Python loop over the leading axis.  Under autograd the forward runs each
block under ``torch.utils.checkpoint`` (``remat``: the reference's
``jax.checkpoint`` per layer, full remat, nothing saved inside a block).  ``init_model`` draws the reference's
bits: ``jax.vmap`` over ``split(key, L)`` equals a loop over the split
keys.  The other families raise ``NotImplementedError`` naming their
ROADMAP item (``kvcache.require_dense``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.kvcache import require_dense

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


def _require_attn_mlp(kind: str) -> None:
    if kind != "attn_mlp":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet (ROADMAP queue 1 item 10.1.3)")


def init_block(key: torch.Tensor, cfg: ModelConfig, kind: str, *, device=None) -> Params:
    _require_attn_mlp(kind)
    ks = prng.split(key, 4)
    d = cfg.d_model
    return {
        "ln1": L.init_norm(cfg, d, device=device),
        "attn": L.init_attention(ks[0], cfg, device=device),
        "ln2": L.init_norm(cfg, d, device=device),
        "mlp": L.init_mlp(ks[1], cfg, device=device),
    }


def apply_block(
    bp: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: str,
    *,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal block.  Returns (x, aux_loss, (roped K, V))."""
    _require_attn_mlp(kind)
    h = L.apply_norm(bp["ln1"], x, cfg)
    a, kv = L.apply_attention(bp["attn"], h, cfg, positions=positions)
    x = x + a
    h = L.apply_norm(bp["ln2"], x, cfg)
    x = x + L.apply_mlp(bp["mlp"], h)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), kv


def decode_block(
    bp: Params,
    x: torch.Tensor,
    cache: Params,
    cfg: ModelConfig,
    kind: str,
    *,
    positions: torch.Tensor,
    cache_len,
) -> Tuple[torch.Tensor, Params]:
    """Single-step block over this layer's cache (written in place)."""
    _require_attn_mlp(kind)
    h = L.apply_norm(bp["ln1"], x, cfg)
    a, new_kv = L.apply_attention(
        bp["attn"], h, cfg, positions=positions, cache=(cache["k"], cache["v"]), cache_len=cache_len
    )
    x = x + a
    h = L.apply_norm(bp["ln2"], x, cfg)
    return x + L.apply_mlp(bp["mlp"], h), {"k": new_kv[0], "v": new_kv[1]}


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
    ``init_model(jax.random.PRNGKey(seed), cfg)`` bit for bit."""
    require_dense(cfg)
    dev = resolve_device(device)
    ks = prng.split(key, 8)
    dt = L._dtype(cfg)
    return {
        "embed": L.draw_normal(ks[0], (cfg.vocab_size, cfg.d_model), 0.02, dt, dev),
        "final_norm": L.init_norm(cfg, cfg.d_model, device=dev),
        "blocks": _stack_init(ks[1], cfg, block_kind(cfg), cfg.num_layers, device=dev),
    }


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then float32 logits against the tied embedding."""
    x = L.apply_norm(params["final_norm"], x, cfg)
    return x.float() @ params["embed"].float().T


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S) int
    *,
    collect_kv: bool = False,
    remat: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Full-sequence forward.  Returns (logits (B, S, V) float32, aux_loss,
    (kvs, None)); kvs = (K, V) stacked (L, B, S, KV, hd) when
    ``collect_kv``.  With ``remat`` and autograd on, each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward, not kept.  Serving runs without autograd,
    where ``remat`` changes nothing."""
    require_dense(cfg)
    b, s_len = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s_len, dtype=torch.int32, device=x.device)[None].expand(b, s_len)
    kind = block_kind(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    recompute = remat and torch.is_grad_enabled()
    ks, vs = [], []
    for bp in unbind_layers(params["blocks"]):
        if recompute:
            x, a, kv = checkpoint(apply_block, bp, x, cfg, kind, positions=positions, use_reentrant=False)
        else:
            x, a, kv = apply_block(bp, x, cfg, kind, positions=positions)
        aux = aux + a
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return _logits(params, cfg, x), aux, (kvs, None)


# ---------------------------------------------------------------------------
# Decode (single token over cache)
# ---------------------------------------------------------------------------


def decode_step(
    params: Params,
    cfg: ModelConfig,
    cache: Params,
    tokens: torch.Tensor,  # (B, 1)
    cache_len,  # int (or 0-d tensor): tokens already in the cache
) -> Tuple[torch.Tensor, Params]:
    """One decode step.  Returns (logits (B, 1, V) float32, cache); the new
    K/V are written into ``cache``'s tensors in place."""
    require_dense(cfg)
    b = tokens.shape[0]
    x = params["embed"][tokens]
    positions = torch.full((b, 1), int(cache_len), dtype=torch.int32, device=x.device)
    kind = block_kind(cfg)
    for i in range(num_layers(params["blocks"])):
        x, _ = decode_block(
            layer(params["blocks"], i), x, {"k": cache["k"][i], "v": cache["v"][i]}, cfg, kind,
            positions=positions, cache_len=cache_len,
        )
    return _logits(params, cfg, x), cache
