"""Transformer building blocks of the dense family: norms, RoPE, chunked
(flash) attention with GQA / sliding window, decode attention over a KV
cache, and the SwiGLU MLP — the reference's ``repro.models.layers`` in
PyTorch.

Conventions (the reference's):
- Params are plain nested dicts of tensors; ``init_*`` builds them, the
  matching ``apply_*`` consumes them.
- Activations are in ``cfg.dtype``; softmax statistics and norms run in
  float32.  A product the reference asks for with
  ``preferred_element_type=float32`` widens both operands to float32.
- Weights are drawn as the reference draws them: float32 normals from the
  threefry key (``core.prng``), times the scale as a float32 scalar,
  rounded to the model dtype; so the bits are the reference's.

The reference's sharding hints (``dist.hints.shard``, ``current_mesh``)
are the identity without a mesh and are left out (meshes: ROADMAP queue 1
item 7b).  The MoE layers wait for the ``moe`` slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.models.flash import NEG_INF, flash_attention

Params = Dict[str, Any]
CacheLen = Union[int, torch.Tensor]

# elements of one weight draw at a time: the threefry passes hold several
# int64 temporaries per element, so a full-width leaf is drawn in pieces
INIT_CHUNK = 1 << 24


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def draw_normal(key: torch.Tensor, shape, scale: float, dtype: torch.dtype, device) -> torch.Tensor:
    """``(jax.random.normal(key, shape) * scale).astype(dtype)``, bit for bit:
    float32 normals times ``scale`` rounded to float32 (the reference's
    weakly typed multiply), rounded to ``dtype`` to nearest even.  Drawn
    ``INIT_CHUNK`` elements at a time through ``prng.normal(offset=)``,
    which gives the bits of one whole draw."""
    shape = tuple(int(s) for s in shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    s = torch.tensor(scale, dtype=torch.float32, device=device)
    for a in range(0, flat.numel(), INIT_CHUNK):
        b = min(a + INIT_CHUNK, flat.numel())
        flat[a:b] = (prng.normal(key, (b - a,), offset=a, device=device) * s).to(dtype)
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, d: int, *, device=None) -> Params:
    if cfg.norm == "layernorm_np":
        return {}  # olmo-style non-parametric LN: no learnable scale/bias
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm_np":
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-5)
    else:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p["scale"]
    return out.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-head-dim RMSNorm (qwen3 qk_norm); scale shape (head_dim,)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, *, device=None) -> torch.Tensor:
    e = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # theta as a float32 scalar (the reference's weak type); a Python number,
    # so no host-to-device copy waits on the stream
    return 1.0 / torch.pow(float(torch.tensor(theta, dtype=torch.float32)), e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def init_attention(key: torch.Tensor, cfg: ModelConfig, *, device=None) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ks = prng.split(key, 4)
    std = d**-0.5
    dt = _dtype(cfg)
    p: Params = {
        "wq": draw_normal(ks[0], (d, h * hd), std, dt, device),
        "wk": draw_normal(ks[1], (d, kv * hd), std, dt, device),
        "wv": draw_normal(ks[2], (d, kv * hd), std, dt, device),
        "wo": draw_normal(ks[3], (h * hd, d), std, dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    return p


def _largest_divisor(n: int, cap: int) -> int:
    c = min(cap, n)
    while n % c:  # largest divisor fallback keeps odd lengths exact
        c -= 1
    return c


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd)
    *,
    causal: bool,
    window: int = 0,
    q_offset: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention (``flash_attention``) with chunk sizes the
    largest divisors of the lengths within ``q_chunk`` / ``kv_chunk``; never
    materialises the (Sq, Sk) scores."""
    qc = _largest_divisor(q.shape[1], q_chunk)
    kc = _largest_divisor(k.shape[1], kv_chunk)
    return flash_attention(q, k, v, causal, window, q_offset, qc, kc).to(q.dtype)


def _write(cache: torch.Tensor, new: torch.Tensor, idx: int) -> torch.Tensor:
    """``lax.dynamic_update_slice(cache, new, (0, idx, 0, 0))`` in place: the
    start clamped so that the update fits, as XLA clamps it."""
    idx = min(max(idx, 0), cache.shape[1] - new.shape[1])
    cache[:, idx : idx + new.shape[1]] = new.to(cache.dtype)
    return cache


def apply_attention(
    p: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (B, S)
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (K, V) (B, S_cache, KV, hd)
    cache_len: Optional[CacheLen] = None,  # valid prefix of the cache
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention.  Returns (output, kv).

    Forward / prefill (no cache): kv is the roped (K, V) of x, which prefill
    turns into the decode cache.  Decode: the new K/V are written into the
    given cache tensors at ``cache_len`` (at ``cache_len % window`` in a
    sliding-window ring) IN PLACE, attention runs over the cache, and kv is
    that cache.
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    kproj = (x @ p["wk"]).reshape(b, s, kv, hd)
    vproj = (x @ p["wv"]).reshape(b, s, kv, hd)

    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q)
        kproj = rms_head_norm(p["k_norm"], kproj)

    q = apply_rope(q, positions, cfg.rope_theta)
    kproj = apply_rope(kproj, positions, cfg.rope_theta)

    if cache is not None:
        ck, cv = cache
        n = int(cache_len)
        if cfg.sliding_window and ck.shape[1] == cfg.sliding_window:
            # ring buffer for SWA: slot j holds the position p with
            # p % window == j; the valid count masks the unwritten slots
            idx = n % cfg.sliding_window
            valid = min(n + s, cfg.sliding_window)
        else:
            idx, valid = n, n + s
        _write(ck, kproj, idx)
        _write(cv, vproj, idx)
        out = _decode_attention(q, ck, cv, valid_len=valid)
        return out @ p["wo"], (ck, cv)

    out = chunked_attention(q, kproj, vproj, causal=True, window=cfg.sliding_window)
    return out.reshape(b, s, h * hd) @ p["wo"], (kproj, vproj)


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, valid_len: int) -> torch.Tensor:
    """Small-Sq attention over a (possibly partly filled) cache, in the
    reference's factored GQA form (no KV-head repeat): q heads grouped as
    (KV, H/KV); cache positions >= ``valid_len`` are masked."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qr = q.reshape(b, sq, kvh, rep, hd)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qr.float(), k.float()) * hd**-0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    s = torch.where((kpos < valid_len)[None, None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", p.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h * hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(key: torch.Tensor, cfg: ModelConfig, d_ff: Optional[int] = None, *, device=None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    ks = prng.split(key, 3)
    dt = _dtype(cfg)
    std = d**-0.5
    return {
        "w1": draw_normal(ks[0], (d, f), std, dt, device),
        "w3": draw_normal(ks[1], (d, f), std, dt, device),
        "w2": draw_normal(ks[2], (f, d), f**-0.5, dt, device),
    }


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]
