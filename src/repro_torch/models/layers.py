"""Transformer building blocks: norms, RoPE, chunked (flash) attention
with GQA / sliding window / cross-attention, decode attention over a KV
cache, the SwiGLU MLP and the sort-based top-k MoE — the reference's
``repro.models.layers`` in PyTorch.

Conventions (the reference's):
- Params are plain nested dicts of tensors; ``init_*`` builds them, the
  matching ``apply_*`` consumes them.
- Activations are in ``cfg.dtype``; softmax statistics and norms run in
  float32.  A product the reference asks for with
  ``preferred_element_type=float32`` widens both operands to float32.
- Weights are drawn as the reference draws them: float32 normals from the
  threefry key (``core.prng``), times the scale as a float32 scalar,
  rounded to the model dtype; so the bits are the reference's.

The reference's sharding hints sit where the reference puts them
(``dist.hints.shard``, ``current_mesh``): the identity on plain tensors, so
they change no bit there; on DTensors under an ambient mesh they place the
attention's query, the MLP's hidden layer and the MoE's expert buffers
(``expert_sharding`` "ep" / "tp"), and with a ``model`` axis that does not
divide the heads the attention runs sequence-parallel (one query chunk).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.dist.hints import current_mesh, is_dtensor, local_map, mesh_axes, shard, spec_placements
from repro_torch.models.flash import NEG_INF, flash_attention

Params = Dict[str, Any]
CacheLen = Union[int, torch.Tensor]

# elements of one weight draw at a time: the threefry passes hold several
# int64 temporaries per element, so a full-width leaf is drawn in pieces
INIT_CHUNK = 1 << 24


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's dtype promotion: operands of two float dtypes
    (a bf16 activation against a float32 weight or context) both widen to
    the wider one first, where PyTorch would raise."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def draw_normal(key: torch.Tensor, shape, scale: float, dtype: torch.dtype, device) -> torch.Tensor:
    """``(jax.random.normal(key, shape) * scale).astype(dtype)``, bit for bit:
    float32 normals times ``scale`` rounded to float32 (the reference's
    weakly typed multiply), rounded to ``dtype`` to nearest even.  Drawn
    ``INIT_CHUNK`` elements at a time through ``prng.normal(offset=)``,
    which gives the bits of one whole draw."""
    shape = tuple(int(s) for s in shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:  # shapes and dtypes only
        return out
    flat = out.view(-1)
    s = torch.full((), scale, dtype=torch.float32, device=device)
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


def init_attention(key: torch.Tensor, cfg: ModelConfig, *, cross: bool = False, device=None) -> Params:
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
    if cfg.qk_norm and not cross:
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
    materialises the (Sq, Sk) scores.

    Sequence-parallel fallback (the reference's): when the ambient mesh's
    ``model`` axis does not divide the heads (qwen3: 40 on 16, whisper: 8
    on 16) but divides the query length, the query positions shard over it
    and run as one chunk; otherwise the heads shard."""
    sq, h = q.shape[1], q.shape[2]
    mesh = current_mesh()
    tp = mesh_axes(mesh).get("model", 1) if mesh is not None else 1
    seq_parallel = tp > 1 and h % tp != 0 and sq % tp == 0
    qc = sq if seq_parallel else _largest_divisor(sq, q_chunk)
    kc = _largest_divisor(k.shape[1], kv_chunk)
    if seq_parallel:
        qs = shard(q, "batch", "tp", None, None)
    else:
        qs = shard(q, "batch", None, "tp", None)
    if not is_dtensor(qs):
        return flash_attention(qs, k, v, causal, window, q_offset, qc, kc).to(q.dtype)
    return _flash_local(qs, k, v, causal, window, q_offset, qc, kc, seq_parallel).to(q.dtype)


def _flash_local(q, k, v, causal, window, q_offset, qc, kc, seq_parallel):
    """``flash_attention`` on DTensors, each rank on its own shards: its
    batch rows and heads, or (``seq_parallel``) its batch rows and query
    positions against the whole K/V, the causal mask offset by its first
    position.  A rank's query heads read their own K/V heads (a GQA group
    is picked out of replicated K/V where the ``model`` axis does not
    divide the KV heads); K/V that feed different work on each rank take
    ``Partial`` gradients."""
    from torch.distributed.tensor import Partial, Replicate

    dm = q.device_mesh
    mi = dm.mesh_dim_names.index("model") if "model" in dm.mesh_dim_names else None
    r = dm.get_local_rank("model") if mi is not None else 0
    h, kvh = q.shape[2], k.shape[2]
    pick = None
    if seq_parallel:
        qpl = spec_placements(("batch", "tp"), q)
        kpl = spec_placements(("batch",), k)
        qcl = qc // dm.size(mi)
        q_offset = q_offset + r * qcl
    else:
        qpl = spec_placements(("batch", None, "tp"), q)
        kpl = spec_placements(("batch", None, "tp"), k)
        qcl = qc
        if mi is not None and qpl[mi] != Replicate() and kpl[mi] == Replicate():
            hl = h // dm.size(mi)  # this rank's query heads read these KV heads
            pick = torch.div(r * hl + torch.arange(hl, device=k.device), h // kvh, rounding_mode="floor")
    gpl = kpl
    if mi is not None and kpl[mi] == Replicate() and qpl[mi] != Replicate():
        gpl = tuple(Partial() if i == mi else p for i, p in enumerate(kpl))

    def local(q, k, v):
        if pick is not None:
            k, v = k[:, :, pick], v[:, :, pick]
        return flash_attention(q, k, v, causal, window, q_offset, qcl, kc)

    return local_map(local, (q, k, v), (qpl, kpl, kpl), qpl, (None, gpl, gpl))


def _tp_splits(n: int) -> bool:
    """Whether the ambient mesh's ``model`` axis (if any) divides ``n``
    heads: a view cannot split a head across devices."""
    mesh = current_mesh()
    return mesh is None or n % mesh_axes(mesh).get("model", 1) == 0


def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd), a DTensor's TP-sharded feature dim
    gathered first where the heads do not split over ``model``."""
    if not _tp_splits(n):
        t = shard(t, "batch")
    return t.reshape(t.shape[0], t.shape[1], n, hd)


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
    kv_source: Optional[torch.Tensor] = None,  # cross-attention source (B, S_src, D)
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (K, V) (B, S_cache, KV, hd)
    cache_len: Optional[CacheLen] = None,  # valid prefix of the cache
    causal: bool = True,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self- or cross-attention.  Returns (output, kv).

    Forward / prefill (no cache): kv is the roped (K, V) of x, which prefill
    turns into the decode cache.  Decode: the new K/V are written into the
    given cache tensors at ``cache_len`` (at ``cache_len % window`` in a
    sliding-window ring) IN PLACE, attention runs over the cache, and kv is
    that cache.  With ``kv_source`` K/V come from that source, with no RoPE,
    no window and no mask (``causal`` is ignored).
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    src = x if kv_source is None else kv_source
    # the weights as the products use them: FSDP-gathered, TP-sharded
    # (identities on plain tensors)
    wq, wk, wv = (shard(p[n], None, "tp") for n in ("wq", "wk", "wv"))
    # row-parallel only where the heads split (its gradient is viewed per head)
    wo = shard(p["wo"], "tp" if _tp_splits(h) else None, None)
    q = _heads(x @ wq, h, hd)
    kproj = _heads(matmul(src, wk), kv, hd)
    vproj = _heads(matmul(src, wv), kv, hd)

    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q)
        kproj = rms_head_norm(p["k_norm"], kproj)

    is_cross = kv_source is not None
    if not is_cross:
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
        return shard(out @ wo, "batch"), (ck, cv)

    out = chunked_attention(q, kproj, vproj, causal=causal and not is_cross,
                            window=0 if is_cross else cfg.sliding_window)
    out = out.reshape(b, s, h * hd)
    if is_dtensor(out) and not _tp_splits(h):
        # wo replicated, out sharded over batch and (sequence-parallel)
        # sequence: a product per shard, as torch 2.11's DTensor refuses to
        # flatten the two sharded dims
        return shard(_rows_matmul(out, wo), "batch"), (kproj, vproj)
    # the row-parallel product reduced where it is made (in its dtype)
    return shard(out @ wo, "batch"), (kproj, vproj)


def _rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a DTensor ``x`` (B, S, K) whose leading dims may be
    sharded (on several mesh dims) and a replicated ``w`` (K, N), on each
    rank's rows; ``w``'s gradient is Partial() over the rows' mesh dims."""
    from torch.distributed.tensor import Partial, Replicate

    x_pl = tuple(Replicate() if p.is_partial() or p.is_shard(x.ndim - 1) else p for p in x.placements)
    w_pl = (Replicate(),) * len(x_pl)
    w_grad = tuple(Partial() if p.is_shard() else Replicate() for p in x_pl)
    return local_map(torch.matmul, (x, w), (x_pl, w_pl), x_pl, grad_placements=(None, w_grad))


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, valid_len: int) -> torch.Tensor:
    """Small-Sq attention over a (possibly partly filled) cache, in the
    reference's factored GQA form (no KV-head repeat): q heads grouped as
    (KV, H/KV); cache positions >= ``valid_len`` are masked."""
    if is_dtensor(q):  # each rank on its batch rows and KV groups
        names = ("batch", None, "tp") if not k.shape[2] % mesh_axes(current_mesh()).get("model", 1) else ("batch",)
        qpl, kpl = spec_placements(names, q), spec_placements(names, k)
        return local_map(lambda q, k, v: _decode_attention(q, k, v, valid_len=valid_len), (q, k, v),
                         (qpl, kpl, kpl), qpl)
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
# MLP (SwiGLU) and MoE
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
    w1, w3, w2 = shard(p["w1"], None, "tp"), shard(p["w3"], None, "tp"), shard(p["w2"], "tp", None)
    h = torch.nn.functional.silu(x @ w1) * (x @ w3)
    h = shard(h, "batch", None, "tp")  # (B, S, F): keep TP on d_ff
    return shard(h @ w2, "batch")


def init_moe(key: torch.Tensor, cfg: ModelConfig, *, device=None) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    ks = prng.split(key, 4)
    dt = _dtype(cfg)
    std = d**-0.5
    return {
        "router": draw_normal(ks[0], (d, e), std, torch.float32, device),
        "w1": draw_normal(ks[1], (e, d, f), std, dt, device),
        "w3": draw_normal(ks[2], (e, d, f), std, dt, device),
        "w2": draw_normal(ks[3], (e, f, d), f**-0.5, dt, device),
    }


def _capacity(tokens_per_row: int, cfg: ModelConfig) -> int:
    """Slots per expert and batch row: lossless up to 128 routed slots
    (padded to a multiple of 8), else ``capacity_factor`` x the even share,
    rounded up to a multiple of 128 past 128 (of 8 below)."""
    full = tokens_per_row * cfg.experts_per_token
    if full <= 128:
        return max(((full + 7) // 8) * 8, cfg.experts_per_token)
    c = int(full * cfg.capacity_factor / cfg.num_experts)  # lint: disable=host-sync-in-step -- config arithmetic on Python numbers
    if c >= 128:
        return ((c + 127) // 128) * 128
    return max(((c + 7) // 8) * 8, cfg.experts_per_token)


class Routing(NamedTuple):
    """One MoE layer's routing: ``probs`` (B, S, E) float32, the top-k
    ``gate_idx`` (B, S, k), the row-local stable sort of the S*k routed
    slots by expert (``order``, ``sorted_e``, and ``sorted_w`` the slots'
    renormalised gate values), each slot's position in its expert's segment
    (``seg_pos``) and whether it fits the capacity (``keep``), and the
    load-balancing ``aux`` loss."""

    probs: torch.Tensor
    gate_idx: torch.Tensor
    order: torch.Tensor
    sorted_e: torch.Tensor
    sorted_w: torch.Tensor
    seg_pos: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor


def route_moe(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The router of :func:`apply_moe`.  ``jax.lax.top_k`` puts the lower
    expert first on a tie and ``jnp.argsort`` is stable, so both are a
    stable sort here (``torch.topk`` promises no order on ties)."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = _capacity(s, cfg)
    logits = x.float() @ p["router"]  # (b, s, e) float32
    probs = torch.softmax(logits, dim=-1)
    gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(gate_idx, e).to(torch.float32).sum(dim=2).mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)

    flat_e = gate_idx.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=1, stable=True)  # row-local sort
    sorted_e = torch.gather(flat_e, 1, order)
    sorted_w = torch.gather(gate_vals.reshape(b, s * k), 1, order)
    one_hot = torch.nn.functional.one_hot(sorted_e, e)  # (b, sk, e)
    seg_prefix = torch.cumsum(one_hot, dim=1) - one_hot
    seg_pos = torch.gather(seg_prefix, 2, sorted_e[..., None])[..., 0]
    return Routing(probs, gate_idx, order, sorted_e, sorted_w, seg_pos, seg_pos < c, aux)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(t, idx[..., None], axis=1)`` for t (B, N, D)."""
    return torch.gather(t, 1, idx[..., None].expand(*idx.shape, t.shape[-1]))


def _experts(buf, w1, w3, w2):
    """The experts' SwiGLU on their (B, E, C, D) buffers."""
    h = torch.einsum("becd,edf->becf", buf, w1)
    g = torch.einsum("becd,edf->becf", buf, w3)
    return torch.einsum("becf,efd->becd", torch.nn.functional.silu(h) * g, w2)


def _experts_local(buf, w1, w3, w2, ep: bool):
    """:func:`_experts` on DTensors, each rank on its shards: its batch rows
    and, with ``ep``, its experts (the weights' FSDP dim gathered), else
    its slice of every expert's FFN width (the output a partial sum over
    ``model``).  Weights take partial gradients over the batch axes."""
    from torch.distributed.tensor import Partial

    if ep:
        bpl = spec_placements(("batch", "tp"), buf)
        w13, w2pl = spec_placements(("tp",), w1), spec_placements(("tp",), w2)
        opl, bgrad = bpl, bpl
    else:
        bpl = spec_placements(("batch",), buf)
        w13, w2pl = spec_placements((None, None, "tp"), w1), spec_placements((None, "tp"), w2)
        split = tuple(i for i, p in enumerate(w13) if p.is_shard())  # the width's mesh dims
        opl = tuple(Partial() if i in split else p for i, p in enumerate(bpl))
        bgrad = opl
    batch_dims = {i for i, p in enumerate(bpl) if p.is_shard() and p.dim == 0}

    def wgrad(pl):
        return tuple(Partial() if i in batch_dims else p for i, p in enumerate(pl))

    return local_map(lambda *a: _experts(*a).contiguous(), (buf, w1, w3, w2), (bpl, w13, w13, w2pl), opl,
                     (bgrad, wgrad(w13), wgrad(w13), wgrad(w2pl)))


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based top-k MoE with per-batch-row dispatch.  Returns (output,
    aux_loss).

    Each batch row sorts its own S*k token-expert slots by expert; expert
    e's slots are then the contiguous sorted range [starts_e, starts_e +
    count_e), so its (C, D) buffer is a gather at computed positions.
    Slots past the capacity C are dropped (their tokens pass through the
    residual).  The expert outputs go back to their slots by a gather, are
    weighted, un-sorted and summed over each token's k copies."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = _capacity(s, cfg)
    r = route_moe(p, x, cfg)
    sk = s * k
    seg_pos_c = torch.where(r.keep, r.seg_pos, c - 1)

    counts = torch.nn.functional.one_hot(r.sorted_e, e).sum(dim=1)  # (b, e)
    starts = torch.cumsum(counts, dim=1) - counts
    slot = torch.arange(e * c, device=x.device)
    slot_e, slot_p = slot // c, slot % c
    src = starts[:, slot_e] + slot_p[None, :]  # (b, e*c)
    valid = slot_p[None, :] < counts[:, slot_e]
    xin = _rows(x, r.order // k)  # (b, sk, d): each sorted slot's token
    buf = torch.where(valid[..., None], _rows(xin, torch.clamp_max(src, sk - 1)), 0)
    buf = buf.reshape(b, e, c, d).to(x.dtype)

    if cfg.expert_sharding == "ep":
        # the expert axis shards over model; batch-sharded tokens into the
        # E-sharded buffer is the all-to-all
        buf = shard(buf, "batch", "tp", None, None)
    else:
        # expert-TP: buffer replicated over model, the expert FFN width
        # sharded; the combine all-reduces out_e
        buf = shard(buf, "batch", None, None, None)
    if is_dtensor(buf):
        out_e = _experts_local(buf, p["w1"], p["w3"], p["w2"], cfg.expert_sharding == "ep")
    else:
        out_e = _experts(buf, p["w1"], p["w3"], p["w2"])

    vals = _rows(out_e.reshape(b, e * c, d), r.sorted_e * c + seg_pos_c)  # (b, sk, d)
    vals = vals * torch.where(r.keep, r.sorted_w, 0.0)[..., None].to(vals.dtype)
    vals = _rows(vals, torch.argsort(r.order, dim=1))
    return vals.reshape(b, s, k, d).sum(dim=2).to(x.dtype), r.aux
