"""State-space sequence mixers: Mamba-1 (falcon-mamba) and Mamba-2
(zamba2) — the reference's ``repro.models.ssm`` in PyTorch.

Both run a chunked scan: the sequence is split into ``cfg.ssm_chunk``-long
chunks (the largest divisor of the length within it); inside a chunk the
recurrence runs in parallel (the reference's ``lax.associative_scan``
recursion for Mamba-1, the SSD matmul form for Mamba-2) and a Python loop
carries the state across chunks, so the (B, chunk, d_inner, d_state)
working set is never built at full sequence length.

Decode is a single-step recurrence over an explicit (state, conv tail)
cache.  Projections stay separate leaves ([z|x|B|C|dt] unfused), as in the
reference.  ``softplus`` is the reference's ``logaddexp(x, 0)``, not
``torch.nn.functional.softplus`` (which returns ``x`` past a threshold).
The init draws the reference's bits: ``prng.uniform`` and ``f32math``'s
``exp``, ``expm1`` and ``log`` evaluate as its compiled code does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import f32math, prng
from repro_torch.dist.hints import is_dtensor, local_map, shard, spec_placements
from repro_torch.models.layers import _dtype, draw_normal, matmul

Params = Dict[str, Any]


def dt_rank(cfg: ModelConfig) -> int:
    return math.ceil(cfg.d_model / 16)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq: x (B, S, C), w (K, C), b (C).  A
    DTensor ``x`` is convolved on each rank's (batch, channel) shard
    (``local_map``): torch 2.11's DTensor fails in ``F.pad``'s strategy on
    a (Shard(0), Shard(2)) input."""
    if is_dtensor(x):
        return _causal_conv_sharded(x, w, b)
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i : i + s] * w[i]
    return out + b


def _causal_conv_sharded(x, w, b) -> torch.Tensor:
    """:func:`_causal_conv` per shard: the sequence gathered, the batch kept,
    the weights cut to x's channel shards; their gradients are Partial()
    over the batch's mesh dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    x_pl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in x.placements)

    def weight(dim):
        return (tuple(Shard(dim) if p.is_shard(2) else Replicate() for p in x_pl),
                tuple(Shard(dim) if p.is_shard(2) else Partial() if p.is_shard(0) else Replicate() for p in x_pl))

    (w_pl, w_grad), (b_pl, b_grad) = weight(1), weight(0)
    return local_map(_causal_conv, (x, w, b), (x_pl, w_pl, b_pl), x_pl, grad_placements=(None, w_grad, b_grad))


def _conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-token conv: window (B, K, C) holds the last K raw inputs."""
    return torch.einsum("bkc,kc->bc", window, w) + b


def _chunks(t: torch.Tensor, nchunk: int, lc: int):
    """The ``nchunk`` chunks of length ``lc`` along t's axis 1 (views; a
    DTensor sharded along the sequence is gathered first)."""
    return t.split(lc, dim=1)


def _chunk_len(cfg: ModelConfig, s_len: int) -> int:
    lc = min(cfg.ssm_chunk, s_len)
    while s_len % lc:  # largest divisor fallback (exactness > speed)
        lc -= 1
    return lc


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (``even`` may hold one
    more); stacked, not written into a new buffer, so a DTensor keeps its
    sharding."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return out if even.shape[1] == n else torch.cat([out, even[:, n:]], dim=1)


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.associative_scan(combine, (a, b), axis=1)`` for the linear
    recurrence ``combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)``, by the
    same odd/even recursion (so the same products and sums): combine
    adjacent pairs, scan the pairs, combine the odd prefixes with the even
    elements, interleave.  log2(n) levels of elementwise ops."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_lo, b_lo, a_hi, b_hi = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = associative_scan(a_lo * a_hi, a_hi * b_lo + b_hi)
    a2, b2 = a[:, 2::2], b[:, 2::2]
    if n % 2 == 0:
        even_a, even_b = odd_a[:, :-1] * a2, a2 * odd_b[:, :-1] + b2
    else:
        even_a, even_b = odd_a * a2, a2 * odd_b + b2
    even_a = torch.cat([a[:, :1], even_a], dim=1)
    even_b = torch.cat([b[:, :1], even_b], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------


def init_mamba1(key: torch.Tensor, cfg: ModelConfig, *, device=None) -> Params:
    d, di, s, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    r = dt_rank(cfg)
    ks = prng.split(key, 8)
    dt = _dtype(cfg)
    std = d**-0.5
    f32 = torch.float32
    # the reference draws dt_init and out_proj from the same key, ks[6]
    dt_init = f32math.exp(prng.uniform(ks[6], (di,), minval=math.log(1e-3), maxval=math.log(1e-1), device=device))
    return {
        "in_x": draw_normal(ks[0], (d, di), std, dt, device),
        "in_z": draw_normal(ks[1], (d, di), std, dt, device),
        "conv_w": draw_normal(ks[2], (k, di), k**-0.5, dt, device),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "xp_dt": draw_normal(ks[3], (di, r), di**-0.5, dt, device),
        "xp_B": draw_normal(ks[4], (di, s), di**-0.5, dt, device),
        "xp_C": draw_normal(ks[5], (di, s), di**-0.5, dt, device),
        "dt_proj": draw_normal(ks[7], (r, di), r**-0.5, f32, device),
        "dt_bias": f32math.log(f32math.expm1(dt_init)),
        "A_log": f32math.log(torch.arange(1, s + 1, dtype=f32, device=device).expand(di, s).contiguous()),
        "D": torch.ones((di,), dtype=f32, device=device),
        "out_proj": draw_normal(ks[6], (di, d), di**-0.5, dt, device),
    }


def apply_mamba1(p: Params, x: torch.Tensor, cfg: ModelConfig, *, return_cache: bool = False):
    """Full-sequence forward, chunked scan.  x: (B, S, D) -> (B, S, D).

    With ``return_cache`` also returns {h, conv}: the final SSM state and
    the last ssm_conv - 1 raw conv inputs, :func:`decode_mamba1`'s cache."""
    b, s_len, _ = x.shape
    di, ns = cfg.d_inner, cfg.ssm_state
    lc = _chunk_len(cfg, s_len)
    nchunk = s_len // lc

    w = _mamba1_weights(p)
    xin_raw = shard(x @ w["in_x"], "batch", None, "tp")
    z = x @ w["in_z"]
    xin = F.silu(_causal_conv(xin_raw, p["conv_w"], p["conv_b"]))
    dt = softplus(matmul(xin @ w["xp_dt"], w["dt_proj"]) + p["dt_bias"])  # (b, s, di) float32
    dt = shard(dt, "batch", None, "tp")
    # contracted over the TP-sharded d_inner: reduced here (the in-place
    # state add below needs its operands placed alike)
    bmat = shard(xin @ w["xp_B"], "batch", None, None)
    cmat = shard(xin @ w["xp_C"], "batch", None, None)
    A = -torch.exp(p["A_log"])  # (di, ns)

    if is_dtensor(dt):  # each rank scans its batch rows and d_inner channels
        pl = spec_placements(("batch", None, "tp"), dt)
        bpl = spec_placements(("batch",), bmat)
        y, h = local_map(lambda *a: _mamba1_scan(*a, nchunk, lc), (dt, bmat, cmat, xin, A),
                         (pl, bpl, bpl, pl, spec_placements(("tp",), A)),
                         (pl, _state_placements(pl)))
    else:
        y, h = _mamba1_scan(dt, bmat, cmat, xin, A, nchunk, lc)

    y = y + p["D"] * xin.float()
    y = y.to(x.dtype) * F.silu(z)
    out = shard(y @ w["out_proj"], "batch")
    if return_cache:
        tail = xin_raw[:, -(cfg.ssm_conv - 1) :, :]
        return out, {"h": h, "conv": tail.to(torch.bfloat16)}
    return out


def _mamba1_weights(p: Params) -> Params:
    """Mamba-1's projections as its products use them: FSDP-gathered,
    d_inner over TP (identities on plain tensors)."""
    return {"in_x": shard(p["in_x"], None, "tp"), "in_z": shard(p["in_z"], None, "tp"),
            "xp_dt": shard(p["xp_dt"], "tp", None), "xp_B": shard(p["xp_B"], "tp", None),
            "xp_C": shard(p["xp_C"], "tp", None), "dt_proj": shard(p["dt_proj"], None, "tp"),
            "out_proj": shard(p["out_proj"], "tp", None)}


def _mamba2_weights(p: Params) -> Params:
    """Mamba-2's projections as its products use them (see
    :func:`_mamba1_weights`); the small B, C and dt projections whole."""
    return {"w_z": shard(p["w_z"], None, "tp"), "w_x": shard(p["w_x"], None, "tp"),
            "w_B": shard(p["w_B"]), "w_C": shard(p["w_C"]), "w_dt": shard(p["w_dt"]),
            "out_proj": shard(p["out_proj"], "tp", None)}


def h0_like(t: torch.Tensor, *tail: int) -> torch.Tensor:
    """A zero state (B, *C, *tail) made like ``t``'s (B, S, *C) first rows
    (so on a DTensor it takes their sharding)."""
    s0 = t[:, 0]
    return torch.zeros_like(s0[(...,) + (None,) * len(tail)].expand(*s0.shape, *tail))


def _state_placements(pl: tuple) -> tuple:
    """Placements of a state (B, *C, ...) made from a (B, S, *C) tensor
    placed by ``pl``: the sequence dim dropped."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(p.dim - (p.dim > 1)) if p.is_shard() and p.dim != 1 else
                 (Replicate() if p.is_shard() else p) for p in pl)


def _mamba1_scan(dt, bmat, cmat, xin, A, nchunk: int, lc: int):
    """The chunked selective scan: (y (B, S, di) float32, the final state
    (B, di, ns)); the (b, lc, di, ns) discretised tensors exist one chunk
    at a time."""
    h = h0_like(dt, A.shape[-1])
    ys = []
    for dt_c, b_c, c_c, x_c in zip(*(_chunks(t, nchunk, lc) for t in (dt, bmat, cmat, xin))):
        da_c = torch.exp(dt_c[..., None] * A)  # (b, lc, di, ns)
        dbx_c = dt_c[..., None] * b_c.float()[:, :, None, :] * x_c.float()[..., None]
        dbx_c[:, 0] += da_c[:, 0] * h
        _, b_scan = associative_scan(da_c, dbx_c)
        ys.append(torch.einsum("bldn,bln->bld", b_scan, c_c.float()))
        h = b_scan[:, -1]
    return torch.cat(ys, dim=1), h


def mamba1_cache_shape(cfg: ModelConfig, batch: int):
    return {
        "h": (batch, cfg.d_inner, cfg.ssm_state),
        "conv": (batch, cfg.ssm_conv - 1, cfg.d_inner),
    }


def decode_mamba1(p: Params, x: torch.Tensor, cache: Params, cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """Single-token step.  x: (B, 1, D); cache: {h, conv}.  Returns the
    output and the new {h, conv} (new tensors; the cache is not written)."""
    w = _mamba1_weights(p)
    xin_raw = x[:, 0] @ w["in_x"]
    z = x[:, 0] @ w["in_z"]
    window = torch.cat([cache["conv"].to(xin_raw.dtype), xin_raw[:, None, :]], dim=1)  # (b, k, di)
    xin = F.silu(_conv_step(window, p["conv_w"], p["conv_b"]))
    dt = softplus(matmul(xin @ w["xp_dt"], w["dt_proj"]) + p["dt_bias"])
    bvec = xin @ w["xp_B"]
    cvec = xin @ w["xp_C"]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)  # (b, di, ns)
    dBx = dt[..., None] * bvec.float()[:, None, :] * xin.float()[..., None]
    h = cache["h"] * dA + dBx
    y = torch.einsum("bdn,bn->bd", h, cvec.float())
    y = y + p["D"] * xin.float()
    y = y.to(x.dtype) * F.silu(z)
    return (y @ w["out_proj"])[:, None, :], {"h": h, "conv": window[:, 1:, :].to(torch.bfloat16)}


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------


def init_mamba2(key: torch.Tensor, cfg: ModelConfig, *, device=None) -> Params:
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    k = cfg.ssm_conv
    ks = prng.split(key, 9)
    dt = _dtype(cfg)
    std = d**-0.5
    f32 = torch.float32
    return {
        "w_z": draw_normal(ks[0], (d, di), std, dt, device),
        "w_x": draw_normal(ks[1], (d, di), std, dt, device),
        "w_B": draw_normal(ks[2], (d, ns), std, dt, device),
        "w_C": draw_normal(ks[3], (d, ns), std, dt, device),
        "w_dt": draw_normal(ks[4], (d, nh), std, f32, device),
        "conv_x": draw_normal(ks[5], (k, di), k**-0.5, dt, device),
        "conv_x_b": torch.zeros((di,), dtype=dt, device=device),
        "conv_B": draw_normal(ks[6], (k, ns), k**-0.5, dt, device),
        "conv_B_b": torch.zeros((ns,), dtype=dt, device=device),
        "conv_C": draw_normal(ks[7], (k, ns), k**-0.5, dt, device),
        "conv_C_b": torch.zeros((ns,), dtype=dt, device=device),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=device),
        "A_log": f32math.log(prng.uniform(ks[8], (nh,), minval=1.0, maxval=16.0, device=device)),
        "D": torch.ones((nh,), dtype=f32, device=device),
        "norm_scale": torch.ones((di,), dtype=f32, device=device),
        # the reference draws conv_x and out_proj from the same key, ks[5]
        "out_proj": draw_normal(ks[5], (di, d), di**-0.5, dt, device),
    }


def _gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = (x * F.silu(z)).float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale).to(x.dtype)


def _ssd_chunk(h, da_c, x_c, b_c, c_c):
    """One SSD chunk: h (b, nh, hd, ns), da_c (b, lc, nh) log-decays, x_c
    (b, lc, nh, hd), b_c / c_c (b, lc, ns).  Returns (new h, y (b, lc, nh,
    hd)).  The intra-chunk decay is ``exp(rel)`` on and below the diagonal
    and 0 above it, taken as ``exp`` of ``rel`` masked to -inf: the
    reference's ``where(causal, exp(rel), 0)`` has these values, but its
    gradient is 0 x inf = NaN wherever an above-diagonal ``rel`` overflows
    ``exp`` (long chunks), and this one is 0 there."""
    lc = da_c.shape[1]
    seg = torch.cumsum(da_c, dim=1)  # (b, lc, nh)
    rel = seg[:, :, None, :] - seg[:, None, :, :]
    causal = torch.ones((lc, lc), dtype=torch.bool, device=seg.device).tril()
    decay = torch.exp(torch.where(causal[None, :, :, None], rel, float("-inf")))
    cb = torch.einsum("bqn,bkn->bqk", c_c, b_c)
    y_intra = torch.einsum("bqk,bqkh,bkhd->bqhd", cb, decay, x_c)
    y_inter = torch.einsum("bqn,bhdn,bqh->bqhd", c_c, h, torch.exp(seg))
    to_end = torch.exp(seg[:, -1:, :] - seg)
    new_h = h * torch.exp(seg[:, -1])[:, :, None, None] + torch.einsum("bkn,bkhd,bkh->bhdn", b_c, x_c, to_end)
    return new_h, y_intra + y_inter


def apply_mamba2(p: Params, x: torch.Tensor, cfg: ModelConfig, *, return_cache: bool = False):
    """SSD chunked forward.  x: (B, S, D) -> (B, S, D)."""
    b, s_len, _ = x.shape
    di, ns = cfg.d_inner, cfg.ssm_state
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    lc = _chunk_len(cfg, s_len)
    nchunk = s_len // lc

    w = _mamba2_weights(p)
    z = x @ w["w_z"]
    x_raw = shard(x @ w["w_x"], "batch", None, "tp")
    b_raw = x @ w["w_B"]
    c_raw = x @ w["w_C"]
    dtl = matmul(x, w["w_dt"])
    xin = F.silu(_causal_conv(x_raw, p["conv_x"], p["conv_x_b"]))
    bmat = F.silu(_causal_conv(b_raw, p["conv_B"], p["conv_B_b"]))
    cmat = F.silu(_causal_conv(c_raw, p["conv_C"], p["conv_C_b"]))
    dt = softplus(dtl.float() + p["dt_bias"])  # (b, s, nh)
    A = -torch.exp(p["A_log"])  # (nh,)
    da = dt * A  # log-decay per step

    xh = xin.reshape(b, s_len, nh, hd).float() * dt[..., None]
    xh = shard(xh, "batch", None, "tp", None)  # heads over model
    bf, cf = bmat.float(), cmat.float()
    if is_dtensor(xh):  # each rank scans its batch rows and heads
        xpl = spec_placements(("batch", None, "tp"), xh)
        dpl = placements_like(xpl, da)
        bpl = spec_placements(("batch",), bf)
        y, h = local_map(lambda *a: _ssd_scan(*a, nchunk, lc), (da, xh, bf, cf), (dpl, xpl, bpl, bpl),
                         (xpl, _state_placements(xpl)))
    else:
        y, h = _ssd_scan(da, xh, bf, cf, nchunk, lc)  # y (b, s, nh, hd)
    y = y + p["D"][:, None] * xin.reshape(b, s_len, nh, hd).float()
    y = y.reshape(b, s_len, di).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    out = shard(y @ w["out_proj"], "batch")
    if return_cache:
        tail = torch.cat([x_raw, b_raw, c_raw], dim=-1)[:, -(cfg.ssm_conv - 1) :, :]
        return out, {"h": h, "conv": tail.to(torch.bfloat16)}
    return out


def placements_like(pl: tuple, t: torch.Tensor) -> tuple:
    """``pl`` (placements of a (B, S, H, ...) tensor) for ``t`` of (B, S,
    H): a shard of a dim ``t`` lacks is dropped."""
    from torch.distributed.tensor import Replicate

    return tuple(p if not p.is_shard() or p.dim < t.ndim else Replicate() for p in pl)


def _ssd_scan(da, xh, bf, cf, nchunk: int, lc: int):
    """The chunked SSD scan: (y (B, S, nh, hd), the final state (B, nh, hd,
    ns))."""
    h = h0_like(xh, bf.shape[-1])
    ys = []
    for da_c, x_c, b_c, c_c in zip(*(_chunks(t, nchunk, lc) for t in (da, xh, bf, cf))):
        h, y_c = _ssd_chunk(h, da_c, x_c, b_c, c_c)
        ys.append(y_c)
    return torch.cat(ys, dim=1), h


def mamba2_cache_shape(cfg: ModelConfig, batch: int):
    return {
        "h": (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
        "conv": (batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
    }


def decode_mamba2(p: Params, x: torch.Tensor, cache: Params, cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """Single-token step.  x: (B, 1, D); cache: {h, conv}.  Returns the
    output and the new {h, conv} (new tensors; the cache is not written)."""
    b = x.shape[0]
    di, ns = cfg.d_inner, cfg.ssm_state
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    x0 = x[:, 0]
    w = _mamba2_weights(p)
    z = x0 @ w["w_z"]
    new_raw = torch.cat([x0 @ w["w_x"], x0 @ w["w_B"], x0 @ w["w_C"]], dim=-1)
    dtl = matmul(x0, w["w_dt"])
    window = torch.cat([cache["conv"].to(new_raw.dtype), new_raw[:, None, :]], dim=1)  # (b, k, di + 2ns)
    wx, wb, wc = torch.split(window, [di, ns, ns], dim=-1)
    xin = F.silu(_conv_step(wx, p["conv_x"], p["conv_x_b"]))
    bvec = F.silu(_conv_step(wb, p["conv_B"], p["conv_B_b"]))
    cvec = F.silu(_conv_step(wc, p["conv_C"], p["conv_C_b"]))
    dt = softplus(dtl.float() + p["dt_bias"])  # (b, nh)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt * A)
    xh = xin.reshape(b, nh, hd).float() * dt[..., None]
    h = cache["h"] * da[..., None, None] + torch.einsum("bn,bhd->bhdn", bvec.float(), xh)
    y = torch.einsum("bn,bhdn->bhd", cvec.float(), h)
    y = y + p["D"][:, None] * xin.reshape(b, nh, hd).float()
    y = y.reshape(b, di).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    return (y @ w["out_proj"])[:, None, :], {"h": h, "conv": window[:, 1:, :].to(torch.bfloat16)}
